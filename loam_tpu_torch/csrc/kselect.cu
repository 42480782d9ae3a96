// The k nearest of each query's own candidate points, one warp per query.
//
// Replaces: loam_tpu/ops/pallas/kselect.py:_kselect_kernel (wrapper
// knn_select), the fused distance + k-smallest selection behind
// map_store.knn_candidates (the 27-cell gather, C = 864, k = 24) and
// map_store.knn_from_candidates (the per-iteration re-rank of a cached
// candidate set, C = 24 or 8, k = 5).
//
// What bounds it on the H100: bytes.  Every candidate is read once
// (12 bytes of coordinates and one validity byte) against about 9 fp32
// operations, far below the card's operations-per-byte balance, and
// the outputs are k/C of the input.  The k selection rounds work on
// distances that never leave the SM.
//
// Design: the Pallas kernel pads C to 128 lanes, splits x, y and z
// into planes and gathers each pick by a one-hot sum, because the TPU
// has no dynamic column store; none of that is needed here.  A warp
// owns one query.  Lane l computes the squared distances of candidates
// l, l + 32, ... into the warp's slice of shared memory (invalid ones
// as 1e30) and remembers its own smallest (distance, index).  Each of
// the k rounds is a warp-wide (distance, index) min-reduction by
// __shfl_xor_sync, the smaller index winning a tie; lane 0 writes the
// winner's distance and its coordinates, read from `cand` by index; the
// lane that owned the winner retires it (+inf) and rescans its own
// <= 32 entries.  So the picks are distinct indices in ascending
// (distance, index) order, invalid candidates (1e30) after every valid
// one: the rule of a stable top-k, which the plain PyTorch version
// follows to the bit.  Distances are (c - q)^2 with explicit
// round-to-nearest multiplies and adds in the order
// round(round(dx^2 + dy^2) + dz^2), no FMA contraction, no tensor cores.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kMaxC = 1024;  // candidates a query: <= 32 a lane
constexpr int kMaxK = 32;
constexpr int kWarps = 8;    // queries a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ float sq_dist(float cx, float cy, float cz,
                                         float qx, float qy, float qz) {
  const float dx = __fsub_rn(cx, qx);
  const float dy = __fsub_rn(cy, qy);
  const float dz = __fsub_rn(cz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void kselect_kernel(const float* __restrict__ cand,
                               const uint8_t* __restrict__ valid,
                               const float* __restrict__ q,
                               float* __restrict__ pts_out,
                               float* __restrict__ d2_out, int Q, int C,
                               int k) {
  extern __shared__ float dist[];  // kWarps * C distances
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= Q) return;  // a whole warp leaves; no block-wide barrier below

  float* d = dist + warp * C;
  const float* cq = cand + static_cast<long>(qi) * C * 3;
  const uint8_t* vq = valid + static_cast<long>(qi) * C;
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];

  // this lane's smallest; ascending j keeps the first of equal distances
  float best = CUDART_INF_F;
  int best_i = kNoIndex;
  for (int j = lane; j < C; j += 32) {
    const float v = vq[j] ? sq_dist(cq[3 * j], cq[3 * j + 1], cq[3 * j + 2],
                                    qx, qy, qz)
                          : kBig;
    d[j] = v;
    if (v < best) {
      best = v;
      best_i = j;
    }
  }

  float* po = pts_out + static_cast<long>(qi) * k * 3;
  float* dout = d2_out + static_cast<long>(qi) * k;
  for (int s = 0; s < k; ++s) {
    float m = best;
    int mi = best_i;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(kFull, m, off);
      const int oi = __shfl_xor_sync(kFull, mi, off);
      if (om < m || (om == m && oi < mi)) {
        m = om;
        mi = oi;
      }
    }
    // every lane now holds the same winner; k <= C keeps it a real index
    if (lane == 0) {
      dout[s] = m;
      po[3 * s] = cq[3 * mi];
      po[3 * s + 1] = cq[3 * mi + 1];
      po[3 * s + 2] = cq[3 * mi + 2];
    }
    if ((mi & 31) == lane) {  // the owner retires it and rescans its own
      d[mi] = CUDART_INF_F;
      best = CUDART_INF_F;
      best_i = kNoIndex;
      for (int j = lane; j < C; j += 32) {
        const float v = d[j];
        if (v < best) {
          best = v;
          best_i = j;
        }
      }
    }
  }
}

}  // namespace

// cand (Q, C, 3) float32, valid (Q, C) one byte each (0 or 1), q (Q, 3)
// float32; outputs pts (Q, k, 3) and d2 (Q, k) float32, nearest first.
// 1 <= k <= min(C, 32), C <= 1024.  Returns cudaGetLastError().
extern "C" int kselect_launch(const void* cand, const void* valid,
                              const void* q, void* pts, void* d2, int Q,
                              int C, int k, void* stream) {
  if (Q <= 0) return 0;
  if (C <= 0 || C > kMaxC || k <= 0 || k > kMaxK || k > C)
    return cudaErrorInvalidValue;
  const int blocks = (Q + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * kWarps * C;  // <= 32 KB
  kselect_kernel<<<blocks, kWarps * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(q), static_cast<float*>(pts),
      static_cast<float*>(d2), Q, C, k);
  return cudaGetLastError();
}
