// Exact brute-force k nearest neighbours, one thread per query.
//
// Replaces: loam_tpu/ops/pallas/knn_topk.py:_knn_kernel (k=1, the
// odometry 1-NN) and :_knn_kernel_dyn (k=5, the pruned mapping 5-NN
// with live query blocks and per-block reference-tile windows).
//
// What bounds it on the H100: fp32 CUDA-core arithmetic and issue
// slots, not bytes.  Each query/reference pair costs 3 subtractions,
// 3 multiplies, 2 adds and a compare (plus a k-way insert on the rare
// hit); references are read once per block from device memory into
// shared memory and then broadcast to all threads.  At the mapping
// shapes (8192 queries x 65536 references, pruned to a few tiles per
// block) the work is ~10^8 pairs; the small query counts leave most of
// the card's 132 SMs idle (one block per 256 queries), which later
// work can fix by splitting the reference range across blocks.
//
// Design: a block of tq threads owns tq queries and streams its tile
// window [t_lo, t_hi) of tm references through shared memory; each
// thread keeps its k best (d2, index) pairs sorted in registers
// (K is a template parameter, so the insert unrolls).  Distances are
// exact fp32 (q - r)^2 with explicit round-to-nearest multiplies and
// adds, in the order round(round(dx^2 + dy^2) + dz^2): the plain torch
// version computes the same sequence, so both agree bit for bit and
// the neighbour order (ties -> smaller index) is identical.  No tensor
// cores, no TF32, no mantissa-truncated keys.  Blocks past the live
// query count write the empty fill (d2 = 1e30, index 0) and exit;
// references at or past the live count n_ref are skipped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int K>
__global__ void knn_kernel(const float* __restrict__ q,
                           const float* __restrict__ ref,
                           const int32_t* __restrict__ n_q,
                           const int32_t* __restrict__ n_ref,
                           const int32_t* __restrict__ t_lo,
                           const int32_t* __restrict__ t_hi,
                           float* __restrict__ d2_out,
                           int32_t* __restrict__ idx_out, int Q, int M,
                           int tm, int nqb) {
  extern __shared__ float tile[];  // 3 * tm floats, xyz interleaved
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int tq = blockDim.x;
  const int qi = blk * tq + threadIdx.x;  // Q == nqb * tq

  float bd[K];
  int32_t bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kBig;
    bi[s] = 0;
  }

  const int nq = n_q[b];
  const int nr = n_ref[b];
  int live_blocks = (nq + tq - 1) / tq;
  live_blocks = live_blocks < 1 ? 1 : (live_blocks > nqb ? nqb : live_blocks);
  if (blk < live_blocks) {
    const int m_tiles = (M + tm - 1) / tm;
    int live_tiles = (nr + tm - 1) / tm;
    live_tiles = live_tiles < 1 ? 1 : (live_tiles > m_tiles ? m_tiles
                                                            : live_tiles);
    int lo = t_lo[b * nqb + blk];
    int hi = t_hi[b * nqb + blk];
    lo = lo < 0 ? 0 : lo;
    hi = hi > live_tiles ? live_tiles : hi;

    const float* qp = q + (static_cast<long>(b) * Q + qi) * 3;
    const float qx = qp[0], qy = qp[1], qz = qp[2];
    const float* rb = ref + static_cast<long>(b) * M * 3;

    for (int t = lo; t < hi; ++t) {  // trip count uniform across the block
      const int base = t * tm;
      __syncthreads();
      for (int j = threadIdx.x; j < 3 * tm; j += tq) {
        const int g = base * 3 + j;
        tile[j] = g < M * 3 ? rb[g] : 0.0f;
      }
      __syncthreads();
      int n = nr - base;
      n = n > tm ? tm : n;
      for (int j = 0; j < n; ++j) {
        const float d = sq_dist(qx, qy, qz, tile[3 * j], tile[3 * j + 1],
                                tile[3 * j + 2]);
        if (d < bd[K - 1]) {
          // sorted insert; an equal distance lands after the earlier
          // (smaller) index
#pragma unroll
          for (int s = K - 1; s > 0; --s) {
            if (d < bd[s - 1]) {
              bd[s] = bd[s - 1];
              bi[s] = bi[s - 1];
            } else if (d < bd[s]) {
              bd[s] = d;
              bi[s] = base + j;
            }
          }
          if (d < bd[0]) {
            bd[0] = d;
            bi[0] = base + j;
          }
        }
      }
    }
  }

  const long o = (static_cast<long>(b) * Q + qi) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    d2_out[o + s] = bd[s];
    idx_out[o + s] = bi[s];
  }
}

template <int K>
int launch(const float* q, const float* ref, const int32_t* n_q,
           const int32_t* n_ref, const int32_t* t_lo, const int32_t* t_hi,
           float* d2, int32_t* idx, int B, int Q, int M, int tq, int tm,
           cudaStream_t stream) {
  const int nqb = Q / tq;
  const size_t smem = sizeof(float) * 3 * tm;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        knn_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  knn_kernel<K><<<dim3(nqb, B), tq, smem, stream>>>(
      q, ref, n_q, n_ref, t_lo, t_hi, d2, idx, Q, M, tm, nqb);
  return cudaGetLastError();
}

}  // namespace

// q (B, Q, 3), ref (B, M, 3) float32; n_q, n_ref (B,) int32 live counts;
// t_lo, t_hi (B, Q/tq) int32 tile windows; outputs d2 (B, Q, K) float32
// and idx (B, Q, K) int32, nearest first.  Q must be a multiple of tq.
// Returns cudaGetLastError().
extern "C" int knn_topk_launch(const void* q, const void* ref,
                               const void* n_q, const void* n_ref,
                               const void* t_lo, const void* t_hi, void* d2,
                               void* idx, int B, int Q, int M, int K, int tq,
                               int tm, void* stream) {
  if (B <= 0 || Q <= 0) return 0;
  if (tq <= 0 || tq > 1024 || Q % tq || tm <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* rf = static_cast<const float*>(ref);
  const auto* nq = static_cast<const int32_t*>(n_q);
  const auto* nr = static_cast<const int32_t*>(n_ref);
  const auto* lo = static_cast<const int32_t*>(t_lo);
  const auto* hi = static_cast<const int32_t*>(t_hi);
  auto* d = static_cast<float*>(d2);
  auto* i = static_cast<int32_t*>(idx);
  switch (K) {
    case 1:
      return launch<1>(qf, rf, nq, nr, lo, hi, d, i, B, Q, M, tq, tm, s);
    case 5:
      return launch<5>(qf, rf, nq, nr, lo, hi, d, i, B, Q, M, tq, tm, s);
    default:
      return cudaErrorInvalidValue;
  }
}
