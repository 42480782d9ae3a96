// The k nearest of each query's own candidate points: a group of lanes
// sized to the candidate count owns a query.
//
// Replaces: loam_tpu/ops/pallas/kselect.py:_kselect_kernel (wrapper
// knn_select), the fused distance + k-smallest selection behind
// map_store.knn_candidates (the 27-cell gather, C = 27 *
// search_bucket_cap, k = knn_candidates: 864 and 24 by default) and
// map_store.knn_from_candidates (the per-iteration re-rank of a cached
// candidate set, C = knn_candidates or the hybrid cache, k = map_knn).
//
// What bounds it on the H100: bytes.  Every candidate is read once
// (12 bytes of coordinates and one validity byte) against about 9 fp32
// operations, far below the card's operations-per-byte balance, and
// the outputs are k/C of the input.  At the re-rank shapes the bound is
// below a launch's latency; at the gather shape (23 MB) the version this
// replaces read its rows at 1.2x the byte bound and then spent twice as
// long again in its k selection rounds, ten shuffles and a serial rescan
// of the owner's distances each.
//
// Design.  The Pallas kernel pads C to 128 lanes, splits x, y and z
// into planes and gathers each pick by a one-hot sum, because the TPU
// has no dynamic column store; none of that is needed here.
//   * C <= 32 (kselect_group_kernel): eight lanes own a query, four
//     queries a warp, each lane holding R = ceil(C / 8) candidates (index
//     lane + 8 r) with their coordinates in registers.  A round is the
//     lane's own minimum over its R registers, a (distance, index)
//     minimum over the group by three xor shuffles (offsets 4, 2, 1 stay
//     inside the group), and the owning lane writing the pick and
//     retiring it.  Nothing goes through shared memory.
//   * C > 32 (kselect_warp_kernel): a warp owns a query.  The query's
//     row (C x 12 bytes of coordinates, C validity bytes; both contiguous)
//     arrives by cp.async, 16 bytes a copy, into the warp's slice of
//     shared memory, every byte moved once.  A block has as many warps
//     (8 at most) as its 227 KB hold rows of C, so that the rows of the
//     others are in flight while one is ranked (8 at C = 864 and 1296;
//     one warp takes C up to 17880).  The lanes turn the row into
//     distances in place (lane l takes candidates l, l + 32, ...: words
//     at a stride of three, no bank conflicts).  Each lane keeps its
//     kReady smallest (distance, index) pairs sorted in registers; a
//     round is two hardware warp reductions over the heads
//     (warp_min_pair), the owner retires its pick and moves its next up,
//     and looks through its own ceil(C / 32) distances again only when
//     its ready pairs are used up, which at k = 24 of 864 is rare.  Lane
//     s % 32 keeps round s's pick, and each 32 rounds leave in one
//     coalesced store, the coordinates read back from `cand` by index:
//     k is bounded by C alone.  Rows that are not 16-byte aligned (C
//     not a multiple of 4, or an offset base pointer) take plain loads
//     instead of cp.async.
// Either way the picks are k distinct indices in ascending (distance,
// index) order, invalid candidates (1e30) after every valid one: the
// rule of a stable top-k, which the plain PyTorch version follows to the
// bit.  Distances are (c - q)^2 in the order round(round(dx^2 + dy^2) +
// dz^2) (exact_dist.cuh), no FMA contraction, no tensor cores.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "exact_dist.cuh"
#include "warp_util.cuh"

namespace {

constexpr int kSmemMax = 232448;  // dynamic shared memory a block may ask
constexpr int kGroup = 8;       // lanes a query in kselect_group_kernel
constexpr int kGroupMaxC = 4 * kGroup;  // at most 4 candidates a lane
constexpr int kGroupThreads = 256;
constexpr int kWarps = 8;    // warps a block in kselect_warp_kernel, at most
constexpr int kReady = 4;    // pairs a lane keeps ready there
constexpr int kBatch = 4;    // candidates a lane loads before it stores

template <int R>
__global__ void __launch_bounds__(kGroupThreads)
    kselect_group_kernel(const float* __restrict__ cand,
                         const uint8_t* __restrict__ valid,
                         const float* __restrict__ q,
                         float* __restrict__ pts_out,
                         float* __restrict__ d2_out, int Q, int C, int k) {
  const int t = blockIdx.x * kGroupThreads + threadIdx.x;
  const int sub = t % kGroup;
  const bool live = t / kGroup < Q;
  // a group past Q repeats the last query and writes nothing, so every
  // lane of the warp stays in the full-mask shuffles below
  const int qi = live ? t / kGroup : Q - 1;
  const float* cq = cand + static_cast<long>(qi) * C * 3;
  const uint8_t* vq = valid + static_cast<long>(qi) * C;
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];

  float d[R], cx[R], cy[R], cz[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = sub + kGroup * r;
    d[r] = CUDART_INF_F;  // no such candidate
    cx[r] = cy[r] = cz[r] = 0.0f;
    if (j < C) {
      cx[r] = cq[3 * j];
      cy[r] = cq[3 * j + 1];
      cz[r] = cq[3 * j + 2];
      d[r] = vq[j] ? sq_dist(cx[r], cy[r], cz[r], qx, qy, qz) : kBig;
    }
  }

  float* po = pts_out + static_cast<long>(qi) * k * 3;
  float* dout = d2_out + static_cast<long>(qi) * k;
  for (int s = 0; s < k; ++s) {
    // the lane's own smallest; ascending r keeps the first of equals
    float m = d[0];
    int mr = 0;
#pragma unroll
    for (int r = 1; r < R; ++r) {
      if (d[r] < m) {
        m = d[r];
        mr = r;
      }
    }
    const int own = m < CUDART_INF_F ? sub + kGroup * mr : kNoIndex;
    int mi = own;
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(kFullMask, m, off);
      const int oi = __shfl_xor_sync(kFullMask, mi, off);
      if (om < m || (om == m && oi < mi)) {
        m = om;
        mi = oi;
      }
    }
    // k <= C keeps the winner a real index, held by exactly one lane
    if (mi == own && live) {
      float px = cx[0], py = cy[0], pz = cz[0];
#pragma unroll
      for (int r = 1; r < R; ++r) {
        if (r == mr) {
          px = cx[r];
          py = cy[r];
          pz = cz[r];
        }
      }
      dout[s] = m;
      po[3 * s] = px;
      po[3 * s + 1] = py;
      po[3 * s + 2] = pz;
    }
    if (mi == own) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r == mr) d[r] = CUDART_INF_F;
      }
    }
  }
}

// A warp's slice of shared memory.  With kAsync the staged row (3 C
// floats) and C validity bytes padded to 16; candidate j's distance then
// overwrites its own x word.  Without, C distances.
__host__ __device__ constexpr size_t warp_smem_bytes(int C, bool async) {
  return async ? sizeof(float) * 3 * C + ((C + 15) / 16) * 16
               : sizeof(float) * C;
}

template <bool kAsync>
__global__ void __launch_bounds__(kWarps * 32)
    kselect_warp_kernel(const float* __restrict__ cand,
                        const uint8_t* __restrict__ valid,
                        const float* __restrict__ q,
                        float* __restrict__ pts_out,
                        float* __restrict__ d2_out, int Q, int C, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStride = kAsync ? 3 : 1;  // words between two distances
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (blockDim.x >> 5) + warp;
  if (qi >= Q) return;  // a whole warp leaves; no block-wide barrier below
  unsigned char* mine = smem + warp * warp_smem_bytes(C, kAsync);
  float* row = reinterpret_cast<float*>(mine);
  uint8_t* vrow = mine + sizeof(float) * 3 * C;  // kAsync only
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
  const float* cq = cand + static_cast<long>(qi) * C * 3;
  const uint8_t* vq = valid + static_cast<long>(qi) * C;
  if (kAsync) {  // C % 4 == 0 here: whole 16- and 4-byte words
    cp_async_floats(row, cq, 3 * C, true, lane, 32);
    for (int i = lane; i < C / 4; i += 32)
      cp_async4(vrow + 4 * i, vq + 4 * i);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();  // every lane's copies are visible to the warp
  }
  const float* c = kAsync ? row : cq;
  const uint8_t* v = kAsync ? vrow : vq;
  // from here on a lane touches only its own candidates (j % 32 == lane);
  // four a step, all loads before the stores that may overwrite the row
  for (int j0 = lane; j0 < C; j0 += 32 * kBatch) {
    float d[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + 32 * u;
      if (j < C) {
        d[u] = v[j] ? sq_dist(c[3 * j], c[3 * j + 1], c[3 * j + 2], qx, qy,
                              qz)
                    : kBig;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + 32 * u;
      if (j < C) row[kStride * j] = d[u];
    }
  }

  // the lane's kReady smallest (distance, index) pairs in order;
  // ascending j and a strict < keep the first of equal distances first
  float bd[kReady];
  int bi[kReady];
  auto rescan = [&]() {
#pragma unroll
    for (int u = 0; u < kReady; ++u) {
      bd[u] = CUDART_INF_F;
      bi[u] = kNoIndex;
    }
#pragma unroll 4
    for (int j = lane; j < C; j += 32) {
      const float x = row[kStride * j];
      if (x < bd[kReady - 1]) sorted_insert<kReady>(bd, bi, x, j);
    }
  };
  rescan();
  int ready = kReady;

  // round s's pick stays in lane s % 32 until its 32 rounds are done
  const long o = static_cast<long>(qi) * k;
  float out_d = 0.0f;
  int out_i = 0;
  for (int s = 0; s < k; ++s) {
    float m = bd[0];
    int mi = bi[0];
    warp_min_pair(m, mi);
    // k <= C keeps the winner a real index, held by exactly one lane
    if (lane == (s & 31)) {
      out_d = m;
      out_i = mi;
    }
    if (bi[0] == mi) {  // the owner retires it and moves its next up
      row[kStride * mi] = CUDART_INF_F;
#pragma unroll
      for (int u = 0; u + 1 < kReady; ++u) {
        bd[u] = bd[u + 1];
        bi[u] = bi[u + 1];
      }
      bd[kReady - 1] = CUDART_INF_F;
      bi[kReady - 1] = kNoIndex;
      if (--ready == 0 && s + 1 < k) {  // nothing ready: look again
        rescan();
        ready = kReady;
      }
    }
    if ((s & 31) == 31 || s + 1 == k) {
      const long slot = (s & ~31) + lane;
      if (slot <= s) {
        d2_out[o + slot] = out_d;
        pts_out[3 * (o + slot)] = cq[3 * out_i];
        pts_out[3 * (o + slot) + 1] = cq[3 * out_i + 1];
        pts_out[3 * (o + slot) + 2] = cq[3 * out_i + 2];
      }
    }
  }
}

template <int R>
void launch_group(const float* cand, const uint8_t* valid, const float* q,
                  float* pts, float* d2, int Q, int C, int k,
                  cudaStream_t stream) {
  const long threads = static_cast<long>(Q) * kGroup;
  const int blocks =
      static_cast<int>((threads + kGroupThreads - 1) / kGroupThreads);
  kselect_group_kernel<R><<<blocks, kGroupThreads, 0, stream>>>(
      cand, valid, q, pts, d2, Q, C, k);
}

template <bool kAsync>
int launch_warp(const float* cand, const uint8_t* valid, const float* q,
                float* pts, float* d2, int Q, int C, int k,
                cudaStream_t stream) {
  // as many warps as the block's shared memory holds rows of C
  const size_t row = warp_smem_bytes(C, kAsync);
  const int fit = static_cast<int>(kSmemMax / row);
  const int warps = fit < kWarps ? fit : kWarps;
  const int smem = static_cast<int>(warps * row);
  // above 48 KB a block's dynamic shared memory has to be asked for; the
  // limit asked is the card's, the same for every C, so launches from
  // several host threads never race on it
  cudaError_t e = cudaFuncSetAttribute(
      kselect_warp_kernel<kAsync>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e != cudaSuccess) return e;
  kselect_warp_kernel<kAsync><<<(Q + warps - 1) / warps, warps * 32, smem,
                                stream>>>(cand, valid, q, pts, d2, Q, C, k);
  return cudaSuccess;
}

}  // namespace

// cand (Q, C, 3) float32, valid (Q, C) one byte each (0 or 1), q (Q, 3)
// float32; outputs pts (Q, k, 3) and d2 (Q, k) float32, nearest first.
// 1 <= k <= C, and one row of C fits a block's shared memory
// (warp_smem_bytes(C, true) <= 227 KB: C <= 17880).  Returns
// cudaGetLastError().
extern "C" int kselect_launch(const void* cand, const void* valid,
                              const void* q, void* pts, void* d2, int Q,
                              int C, int k, void* stream) {
  if (Q <= 0) return 0;
  if (C <= 0 || k <= 0 || k > C || warp_smem_bytes(C, true) > kSmemMax)
    return cudaErrorInvalidValue;
  const auto* cf = static_cast<const float*>(cand);
  const auto* vb = static_cast<const uint8_t*>(valid);
  const auto* qf = static_cast<const float*>(q);
  auto* pf = static_cast<float*>(pts);
  auto* df = static_cast<float*>(d2);
  const auto s = static_cast<cudaStream_t>(stream);
  if (C <= kGroupMaxC) {
    switch ((C + kGroup - 1) / kGroup) {
      case 1:
        launch_group<1>(cf, vb, qf, pf, df, Q, C, k, s);
        break;
      case 2:
        launch_group<2>(cf, vb, qf, pf, df, Q, C, k, s);
        break;
      case 3:
        launch_group<3>(cf, vb, qf, pf, df, Q, C, k, s);
        break;
      default:
        launch_group<4>(cf, vb, qf, pf, df, Q, C, k, s);
    }
  } else {
    const bool rows_aligned = C % 4 == 0 && aligned16(cand) &&
                              (reinterpret_cast<uintptr_t>(valid) & 3) == 0;
    const int e = rows_aligned
                      ? launch_warp<true>(cf, vb, qf, pf, df, Q, C, k, s)
                      : launch_warp<false>(cf, vb, qf, pf, df, Q, C, k, s);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

// the most candidates a row kselect_launch takes: one warp's staged row
// in a block's dynamic shared memory
extern "C" int kselect_max_c() {
  int C = kSmemMax / 12;
  while (warp_smem_bytes(C, true) > kSmemMax) --C;
  return C;
}
