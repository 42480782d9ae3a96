// Exact brute-force k nearest neighbours over tile-windowed references,
// one warp per query.
//
// Replaces: loam_tpu/ops/pallas/knn_topk.py:_knn_kernel_dyn (k=5, the
// pruned mapping 5-NN with live query blocks and per-block
// reference-tile windows; k=8, the hybrid cadence's candidate gather;
// k=1 through knn_topk_dyn) and :_knn_kernel at k > 1.  The odometry
// 1-NN over a whole live reference has a kernel of its own,
// knn_nearest.cu.
//
// What bounds it on the H100: fp32 CUDA-core instruction slots, not
// bytes.  A query/reference pair costs 3 subtractions, 3 multiplies, 2 adds and a
// compare, and a sorted insert of about 6 K instructions whenever any
// lane of the warp finds a new candidate (which, with 32 private lists a
// query, is most steps).  At the mapping shapes (6000 live queries
// against windows of about 3500 of 50000 references) that is 2 * 10^7
// pairs and a few 10^7 warp instructions: tens of microseconds for the
// whole card, where the byte bound is under one.  The version this
// replaces ran one thread a query: 6 to 24 live blocks on 132 SMs, each
// thread alone with a latency chain of several thousand references.
//
// Design.  A warp owns a query; a block of kWarps warps takes kWarps
// consecutive rows of one query block of the contract (tq rows, one
// tile window), so 6000 live queries are 1500 blocks and 1500 queries
// 375: either fills the card's 132 SMs.  The block streams
// its window through shared memory in slices of kSlice points, the next
// slice's cp.async copies in flight while the current one is scanned
// (16 bytes a copy where the window starts 16-byte aligned).  Lane l
// takes points l, l + 32, ... of a slice (three words at a stride of
// three: no bank conflicts) and keeps its own K best (d2, index) sorted
// in registers, strict < on insert, so the earlier index stays first
// among equal distances.  After the window the lanes' lists merge inside
// the warp: K rounds of a (distance, index) minimum over the list heads,
// the winning lane popping its head.  Each list is in (distance, index)
// order and the lanes hold disjoint indices, so the K winners are the K
// smallest pairs of the window in order: the plain version's k
// first-occurrence argmins, bit for bit, in any block order.  No scratch
// in device memory, no second launch, no atomics.  Distances are exact
// fp32 round(round(dx^2 + dy^2) + dz^2) (exact_dist.cuh): no FMA
// contraction, no tensor cores.  Rows past n_q inside a live query block
// are computed like any other; dead blocks, empty windows and missing
// neighbours write (index 0, d2 = 1e30).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "exact_dist.cuh"
#include "warp_util.cuh"

namespace {

constexpr int kWarps = 4;     // warps (queries) a block
constexpr int kSlice = 1024;  // reference points a staged slice; % 4 == 0

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
    knn_kernel(const float* __restrict__ q, const float* __restrict__ ref,
               const int32_t* __restrict__ n_q,
               const int32_t* __restrict__ n_ref,
               const int32_t* __restrict__ t_lo,
               const int32_t* __restrict__ t_hi, float* __restrict__ d2_out,
               int32_t* __restrict__ idx_out, int Q, int M, int tq, int tm,
               int parts) {
  __shared__ __align__(16) float tile[2][3 * kSlice];  // xyz interleaved
  const int b = blockIdx.y;
  const int blk = blockIdx.x / parts;  // query block of the contract
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nqb = Q / tq;
  // this warp's row of the query block; past tq only in the last part
  const int row = (blockIdx.x % parts) * kWarps + warp;

  float bd[K];
  int32_t bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = kNoIndex;
  }

  // the window [start, end) of visible references; uniform over the block
  const int nq = n_q[b];
  const int nr = n_ref[b];
  int live_blocks = (nq + tq - 1) / tq;
  live_blocks = live_blocks < 1 ? 1 : (live_blocks > nqb ? nqb : live_blocks);
  int start = 0, end = 0;
  if (blk < live_blocks) {
    const int m_tiles = (M + tm - 1) / tm;
    int live_tiles = (nr + tm - 1) / tm;
    live_tiles = live_tiles < 1 ? 1 : (live_tiles > m_tiles ? m_tiles
                                                            : live_tiles);
    int lo = t_lo[b * nqb + blk];
    int hi = t_hi[b * nqb + blk];
    lo = lo < 0 ? 0 : lo;
    hi = hi > live_tiles ? live_tiles : hi;
    if (lo < hi) {
      start = lo * tm;
      const long cut = static_cast<long>(hi) * tm;
      end = nr < M ? nr : M;
      end = cut < end ? static_cast<int>(cut) : end;
    }
  }

  if (start < end) {
    const int qrow = row < tq ? row : tq - 1;  // a spare warp recomputes
    const float* qp = q + (static_cast<long>(b) * Q + blk * tq + qrow) * 3;
    const float qx = qp[0], qy = qp[1], qz = qp[2];
    const float* src = ref + (static_cast<long>(b) * M + start) * 3;
    const bool wide = aligned16(src);
    const int total = end - start;
    const int n_slices = (total + kSlice - 1) / kSlice;

    auto stage = [&](int s) {
      const int n = min(kSlice, total - s * kSlice);
      cp_async_floats(tile[s & 1], src + static_cast<long>(s) * kSlice * 3,
                      3 * n, wide, threadIdx.x, kWarps * 32);
    };
    stage(0);
    cp_async_commit();
    for (int s = 0; s < n_slices; ++s) {
      if (s + 1 < n_slices) stage(s + 1);
      cp_async_commit();   // possibly empty: one group a slice
      cp_async_wait<1>();  // all but the newest group: slice s is here
      __syncthreads();
      const float* t = tile[s & 1];
      const int n = min(kSlice, total - s * kSlice);
      const int base = start + s * kSlice;
#pragma unroll 4
      for (int j = lane; j < n; j += 32) {
        const float d = sq_dist(qx, qy, qz, t[3 * j], t[3 * j + 1],
                                t[3 * j + 2]);
        if (d < bd[K - 1]) sorted_insert<K>(bd, bi, d, base + j);
      }
      __syncthreads();  // slice s + 2 lands in this buffer
    }
  }

  // merge the 32 lists: round s leaves the s-th smallest pair in lane s
  float out_d = kBig;
  int32_t out_i = 0;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    float m = bd[0];
    int mi = bi[0];
    warp_min_pair(m, mi);
    if (mi != kNoIndex) {
      if (bi[0] == mi) {  // the one lane that held it pops its head
#pragma unroll
        for (int u = 0; u + 1 < K; ++u) {
          bd[u] = bd[u + 1];
          bi[u] = bi[u + 1];
        }
        bd[K - 1] = CUDART_INF_F;
        bi[K - 1] = kNoIndex;
      }
      if (lane == s) {
        out_d = m;
        out_i = mi;
      }
    }
  }
  if (row < tq && lane < K) {
    const long o = (static_cast<long>(b) * Q + blk * tq + row) * K + lane;
    d2_out[o] = out_d;
    idx_out[o] = out_i;
  }
}

template <int K>
int launch(const float* q, const float* ref, const int32_t* n_q,
           const int32_t* n_ref, const int32_t* t_lo, const int32_t* t_hi,
           float* d2, int32_t* idx, int B, int Q, int M, int tq, int tm,
           cudaStream_t stream) {
  const int parts = (tq + kWarps - 1) / kWarps;
  knn_kernel<K><<<dim3((Q / tq) * parts, B), kWarps * 32, 0, stream>>>(
      q, ref, n_q, n_ref, t_lo, t_hi, d2, idx, Q, M, tq, tm, parts);
  return cudaGetLastError();
}

}  // namespace

// q (B, Q, 3), ref (B, M, 3) float32; n_q, n_ref (B,) int32 live counts;
// t_lo, t_hi (B, Q/tq) int32 tile windows; outputs d2 (B, Q, K) float32
// and idx (B, Q, K) int32, nearest first.  K is 1, 5 or 8; Q must be a
// multiple of tq (any tq; a multiple of 4 leaves no warp spare).
// Returns cudaGetLastError().
extern "C" int knn_topk_launch(const void* q, const void* ref,
                               const void* n_q, const void* n_ref,
                               const void* t_lo, const void* t_hi, void* d2,
                               void* idx, int B, int Q, int M, int K, int tq,
                               int tm, void* stream) {
  if (B <= 0 || Q <= 0) return 0;
  if (tq <= 0 || Q % tq || tm <= 0 || B > 65535) return cudaErrorInvalidValue;
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
    case 8:
      return launch<8>(qf, rf, nq, nr, lo, hi, d, i, B, Q, M, tq, tm, s);
    default:
      return cudaErrorInvalidValue;
  }
}
