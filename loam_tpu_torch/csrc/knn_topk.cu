// Exact brute-force k nearest neighbours over tile-windowed references,
// one warp per query.
//
// Replaces: loam_tpu/ops/pallas/knn_topk.py:_knn_kernel_dyn (map_knn,
// 5 by default: the pruned mapping k-NN with live query blocks and
// per-block reference-tile windows; max(map_exact_cache_k, map_knn), 8
// by default: the hybrid cadence's candidate gather; k=1 through
// knn_topk_dyn) and :_knn_kernel at k > 1, any k from 1 to kMaxK (1024).
// The odometry 1-NN over a whole live reference has a kernel of its own,
// knn_nearest.cu.
//
// What bounds it on the H100: fp32 CUDA-core instruction slots, not
// bytes.  A query/reference pair costs 3 subtractions, 3 multiplies, 2
// adds and a compare, and the selection costs whatever the warp spends
// keeping the best pairs.  At the mapping shapes (6000 live queries
// against windows of about 3500 of 50000 references) that is 2 * 10^7
// pairs and a few 10^7 warp instructions: tens of microseconds for the
// whole card, where the byte bound is under one.
//
// Design.  A warp owns a query; a block of kWarps warps takes kWarps
// consecutive rows of one query block of the contract (tq rows, one
// tile window), so 6000 live queries are 1500 blocks and 1500 queries
// 375: either fills the card's 132 SMs.  The block streams its window
// through shared memory in slices of kSlice points, the next slice's
// cp.async copies in flight while the current one is scanned (16 bytes
// a copy where the window starts 16-byte aligned).  Lane l takes points
// l, l + 32, ... of a slice (three words at a stride of three: no bank
// conflicts).  Distances are exact fp32 round(round(dx^2 + dy^2) +
// dz^2) (exact_dist.cuh): no FMA contraction, no tensor cores.  Rows
// past n_q inside a live query block are computed like any other; dead
// blocks, empty windows and missing neighbours write (index 0,
// d2 = 1e30).  Two ways keep the best pairs, chosen by k:
//
// k <= 8: each lane keeps its own K = k best (d2, index) pairs sorted in
// registers (RegList), strict < on insert, so the earlier index stays
// first among equal distances.  After the window the 32 lists merge: k
// rounds of a (distance, index) minimum over the list heads, the
// winning lane popping its head.  Each list is in (distance, index)
// order and the lanes hold disjoint indices, so the k winners are the k
// smallest pairs of the window in order: the plain version's k
// first-occurrence argmins, bit for bit, in any block order.
//
// k > 8: one queue for the whole warp (WarpQueue<W, T>; the WarpSelect
// of Johnson, Douze and Jegou, "Billion-scale similarity search with
// GPUs", 2017, sections 4-5).  Per-lane lists would each take their
// first K points and then anything below their own K-th pair, and an
// insert costs the whole warp about 6 K instructions whenever any lane
// inserts; the queue's cost does not grow with k per lane.
//  - The warp queue holds the W smallest pairs seen so far, W the
//    smallest power of two >= k from 32 to 1024, sorted across the warp
//    in registers: pair r * 32 + l in register r of lane l, as one
//    64-bit key (distance bits above the index, which orders like the
//    (distance, index) pair: the distances are never negative).  The k
//    smallest pairs are a prefix of the W smallest, so only the first k
//    are stored, and the output is the plain version's bit for bit.
//  - Each lane has a thread queue of T slots in registers.  A candidate
//    enters it only if its distance is below kth, the distance of the
//    warp queue's pair k - 1 (+inf until k pairs are held), broadcast by
//    one shuffle after each merge.  A strict < on the distance alone is
//    exact: lane l takes index base + l + 32 t of slices scanned in
//    order, so every later candidate has a larger index than every pair
//    already merged, an equal distance that arrives later loses the
//    (distance, index) tie, and the sort and the merge compare whole
//    keys, never the distance alone.  A stale kth only admits more.
//  - When __any_sync finds a full thread queue, the warp bitonic-sorts
//    the 32 T thread-queue keys across the lanes, keeps the W smallest
//    of both queues (pair e against thread pair W - 1 - e, the lower
//    half of a bitonic merge: one shuffle a register), sorts that
//    bitonic sequence by a bitonic merge, empties the thread queues and
//    refreshes kth.  The scan runs a uniform trip count (lanes past a
//    slice's end offer +inf), so every lane is converged at the vote and
//    the shuffles, and the vote follows every candidate, so no queue
//    overflows.  After the window one last merge takes what the thread
//    queues hold, and the first k pairs leave in stores of 32 columns,
//    coalesced.
// Shared memory holds the two staged slices only (24 KB a block), so
// four warps a block at every k; kMaxK is the widest queue, 32 pairs a
// lane.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "exact_dist.cuh"
#include "warp_util.cuh"

namespace {

constexpr int kWarps = 4;     // warps (queries) a block
constexpr int kSlice = 1024;  // reference points a staged slice; % 32 == 0
constexpr int kMaxK = 1024;   // the widest warp queue: 32 pairs a lane

// A lane's K best (d2, index) pairs, sorted, in registers.
template <int K>
struct RegList {
  float d[K];
  int32_t i[K];
  __device__ __forceinline__ RegList() {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      d[s] = CUDART_INF_F;
      i[s] = kNoIndex;
    }
  }
  __device__ __forceinline__ float worst() const { return d[K - 1]; }
  __device__ __forceinline__ void insert(float x, int j) {
    sorted_insert<K>(d, i, x, j);
  }
  __device__ __forceinline__ float head_d() const { return d[0]; }
  __device__ __forceinline__ int head_i() const { return i[0]; }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int u = 0; u + 1 < K; ++u) {
      d[u] = d[u + 1];
      i[u] = i[u + 1];
    }
    d[K - 1] = CUDART_INF_F;
    i[K - 1] = kNoIndex;
  }
};

// k <= 8: a RegList a lane, merged by k rounds of a warp minimum.
template <int K>
struct LaneLists {
  RegList<K> list;
  int k, lane;
  __device__ __forceinline__ LaneLists(int k_, int lane_)
      : k(k_), lane(lane_) {}

  // the slice t[3 n] of references base, base + 1, ...
  __device__ __forceinline__ void scan(const float* t, int n, int base,
                                       float qx, float qy, float qz) {
#pragma unroll 4
    for (int j = lane; j < n; j += 32) {
      const float d = sq_dist(qx, qy, qz, t[3 * j], t[3 * j + 1],
                              t[3 * j + 2]);
      if (d < list.worst()) list.insert(d, base + j);
    }
  }

  // round s leaves the s-th smallest pair in lane s % 32, stored when a
  // lane would be reused or the rounds end
  __device__ __forceinline__ void store(float* d2, int32_t* idx,
                                        bool live) {
    float out_d = kBig;
    int32_t out_i = 0;
    for (int s = 0; s < k; ++s) {
      float m = list.head_d();
      int mi = list.head_i();
      warp_min_pair(m, mi);
      if (mi != kNoIndex) {
        if (list.head_i() == mi) list.pop();  // the one lane that held it
        if (lane == (s & 31)) {
          out_d = m;
          out_i = mi;
        }
      }
      if ((s & 31) == 31 || s + 1 == k) {
        const int slot = (s & ~31) + lane;
        if (live && slot <= s) {
          d2[slot] = out_d;
          idx[slot] = out_i;
        }
        out_d = kBig;
        out_i = 0;
      }
    }
  }
};

// One compare-exchange step of a bitonic network over the warp-wide
// array a (element e = r * 32 + lane in register r): e meets e ^ J, and
// the lower of the two keeps the smaller key in a run of Size that
// ascends ((e & Size) == 0), the larger in one that descends.
template <int N, int Size, int J>
__device__ __forceinline__ void bitonic_step(Key (&a)[N], int lane) {
  if constexpr (J >= 32) {
    constexpr int rj = J / 32;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if ((r & rj) == 0) {
        const bool up = ((r * 32) & Size) == 0;
        const Key x = a[r], y = a[r | rj];
        const bool swap = up ? (y < x) : (x < y);
        a[r] = swap ? y : x;
        a[r | rj] = swap ? x : y;
      }
    }
  } else {
    const bool low = (lane & J) == 0;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const Key o = __shfl_xor_sync(kFullMask, a[r], J);
      const bool up = (((r * 32) | lane) & Size) == 0;
      const bool take_smaller = low == up;
      a[r] = (take_smaller == (o < a[r])) ? o : a[r];
    }
  }
}

// the steps J = Jmax, Jmax / 2, ..., 1 of the stage that merges runs of
// Size: with Size = 32 N and Jmax = Size / 2, a bitonic sequence sorted
// ascending
template <int N, int Size, int J>
__device__ __forceinline__ void bitonic_merge(Key (&a)[N], int lane) {
  bitonic_step<N, Size, J>(a, lane);
  if constexpr (J > 1) bitonic_merge<N, Size, J / 2>(a, lane);
}

// the warp-wide array a sorted ascending
template <int N, int Size = 2>
__device__ __forceinline__ void bitonic_sort(Key (&a)[N], int lane) {
  bitonic_merge<N, Size, Size / 2>(a, lane);
  if constexpr (Size < 32 * N) bitonic_sort<N, Size * 2>(a, lane);
}

// k > 8: the warp queue and the thread queues (the header's design).
template <int W, int T>
struct WarpQueue {
  static constexpr int R = W / 32;  // warp-queue registers a lane
  Key q[R];   // the W smallest pairs so far, ascending: r * 32 + lane
  Key t[T];   // this lane's candidates since the last merge, newest
              // first: [0, n)
  int n;
  float kth;  // distance of q's pair k - 1: +inf until k pairs are held
  int k, lane;

  __device__ __forceinline__ WarpQueue(int k_, int lane_)
      : n(0), kth(kInf), k(k_), lane(lane_) {
#pragma unroll
    for (int r = 0; r < R; ++r) q[r] = kEmptyKey;
#pragma unroll
    for (int s = 0; s < T; ++s) t[s] = kEmptyKey;
  }

  __device__ __forceinline__ void merge() {
    bitonic_sort<T>(t, lane);
    // the W smallest of both: pair e of q against thread pair W - 1 - e
    // (register R - 1 - r of lane 31 - lane) where that exists; q is
    // then bitonic
    constexpr int kPairs = T < R ? T : R;
#pragma unroll
    for (int s = 0; s < kPairs; ++s) {
      const Key o = __shfl_xor_sync(kFullMask, t[s], 31);
      q[R - 1 - s] = o < q[R - 1 - s] ? o : q[R - 1 - s];
    }
    bitonic_merge<R, W, W / 2>(q, lane);
    n = 0;
#pragma unroll
    for (int s = 0; s < T; ++s) t[s] = kEmptyKey;
    // pair k - 1 is in register (k - 1) / 32 of lane (k - 1) % 32: every
    // register is shuffled and the right one kept, since a register
    // picked by a run-time index before the shuffle becomes an indexed
    // load, and q an array in local memory
    const int p = k - 1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float x = __shfl_sync(kFullMask, key_dist(q[r]), p & 31);
      if (r == (p >> 5)) kth = x;
    }
  }

  __device__ __forceinline__ void scan(const float* tile, int n_pts,
                                       int base, float qx, float qy,
                                       float qz) {
#pragma unroll 2
    for (int j0 = 0; j0 < n_pts; j0 += 32) {
      const int j = j0 + lane;  // < kSlice: in the buffer, maybe stale
      float d = sq_dist(qx, qy, qz, tile[3 * j], tile[3 * j + 1],
                        tile[3 * j + 2]);
      d = j < n_pts ? d : kInf;
      if (d < kth) {  // shift in: no register indexed by n
#pragma unroll
        for (int s = T - 1; s > 0; --s) t[s] = t[s - 1];
        t[0] = pair_key(d, base + j);
        ++n;
      }
      if (__any_sync(kFullMask, n == T)) merge();
    }
  }

  __device__ __forceinline__ void store(float* d2, int32_t* idx,
                                        bool live) {
    if (__any_sync(kFullMask, n > 0)) merge();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = r * 32 + lane;
      if (live && c < k) {
        const float d = key_dist(q[r]);
        const bool found = d < kInf;
        d2[c] = found ? d : kBig;
        idx[c] = found ? key_index(q[r]) : 0;
      }
    }
  }
};

template <class Sel>
__global__ void __launch_bounds__(kWarps * 32)
    knn_kernel(const float* __restrict__ q, const float* __restrict__ ref,
               const int32_t* __restrict__ n_q,
               const int32_t* __restrict__ n_ref,
               const int32_t* __restrict__ t_lo,
               const int32_t* __restrict__ t_hi, float* __restrict__ d2_out,
               int32_t* __restrict__ idx_out, int Q, int M, int tq, int tm,
               int parts, int k) {
  // two staged slices (xyz interleaved)
  __shared__ __align__(16) float tile[2][3 * kSlice];
  const int b = blockIdx.y;
  const int blk = blockIdx.x / parts;  // query block of the contract
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nqb = Q / tq;
  // this warp's row of the query block; past tq only in the last part
  const int row = (blockIdx.x % parts) * warps + warp;

  Sel sel(k, lane);

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
                      3 * n, wide, threadIdx.x, blockDim.x);
    };
    stage(0);
    cp_async_commit();
    for (int s = 0; s < n_slices; ++s) {
      if (s + 1 < n_slices) stage(s + 1);
      cp_async_commit();   // possibly empty: one group a slice
      cp_async_wait<1>();  // all but the newest group: slice s is here
      __syncthreads();
      sel.scan(tile[s & 1], min(kSlice, total - s * kSlice),
               start + s * kSlice, qx, qy, qz);
      __syncthreads();  // slice s + 2 lands in this buffer
    }
  }

  const long o = (static_cast<long>(b) * Q + blk * tq + row) * k;
  sel.store(d2_out + o, idx_out + o, row < tq);
}

template <class Sel>
int launch(const float* q, const float* ref, const int32_t* n_q,
           const int32_t* n_ref, const int32_t* t_lo, const int32_t* t_hi,
           float* d2, int32_t* idx, int B, int Q, int M, int k, int tq,
           int tm, cudaStream_t stream) {
  const int parts = (tq + kWarps - 1) / kWarps;
  knn_kernel<Sel><<<dim3((Q / tq) * parts, B), kWarps * 32, 0, stream>>>(
      q, ref, n_q, n_ref, t_lo, t_hi, d2, idx, Q, M, tq, tm, parts, k);
  return cudaGetLastError();
}

}  // namespace

// q (B, Q, 3), ref (B, M, 3) float32; n_q, n_ref (B,) int32 live counts;
// t_lo, t_hi (B, Q/tq) int32 tile windows; outputs d2 (B, Q, k) float32
// and idx (B, Q, k) int32, nearest first.  1 <= k <= knn_topk_max_k();
// Q must be a multiple of tq (any tq; a multiple of 4 leaves no warp
// spare).  *instance receives what was launched: K of the per-lane lists
// (k itself, 1 to 8), W of the warp queue (32 to 1024), 0 when nothing
// launched.  Returns cudaGetLastError().
extern "C" int knn_topk_launch(const void* q, const void* ref,
                               const void* n_q, const void* n_ref,
                               const void* t_lo, const void* t_hi, void* d2,
                               void* idx, int B, int Q, int M, int k, int tq,
                               int tm, int* instance, void* stream) {
  *instance = 0;
  if (B <= 0 || Q <= 0) return 0;
  if (tq <= 0 || Q % tq || tm <= 0 || B > 65535 || k < 1 || k > kMaxK)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* rf = static_cast<const float*>(ref);
  const auto* nq = static_cast<const int32_t*>(n_q);
  const auto* nr = static_cast<const int32_t*>(n_ref);
  const auto* lo = static_cast<const int32_t*>(t_lo);
  const auto* hi = static_cast<const int32_t*>(t_hi);
  auto* d = static_cast<float*>(d2);
  auto* i = static_cast<int32_t*>(idx);
#define KNN_REG(K)                                                         \
  (*instance = K, launch<LaneLists<K>>(qf, rf, nq, nr, lo, hi, d, i, B, Q, \
                                       M, k, tq, tm, s))
  switch (k) {
    case 1: return KNN_REG(1);
    case 2: return KNN_REG(2);
    case 3: return KNN_REG(3);
    case 4: return KNN_REG(4);
    case 5: return KNN_REG(5);
    case 6: return KNN_REG(6);
    case 7: return KNN_REG(7);
    case 8: return KNN_REG(8);
    default: break;
  }
#undef KNN_REG
  // the warp queue of W pairs, the smallest power of two >= k from 32,
  // and T slots a lane, T as measured on the card on the dense gather's
  // sorted slabs and on the lattice (profile_torch_knn.py --queue;
  // PERF.md section 6)
#define KNN_QUEUE(W, T)                                                  \
  (*instance = W, launch<WarpQueue<W, T>>(qf, rf, nq, nr, lo, hi, d, i, \
                                          B, Q, M, k, tq, tm, s))
  if (k <= 32) return KNN_QUEUE(32, 4);
  if (k <= 64) return KNN_QUEUE(64, 4);
  if (k <= 128) return KNN_QUEUE(128, 4);
  if (k <= 256) return KNN_QUEUE(256, 8);
  if (k <= 512) return KNN_QUEUE(512, 8);
  return KNN_QUEUE(1024, 8);
#undef KNN_QUEUE
}

// the largest k knn_topk_launch takes
extern "C" int knn_topk_max_k() { return kMaxK; }
