// Exact brute-force k nearest neighbours over tile-windowed references,
// one warp per query.
//
// Replaces: loam_tpu/ops/pallas/knn_topk.py:_knn_kernel_dyn (map_knn,
// 5 by default: the pruned mapping k-NN with live query blocks and
// per-block reference-tile windows; max(map_exact_cache_k, map_knn), 8
// by default: the hybrid cadence's candidate gather; k=1 through
// knn_topk_dyn) and :_knn_kernel at k > 1, any k from 1 to kMaxK (812).
// The odometry 1-NN over a whole live reference has a kernel of its own,
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
// the warp: k rounds of a (distance, index) minimum over the list heads,
// the winning lane popping its head.  Each list is in (distance, index)
// order and the lanes hold disjoint indices, so the k winners are the k
// smallest pairs of the window in order: the plain version's k
// first-occurrence argmins, bit for bit, in any block order.  No scratch
// in device memory, no second launch, no atomics.  Distances are exact
// fp32 round(round(dx^2 + dy^2) + dz^2) (exact_dist.cuh): no FMA
// contraction, no tensor cores.  Rows past n_q inside a live query block
// are computed like any other; dead blocks, empty windows and missing
// neighbours write (index 0, d2 = 1e30).
//
// Any k.  The lists are a template: K = 1 to 8, 12, 16, 24 and 32 in
// registers (RegList), launched at the smallest K >= k, which writes
// only the first k columns: the k smallest (distance, index) pairs are a
// prefix of the K smallest, so the output is the plain version's bit for
// bit.  Past 32 each lane's list of k lives in dynamic shared memory
// (SmemList, entry u of lane l at u * 32 + l: no bank conflicts), the
// window's staging buffers before the lists, and a block has as many
// warps (4 at most) as 227 KB hold; at one warp that is k <= 812.  The
// merge keeps round s's pick in lane s % 32 and stores 32 picks at a
// time, coalesced.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "exact_dist.cuh"
#include "warp_util.cuh"

namespace {

constexpr int kWarps = 4;     // warps (queries) a block, at most
constexpr int kSlice = 1024;  // reference points a staged slice; % 4 == 0
constexpr int kTileBytes = 2 * 3 * kSlice * sizeof(float);
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may ask
constexpr int kPairBytes = 32 * 8;  // a warp's (d2, index) list entry
constexpr int kMaxK = (kSmemMax - kTileBytes) / kPairBytes;  // 812
// +inf for code that the host compiler sees too (CUDART_INF_F is a
// device intrinsic)
constexpr float kInf = __builtin_huge_valf();

// A lane's K best (d2, index) pairs, sorted, in registers.
template <int K>
struct RegList {
  float d[K];
  int32_t i[K];
  __device__ __forceinline__ RegList(unsigned char*, int, int) {
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

// A lane's k best pairs, sorted, in the warp's slice of shared memory
// (32 k distances, then 32 k indices; entry u of lane l at u * 32 + l);
// only the lane itself touches its column.  The merge walks a head instead of
// shifting the list.
struct SmemList {
  float* d;
  int32_t* i;
  int k, lane, head;
  float last;  // d[(k - 1) * 32 + lane], kept in a register
  __device__ __forceinline__ SmemList(unsigned char* warp_smem, int k_,
                                      int lane_)
      : d(reinterpret_cast<float*>(warp_smem)),
        i(reinterpret_cast<int32_t*>(warp_smem) + 32 * k_),
        k(k_), lane(lane_), head(0), last(kInf) {
    for (int u = 0; u < k; ++u) {
      d[u * 32 + lane] = kInf;
      i[u * 32 + lane] = kNoIndex;
    }
  }
  __device__ __forceinline__ float worst() const { return last; }
  // given x < worst(): the last pair drops out, an equal distance lands
  // after the pairs already there (strict <), as sorted_insert does
  __device__ __forceinline__ void insert(float x, int j) {
    int u = k - 1;
    while (u > 0 && x < d[(u - 1) * 32 + lane]) {
      d[u * 32 + lane] = d[(u - 1) * 32 + lane];
      i[u * 32 + lane] = i[(u - 1) * 32 + lane];
      --u;
    }
    d[u * 32 + lane] = x;
    i[u * 32 + lane] = j;
    last = d[(k - 1) * 32 + lane];
  }
  __device__ __forceinline__ float head_d() const {
    return head < k ? d[head * 32 + lane] : kInf;
  }
  __device__ __forceinline__ int head_i() const {
    return head < k ? i[head * 32 + lane] : kNoIndex;
  }
  __device__ __forceinline__ void pop() { ++head; }
};

template <class List>
__global__ void __launch_bounds__(kWarps * 32)
    knn_kernel(const float* __restrict__ q, const float* __restrict__ ref,
               const int32_t* __restrict__ n_q,
               const int32_t* __restrict__ n_ref,
               const int32_t* __restrict__ t_lo,
               const int32_t* __restrict__ t_hi, float* __restrict__ d2_out,
               int32_t* __restrict__ idx_out, int Q, int M, int tq, int tm,
               int parts, int k) {
  // two staged slices (xyz interleaved), then each warp's list if any
  extern __shared__ __align__(16) unsigned char smem[];
  float(*tile)[3 * kSlice] = reinterpret_cast<float(*)[3 * kSlice]>(smem);
  const int b = blockIdx.y;
  const int blk = blockIdx.x / parts;  // query block of the contract
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nqb = Q / tq;
  // this warp's row of the query block; past tq only in the last part
  const int row = (blockIdx.x % parts) * warps + warp;

  List list(smem + kTileBytes + warp * k * kPairBytes, k, lane);

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
      const float* t = tile[s & 1];
      const int n = min(kSlice, total - s * kSlice);
      const int base = start + s * kSlice;
#pragma unroll 4
      for (int j = lane; j < n; j += 32) {
        const float d = sq_dist(qx, qy, qz, t[3 * j], t[3 * j + 1],
                                t[3 * j + 2]);
        if (d < list.worst()) list.insert(d, base + j);
      }
      __syncthreads();  // slice s + 2 lands in this buffer
    }
  }

  // merge the 32 lists: round s leaves the s-th smallest pair in lane
  // s % 32, stored when a lane would be reused or the rounds end
  const long o = (static_cast<long>(b) * Q + blk * tq + row) * k;
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
      if (row < tq && slot <= s) {
        d2_out[o + slot] = out_d;
        idx_out[o + slot] = out_i;
      }
      out_d = kBig;
      out_i = 0;
    }
  }
}

// warps a block of the shared-memory lists: 4 if 227 KB hold them
int smem_warps(int k) {
  const int w = (kSmemMax - kTileBytes) / (k * kPairBytes);
  return w < kWarps ? w : kWarps;
}

template <class List>
int launch(const float* q, const float* ref, const int32_t* n_q,
           const int32_t* n_ref, const int32_t* t_lo, const int32_t* t_hi,
           float* d2, int32_t* idx, int B, int Q, int M, int k, int tq,
           int tm, int warps, int list_bytes, cudaStream_t stream) {
  const int parts = (tq + warps - 1) / warps;
  const int smem = kTileBytes + warps * list_bytes;
  if (smem > 48 * 1024) {  // above 48 KB it has to be asked for
    // the card's limit, the same for every k: launches from several host
    // threads never race on it
    const cudaError_t e = cudaFuncSetAttribute(
        knn_kernel<List>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax);
    if (e != cudaSuccess) return e;
  }
  knn_kernel<List><<<dim3((Q / tq) * parts, B), warps * 32, smem, stream>>>(
      q, ref, n_q, n_ref, t_lo, t_hi, d2, idx, Q, M, tq, tm, parts, k);
  return cudaGetLastError();
}

}  // namespace

// q (B, Q, 3), ref (B, M, 3) float32; n_q, n_ref (B,) int32 live counts;
// t_lo, t_hi (B, Q/tq) int32 tile windows; outputs d2 (B, Q, k) float32
// and idx (B, Q, k) int32, nearest first.  1 <= k <= knn_topk_max_k();
// Q must be a multiple of tq (any tq; a multiple of 4 leaves no warp
// spare).  *instance receives the list launched: K of the register list
// RegList<K>, k for the shared-memory lists, 0 when nothing launched.
// Returns cudaGetLastError().
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
#define KNN_REG(K)                                                        \
  (*instance = K, launch<RegList<K>>(qf, rf, nq, nr, lo, hi, d, i, B, Q, \
                                     M, k, tq, tm, kWarps, 0, s))
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
  if (k <= 12) return KNN_REG(12);
  if (k <= 16) return KNN_REG(16);
  if (k <= 24) return KNN_REG(24);
  if (k <= 32) return KNN_REG(32);
#undef KNN_REG
  *instance = k;
  return launch<SmemList>(qf, rf, nq, nr, lo, hi, d, i, B, Q, M, k, tq, tm,
                          smem_warps(k), k * kPairBytes, s);
}

// the largest k knn_topk_launch takes
extern "C" int knn_topk_max_k() { return kMaxK; }
