// The k nearest of each query's own candidate points: a group of eight
// lanes a query up to 64 candidates, a warp a query above.
//
// Replaces: loam_tpu/ops/pallas/kselect.py:_kselect_kernel (wrapper
// knn_select), the fused distance + k-smallest selection behind
// map_store.knn_candidates (the 27-cell gather, C = 27 *
// search_bucket_cap, k = knn_candidates: 864 and 24 by default, 1296
// and 40 in the dense cell) and map_store.knn_from_candidates (the
// per-iteration re-rank of a cached candidate set, C = knn_candidates
// or the hybrid cache, k = map_knn).
//
// What bounds it on the H100: bytes.  Every candidate is read once
// (12 bytes of coordinates and one validity byte) against about 9 fp32
// operations, far below the card's operations-per-byte balance, and
// the outputs are k/C of the input.  At the re-rank shapes the bound is
// below a launch's latency.  At the gather shapes one warp a query puts
// only 15.5 warps on an SM (Q = 2048), however little shared memory a
// warp takes, so a selection that is a chain of k dependent rounds (two
// warp reductions each) cannot hide behind other warps: the time has to
// come off each warp's chain.
//
// Design.  The Pallas kernel pads C to 128 lanes, splits x, y and z
// into planes and gathers each pick by a one-hot sum, because the TPU
// has no dynamic column store; none of that is needed here.
//   * C <= 64 (kselect_group_kernel): eight lanes own a query, four
//     queries a warp, each lane holding R = ceil(C / 8) candidates (index
//     lane + 8 r) with their coordinates in registers.  A round is the
//     lane's own minimum over its R registers, a (distance, index)
//     minimum over the group by three xor shuffles (offsets 4, 2, 1 stay
//     inside the group), and the owning lane writing the pick and
//     retiring it.  Nothing goes through shared memory.
//   * C > 64 (kselect_warp_kernel): a warp owns a query.  It turns its
//     row into C distances in its slice of shared memory (4 bytes a
//     candidate: 16-byte loads of four candidates a lane where the row is
//     aligned), each lane keeping the L smallest (distance, index) keys
//     of those it computed (L = 2 for k <= 48, else 8).  The warp sorts
//     its 32 L keys at once (a bitonic network in lane-major order: each
//     lane's keys are already a sorted run, so 15 of its steps shuffle
//     and the rest stay in a lane).  Keys no lane holds lie above the
//     least of the full lanes' last keys: the held keys up to it are the
//     smallest, in order.  Else tau, the k-th held key, bounds the k-th
//     smallest from above, and one pass of ballots compacts every key
//     <= tau (about 50 at k = 40 of 1296) into a 128-key buffer, which
//     is sorted and gives the picks.  What neither covers (k > 32 L, a
//     full buffer) repeats with the picks so far retired: every round
//     picks at least L.  Each row is read once; a block of 4 warps takes
//     4 (4 C + 1 KB), three warps a block at C = 17880.
// Either way the picks are k distinct indices in ascending (distance,
// index) order, invalid candidates (1e30) after every valid one: the
// rule of a stable top-k, which the plain PyTorch version follows to the
// bit; once only +inf distances are left (they overflowed), each further
// pick is candidate 0 at +inf, as the plain version's argmins give it.
// Distances are (c - q)^2 in the order round(round(dx^2 + dy^2) +
// dz^2) (exact_dist.cuh), no FMA contraction, no tensor cores.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "exact_dist.cuh"
#include "warp_util.cuh"

namespace {

constexpr int kSmemMax = 232448;  // dynamic shared memory a block may ask
// the most candidates a row: search_bucket_cap 662, the limit of the
// whole-row staging this kernel replaced, kept (4 C + 1 KB of shared
// memory a warp would take C up to 57856)
constexpr int kMaxC = 17880;
constexpr int kGroup = 8;         // lanes a query in kselect_group_kernel
constexpr int kGroupMaxC = 8 * kGroup;  // at most 8 candidates a lane
constexpr int kGroupThreads = 256;
constexpr int kWarps = 4;    // warps (queries) a block in the warp kernel
constexpr int kBatch = 4;    // loads a lane has in flight, in candidates
constexpr int kBuf = 128;    // keys a warp compacts below its threshold

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
    // a lane left with +inf alone offers (+inf, its candidate): with
    // only +inf left (distances that overflowed), lane 0's candidate 0
    // wins, as the plain version's argmin takes it
    const int own = sub + kGroup * mr;
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

// The row's C distances into dist (dist[j] for candidate j), by the
// warp, and each lane's L smallest (distance, index) pairs of those it
// computed, ascending, into (bd, bi).  Where C % 4 == 0, the row is
// 16-byte aligned and its validity bytes 4-byte aligned, lane l takes
// candidates 4 g .. 4 g + 3 for g = l, l + 32, ... (three 16-byte loads,
// one 4-byte load and one 16-byte store each; 2 kBatch candidates' loads
// in flight a lane), elsewhere candidates l, l + 32, ... (kBatch).
template <int L>
__device__ __forceinline__ void row_distances(const float* cq,
                                              const uint8_t* vq, int C,
                                              float qx, float qy, float qz,
                                              float* dist, int lane,
                                              float (&bd)[L], int (&bi)[L]) {
  // into the lane's list as they come: ascending j and a strict < keep
  // the first of equal distances first
  auto keep = [&](float x, int j) {
    if (x < bd[L - 1]) sorted_insert<L>(bd, bi, x, j);
  };
  const bool vec = C % 4 == 0 && aligned16(cq) &&
                   (reinterpret_cast<uintptr_t>(vq) & 3) == 0;
  if (vec) {
    const auto* c4 = reinterpret_cast<const float4*>(cq);
    const auto* v4 = reinterpret_cast<const unsigned*>(vq);
    auto* d4 = reinterpret_cast<float4*>(dist);
    const int n4 = C / 4;
    constexpr int kB = kBatch / 2;  // groups of 4 in flight
    for (int g0 = lane; g0 < n4; g0 += 32 * kB) {
      float4 a[kB], b[kB], c[kB];
      unsigned v[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int g = g0 + 32 * u;
        if (g < n4) {
          a[u] = c4[3 * g];
          b[u] = c4[3 * g + 1];
          c[u] = c4[3 * g + 2];
          v[u] = v4[g];
        }
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int g = g0 + 32 * u;
        if (g < n4) {
          float4 d;
          d.x = (v[u] & 0xffu) ? sq_dist(a[u].x, a[u].y, a[u].z, qx, qy, qz)
                               : kBig;
          d.y = (v[u] & 0xff00u)
                    ? sq_dist(a[u].w, b[u].x, b[u].y, qx, qy, qz)
                    : kBig;
          d.z = (v[u] & 0xff0000u)
                    ? sq_dist(b[u].z, b[u].w, c[u].x, qx, qy, qz)
                    : kBig;
          d.w = (v[u] & 0xff000000u)
                    ? sq_dist(c[u].y, c[u].z, c[u].w, qx, qy, qz)
                    : kBig;
          d4[g] = d;
          keep(d.x, 4 * g);
          keep(d.y, 4 * g + 1);
          keep(d.z, 4 * g + 2);
          keep(d.w, 4 * g + 3);
        }
      }
    }
  } else {
    for (int j0 = lane; j0 < C; j0 += 32 * kBatch) {
      float d[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + 32 * u;
        if (j < C) {
          d[u] = vq[j] ? sq_dist(cq[3 * j], cq[3 * j + 1], cq[3 * j + 2],
                                 qx, qy, qz)
                       : kBig;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + 32 * u;
        if (j < C) {
          dist[j] = d[u];
          keep(d[u], j);
        }
      }
    }
  }
  __syncwarp();  // every lane's distances are visible to the warp
}

// One compare-exchange step of a bitonic network over the warp's 32 L
// keys in lane-major order (key e = lane * L + r in register r): e meets
// e ^ J, and the lower of the two keeps the smaller key in a run of Size
// that ascends ((e & Size) == 0), the larger in one that descends.  Size
// >= 2 L, so a run's direction is the lane's; J < L pairs two registers
// of a lane, J >= L the same register of lane ^ (J / L).
template <int L, int Size, int J>
__device__ __forceinline__ void lane_step(Key (&a)[L], int lane) {
  const bool up = ((lane * L) & Size) == 0;
  if constexpr (J >= L) {
    const bool low = (lane & (J / L)) == 0;
#pragma unroll
    for (int r = 0; r < L; ++r) {
      const Key o = __shfl_xor_sync(kFullMask, a[r], J / L);
      a[r] = ((low == up) == (o < a[r])) ? o : a[r];
    }
  } else {
#pragma unroll
    for (int r = 0; r < L; ++r) {
      if ((r & J) == 0) {
        const Key x = a[r], y = a[r | J];
        const bool swap = up ? (y < x) : (x < y);
        a[r] = swap ? y : x;
        a[r | J] = swap ? x : y;
      }
    }
  }
}

// A lane's L keys ascending (odd-even transposition: L passes).
template <int L>
__device__ __forceinline__ void sort_registers(Key (&a)[L]) {
#pragma unroll
  for (int p = 0; p < L; ++p) {
#pragma unroll
    for (int r = p & 1; r + 1 < L; r += 2) {
      const Key x = a[r], y = a[r + 1];
      a[r] = y < x ? y : x;
      a[r + 1] = y < x ? x : y;
    }
  }
}

template <int L, int Size, int J>
__device__ __forceinline__ void lane_merge(Key (&a)[L], int lane) {
  lane_step<L, Size, J>(a, lane);
  if constexpr (J > 1) lane_merge<L, Size, J / 2>(a, lane);
}

// The warp's 32 L keys sorted ascending in lane-major order, given each
// lane's L keys ascending: odd lanes reverse theirs, so that the runs of
// L alternate as a bitonic sort leaves them, and the stages from runs of
// 2 L on follow.  Their steps that cross lanes (1 + 2 + 3 + 4 + 5)
// shuffle every register; the others pair registers of a lane.
template <int L, int Size = 2 * L>
__device__ __forceinline__ void lane_sort(Key (&a)[L], int lane) {
  if constexpr (Size == 2 * L) {
    const bool odd = lane & 1;
#pragma unroll
    for (int r = 0; r < L / 2; ++r) {
      const Key x = a[r], y = a[L - 1 - r];
      a[r] = odd ? y : x;
      a[L - 1 - r] = odd ? x : y;
    }
  }
  lane_merge<L, Size, Size / 2>(a, lane);
  if constexpr (Size < 32 * L) lane_sort<L, Size * 2>(a, lane);
}

// Picks s .. s + n - 1 of the query (output row o): the first n of the
// warp's sorted keys a (lane-major, L a lane), the coordinates read back
// from the row by index; with `retire`, each pick's distance becomes
// +inf, out of the later rounds.
template <int L>
__device__ __forceinline__ void emit(const Key (&a)[L], int n, int s,
                                     bool retire, int lane, const float* cq,
                                     long o, float* dist, float* pts_out,
                                     float* d2_out) {
#pragma unroll
  for (int r = 0; r < L; ++r) {
    const int e = lane * L + r;
    if (e < n) {
      const int i = key_index(a[r]);
      d2_out[o + s + e] = key_dist(a[r]);
      pts_out[3 * (o + s + e)] = cq[3 * i];
      pts_out[3 * (o + s + e) + 1] = cq[3 * i + 1];
      pts_out[3 * (o + s + e) + 2] = cq[3 * i + 2];
      if (retire) dist[i] = CUDART_INF_F;
    }
  }
}

// The n keys of buf (in index order) sorted in registers, B a lane, and
// the first `need` of them written as picks s ..
template <int B>
__device__ __forceinline__ void sort_buffer(const Key* buf, int n, int need,
                                            int s, int lane, const float* cq,
                                            long o, float* dist,
                                            float* pts_out, float* d2_out) {
  Key b[B];
#pragma unroll
  for (int r = 0; r < B; ++r) {
    const int e = lane * B + r;
    b[r] = e < n ? buf[e] : kEmptyKey;
  }
  sort_registers<B>(b);
  lane_sort<B>(b, lane);
  emit<B>(b, need, s, false, lane, cq, o, dist, pts_out, d2_out);
}

// A warp a query: the row's distances in the warp's C floats of shared
// memory, then rounds over the remaining candidates.  A round sorts the
// lanes' L smallest remaining (distance, index) keys across the warp
// (each lane's own: those it computed in the first round, j % 32 ==
// lane after).
//  - The bound: every key no lane holds lies above each full lane's last
//    key, so above the least of those.  The held keys up to it are the
//    smallest remaining, in order; if they cover the picks still to
//    make (need), they are the picks.
//  - Else the threshold: tau, the need-th smallest held key (need <=
//    32 L), is at least the need-th smallest remaining key.  Every
//    remaining key <= tau goes to the warp's buffer in one pass (a
//    ballot a step); if they fit its kBuf, they are sorted and the first
//    `need` are the picks.
//  - Else the held keys up to the bound (at least L) are picked and
//    retired, and the next round starts.
template <int L>
__global__ void __launch_bounds__(kWarps * 32)
    kselect_warp_kernel(const float* __restrict__ cand,
                        const uint8_t* __restrict__ valid,
                        const float* __restrict__ q,
                        float* __restrict__ pts_out,
                        float* __restrict__ d2_out, int Q, int C, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * warps + warp;
  if (qi >= Q) return;  // a whole warp leaves; no block-wide barrier below
  Key* buf = reinterpret_cast<Key*>(smem) + warp * kBuf;
  float* dist = reinterpret_cast<float*>(smem + warps * kBuf * sizeof(Key)) +
                static_cast<long>(warp) * C;
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
  const float* cq = cand + static_cast<long>(qi) * C * 3;
  float bd[L];  // the lane's L smallest remaining pairs, ascending;
  int bi[L];    // unfilled slots are (+inf, kNoIndex): the empty key
#pragma unroll
  for (int u = 0; u < L; ++u) {
    bd[u] = CUDART_INF_F;
    bi[u] = kNoIndex;
  }
  row_distances<L>(cq, valid + static_cast<long>(qi) * C, C, qx, qy, qz,
                   dist, lane, bd, bi);

  const long o = static_cast<long>(qi) * k;
  for (int s = 0; s < k;) {  // s picks written
    if (s > 0) {  // the lists again, of what is left: j % 32 == lane
#pragma unroll
      for (int u = 0; u < L; ++u) {
        bd[u] = CUDART_INF_F;
        bi[u] = kNoIndex;
      }
#pragma unroll 4
      for (int j = lane; j < C; j += 32) {
        const float x = dist[j];
        if (x < bd[L - 1]) sorted_insert<L>(bd, bi, x, j);
      }
    }
    float bd_last = bd[L - 1];
    int bi_last = bi[L - 1];
    warp_min_pair(bd_last, bi_last);
    const Key bound = pair_key(bd_last, bi_last);
    Key a[L];
#pragma unroll
    for (int r = 0; r < L; ++r) a[r] = pair_key(bd[r], bi[r]);
    lane_sort<L>(a, lane);
    int held = 0;  // held keys up to the bound
#pragma unroll
    for (int r = 0; r < L; ++r) {
      held += __popc(
          __ballot_sync(kFullMask, a[r] <= bound && a[r] != kEmptyKey));
    }
    const int need = k - s;
    if (held < need && need <= 32 * L) {
      // tau: key need - 1 of the sorted keys, in lane (need - 1) / L
      const int p = need - 1;
      Key tau = kEmptyKey;
#pragma unroll
      for (int r = 0; r < L; ++r) {
        const Key x = __shfl_sync(kFullMask, a[r], p / L);
        if (r == p % L) tau = x;
      }
      if (tau != kEmptyKey) {
        int n = 0;  // remaining keys <= tau, the first kBuf in the buffer
#pragma unroll 4
        for (int j0 = 0; j0 < C; j0 += 32) {
          const int j = j0 + lane;
          const Key x = j < C ? pair_key(dist[j], j) : kEmptyKey;
          const bool take = x <= tau;
          const unsigned m = __ballot_sync(kFullMask, take);
          const int at = n + __popc(m & ((1u << lane) - 1));
          if (take && at < kBuf) buf[at] = x;
          n += __popc(m);
        }
        if (n <= kBuf) {  // need <= n: the query is done
          __syncwarp();
          if (n <= kBuf / 2) {
            sort_buffer<kBuf / 64>(buf, n, need, s, lane, cq, o, dist,
                                   pts_out, d2_out);
          } else {
            sort_buffer<kBuf / 32>(buf, n, need, s, lane, cq, o, dist,
                                   pts_out, d2_out);
          }
          break;
        }
      }
    }
    // at least L, or every remaining key
    const int n = held < need ? held : need;
    if (n == 0) {
      // no lane holds a key: every remaining distance is +inf (it
      // overflowed), and the plain version's argmin takes candidate 0
      // for each pick left
      for (int e = s + lane; e < k; e += 32) {
        d2_out[o + e] = CUDART_INF_F;
        pts_out[3 * (o + e)] = cq[0];
        pts_out[3 * (o + e) + 1] = cq[1];
        pts_out[3 * (o + e) + 2] = cq[2];
      }
      break;
    }
    emit<L>(a, n, s, s + n < k, lane, cq, o, dist, pts_out, d2_out);
    s += n;
    __syncwarp();
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

template <int L>
int launch_warp(const float* cand, const uint8_t* valid, const float* q,
                float* pts, float* d2, int Q, int C, int k,
                cudaStream_t stream) {
  // as many warps as the block's shared memory holds rows of distances
  // and key buffers
  const int per_warp = 4 * C + kBuf * static_cast<int>(sizeof(Key));
  const int fit = kSmemMax / per_warp;
  const int warps = fit < kWarps ? fit : kWarps;
  // above 48 KB a block's dynamic shared memory has to be asked for; the
  // limit asked is the card's, the same for every C, so launches from
  // several host threads never race on it
  cudaError_t e = cudaFuncSetAttribute(
      kselect_warp_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemMax);
  if (e != cudaSuccess) return e;
  kselect_warp_kernel<L><<<(Q + warps - 1) / warps, warps * 32,
                           warps * per_warp, stream>>>(cand, valid, q, pts,
                                                       d2, Q, C, k);
  return cudaSuccess;
}

}  // namespace

// cand (Q, C, 3) float32, valid (Q, C) one byte each (0 or 1), q (Q, 3)
// float32; outputs pts (Q, k, 3) and d2 (Q, k) float32, nearest first.
// 1 <= k <= C <= kselect_max_c().  Returns cudaGetLastError().
extern "C" int kselect_launch(const void* cand, const void* valid,
                              const void* q, void* pts, void* d2, int Q,
                              int C, int k, void* stream) {
  if (Q <= 0) return 0;
  if (C <= 0 || k <= 0 || k > C || C > kMaxC) return cudaErrorInvalidValue;
  const auto* cf = static_cast<const float*>(cand);
  const auto* vb = static_cast<const uint8_t*>(valid);
  const auto* qf = static_cast<const float*>(q);
  auto* pf = static_cast<float*>(pts);
  auto* df = static_cast<float*>(d2);
  const auto s = static_cast<cudaStream_t>(stream);
  if (C <= kGroupMaxC) {
    switch ((C + kGroup - 1) / kGroup) {
      case 1: launch_group<1>(cf, vb, qf, pf, df, Q, C, k, s); break;
      case 2: launch_group<2>(cf, vb, qf, pf, df, Q, C, k, s); break;
      case 3: launch_group<3>(cf, vb, qf, pf, df, Q, C, k, s); break;
      case 4: launch_group<4>(cf, vb, qf, pf, df, Q, C, k, s); break;
      case 5: launch_group<5>(cf, vb, qf, pf, df, Q, C, k, s); break;
      case 6: launch_group<6>(cf, vb, qf, pf, df, Q, C, k, s); break;
      case 7: launch_group<7>(cf, vb, qf, pf, df, Q, C, k, s); break;
      default: launch_group<8>(cf, vb, qf, pf, df, Q, C, k, s);
    }
  } else {
    // L keys a lane: 32 L >= 4 k / 3 for the threshold
    const int e = k <= 48 ? launch_warp<2>(cf, vb, qf, pf, df, Q, C, k, s)
                          : launch_warp<8>(cf, vb, qf, pf, df, Q, C, k, s);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

// the most candidates a row kselect_launch takes
extern "C" int kselect_max_c() { return kMaxC; }
