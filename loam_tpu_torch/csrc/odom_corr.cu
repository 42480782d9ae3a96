// Odometry 2nd/3rd correspondence points: the reference's break-bounded
// ring walks outward from the 1-NN, one warp per query.
//
// Replaces: loam_tpu/ops/pallas/odom_corr.py:_corr_kernel (wrapper
// _corr_pallas), which re-expresses the walks as a streaming reduction
// over reference tiles; this kernel runs the reference's own walks
// instead (src/laserOdometry.cpp:486-524 corners, :598-645 surfaces),
// which need no streaming state.
//
// What bounds it on the H100: launch latency and the longest walk of the
// call, not bytes or arithmetic.  A walk covers the points whose ring id
// stays within cr +- ring_window of the 1-NN's ring cr: up to ~5 of 16
// rings, a few thousand points of a 16k-point surface cloud, 16 bytes
// and ~10 operations each; there are only 256-512 queries a call.  Walked
// by one thread a query, every step is a dependent load and a warp waits
// for its longest walk.
//
// Design: a warp owns a query and its 32 lanes take 32 consecutive points
// of the walk, so the loads of `ring` and `ref` are coalesced; a block is
// 4 warps, so 512 queries are 128 blocks and 256 are 64.  A side of the
// walk advances kUnroll warp steps (128 points) an iteration, and the
// next iteration's points are loaded before this one's are judged, so no
// load waits for a break decision.  The break is found, not assumed: each
// lane tests its own point (ring > cr + window upward, ring < cr - window
// downward), __ballot_sync names the first breaking lane, lanes at or
// past it drop out and the side ends after that step.  Nothing requires
// the ring ids to be sorted.  Every lane keeps its own best (d, index)
// for the 2nd and, for surfaces, the 3rd point under one rule, the
// lexicographic minimum of (distance, index), and a shuffle reduction
// under the same rule ends the walk.
//
// Semantics (identical to the jnp walks loam_tpu/odometry.py:94-146):
// for a query with 0 <= j1 < n_ref and cr = ring[j1],
//   upward   j = j1+1, ...  stops at the first ring > cr + window, at the
//            live count n_ref, and (truncate) at the current feature
//            count n_q, the reference's loop-bound quirk (:486, :598);
//   downward j = j1-1, ...  stops at the first ring < cr - window.
// Eligible 2nd points: corner, ring > cr upward / ring < cr downward;
// surface, ring <= cr upward / ring >= cr downward.  Eligible 3rd points
// (surface): ring > cr upward / ring < cr downward.
// Tie rule: among equal exact distances the smaller index wins (the
// first-occurrence argmin of the jnp walks; the Pallas kernel instead
// prefers the upward side, PARITY.md "Documented TPU-only divergences").
// A serial walk gets there by keeping the first best upward, the last
// best downward and letting the downward side win the merge; all three
// say (distance, index) lexicographic, which needs no walk order.
// Distances are exact fp32 (exact_dist.cuh), like the plain torch
// version; the caller applies the 25 m^2 gates on recomputed distances.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "exact_dist.cuh"

namespace {

constexpr int kWarps = 4;    // queries a block
constexpr int kUnroll = 4;   // warp steps an iteration: 128 points
constexpr unsigned kFull = 0xffffffffu;

// The smallest (distance, index) seen.  Empty is (+inf, -1): no real
// candidate has an index below -1, so an infinite distance never enters.
struct Best {
  float d;
  int32_t i;
  __device__ __forceinline__ Best() : d(INFINITY), i(-1) {}
  __device__ __forceinline__ void take(float nd, int32_t ni) {
    if (nd < d || (nd == d && ni < i)) {
      d = nd;
      i = ni;
    }
  }
};

__device__ __forceinline__ Best warp_min(Best b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    b.take(__shfl_xor_sync(kFull, b.d, off), __shfl_xor_sync(kFull, b.i, off));
  return b;
}

// kUnroll warp steps of one side, as loaded: ring id and coordinates of
// this lane's point of each step (untouched where the walk has ended).
struct Chunk {
  float r[kUnroll], x[kUnroll], y[kUnroll], z[kUnroll];
};

// One side of the walk: `len` points starting beside j1, in walk order
// p = 0, 1, ...; point p is column j1 + 1 + p upward, j1 - 1 - p downward.
template <bool kSurf, bool kUp>
__device__ __forceinline__ void walk_side(const float* __restrict__ R,
                                          const int32_t* __restrict__ rg,
                                          int j1, int len, float cr,
                                          float window, float qx, float qy,
                                          float qz, int lane, Best& b2,
                                          Best& b3) {
  const float edge = kUp ? __fadd_rn(cr, window) : __fsub_rn(cr, window);
  auto column = [&](int p) { return kUp ? j1 + 1 + p : j1 - 1 - p; };
  auto load = [&](int p0) {
    Chunk c;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + 32 * u + lane;
      c.r[u] = c.x[u] = c.y[u] = c.z[u] = 0.0f;
      if (p < len) {
        const long col = column(p);
        c.r[u] = static_cast<float>(rg[col]);
        c.x[u] = R[3 * col];
        c.y[u] = R[3 * col + 1];
        c.z[u] = R[3 * col + 2];
      }
    }
    return c;
  };

  Chunk cur = load(0);
  for (int p0 = 0; p0 < len; p0 += 32 * kUnroll) {
    const Chunk nxt = load(p0 + 32 * kUnroll);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + 32 * u + lane;
      const float r = cur.r[u];
      const bool in = p < len;
      const bool brk = in && (kUp ? r > edge : r < edge);
      const unsigned broke = __ballot_sync(kFull, brk);
      // visited: in range and before the first breaking lane of the step
      if (in && (broke & ((2u << lane) - 1u)) == 0u) {
        const bool beyond = kUp ? r > cr : r < cr;  // strictly past cr
        const bool el2 = kSurf ? !beyond : beyond;
        const bool el3 = kSurf && beyond;
        if (el2 || el3) {
          const float d = sq_dist(qx, qy, qz, cur.x[u], cur.y[u], cur.z[u]);
          const int32_t col = column(p);
          if (el2) b2.take(d, col);
          if (el3) b3.take(d, col);
        }
      }
      if (broke) return;  // uniform across the warp
    }
    cur = nxt;
  }
}

template <bool kSurf>
__global__ void odom_corr_kernel(const float* __restrict__ q,
                                 const float* __restrict__ ref,
                                 const int32_t* __restrict__ ring,
                                 const int32_t* __restrict__ j1,
                                 const int32_t* __restrict__ n_q,
                                 const int32_t* __restrict__ n_ref,
                                 int32_t* __restrict__ j2,
                                 int32_t* __restrict__ j3,
                                 float* __restrict__ d2,
                                 float* __restrict__ d3, int Q, int M,
                                 float window, int truncate) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= Q) return;  // a whole warp leaves; there is no block barrier
  const long qo = static_cast<long>(b) * Q + i;
  const float* R = ref + static_cast<long>(b) * M * 3;
  const int32_t* rg = ring + static_cast<long>(b) * M;
  const int nr = n_ref[b] < M ? n_ref[b] : M;
  const int j = j1[qo];

  Best b2, b3;
  if (j >= 0 && j < nr) {
    const float qx = q[qo * 3], qy = q[qo * 3 + 1], qz = q[qo * 3 + 2];
    const float cr = static_cast<float>(rg[j]);
    int up_end = nr;
    if (truncate && n_q[b] < up_end) up_end = n_q[b];
    walk_side<kSurf, true>(R, rg, j, up_end - (j + 1), cr, window, qx, qy, qz,
                           lane, b2, b3);
    walk_side<kSurf, false>(R, rg, j, j, cr, window, qx, qy, qz, lane, b2,
                            b3);
    b2 = warp_min(b2);
    if (kSurf) b3 = warp_min(b3);
  }
  if (lane == 0) {
    j2[qo] = b2.i;
    d2[qo] = b2.i >= 0 ? b2.d : kBig;
    j3[qo] = b3.i;
    d3[qo] = b3.i >= 0 ? b3.d : kBig;
  }
}

}  // namespace

// q (B, Q, 3), ref (B, M, 3) float32 (recentred); ring (B, M) int32 ring
// ids, in any order; j1 (B, Q) int32 gated 1-NN (-1 none); n_q, n_ref
// (B,) int32.  Outputs j2, j3 (B, Q) int32 (-1 none) and their exact
// squared distances d2, d3 (B, Q) float32 (1e30 none).  Returns
// cudaGetLastError().
extern "C" int odom_corr_launch(const void* q, const void* ref,
                                const void* ring, const void* j1,
                                const void* n_q, const void* n_ref, void* j2,
                                void* j3, void* d2, void* d3, int B, int Q,
                                int M, float window, int surf, int truncate,
                                void* stream) {
  if (B <= 0 || Q <= 0) return 0;
  const dim3 grid((Q + kWarps - 1) / kWarps, B);
  auto* kernel = surf ? odom_corr_kernel<true> : odom_corr_kernel<false>;
  kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(ref),
      static_cast<const int32_t*>(ring), static_cast<const int32_t*>(j1),
      static_cast<const int32_t*>(n_q), static_cast<const int32_t*>(n_ref),
      static_cast<int32_t*>(j2), static_cast<int32_t*>(j3),
      static_cast<float*>(d2), static_cast<float*>(d3), Q, M, window,
      truncate);
  return cudaGetLastError();
}
