// Odometry 2nd/3rd correspondence points: the reference's break-bounded
// ring walks outward from the 1-NN, one thread per query.
//
// Replaces: loam_tpu/ops/pallas/odom_corr.py:_corr_kernel (wrapper
// _corr_pallas), which re-expresses the walks as a streaming reduction
// over reference tiles; this kernel runs the reference's own loops
// instead (src/laserOdometry.cpp:486-524 corners, :598-645 surfaces),
// which need no streaming state.
//
// What bounds it on the H100: dependent loads.  Each thread walks the
// ring-sorted previous cloud from its 1-NN j1 until the ring id leaves
// cr +- ring_window, which spans up to ~5 of 16 rings (a few thousand
// points of a 16k-point surface cloud); every step reads 16 bytes
// (xyz + ring) that the block's neighbouring queries often share via
// L1/L2.  There are only 256-512 queries per call, so the card is
// mostly idle; the walk is short compared to the launch either way.
//
// Semantics (identical to the jnp walks loam_tpu/odometry.py:94-146):
// for a query with j1 >= 0 and cr = ring[j1],
//   upward   j = j1+1, ...  stops at the first ring > cr + window, at the
//            live count n_ref, and (truncate) at the current feature
//            count n_q — the reference's loop-bound quirk (:486, :598);
//   downward j = j1-1, ...  stops at the first ring < cr - window.
// Eligible 2nd points: corner, ring > cr upward / ring < cr downward;
// surface, ring <= cr upward / ring >= cr downward.  Eligible 3rd points
// (surface): ring > cr upward / ring < cr downward.
// Tie rule: among equal exact distances the smaller index wins (the
// first-occurrence argmin of the jnp walks; the Pallas kernel instead
// prefers the upward side, PARITY.md "Documented TPU-only divergences").
// The upward walk keeps the first best (strict <), the downward walk the
// last best (<=), and the two sides merge with the downward side winning
// ties.  Distances are exact fp32 (q - r)^2 in the order
// round(round(dx^2 + dy^2) + dz^2), like the plain torch version; the
// caller applies the 25 m^2 gates on recomputed distances.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         const float* r) {
  const float dx = __fsub_rn(qx, r[0]);
  const float dy = __fsub_rn(qy, r[1]);
  const float dz = __fsub_rn(qz, r[2]);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

struct Best {
  float d = kBig;
  int32_t i = -1;
};

// downward candidates sit below upward ones, so on a tie they win
__device__ __forceinline__ Best merge(Best up, Best dn) {
  return (dn.i >= 0 && (up.i < 0 || dn.d <= up.d)) ? dn : up;
}

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
                                 float window, int surf, int truncate) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const long qo = static_cast<long>(b) * Q + i;
  const float* R = ref + static_cast<long>(b) * M * 3;
  const int32_t* rg = ring + static_cast<long>(b) * M;
  const int nr = n_ref[b] < M ? n_ref[b] : M;
  const int j = j1[qo];

  Best up2, up3, dn2, dn3;
  if (j >= 0 && j < nr) {
    const float qx = q[qo * 3], qy = q[qo * 3 + 1], qz = q[qo * 3 + 2];
    const float cr = static_cast<float>(rg[j]);
    int up_end = nr;
    if (truncate && n_q[b] < up_end) up_end = n_q[b];
    for (int c = j + 1; c < up_end; ++c) {
      const float r = static_cast<float>(rg[c]);
      if (r > cr + window) break;
      const bool el2 = surf ? (r <= cr) : (r > cr);
      const bool el3 = surf && (r > cr);
      if (!el2 && !el3) continue;
      const float d = sq_dist(qx, qy, qz, R + 3L * c);
      if (el2 && d < up2.d) up2 = {d, c};
      if (el3 && d < up3.d) up3 = {d, c};
    }
    for (int c = j - 1; c >= 0; --c) {
      const float r = static_cast<float>(rg[c]);
      if (r < cr - window) break;
      const bool el2 = surf ? (r >= cr) : (r < cr);
      const bool el3 = surf && (r < cr);
      if (!el2 && !el3) continue;
      const float d = sq_dist(qx, qy, qz, R + 3L * c);
      if (el2 && d <= dn2.d) dn2 = {d, c};
      if (el3 && d <= dn3.d) dn3 = {d, c};
    }
  }
  const Best b2 = merge(up2, dn2);
  const Best b3 = merge(up3, dn3);
  j2[qo] = b2.i;
  d2[qo] = b2.d;
  j3[qo] = b3.i;
  d3[qo] = b3.d;
}

}  // namespace

// q (B, Q, 3), ref (B, M, 3) float32 (recentred); ring (B, M) int32 ring
// ids; j1 (B, Q) int32 gated 1-NN (-1 none); n_q, n_ref (B,) int32.
// Outputs j2, j3 (B, Q) int32 (-1 none) and their exact squared
// distances d2, d3 (B, Q) float32 (1e30 none).  Returns cudaGetLastError().
extern "C" int odom_corr_launch(const void* q, const void* ref,
                                const void* ring, const void* j1,
                                const void* n_q, const void* n_ref, void* j2,
                                void* j3, void* d2, void* d3, int B, int Q,
                                int M, float window, int surf, int truncate,
                                void* stream) {
  if (B <= 0 || Q <= 0) return 0;
  constexpr int kThreads = 128;
  dim3 grid((Q + kThreads - 1) / kThreads, B);
  odom_corr_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(ref),
      static_cast<const int32_t*>(ring), static_cast<const int32_t*>(j1),
      static_cast<const int32_t*>(n_q), static_cast<const int32_t*>(n_ref),
      static_cast<int32_t*>(j2), static_cast<int32_t*>(j3),
      static_cast<float*>(d2), static_cast<float*>(d3), Q, M, window, surf,
      truncate);
  return cudaGetLastError();
}
