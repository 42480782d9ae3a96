// Exact fp32 squared distance shared by the neighbour-search kernels
// (knn_topk.cu, knn_nearest.cu, odom_corr.cu, kselect.cu).
//
// (q - r)^2 in the order round(round(dx^2 + dy^2) + dz^2), every step an
// explicit round-to-nearest intrinsic so that nvcc contracts nothing into
// an FMA: the plain PyTorch versions (ops/nn.pairwise_sq_dists,
// ops/cuda/kselect.masked_sq_dists) run the same IEEE sequence, and kernel
// and plain version agree bit for bit.  Swapping the two points gives the
// same bits: (r - q)^2 rounds like (q - r)^2.

#pragma once

constexpr float kBig = 1e30f;  // the contracts' fill for "no neighbour"

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}
