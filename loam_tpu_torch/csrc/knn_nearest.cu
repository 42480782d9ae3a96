// Exact nearest neighbour (k = 1) of every query over a whole live
// reference cloud: the grid splits queries AND references, and an atomic
// minimum on a packed (distance, index) key merges the slices.
//
// Replaces: loam_tpu/ops/pallas/knn_topk.py:_knn_kernel at k = 1, the
// odometry 1-NN (256 sharp queries against <= 2048 corner points, 512
// flat queries against <= 16384 surface points, twice a re-association).
//
// What bounds it on the H100: launch latency.  The whole call is a few
// million query/reference pairs of 9 fp32 operations, under 2
// microseconds of the card's CUDA cores, and under 200 KB of input.  A
// grid over query blocks alone gives 1-2 blocks on 132 SMs, each thread
// scanning every live reference serially; that, not arithmetic or bytes,
// is what a design has to remove.
//
// Design: block (x, y, b) owns kQueries queries of problem b and the
// reference slice [y * kSlice, (y + 1) * kSlice).  It stages the slice in
// shared memory once (xyz padded to a float4, so a scan step is one
// broadcast 16-byte load), each thread scans it for its own query, and
// the thread's best (d, j) goes into the query's 64-bit key with one
// atomicMin.  A non-negative fp32 orders as its bit pattern, so
// (bits(d) << 32) | j as an unsigned integer orders by (distance, index):
// the minimum over all slices is the nearest reference with ties to the
// smaller index, whatever order the blocks arrive in.  The caller fills
// the keys with (bits(1e30) << 32) | 0 before the launch: the contract's
// fill for "no reference" (index 0, d2 = 1e30), which also means that a
// distance at or above 1e30 reads as no reference.  Slices at or past
// the live count n_ref exit at once; the last query block may be ragged.
// At the surf shape (Q = 512, M = 16384) 64 queries x 64 references a
// block give 8 x 256 blocks, about 1370 of them live at 10922 references,
// and 4 x 32 at the corner shape (Q = 256, M = 2048): every SM scans, and
// a thread's serial chain is 64 pairs, not 10922.
// Distances are exact fp32 (exact_dist.cuh): no tensor cores, no TF32.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "exact_dist.cuh"

namespace {

constexpr int kQueries = 64;  // queries a block, one a thread
constexpr int kSlice = 64;    // references a block stages (1 KB) and scans

__global__ void knn_nearest_kernel(const float* __restrict__ q,
                                   const float* __restrict__ ref,
                                   const int32_t* __restrict__ n_ref,
                                   unsigned long long* __restrict__ keys,
                                   int Q, int M) {
  __shared__ float4 tile[kSlice];
  const int b = blockIdx.z;
  int nr = n_ref[b];
  nr = nr < M ? nr : M;
  const int base = blockIdx.y * kSlice;
  if (base >= nr) return;  // the whole block leaves: no barrier is skipped
  const int n = nr - base < kSlice ? nr - base : kSlice;

  const float* rb = ref + (static_cast<long>(b) * M + base) * 3;
  static_assert(kQueries >= kSlice, "one staging pass covers the slice");
  const int t = threadIdx.x;
  if (t < n)
    tile[t] = make_float4(rb[3 * t], rb[3 * t + 1], rb[3 * t + 2], 0.0f);
  __syncthreads();

  const int qi = blockIdx.x * kQueries + t;
  if (qi >= Q) return;
  const long qo = static_cast<long>(b) * Q + qi;
  const float qx = q[qo * 3], qy = q[qo * 3 + 1], qz = q[qo * 3 + 2];

  // ascending j and a strict < keep the first of equal distances
  float bd = CUDART_INF_F;
  int bj = 0;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 r = tile[j];
    const float d = sq_dist(qx, qy, qz, r.x, r.y, r.z);
    if (d < bd) {
      bd = d;
      bj = j;
    }
  }
  const unsigned long long key =
      (static_cast<unsigned long long>(__float_as_uint(bd)) << 32) |
      static_cast<unsigned>(base + bj);
  atomicMin(keys + qo, key);
}

}  // namespace

// q (B, Q, 3), ref (B, M, 3) float32; n_ref (B,) int32 live counts (ref
// front-compacted); keys (B, Q) 64-bit, filled by the caller with
// (bits(1e30f) << 32) | 0.  On return the low word of a key is the
// nearest live reference's index and the high word the bits of its exact
// squared distance.  Returns cudaGetLastError().
extern "C" int knn_nearest_launch(const void* q, const void* ref,
                                  const void* n_ref, void* keys, int B, int Q,
                                  int M, void* stream) {
  if (B <= 0 || Q <= 0 || M <= 0) return 0;
  const dim3 grid((Q + kQueries - 1) / kQueries, (M + kSlice - 1) / kSlice, B);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  knn_nearest_kernel<<<grid, kQueries, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(ref),
      static_cast<const int32_t*>(n_ref),
      static_cast<unsigned long long*>(keys), Q, M);
  return cudaGetLastError();
}
