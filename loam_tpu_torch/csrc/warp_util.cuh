// Warp-level pieces shared by the neighbour-selection kernels
// (knn_topk.cu, kselect.cu): asynchronous copies from device memory into
// shared memory, the warp-wide minimum of a (distance, index) pair, a
// sorted insert into a short register list, and a (distance, index) pair
// as one 64-bit key.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kNoIndex = 0x7fffffff;  // the index of an empty entry
// +inf for code that the host compiler sees too (CUDART_INF_F is a
// device intrinsic)
constexpr float kInf = __builtin_huge_valf();

// cp.async: the copy is issued and the thread goes on; it lands before
// cp_async_wait<N>() returns with at most N committed groups pending.
// Source and destination must be aligned to the copy's size.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n_floats consecutive floats by the calling threads (thread `rank` of
// `size`): 16 bytes a copy when both pointers are 16-byte aligned
// (`wide`), the ragged end and unaligned spans 4 bytes a copy.
__device__ __forceinline__ void cp_async_floats(float* smem,
                                                const float* gmem,
                                                int n_floats, bool wide,
                                                int rank, int size) {
  const int n_wide = wide ? n_floats >> 2 : 0;
  for (int i = rank; i < n_wide; i += size)
    cp_async16(smem + 4 * i, gmem + 4 * i);
  for (int i = 4 * n_wide + rank; i < n_floats; i += size)
    cp_async4(smem + i, gmem + i);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The smallest (d, i) pair over the warp's lanes, in every lane: smaller
// distance first, smaller index among equal distances.  d must be a
// non-negative float or +inf (a squared distance: never -0, so the bit
// patterns order like the values), and the lanes' indices distinct or
// kNoIndex.  Two hardware warp reductions, no shuffle ladder.
__device__ __forceinline__ void warp_min_pair(float& d, int& i) {
  const unsigned bits = __float_as_uint(d);
  const unsigned best = __reduce_min_sync(kFullMask, bits);
  i = __reduce_min_sync(kFullMask, bits == best ? i : kNoIndex);
  d = __uint_as_float(best);
}

// (d, i) into a list of K pairs sorted by distance, given d < bd[K - 1]:
// the last pair drops out, and an equal distance lands after the pairs
// already there (callers insert in ascending index order, so the list
// stays in (distance, index) order).
template <int K>
__device__ __forceinline__ void sorted_insert(float (&bd)[K], int (&bi)[K],
                                              float d, int i) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (d < bd[s - 1]) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (d < bd[s]) {
      bd[s] = d;
      bi[s] = i;
    }
  }
  if (d < bd[0]) {
    bd[0] = d;
    bi[0] = i;
  }
}

// A (d2, index) pair as one key that orders like the pair: d2 is never
// negative (a sum of squares, never -0), so its bits order like its
// value, and the index fills the low word.  The empty key (+inf,
// kNoIndex) is above every pair.
using Key = unsigned long long;
constexpr Key kEmptyKey = (Key{0x7f800000u} << 32) | Key{0x7fffffffu};

__device__ __forceinline__ Key pair_key(float d, int i) {
  return (static_cast<Key>(__float_as_uint(d)) << 32) |
         static_cast<unsigned>(i);
}

__device__ __forceinline__ float key_dist(Key x) {
  return __uint_as_float(static_cast<unsigned>(x >> 32));
}

__device__ __forceinline__ int key_index(Key x) {
  return static_cast<int>(static_cast<unsigned>(x));
}
