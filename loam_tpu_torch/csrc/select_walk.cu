// Greedy feature-selection walk, one thread per ring.
//
// Replaces: loam_tpu/ops/pallas/select_walk.py:_walk_kernel (and, in the
// port, the default selection loam_tpu/ops/features.py:select_ring,
// whose labels tests/test_select_walk.py pins as identical).
//
// What bounds it on the H100: latency, not bytes or FLOPs.  Each ring's
// walk is a serial chain of dependent steps (a pick suppresses its
// +-5 neighbourhood, which decides later picks), a few hundred steps of
// ~20 integer ops each; the data is 16 rings x 2 x 2094 meta words per
// frame.  With R = 16 * frames rings there are only a few hundred
// threads, so the card is mostly idle; what matters is that every step
// stays on-chip.
//
// Design: everything data-independent (walk order, suppression reaches,
// eligibility) arrives pre-packed in one int32 meta word per candidate,
// built by plain torch with two stable argsorts (ops/features.py).  A
// thread keeps its ring's picked bit-field and the three label
// bit-fields (4 x W/32 words) in its own slice of shared memory, laid
// out word-major across the block's threads so that threads touching
// the same word index hit different banks.  Meta words stream from
// global memory in walk order (read once, sequentially per thread).
//
// Quirks kept from the reference (src/scanRegistration.cpp:477-541):
// the stop condition applies from the NEXT step (a quota-overflow,
// below-threshold or span-end candidate is processed, then the walk
// breaks); the flat walk labels its final pick but breaks before
// suppressing it.
//
// Meta word: bits 0-10 ring index, 11-13 upward reach, 14-16 downward
// reach, 17 in-span (and ring has >= 12 points), 18 curvature qualifies.
// Output per ring: [sharp | less_sharp | flat | picked] bit-fields,
// W/32 uint32 words each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ uint32_t& word(uint32_t* smem, int field, int w,
                                          int wb) {
  return smem[(field * wb + w) * kThreads + threadIdx.x];
}

__global__ void select_walk_kernel(const int32_t* __restrict__ corner_meta,
                                   const int32_t* __restrict__ flat_meta,
                                   const uint32_t* __restrict__ picked0,
                                   uint32_t* __restrict__ out, int R,
                                   int n_sub, int subw, int wb, int max_sharp,
                                   int max_less_sharp, int max_flat) {
  extern __shared__ uint32_t smem[];  // 4 * wb * kThreads words
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;  // no barriers below: threads run independently
  const long ring = static_cast<long>(blockIdx.y) * R + r;
  const int K = n_sub * subw;
  const int32_t* cm = corner_meta + ring * K;
  const int32_t* fm = flat_meta + ring * K;

  // fields: 0 sharp, 1 less_sharp, 2 flat, 3 picked
  for (int w = 0; w < wb; ++w) {
    word(smem, 0, w, wb) = 0u;
    word(smem, 1, w, wb) = 0u;
    word(smem, 2, w, wb) = 0u;
    word(smem, 3, w, wb) = picked0[ring * wb + w];
  }

  auto picked = [&](int ind) {
    return (word(smem, 3, ind >> 5, wb) >> (ind & 31)) & 1u;
  };
  auto set_bit = [&](int field, int ind) {
    word(smem, field, ind >> 5, wb) |= 1u << (ind & 31);
  };
  auto suppress = [&](int ind, int up, int dn) {
    for (int p = ind - dn; p <= ind + up; ++p) set_bit(3, p);
  };

  for (int j = 0; j < n_sub; ++j) {
    const int base = j * subw;

    // corner walk, curvature-descending
    int cnt = 0;
    for (int t = 0; t < subw; ++t) {
      const int m = cm[base + t];
      const int ind = m & 0x7FF;
      const int up = (m >> 11) & 7;
      const int dn = (m >> 14) & 7;
      const bool valid = (m >> 17) & 1;
      const bool qual = (m >> 18) & 1;
      const bool qualify = valid && qual && !picked(ind);
      cnt += qualify ? 1 : 0;
      if (qualify && cnt <= max_less_sharp) {
        set_bit(cnt <= max_sharp ? 0 : 1, ind);
        suppress(ind, up, dn);
      }
      if ((qualify && cnt > max_less_sharp) || !valid || !qual) break;
    }

    // flat walk, curvature-ascending
    cnt = 0;
    for (int t = 0; t < subw; ++t) {
      const int m = fm[base + t];
      const int ind = m & 0x7FF;
      const int up = (m >> 11) & 7;
      const int dn = (m >> 14) & 7;
      const bool valid = (m >> 17) & 1;
      const bool qual = (m >> 18) & 1;
      const bool qualify = valid && qual && !picked(ind);
      cnt += qualify ? 1 : 0;
      if (qualify) {
        set_bit(2, ind);
        if (cnt < max_flat) suppress(ind, up, dn);
      }
      if ((qualify && cnt >= max_flat) || !valid || !qual) break;
    }
  }

  uint32_t* o = out + ring * 4 * wb;
  for (int f = 0; f < 4; ++f)
    for (int w = 0; w < wb; ++w) o[f * wb + w] = word(smem, f, w, wb);
}

}  // namespace

// corner_meta/flat_meta (B, R, n_sub*subw) int32; picked0 (B, R, wb)
// uint32; out (B, R, 4*wb) uint32.  Returns cudaGetLastError().
extern "C" int select_walk_launch(const void* corner_meta,
                                  const void* flat_meta, const void* picked0,
                                  void* out, int B, int R, int n_sub,
                                  int subw, int wb, int max_sharp,
                                  int max_less_sharp, int max_flat,
                                  void* stream) {
  if (B <= 0 || R <= 0) return 0;
  const size_t smem = sizeof(uint32_t) * 4 * wb * kThreads;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        select_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((R + kThreads - 1) / kThreads, B);
  select_walk_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(corner_meta),
      static_cast<const int32_t*>(flat_meta),
      static_cast<const uint32_t*>(picked0), static_cast<uint32_t*>(out), R,
      n_sub, subw, wb, max_sharp, max_less_sharp, max_flat);
  return cudaGetLastError();
}
