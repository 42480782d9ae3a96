// Greedy feature-selection walk, one warp per ring.
//
// Replaces: loam_tpu/ops/pallas/select_walk.py:_walk_kernel (call :208),
// and in the port the default selection loam_tpu/ops/features.py:
// select_ring, whose labels tests/test_select_walk.py pins as identical.
//
// What bounds it on the H100: latency, not bytes or arithmetic.  A ring's
// walk is a chain of dependent decisions (a pick suppresses its +-5
// neighbourhood, which decides later picks); the bytes it needs (the meta
// words it walks, one bit-field in, four out) move in well under a
// microsecond.  Walked by one thread a ring, every candidate was a
// dependent step behind a global load, each of a ring's 12 walks began
// with a cold miss, and the 32 rings of a warp waited for the slowest.
//
// Design: a warp owns a ring (4 warps a block, grid (ceil(R/4), B)).  A
// walk decides something only at an EVENT: a candidate that qualifies
// (in-span, curvature qualifies, not picked) or one that stops the walk
// (not in-span or not qualifying).  Between two events the picked
// bit-field changes only by the last pick's suppression range, so each
// lane holds one candidate of a 32-candidate chunk and whether it is
// still an event; __ballot_sync finds the first event, its suppression
// range goes to every lane by shuffle, the warp acts on it (count, label,
// suppress, or stop), and each later lane drops its candidate if the
// range covers it.  A chunk costs one round plus one a pick, where the
// serial walk took a dependent step a candidate.  A round is the chain
// ballot, find-leading-one, shuffle, three compares: a warp has no other
// work to hide its latencies behind, so everything else is kept off it.
// Candidates sit in reverse lane order (the first event is the ballot's
// highest bit: no bit reversal); a lane computes its own candidate's
// range and picked words when the chunk starts; the ring's picked
// bit-field lives in registers, word w in lane w % 32 (two words a lane
// at W = 2048), ORed in by the owner lanes (at most two words a pick, as
// the Pallas kernel's suppress does) and read by two shuffles a chunk;
// the labels are only written, by atomicOr into shared memory when a
// chunk ends.  Each subregion's two walks are loaded while the previous
// subregion's run, by loads that the compiler may not sink to their use
// (the replays' walks are under 64 candidates); a longer walk loads its
// next chunk while it works on the current one.  picked0 is read, and the
// outputs written, as int64 words, so the wrapper converts nothing.
//
// Quirks kept from the reference (src/scanRegistration.cpp:477-541): a
// stop takes effect after the stop candidate is processed (a quota
// overflow, a non-qualifying or a not-in-span candidate ends the walk);
// the 21st qualifying corner is counted, not labelled; the flat walk
// labels its last pick and stops before suppressing it.  A walk ends at
// step `lim` (the corner_scan_k / flat_scan_k depth, else the subregion).
//
// Meta word: bits 0-12 ring index, 13-17 upward reach, 18-22 downward
// reach, 23 in-span (and ring has >= 12 points), 24 curvature qualifies.
// Each reach is at most 16 (config suppress_neighbors), so a pick's span
// of at most 33 bits lies in two words of the picked bit-field: mask0 and
// mask1 below.
// Output per ring: [sharp | less_sharp | flat | picked] bit-fields,
// wb = ceil(W / 32) uint32 words each, stored as int64; a width that is
// not a multiple of 32 leaves the bits past W - 1 of the last word 0 (no
// suppression range reaches past W - 1).

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_util.cuh"

namespace {

constexpr int kWarps = 4;  // rings a block
constexpr int kMaxW = 8192;  // 13-bit ring indices, 8 words a lane

// the meta word's fields (ops/cuda/select_walk.py packs them)
constexpr int kIndMask = (1 << 13) - 1;
constexpr int kReachMask = (1 << 5) - 1;  // reaches up to 16 (two words)
constexpr int kUpShift = 13;
constexpr int kDnShift = 18;
constexpr int kValidShift = 23;
constexpr int kQualShift = 24;

// bits [lo, hi] of word w (lo <= hi, both within w's 32 or straddling)
__device__ __forceinline__ uint32_t range_bits(int lo, int hi, int w) {
  const int a = max(lo - 32 * w, 0);
  const int b = min(hi - 32 * w, 31);
  const uint32_t upto_b = b == 31 ? 0xffffffffu : (2u << b) - 1u;
  return upto_b & ~((1u << a) - 1u);
}

// A load issued where it is written (volatile: the compiler neither sinks
// it to its use nor drops it), so the next walk's words arrive while this
// walk runs.  The address is clamped into the walk; the caller masks the
// lanes past its end.
__device__ __forceinline__ int load_ahead(const int32_t* meta, int t,
                                          int lim) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];"
               : "=r"(v)
               : "l"(meta + min(t, lim - 1)));
  return v;
}

struct Chunks {  // a lane's words of a walk's first two chunks
  int w0, w1;
};

__device__ __forceinline__ Chunks load_walk(const int32_t* meta, int lane,
                                            int lim) {
  return {load_ahead(meta, 31 - lane, lim), load_ahead(meta, 63 - lane, lim)};
}

// One walk over the candidates [0, lim) of `meta` (walk order).  Lane l
// holds candidate 32c + 31 - l of chunk c, so the first event is the
// highest set bit of a ballot and "the lanes after it" are those below.
// picked[NW]: this lane's words (l, l + 32, ...) of the ring's picked
// bit-field; labels: the warp's sharp, less_sharp and flat bit-fields in
// shared memory, written at each chunk's end.
template <bool kCorner, int NW>
__device__ __forceinline__ void walk(const int32_t* __restrict__ meta,
                                     Chunks first, int lim,
                                     uint32_t (&picked)[NW], uint32_t* labels,
                                     int wb, int lane, int last,
                                     int max_sharp, int quota) {
  int cnt = 0;
  int ahead = 0;  // the next chunk's word of this lane, from chunk 3 on
  for (int c = 0; 32 * c < lim; ++c) {
    const int t = 32 * c + 31 - lane;
    int m = c == 0 ? first.w0 : first.w1;
    if (c >= 2) {
      m = c == 2 ? load_ahead(meta, t, lim) : ahead;
      ahead = load_ahead(meta, t + 32, lim);
    }
    const int ind = m & kIndMask;
    const bool stops =
        ((m >> kValidShift) & 1) == 0 || ((m >> kQualShift) & 1) == 0;
    // this candidate's suppression range, clipped at the ring ends, and
    // its one or two words of the picked bit-field
    const int lo = max(ind - ((m >> kDnShift) & kReachMask), 0);
    const int hi = min(ind + ((m >> kUpShift) & kReachMask), last);
    const uint32_t mask0 = range_bits(lo, hi, lo >> 5);
    const uint32_t mask1 = (hi >> 5) != (lo >> 5)
                               ? range_bits(lo, hi, hi >> 5) : 0u;
    const int span = lo | (hi << 16);
    const int owner = (ind >> 5) & 31;
    const int slot = ind >> 10;
    uint32_t pw = 0u;
#pragma unroll
    for (int u = 0; u < NW; ++u) {
      const uint32_t v = __shfl_sync(kFullMask, picked[u], owner);
      pw = u == slot ? v : pw;
    }
    // live: this lane's candidate is still an event (a stop, or not picked)
    bool live = (t < lim) & (stops | (((pw >> (ind & 31)) & 1u) == 0u));
    const unsigned stop_lanes = __ballot_sync(kFullMask, (t < lim) & stops);
    int kind = -1;  // the label field this lane's candidate went into
    bool done = false;
    while (true) {
      const unsigned hit = __ballot_sync(kFullMask, live);
      if (hit == 0u) break;  // nothing left to decide in this chunk
      const int e = 31 - __clz(hit);
      const int se = __shfl_sync(kFullMask, span, e);
      const uint32_t k0 = __shfl_sync(kFullMask, mask0, e);
      const uint32_t k1 = __shfl_sync(kFullMask, mask1, e);
      done = (stop_lanes >> e) & 1u;
      if (done) break;                          // a stop candidate
      ++cnt;
      done = kCorner && cnt > quota;
      if (done) break;                          // counted, not labelled
      kind = lane == e ? (kCorner ? (cnt <= max_sharp ? 0 : 1) : 2) : kind;
      done = !kCorner && cnt >= quota;
      if (done) break;                          // the last flat pick
      // suppress the pick's range: its owner lanes OR it in, and every
      // later lane drops its candidate if it lies there
      const int elo = se & 0xFFFF;
      const int ehi = se >> 16;
      const int w0 = elo >> 5;
      const int w1 = w0 + 1;
#pragma unroll
      for (int u = 0; u < NW; ++u) {
        picked[u] |= lane + 32 * u == w0 ? k0 : 0u;
        picked[u] |= lane + 32 * u == w1 ? k1 : 0u;
      }
      live = live & (lane < e) & (stops | (ind < elo) | (ind > ehi));
    }
    if (kind >= 0) atomicOr(labels + kind * wb + (ind >> 5), 1u << (ind & 31));
    if (done) return;
  }
}

template <int NW>
__global__ void __launch_bounds__(32 * kWarps)
    select_walk_kernel(const int32_t* __restrict__ corner_meta,
                       const int32_t* __restrict__ flat_meta,
                       const int64_t* __restrict__ picked0,
                       int64_t* __restrict__ out, int R, int n_sub, int subw,
                       int W, int corner_lim, int flat_lim, int max_sharp,
                       int max_less_sharp, int max_flat) {
  __shared__ uint32_t label_smem[kWarps][3 * 32 * NW];
  const int wb = (W + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;  // a whole warp; no block-wide barrier below
  const long ring = static_cast<long>(blockIdx.y) * R + r;
  const long K = static_cast<long>(n_sub) * subw;
  const int32_t* cm = corner_meta + ring * K;
  const int32_t* fm = flat_meta + ring * K;

  // subregion j's walks are loaded while subregion j - 1's run
  Chunks corner = load_walk(cm, lane, corner_lim);
  Chunks flat = load_walk(fm, lane, flat_lim);
  const int64_t* p0 = picked0 + ring * wb;
  uint32_t picked[NW];
#pragma unroll
  for (int u = 0; u < NW; ++u) {
    const int w = lane + 32 * u;
    picked[u] = w < wb ? static_cast<uint32_t>(p0[w]) : 0u;
  }
  uint32_t* labels = label_smem[threadIdx.x >> 5];
  for (int w = lane; w < 3 * wb; w += 32) labels[w] = 0u;
  __syncwarp();
  const int last = W - 1;

  // The last subregion reloads its own walks: on an H100 a branch around
  // those two loads measured slower than the loads themselves.
  for (int j = 0; j < n_sub; ++j) {
    const int next = min(j + 1, n_sub - 1) * subw;
    const Chunks corner_now = corner;
    corner = load_walk(cm + next, lane, corner_lim);
    walk<true, NW>(cm + j * subw, corner_now, corner_lim, picked, labels,
                   wb, lane, last, max_sharp, max_less_sharp);
    const Chunks flat_now = flat;
    flat = load_walk(fm + next, lane, flat_lim);
    walk<false, NW>(fm + j * subw, flat_now, flat_lim, picked, labels, wb,
                    lane, last, 0, max_flat);
  }

  __syncwarp();
  int64_t* o = out + ring * 4 * wb;
  for (int w = lane; w < 3 * wb; w += 32)
    o[w] = static_cast<int64_t>(labels[w]);
#pragma unroll
  for (int u = 0; u < NW; ++u) {
    const int w = lane + 32 * u;
    if (w < wb) o[3 * wb + w] = static_cast<int64_t>(picked[u]);
  }
}

template <int NW>
void launch(const int32_t* cm, const int32_t* fm, const int64_t* p0,
            int64_t* out, int B, int R, int n_sub, int subw, int W,
            int corner_lim, int flat_lim, int max_sharp, int max_less_sharp,
            int max_flat, cudaStream_t stream) {
  dim3 grid((R + kWarps - 1) / kWarps, B);
  select_walk_kernel<NW><<<grid, 32 * kWarps, 0, stream>>>(
      cm, fm, p0, out, R, n_sub, subw, W, corner_lim, flat_lim, max_sharp,
      max_less_sharp, max_flat);
}

}  // namespace

// corner_meta/flat_meta (B, R, n_sub*subw) int32; picked0 (B, R, wb) int64
// holding uint32 words, wb = ceil(W / 32); out (B, R, 4*wb) int64;
// 1 <= W <= select_walk_max_w().  corner_lim/flat_lim in [1, subw]: the
// walks' depths.  *instance receives the words a lane of the kernel
// launched holds (NW: 2, 4 or 8), 0 when nothing launched.
// Returns cudaGetLastError().
extern "C" int select_walk_launch(const void* corner_meta,
                                  const void* flat_meta, const void* picked0,
                                  void* out, int B, int R, int n_sub,
                                  int subw, int W, int corner_lim,
                                  int flat_lim, int max_sharp,
                                  int max_less_sharp, int max_flat,
                                  int* instance, void* stream) {
  *instance = 0;
  if (B <= 0 || R <= 0) return 0;
  if (W <= 0 || W > kMaxW || B > 65535) return cudaErrorInvalidValue;
  const auto* cm = static_cast<const int32_t*>(corner_meta);
  const auto* fm = static_cast<const int32_t*>(flat_meta);
  const auto* p0 = static_cast<const int64_t*>(picked0);
  auto* o = static_cast<int64_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  *instance = W <= 2048 ? 2 : W <= 4096 ? 4 : 8;
  if (*instance == 2)
    launch<2>(cm, fm, p0, o, B, R, n_sub, subw, W, corner_lim, flat_lim,
              max_sharp, max_less_sharp, max_flat, s);
  else if (*instance == 4)
    launch<4>(cm, fm, p0, o, B, R, n_sub, subw, W, corner_lim, flat_lim,
              max_sharp, max_less_sharp, max_flat, s);
  else
    launch<8>(cm, fm, p0, o, B, R, n_sub, subw, W, corner_lim, flat_lim,
              max_sharp, max_less_sharp, max_flat, s);
  return cudaGetLastError();
}

// the widest ring select_walk_launch takes
extern "C" int select_walk_max_w() { return kMaxW; }
