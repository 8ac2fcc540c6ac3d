// Segmented inclusive scans over (flag, v0[, v1[, v2]]) int32 columns.
//
// Replaces the Pallas TPU kernel plass_tpu/ops/pallas_scan.py
// (_scan_padded / _kern_body, entry points seg_scan_pallas and
// first_carry_pallas) that carries the device k-mer matcher's
// representative first-carry and the run/segment scans of
// best_diagonal_hits.
//
// Combine functors, op(earlier, later) (pallas_scan.py:_combine):
//   first  : every element takes the values of its segment's first element
//   cummax : segmented running max
//   sfx2   : lexicographic max of (v0, v1) carrying v2; the earlier operand
//            wins ties (it is not commutative)
// The scan has no identity element: a thread, warp, tile or look-back only
// ever combines real aggregates, in order. A flagged later operand makes
// the result independent of the earlier one; the first element of the scan
// is treated as flagged (a segment starts there whatever its flag says), so
// whatever a partial tile holds before it can never reach an output.
//
// reverse=1 walks logical index i at physical index n-1-i, so "earlier" is
// the higher index. That replaces the three jnp.flip copies the JAX package
// puts around each suffix scan. Tiles stay aligned in physical memory: the
// scan's tile k is physical tile n_tiles-1-k, read ascending with the same
// vector loads and mirrored in registers.
//
// What bounds it on Hopper: device memory. The function reads a one-byte
// flag and NV int32 per element and writes NV int32: 25 bytes per element
// for three columns, 0.19 ms at 3.35 TB/s for a 24M-entry table. The TPU
// kernel kept the running carry in SMEM across a sequential grid; Hopper's
// blocks run in no order. The design is a single pass with decoupled
// look-back, so every element is read once and written once:
//   * a block takes its tile from an atomic counter, so tiles start in
//     scan order and a tile only ever waits for tiles that already run;
//   * a tile is 4,096 elements: 256 threads, each holding four 16-byte
//     vectors of 4 consecutive elements per column (the flags as 4-byte
//     words). Vector h of all threads together is the h-th 1,024-element
//     stretch of the tile, so every warp-wide load and store is one
//     contiguous 512 bytes; a thread scans each vector in registers, the
//     warp-shuffle scan runs once per vector, and one warp scans the 32
//     (vector, warp) totals in scan order: two __syncthreads() per tile;
//   * the first warp publishes the tile's aggregate, then looks back over
//     its predecessors 32 at a time, nearest first, folding their
//     aggregates in tile order (sfx2 is not commutative) until it meets an
//     inclusive prefix or a flagged aggregate - with the matcher's short
//     segments that is usually the nearest tile - and publishes its own
//     inclusive prefix;
//   * a tile's descriptor is a status word (invalid / aggregate /
//     inclusive prefix, plus the segment flag) and two 16-byte value slots,
//     one for the aggregate and one for the inclusive prefix, so a value
//     never changes once its status is visible: values are stored, then
//     __threadfence(), then the status; readers load the status (volatile),
//     fence, then the values from L2. No 128-bit atomicity is relied on.
// The counter and the status words are reset on the stream before each
// launch (one cudaMemsetAsync), which counts in the kernel's time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;  // resident blocks per SM the compiler plans for
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;  // 16-byte vectors (4 elements) per thread and column
constexpr int kItems = 4 * kVecs;
static_assert(kVecs * kWarps <= 32, "one warp scans the warp totals");
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { FIRST = 0, CUMMAX = 1, SFX2 = 2 };
// tile status; kSegFlag rides in the same word
constexpr int kInvalid = 0;
constexpr int kAggregate = 1;
constexpr int kInclusive = 2;
constexpr int kStatusMask = 3;
constexpr int kSegFlag = 4;

template <int NV>
struct St {
  int f;
  int v[NV];
};

struct Cols {
  const int32_t* in[3];
  int32_t* out[3];
};

template <int KIND, int NV>
__device__ __forceinline__ St<NV> combine(const St<NV>& a, const St<NV>& b) {
  St<NV> r;
  r.f = a.f | b.f;
  if constexpr (KIND == FIRST) {
#pragma unroll
    for (int i = 0; i < NV; ++i) r.v[i] = b.f ? b.v[i] : a.v[i];
  } else if constexpr (KIND == CUMMAX) {
#pragma unroll
    for (int i = 0; i < NV; ++i) r.v[i] = b.f ? b.v[i] : max(a.v[i], b.v[i]);
  } else {
    static_assert(NV >= 2, "sfx2 needs (c, pk[, payload])");
    const bool a_wins =
        !b.f && (a.v[0] > b.v[0] || (a.v[0] == b.v[0] && a.v[1] >= b.v[1]));
#pragma unroll
    for (int i = 0; i < NV; ++i) r.v[i] = a_wins ? a.v[i] : b.v[i];
  }
  return r;
}

template <int NV>
__device__ __forceinline__ St<NV> shfl(const St<NV>& x, int src) {
  St<NV> y;
  y.f = __shfl_sync(kFull, x.f, src);
#pragma unroll
  for (int i = 0; i < NV; ++i) y.v[i] = __shfl_sync(kFull, x.v[i], src);
  return y;
}

template <int KIND, int NV>
__device__ __forceinline__ St<NV> warp_scan(St<NV> x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    St<NV> y;
    y.f = __shfl_up_sync(kFull, x.f, d);
#pragma unroll
    for (int i = 0; i < NV; ++i) y.v[i] = __shfl_up_sync(kFull, x.v[i], d);
    if (lane >= d) x = combine<KIND, NV>(y, x);
  }
  return x;
}

// Scratch layout, int32: [0] the tile counter, [1, 1 + n_tiles) the status
// words, then from the next multiple of 4 the aggregates int32[n_tiles][4]
// and the inclusive prefixes int32[n_tiles][4].
__host__ __device__ inline int64_t values_at(int64_t n_tiles) {
  return (1 + n_tiles + 3) / 4 * 4;
}

template <int NV>
__device__ __forceinline__ void publish(int32_t* scratch, int64_t n_tiles, int64_t tile,
                                        const St<NV>& x, int status) {
  int4 v = make_int4(x.v[0], 0, 0, 0);
  if constexpr (NV > 1) v.y = x.v[1];
  if constexpr (NV > 2) v.z = x.v[2];
  int32_t* vals = scratch + values_at(n_tiles) + (status == kInclusive ? 4 * n_tiles : 0);
  *reinterpret_cast<int4*>(vals + 4 * tile) = v;
  __threadfence();
  *reinterpret_cast<volatile int32_t*>(scratch + 1 + tile) = status | (x.f ? kSegFlag : 0);
}

// The first warp folds the predecessors of `tile`, nearest first, into the
// tile's exclusive prefix (tile > 0). Every lane returns it.
template <int KIND, int NV>
__device__ __forceinline__ St<NV> look_back(int32_t* scratch, int64_t n_tiles, int64_t tile,
                                            int lane) {
  const volatile int32_t* status = scratch + 1;
  const int32_t* vals = scratch + values_at(n_tiles);
  St<NV> run;
  bool has_run = false;
  for (int64_t nearest = tile - 1;; nearest -= 32) {
    const int64_t t = nearest - (31 - lane);  // lane 31 reads the nearest tile
    int st;
    int cut;  // the highest lane whose descriptor ends the look-back, or -1
    for (;;) {
      st = t >= 0 ? status[t] : kInvalid;
      const bool ready = (st & kStatusMask) != kInvalid;
      const unsigned ready_mask = __ballot_sync(kFull, ready);
      const unsigned cut_mask = __ballot_sync(
          kFull, ready && ((st & kStatusMask) == kInclusive || (st & kSegFlag)));
      cut = 31 - __clz(cut_mask);  // -1 when no lane cuts
      // every lane above the cut must have published
      const unsigned need = cut >= 31 ? 0u : (kFull << (cut + 1));
      if ((ready_mask & need) == need) break;
    }
    __threadfence();  // the values are read after the status that announces them
    St<NV> y;
    y.f = 0;
#pragma unroll
    for (int i = 0; i < NV; ++i) y.v[i] = 0;
    if (lane >= cut && t >= 0) {
      const int32_t* slot = vals + ((st & kStatusMask) == kInclusive ? 4 * n_tiles : 0) + 4 * t;
      const int4 v = __ldcg(reinterpret_cast<const int4*>(slot));
      y.f = (st & kSegFlag) ? 1 : 0;
      y.v[0] = v.x;
      if constexpr (NV > 1) y.v[1] = v.y;
      if constexpr (NV > 2) y.v[2] = v.z;
    }
    // nothing before the cut lane can matter: flag it, so that the scan
    // drops whatever the lanes below it hold
    if (lane == cut) y.f = 1;
    const St<NV> window = shfl<NV>(warp_scan<KIND, NV>(y, lane), 31);
    run = has_run ? combine<KIND, NV>(window, run) : window;
    has_run = true;
    if (cut >= 0) return run;
  }
}

// Element e (0..3) of vector h of this thread, in scan order, sits at
// physical index vec_start(h) + (REV ? 3 - e : e).
template <bool REV>
__device__ __forceinline__ int64_t vec_start(int64_t base, int h) {
  const int64_t off = static_cast<int64_t>(h) * kThreads * 4 + threadIdx.x * 4;
  return REV ? base + kTile - 4 - off : base + off;
}

// One tile per block: load, scan in registers, scan the thread aggregates,
// look back, write. A thread holds kVecs vectors of 4 consecutive elements;
// vector h of all threads together is the h-th stretch of kThreads * 4
// elements of the tile, so a warp's 16-byte loads and stores are contiguous.
// vec_ok says that every pointer takes the vector loads.
template <int KIND, int NV, bool REV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    scan_lookback(const uint8_t* __restrict__ flag, Cols cols, int64_t n, int64_t n_tiles,
                  int32_t* scratch, int vec_ok) {
  __shared__ int64_t s_tile;
  __shared__ int s_f[32];  // [h * kWarps + warp]: totals, then inclusive prefixes
  __shared__ int s_v[NV][32];
  __shared__ int s_pf;
  __shared__ int s_pv[NV];
  if (threadIdx.x == 0) s_tile = atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = (REV ? n_tiles - 1 - tile : tile) * kTile;
  const int64_t first_phys = REV ? n - 1 : 0;
  const bool vec = vec_ok && base + kTile <= n;

  St<NV> x[kVecs][4];
#pragma unroll
  for (int h = 0; h < kVecs; ++h) {
    const int64_t p0 = vec_start<REV>(base, h);
    if (vec) {
      const uint32_t fw = *reinterpret_cast<const uint32_t*>(flag + p0);
#pragma unroll
      for (int k = 0; k < 4; ++k) x[h][REV ? 3 - k : k].f = ((fw >> (8 * k)) & 0xffu) != 0;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int4 t = *reinterpret_cast<const int4*>(cols.in[c] + p0);
        x[h][REV ? 3 : 0].v[c] = t.x;
        x[h][REV ? 2 : 1].v[c] = t.y;
        x[h][REV ? 1 : 2].v[c] = t.z;
        x[h][REV ? 0 : 3].v[c] = t.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t p = p0 + k;
        const bool ok = p >= 0 && p < n;
        St<NV>& e = x[h][REV ? 3 - k : k];
        e.f = ok ? (flag[p] != 0) : 0;
#pragma unroll
        for (int c = 0; c < NV; ++c) e.v[c] = ok ? cols.in[c][p] : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (p0 + k == first_phys) x[h][REV ? 3 - k : k].f = 1;
  }

  // inclusive scan of each vector, then of the vectors' aggregates across
  // the warp; the lanes before this one give `before[h]` (lane > 0)
  St<NV> before[kVecs];
#pragma unroll
  for (int h = 0; h < kVecs; ++h) {
#pragma unroll
    for (int i = 1; i < 4; ++i) x[h][i] = combine<KIND, NV>(x[h][i - 1], x[h][i]);
    const St<NV> incl = warp_scan<KIND, NV>(x[h][3], lane);
    before[h].f = __shfl_up_sync(kFull, incl.f, 1);
#pragma unroll
    for (int i = 0; i < NV; ++i) before[h].v[i] = __shfl_up_sync(kFull, incl.v[i], 1);
    if (lane == 31) {
      s_f[h * kWarps + warp] = incl.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) s_v[i][h * kWarps + warp] = incl.v[i];
    }
  }
  __syncthreads();
  if (warp == 0) {
    // the kVecs * kWarps warp totals, in scan order -> inclusive prefixes;
    // lanes past them hold nothing and sit after every real total
    constexpr int kTotals = kVecs * kWarps;
    St<NV> w;
    w.f = lane < kTotals ? s_f[lane] : 0;
#pragma unroll
    for (int i = 0; i < NV; ++i) w.v[i] = lane < kTotals ? s_v[i][lane] : 0;
    w = warp_scan<KIND, NV>(w, lane);
    if (lane < kTotals) {
      s_f[lane] = w.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) s_v[i][lane] = w.v[i];
    }
    const St<NV> tile_agg = shfl<NV>(w, kTotals - 1);
    if (tile == 0) {
      if (lane == 0) publish<NV>(scratch, n_tiles, tile, tile_agg, kInclusive);
    } else {
      if (lane == 0) publish<NV>(scratch, n_tiles, tile, tile_agg, kAggregate);
      const St<NV> excl = look_back<KIND, NV>(scratch, n_tiles, tile, lane);
      if (lane == 0) {
        publish<NV>(scratch, n_tiles, tile, combine<KIND, NV>(excl, tile_agg), kInclusive);
        s_pf = excl.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) s_pv[i] = excl.v[i];
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int h = 0; h < kVecs; ++h) {
    // everything before this vector: the tile's exclusive prefix, the warp
    // totals before this warp's (earlier vectors included), the lanes
    // before this one
    St<NV> prefix;
    bool has_prefix = false;
    if (tile > 0) {
      prefix.f = s_pf;
#pragma unroll
      for (int i = 0; i < NV; ++i) prefix.v[i] = s_pv[i];
      has_prefix = true;
    }
    const int slot = h * kWarps + warp - 1;
    if (slot >= 0) {
      St<NV> w;
      w.f = s_f[slot];
#pragma unroll
      for (int i = 0; i < NV; ++i) w.v[i] = s_v[i][slot];
      prefix = has_prefix ? combine<KIND, NV>(prefix, w) : w;
      has_prefix = true;
    }
    if (lane > 0) {
      prefix = has_prefix ? combine<KIND, NV>(prefix, before[h]) : before[h];
      has_prefix = true;
    }
    if (has_prefix) {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[h][i] = combine<KIND, NV>(prefix, x[h][i]);
    }
    const int64_t p0 = vec_start<REV>(base, h);
    if (vec) {
#pragma unroll
      for (int c = 0; c < NV; ++c)
        *reinterpret_cast<int4*>(cols.out[c] + p0) =
            make_int4(x[h][REV ? 3 : 0].v[c], x[h][REV ? 2 : 1].v[c], x[h][REV ? 1 : 2].v[c],
                      x[h][REV ? 0 : 3].v[c]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t p = p0 + k;
        if (p >= 0 && p < n) {
#pragma unroll
          for (int c = 0; c < NV; ++c) cols.out[c][p] = x[h][REV ? 3 - k : k].v[c];
        }
      }
    }
  }
}

inline bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

template <int KIND, int NV, bool REV>
int run(const uint8_t* flag, Cols cols, int64_t n, int32_t* scratch, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles > INT32_MAX) return -1;
  if (!aligned(scratch, 16)) return -2;
  bool vec_ok = aligned(flag, 4);
  for (int c = 0; c < NV; ++c)
    vec_ok = vec_ok && aligned(cols.in[c], 16) && aligned(cols.out[c], 16);
  // reset the tile counter and the status words
  const cudaError_t err = cudaMemsetAsync(scratch, 0, (1 + n_tiles) * sizeof(int32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_lookback<KIND, NV, REV>
      <<<static_cast<unsigned>(n_tiles), kThreads, 0, stream>>>(flag, cols, n, n_tiles, scratch,
                                                               vec_ok ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, int NV>
int run_dir(int reverse, const uint8_t* flag, Cols cols, int64_t n, int32_t* scratch,
            cudaStream_t stream) {
  return reverse ? run<KIND, NV, true>(flag, cols, n, scratch, stream)
                 : run<KIND, NV, false>(flag, cols, n, scratch, stream);
}

}  // namespace

// The number of int32 of scratch a scan of n elements needs (16-byte
// aligned): the tile counter, the status words and two value slots per tile.
extern "C" int64_t seg_scan_scratch_ints(int64_t n) {
  const int64_t n_tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  return values_at(n_tiles) + 8 * n_tiles;
}

// One kernel launch per call, after the reset of the scratch's counter and
// status words on the same stream. Returns the launch's cudaGetLastError()
// (0 = launched), -1 for an unsupported kind/nvals or too many tiles, -2
// for a misaligned scratch.
extern "C" int seg_scan(int kind, int nvals, int reverse, const uint8_t* flag,
                        const int32_t* v0, const int32_t* v1,
                        const int32_t* v2, int32_t* o0, int32_t* o1,
                        int32_t* o2, int64_t n, int32_t* scratch,
                        void* stream) {
  Cols cols{{v0, v1, v2}, {o0, o1, o2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind * 4 + nvals) {
    case FIRST * 4 + 1: return run_dir<FIRST, 1>(reverse, flag, cols, n, scratch, s);
    case FIRST * 4 + 2: return run_dir<FIRST, 2>(reverse, flag, cols, n, scratch, s);
    case FIRST * 4 + 3: return run_dir<FIRST, 3>(reverse, flag, cols, n, scratch, s);
    case CUMMAX * 4 + 1: return run_dir<CUMMAX, 1>(reverse, flag, cols, n, scratch, s);
    case CUMMAX * 4 + 2: return run_dir<CUMMAX, 2>(reverse, flag, cols, n, scratch, s);
    case CUMMAX * 4 + 3: return run_dir<CUMMAX, 3>(reverse, flag, cols, n, scratch, s);
    case SFX2 * 4 + 2: return run_dir<SFX2, 2>(reverse, flag, cols, n, scratch, s);
    case SFX2 * 4 + 3: return run_dir<SFX2, 3>(reverse, flag, cols, n, scratch, s);
    default: return -1;
  }
}
