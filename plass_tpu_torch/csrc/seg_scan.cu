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
// The scan has no identity element: a thread, warp or block only ever
// combines real elements, so "first" needs no sentinel either.
//
// reverse=1 walks logical index i at physical index n-1-i, so "earlier" is
// the higher index. That replaces the three jnp.flip copies the JAX package
// puts around each suffix scan.
//
// What bounds it on Hopper: device memory. Per element and pass the scan
// moves (1 + NV) * 4 bytes (the flag is one byte); the three passes read
// the input twice and write it once, ~2 * 24M * 13 B ≈ 0.6 GB at the
// 24M-entry table, a fraction of a millisecond of HBM time at 3.35 TB/s.
// The TPU kernel kept the running carry in SMEM across a sequential grid;
// Hopper's blocks run in no order, so this design takes three passes:
//   1. each 1024-thread block scans its tile (warp shuffles, then a scan
//      of the 32 warp totals) and writes the tile aggregate;
//   2. one block scans the tile aggregates in place;
//   3. each block rescans its tile and folds in the previous tile's
//      inclusive aggregate.
// A single-pass decoupled look-back scan is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { FIRST = 0, CUMMAX = 1, SFX2 = 2 };

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

// Inclusive scan of one element per thread, in thread order. Returns this
// thread's inclusive value; *total gets the block's aggregate.
template <int KIND, int NV>
__device__ __forceinline__ St<NV> block_scan(St<NV> x, St<NV>* total) {
  __shared__ int sf[kWarps];
  __shared__ int sv[NV][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_scan<KIND, NV>(x, lane);
  if (lane == 31) {
    sf[warp] = x.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) sv[i][warp] = x.v[i];
  }
  __syncthreads();
  if (warp == 0) {
    St<NV> w;
    w.f = sf[lane];
#pragma unroll
    for (int i = 0; i < NV; ++i) w.v[i] = sv[i][lane];
    w = warp_scan<KIND, NV>(w, lane);
    sf[lane] = w.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) sv[i][lane] = w.v[i];
  }
  __syncthreads();
  if (warp > 0) {
    St<NV> p;
    p.f = sf[warp - 1];
#pragma unroll
    for (int i = 0; i < NV; ++i) p.v[i] = sv[i][warp - 1];
    x = combine<KIND, NV>(p, x);
  }
  total->f = sf[kWarps - 1];
#pragma unroll
  for (int i = 0; i < NV; ++i) total->v[i] = sv[i][kWarps - 1];
  __syncthreads();  // the shared arrays are reused by the next call
  return x;
}

// agg layout: [1 + NV][n_tiles] int32 (flag row, then one row per value).
// Pass 1 (FINAL=false) writes each tile's aggregate; pass 3 (FINAL=true)
// folds in the previous tile's inclusive aggregate and writes the output.
// Threads past n sit after every real element, so they never reach a real
// output; they only pollute the last tile's aggregate, which no tile reads.
template <int KIND, int NV, bool REV, bool FINAL>
__global__ void __launch_bounds__(kThreads)
    scan_tiles(const uint8_t* __restrict__ flag, Cols cols, int64_t n,
               int32_t* __restrict__ agg) {
  const int64_t tile = blockIdx.x;
  const int64_t n_tiles = gridDim.x;
  const int64_t i = tile * kThreads + threadIdx.x;
  const bool ok = i < n;
  const int64_t phys = REV ? n - 1 - i : i;
  St<NV> x;
  x.f = ok ? (flag[phys] != 0) : 0;
#pragma unroll
  for (int k = 0; k < NV; ++k) x.v[k] = ok ? cols.in[k][phys] : 0;
  St<NV> total;
  x = block_scan<KIND, NV>(x, &total);
  if constexpr (!FINAL) {
    if (threadIdx.x == 0) {
      agg[tile] = total.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) agg[(k + 1) * n_tiles + tile] = total.v[k];
    }
  } else {
    if (tile > 0) {
      St<NV> c;
      c.f = agg[tile - 1];
#pragma unroll
      for (int k = 0; k < NV; ++k) c.v[k] = agg[(k + 1) * n_tiles + tile - 1];
      x = combine<KIND, NV>(c, x);
    }
    if (ok) {
#pragma unroll
      for (int k = 0; k < NV; ++k) cols.out[k][phys] = x.v[k];
    }
  }
}

// Pass 2: one block turns the tile aggregates into inclusive prefixes, in
// place, 1024 tiles at a time with a running carry.
template <int KIND, int NV>
__global__ void __launch_bounds__(kThreads)
    scan_aggregates(int32_t* __restrict__ agg, int64_t n_tiles) {
  St<NV> carry;
  bool has_carry = false;
  for (int64_t base = 0; base < n_tiles; base += kThreads) {
    const int64_t i = base + threadIdx.x;
    const bool ok = i < n_tiles;
    St<NV> x;
    x.f = ok ? agg[i] : 0;
#pragma unroll
    for (int k = 0; k < NV; ++k) x.v[k] = ok ? agg[(k + 1) * n_tiles + i] : 0;
    St<NV> total;
    x = block_scan<KIND, NV>(x, &total);
    if (has_carry) x = combine<KIND, NV>(carry, x);
    if (ok) {
      agg[i] = x.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) agg[(k + 1) * n_tiles + i] = x.v[k];
    }
    carry = has_carry ? combine<KIND, NV>(carry, total) : total;
    has_carry = true;
  }
}

template <int KIND, int NV, bool REV>
int run(const uint8_t* flag, Cols cols, int64_t n, int32_t* agg,
        cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t n_tiles = (n + kThreads - 1) / kThreads;
  if (n_tiles > 1) {
    scan_tiles<KIND, NV, REV, false>
        <<<n_tiles, kThreads, 0, stream>>>(flag, cols, n, agg);
    scan_aggregates<KIND, NV><<<1, kThreads, 0, stream>>>(agg, n_tiles);
  }
  scan_tiles<KIND, NV, REV, true>
      <<<n_tiles, kThreads, 0, stream>>>(flag, cols, n, agg);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, int NV>
int run_dir(int reverse, const uint8_t* flag, Cols cols, int64_t n,
            int32_t* agg, cudaStream_t stream) {
  return reverse ? run<KIND, NV, true>(flag, cols, n, agg, stream)
                 : run<KIND, NV, false>(flag, cols, n, agg, stream);
}

}  // namespace

// Scratch holds (1 + nvals) * ceil(n / 1024) int32. Returns the launch's
// cudaGetLastError() (0 = launched), or -1 for an unsupported kind/nvals.
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
