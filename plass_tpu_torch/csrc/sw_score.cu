// Best local Smith-Waterman score with affine gaps for (query, target)
// pairs: the score-only prefilter of the amino-acid aligner.
//
// Replaces plass_tpu/ops/device_align.py:32 (sw_score_batch, an XLA
// lax.scan over target columns of padded [B, LQ] states). Per pair, over
// query rows i and target columns j:
//   E(i,j) = max(H(i,j-1) - gapo, E(i,j-1) - gape)              along the target
//   F(i,j) = max_{k<i} (H0(k,j) - gapo - (i-1-k) * gape)          along the query
//   H0(i,j) = max(0, H(i-1,j-1) + sub[q_i][t_j] + bias_i, E(i,j))
//   H(i,j) = max(H0(i,j), F(i,j)),  score = max over all H0
// with H = 0 and E = -inf before the first row and column. F from H0
// rather than H is exact because gapo >= gape (11/1, 5/2): a gap opened
// after a cell whose H came from F is never better than extending that F.
// The score is the best H0: F and E only carry earlier H0 less a gap.
// bias_i is the query's rounded composition bias (int8), added to every
// target letter as the host aligner's striped profile does, so the score
// equals the native ssw score exactly.
//
// Operands are flat, nothing is padded: the queries' codes and bias as
// uint8/int8 rows with int64 offsets and int32 lengths; the target DB's
// own bytes (rows, offsets, lengths) read through a 256-entry code table;
// int32 pair indices (qidx, tidx), the order the pairs are taken in and a
// host plan (device_align.schedule: the bias range and how many pairs take
// each path); the int32 [alpha, alpha] matrix. The output is int32[b].
//
// What bounds it on Hopper: integer operations, not bytes. A pair of
// lengths m and n reads m + n bytes and does m * n cells; the least work
// of a cell is 6 DPX-fused int32 operations, and a DPX instruction runs
// at the int32 rate (62 lanes an SM a clock, kernels/tune.py rates). The
// first kernel (a warp per pair, the F across a warp's lanes closed by a
// prefix max every column; PERF.md) spent about 18 a cell and let one
// long pair set the call. This one spends about 8 (a shared load and its
// address, four DPX, an IMAD, half a three-way max) and a step's
// shuffles. The design:
//   * lanes as a wavefront: lane l of a group holds R consecutive rows in
//     registers and sweeps the target one step behind lane l - 1 (column
//     s - l at step s), so the H and F leaving a lane's last row reach the
//     lane below by a shuffle, with no scan, and a cell is one pass;
//   * every add-and-max is one DPX instruction, on state kept shifted
//     (A = H - gapo, psi = F - gapo): E = __viaddmax_s32(E, -gape, A),
//     H0 = __viaddmax_s32_relu(A above-left, s, E), A = __viaddmax_s32(H0,
//     -gapo, psi), psi = __viaddmax_s32(psi, -gape, H0 - 2 gapo), the best
//     a __vimax3_s32 for two rows;
//   * the bias is folded into the lookup: the shared table holds
//     sub[q][t] + bias + gapo for the kSpan bias values of the plan's
//     range, so a row's score is one shared load at an offset fixed for
//     the strip; a plan whose bias spans more values takes the kernel's
//     second instance, which adds the bias in the cell;
//   * short queries take fewer lanes: a pair takes the least warp-path
//     class that holds its query (class_lanes(c) lanes of class_r(c)
//     rows, several pairs a warp), so a lane holds many rows and a group's
//     fill of lanes - 1 steps is short;
//   * long pairs take a block: a query longer than a warp's strip
//     (kStripRows), or one of two strips whose cells pass the plan's
//     threshold, is swept by a group of a block's warps, warp w taking
//     strips w, w + ws, ... two tiles of 32 steps behind warp w - 1. A
//     strip's bottom (A and psi per column) passes to the next warp
//     through a ring in shared memory, one __syncthreads a tile; a query
//     longer than the group's strips wraps to its warp 0 through a global
//     scratch of strip_cols columns a block, the only global state. A
//     call of few pairs (its tail) gives each long pair the whole block
//     and rows a lane by the query's length; a call that fills the card
//     gives it kMaxR rows a lane and the fewest warps its strips fill
//     (blocks of 1, 2 or 4 pairs), so that no warp idles;
//   * residency: persistent blocks, as many as the occupancy calculator
//     finds resident (at least one an SM), take block-path pairs, then
//     their warps take groups of pairs from per-class counters, the
//     longest queries first; kMinBlocks caps the registers.
// Rows past the query's end and columns past the target's end (and before
// a lane's first) read a score of -2^28: their cells never exceed the best
// of the real cells and feed only cells past the end, so the inner loop
// has no mask. PERF.md has the times, the registers and what was tried.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;        // warps a block: the strips a block-path pair has in flight
constexpr int kMinBlocks = 2;    // blocks an SM the register allocation plans for
constexpr int kMaxR = 16;        // the most rows a lane holds; a warp's strip is 32 * kMaxR
constexpr int kRStep = 2;        // the rows a lane of the warp-path classes step by
constexpr int kMinLanes = 1;     // lanes a pair of the shortest queries takes
constexpr int kSpan = 16;        // bias values the folded table holds
constexpr int kRowOverhead = 48;  // a step's latency, in rows (picks R of a block pair)
constexpr int kThreads = kWarps * 32;
constexpr int kStripRows = 32 * kMaxR;
constexpr int kMaxAlpha = 32;
constexpr int kMaxDevices = 64;
constexpr int kNeg = -(1 << 30);
constexpr int kMask = -(1 << 28);
constexpr unsigned kFull = 0xffffffffu;
// table[t][bias block][q] at t * kTStride + block * kBStride + q: a
// target letter's row holds kSpan bias blocks and a mask block. The
// strides put a row's code q of the lanes' letters t in bank (25 t +
// block + q) mod 32, not in bank q alone: the lanes of a wavefront read
// different letters' rows, and so collide less.
constexpr int kBStride = 33;
constexpr int kTStride = (kSpan + 1) * kBStride + 8;
constexpr int kRingCols = 128;              // boundary columns a warp's ring holds

constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }
// Warp-path classes, by rows held: kMinLanes lanes of 1 row and of kRStep
// .. kMaxR rows, then 2 kMinLanes .. 32 lanes of kMaxR / 2 + kRStep ..
// kMaxR rows each.
constexpr int kFirstRs = kMaxR / kRStep;
constexpr int kUpperRs = kMaxR / 2 / kRStep;
constexpr int kClasses = 1 + kFirstRs + ilog2(32 / kMinLanes) * kUpperRs;
constexpr int kBlockClasses = 3;                     // a block of 1, 2 or 4 pairs
constexpr int kCounters = kBlockClasses + kClasses;  // a counter a block and a warp class
constexpr int kPlan = 4 + kBlockClasses + kClasses;  // a plan's values

__host__ __device__ constexpr int class_lanes(int c) {
  return c <= kFirstRs ? kMinLanes : kMinLanes << ((c - 1 - kFirstRs) / kUpperRs + 1);
}
__host__ __device__ constexpr int class_r(int c) {
  return c == 0 ? 1
         : c <= kFirstRs ? c * kRStep
                         : kMaxR / 2 + ((c - 1 - kFirstRs) % kUpperRs + 1) * kRStep;
}

static_assert(kWarps >= 4 && (kWarps & (kWarps - 1)) == 0, "kWarps: a power of two >= 4");
static_assert(kMaxR >= 4 && (kMaxR & (kMaxR - 1)) == 0, "kMaxR: a power of two >= 4");
static_assert(kRStep >= 1 && (kMaxR / 2) % kRStep == 0, "kRStep divides kMaxR / 2");
static_assert(kMinLanes >= 1 && kMinLanes <= 32 && (kMinLanes & (kMinLanes - 1)) == 0,
              "kMinLanes: a power of two <= 32");
static_assert(class_lanes(kClasses - 1) * class_r(kClasses - 1) == kStripRows,
              "the last class is a warp's strip");
// a block-path query wraps to warp 0 only past kStripRows (the contract's -1)
static_assert(kWarps * 32 * (kMaxR / 4) >= kStripRows, "a block's strips must hold kStripRows");

struct Args {
  const uint8_t* qcodes;
  const int64_t* qoffsets;
  const int32_t* qlens;
  const int8_t* bias;
  const uint8_t* rows;
  const int64_t* offsets;
  const int32_t* lengths;
  const uint8_t* code_lut;
  const int32_t* qidx;
  const int32_t* tidx;
  const int32_t* order;
  const int32_t* sub;
  int alpha;
  int gapo;
  int gape;
  int32_t* out;
  int32_t* counters;     // kCounters, zeroed by the launch
  int2* strips;          // [blocks, strip_cols] (A, psi) per column; null without long queries
  int64_t strip_cols;
  int lo, hi;            // the plan's bias range
  int fill;              // the call fills the card: groups of pairs share a block
  int bstart[kBlockClasses];  // block class b: 2^b pairs a block, kWarps >> b warps each
  int bcount[kBlockClasses];
  int start[kClasses];   // then warp class c's pairs, the highest class first
  int count[kClasses];
};

// Dynamic shared memory: the boundary rings, the block's reduction, the
// target code table and the score table.
constexpr int kRingBytes = kWarps * kRingCols * 8;
static_assert(kRingBytes >= kMaxAlpha * kMaxAlpha * 4, "the ring stages the matrix");
constexpr int kRedInts = 2 * kWarps < 32 ? 32 : 2 * kWarps;
__host__ __device__ constexpr int64_t smem_bytes(int alpha) {
  return kRingBytes + 4 * (kRedInts + 256 + static_cast<int64_t>(alpha + 1) * kTStride);
}
static_assert(kRedInts >= 2 * kWarps, "the block's reduction holds best and bad a warp");

struct Gaps {
  int gapo, gape, gapo2;
};

// A lane's rows i0 .. i0 + R - 1 of a query as byte offsets into a target
// letter's table row: folded (F), the bias block and the code; else the
// code, with the bias in the upper half. Rows past the query read the
// mask block, each lane its own bank of it. Returns whether a row's bias
// is outside the plan's range.
template <int R, bool F>
__device__ __forceinline__ bool load_rows(const Args& a, int64_t qo, int qlen, int i0,
                                          int (&qoff)[R]) {
  bool bad = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    if (i < qlen) {
      const int q = min(static_cast<int>(a.qcodes[qo + i]), a.alpha - 1);
      int b = a.bias[qo + i];
      bad |= b < a.lo || b > a.hi;
      b = min(max(b, a.lo), a.hi);
      qoff[r] = F ? ((b - a.lo) * kBStride + q) * 4 : b * 65536 + q * 4;
    } else {
      qoff[r] = (kSpan * kBStride + (threadIdx.x & 31)) * 4;
    }
  }
  return bad;
}

// One target column for a lane's R rows: trow is the column's table row,
// diag the A (H - gapo) of the row above at the previous column, psi the
// psi (F - gapo) entering the first row. Updates A and E and the best H0;
// returns the psi leaving the last row. A = max(H0 - gapo, psi) is
// H - gapo, and psi passes down as max(psi - gape, H0 - 2 gapo).
template <int R, bool F>
__device__ __forceinline__ int cells(const char* trow, int diag, int psi, const int (&qoff)[R],
                                     int (&av)[R], int (&ev)[R], int& best, const Gaps& g) {
  int hprev = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int s;
    if constexpr (F)
      s = *reinterpret_cast<const int*>(trow + qoff[r]);
    else
      s = *reinterpret_cast<const int*>(trow + (qoff[r] & 0xffff)) + (qoff[r] >> 16);
    ev[r] = __viaddmax_s32(ev[r], -g.gape, av[r]);
    const int h0 = __viaddmax_s32_relu(diag, s, ev[r]);
    diag = av[r];
    av[r] = __viaddmax_s32(h0, -g.gapo, psi);
    psi = __viaddmax_s32(psi, -g.gape, h0 - g.gapo2);
    if (r & 1)
      best = __vimax3_s32(best, hprev, h0);
    else if (r == R - 1)
      best = max(best, h0);
    else
      hprev = h0;
  }
  return psi;
}

// Warp path, class C: groups of G lanes take pairs of queries the class
// holds, 32 / G pairs a warp, from the class's counter; lane l of a group
// holds rows l * R .. l * R + R - 1.
template <int C, bool F>
__device__ void warp_class(const Args& a, const char* table, const int* lut, const Gaps& g) {
  constexpr int G = class_lanes(C);
  constexpr int R = class_r(C);
  constexpr int kPerWarp = 32 / G;
  const int n = a.count[C];
  if (n == 0) return;
  const int lane = threadIdx.x & 31;
  const int gi = lane / G, gl = lane % G;
  const int pad = a.alpha * kTStride * 4;
  for (;;) {
    int k0 = 0;
    if (lane == 0) k0 = atomicAdd(a.counters + 1 + C, kPerWarp);
    k0 = __shfl_sync(kFull, k0, 0);
    if (k0 >= n) break;
    const int k = k0 + gi;
    int64_t p = 0, qo = 0, to = 0;
    int qlen = 0, tlen = 0;
    if (k < n) {
      p = a.order[a.start[C] + k];
      const int qi = a.qidx[p], ti = a.tidx[p];
      qlen = a.qlens[qi];
      tlen = a.lengths[ti];
      qo = a.qoffsets[qi];
      to = a.offsets[ti];
    }
    bool bad = qlen > G * R;  // the plan put the pair in too small a class
    if (bad || qlen == 0) tlen = 0;
    const int tmax = __reduce_max_sync(kFull, tlen);
    int best = 0;
    if (tmax > 0) {
      int qoff[R], av[R], ev[R];
      const bool oob = load_rows<R, F>(a, qo, qlen, gl * R, qoff);
      bad |= oob && tlen > 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        av[r] = -g.gapo;
        ev[r] = kNeg;
      }
      int psi = kNeg, code = pad, prev_ta = -g.gapo;
      // group lane i reads the code of column s0 + i, a batch ahead
      int raw = gl < tlen ? a.rows[to + gl] : -1;
      const int steps = tmax + G - 1;
      for (int s0 = 0; s0 < steps; s0 += G) {
        const int buf = raw >= 0 ? lut[raw] : pad;
        if (s0 + G < steps) raw = s0 + G + gl < tlen ? a.rows[to + s0 + G + gl] : -1;
        const int jn = min(G, steps - s0);
        for (int jj = 0; jj < jn; ++jj) {
          int diag = -g.gapo, pin = kNeg;
          if constexpr (G > 1) {
            // from the lane above: its last row's A and psi at its last
            // step, this lane's column now, and that column's code
            const int ta = __shfl_up_sync(kFull, av[R - 1], 1, G);
            const int tp = __shfl_up_sync(kFull, psi, 1, G);
            const int c0 = __shfl_sync(kFull, buf, jj, G);
            const int cd = __shfl_up_sync(kFull, code, 1, G);
            if (gl > 0) {
              diag = prev_ta;
              prev_ta = ta;
              pin = tp;
              code = cd;
            } else {
              code = c0;
            }
          } else {
            code = buf;
          }
          psi = cells<R, F>(table + code, diag, pin, qoff, av, ev, best, g);
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(kFull, best, o, G));
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) bad |= __shfl_xor_sync(kFull, bad, o, G);
    if (gl == 0 && k < n) a.out[p] = bad ? -2 : best;
  }
}

template <int C, bool F>
__device__ void warp_classes(const Args& a, const char* table, const int* lut, const Gaps& g) {
  warp_class<C, F>(a, table, lut, g);
  if constexpr (C > 0) warp_classes<C - 1, F>(a, table, lut, g);
}

// Block path: a block's warps in groups of ws, each group sweeping one
// pair's strips of 32 * R rows, the group's warp w taking strips w, w +
// ws, ... A strip's bottom at column j leaves lane 31 at step j + 31, so
// warp w runs two tiles of 32 steps behind warp w - 1: at block step s
// it is at its tile k = s - 2 w, pass k / P, tile k % P with P =
// max(tiles + 2, 2 ws); the ring and the wrap scratch are written before
// they are read and read before they are written again. The wrap (a query
// longer than the group's strips) takes the block's scratch, so a plan
// sends such a query only to a group of the whole block.
struct BlockPair {
  bool valid;  // a pair this group sweeps
  int64_t p, qo, to;
  int qlen, tlen;
};

template <int R, bool F>
__device__ void block_sweep(const Args& a, int2* ring, int* red, int* steps_sh, const char* table,
                            const int* lut, const Gaps& g, int ws, const BlockPair& bp) {
  constexpr int S = 32 * R;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = wid / ws, w = wid - sub * ws;
  int n_strips = bp.valid ? (bp.qlen + S - 1) / S : 0;
  bool bad = ws < kWarps && n_strips > ws;  // a wrap in a group of part of the block
  if (bad) n_strips = 0;
  const int tlen = bp.tlen;
  const int tiles = (tlen + 31 + 31) / 32;
  const int period = max(tiles + 2, 2 * ws);
  const int passes = (n_strips + ws - 1) / ws;
  if (w == 0 && lane == 0)
    steps_sh[sub] = n_strips ? (passes - 1) * period + tiles + 2 * (ws - 1) : 0;
  __syncthreads();
  int steps = 0;
  for (int i = 0; i < kWarps / ws; ++i) steps = max(steps, steps_sh[i]);
  const int pad = a.alpha * kTStride * 4;
  int2* wrap = a.strips ? a.strips + blockIdx.x * a.strip_cols : nullptr;
  int2* out_ring = ring + wid * kRingCols;
  const int2* in_ring = ring + (wid - 1) * kRingCols;
  int qoff[R], av[R], ev[R];
  int psi = kNeg, code = pad, prev_ta = -g.gapo, best = 0;
  for (int s = 0; s < steps; ++s) {
    const int k = s - 2 * w;
    const int pass = k / period, c = k - pass * period, st = pass * ws + w;
    if (k >= 0 && st < n_strips && c < tiles) {
      if (c == 0) {
        bad |= load_rows<R, F>(a, bp.qo, bp.qlen, st * S + lane * R, qoff);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          av[r] = -g.gapo;
          ev[r] = kNeg;
        }
        psi = kNeg;
        code = pad;
        prev_ta = -g.gapo;
      }
      // lane i: the code and the top boundary of column 32 c + i, the
      // columns lane 0 takes in this tile
      const int col = c * 32 + lane;
      const int buf = col < tlen ? lut[a.rows[bp.to + col]] : pad;
      int top_a = -g.gapo, top_psi = kNeg;  // above the first strip: H = 0, no F
      if (st > 0 && col < tlen) {
        const int2 v = w > 0 ? in_ring[col & (kRingCols - 1)] : wrap[col];
        top_a = v.x;
        top_psi = v.y;
      }
      const bool pass_down = st < n_strips - 1;
#pragma unroll 1
      for (int jj = 0; jj < 32; ++jj) {
        const int ta = __shfl_up_sync(kFull, av[R - 1], 1);
        const int tp = __shfl_up_sync(kFull, psi, 1);
        const int cd = __shfl_up_sync(kFull, code, 1);
        const int c0 = __shfl_sync(kFull, buf, jj);
        const int ta0 = __shfl_sync(kFull, top_a, jj);
        const int tp0 = __shfl_sync(kFull, top_psi, jj);
        const int diag = prev_ta;
        prev_ta = lane == 0 ? ta0 : ta;
        code = lane == 0 ? c0 : cd;
        psi = cells<R, F>(table + code, diag, lane == 0 ? tp0 : tp, qoff, av, ev, best, g);
        const int j = c * 32 + jj - 31;  // the column leaving lane 31
        if (pass_down && lane == 31 && j >= 0 && j < tlen) {
          const int2 v = make_int2(av[R - 1], psi);
          if (w < ws - 1)
            out_ring[j & (kRingCols - 1)] = v;
          else
            wrap[j] = v;
        }
      }
    }
    __syncthreads();  // a tile's boundary is written before the next warp reads it
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(kFull, best, o));
  bad = __any_sync(kFull, bad);
  if (lane == 0) {
    red[wid] = best;
    red[kWarps + wid] = bad;
  }
  __syncthreads();
  if (bp.valid && w == 0 && lane == 0) {
    for (int i = 1; i < ws; ++i) {
      best = max(best, red[wid + i]);
      bad |= red[kWarps + wid + i];
    }
    a.out[bp.p] = bad ? -2 : best;
  }
}

// The rows a lane of a block-path pair may hold: kMaxR / 4, / 2 and
// kMaxR. (Rows between kMaxR / 2 and kMaxR by kRStep too made the kernel
// spill at kMinBlocks 2; PERF.md.)
__host__ __device__ constexpr int next_rows(int r) { return 2 * r; }

// The rows a lane of a lone pair's strips: the R whose strips take the
// fewest passes of the block, counted with a step's fixed cost (its
// latency: a lone pair runs on one SM).
__device__ __forceinline__ int block_rows(int qlen) {
  int best_r = kMaxR, best_cost = INT32_MAX;
  for (int r = kMaxR / 4; r <= kMaxR; r = next_rows(r)) {
    const int strips = (qlen + 32 * r - 1) / (32 * r);
    const int cost = (strips + kWarps - 1) / kWarps * (r + kRowOverhead);
    if (cost < best_cost) {
      best_cost = cost;
      best_r = r;
    }
  }
  return best_r;
}

// The fewest rows a lane whose strips fit a group of ws warps (kMaxR
// when none does: the query wraps).
__device__ __forceinline__ int group_rows(int qlen, int ws) {
  for (int r = kMaxR / 4; r < kMaxR; r = next_rows(r))
    if ((qlen + 32 * r - 1) / (32 * r) <= ws) return r;
  return kMaxR;
}

template <int R, bool F>
__device__ void block_sweep_r(int r, const Args& a, int2* ring, int* red, int* steps_sh,
                              const char* table, const int* lut, const Gaps& g, int ws,
                              const BlockPair& bp) {
  if constexpr (R >= kMaxR) {
    block_sweep<kMaxR, F>(a, ring, red, steps_sh, table, lut, g, ws, bp);
  } else {
    if (r == R)
      block_sweep<R, F>(a, ring, red, steps_sh, table, lut, g, ws, bp);
    else
      block_sweep_r<next_rows(R), F>(r, a, ring, red, steps_sh, table, lut, g, ws, bp);
  }
}

template <bool F>
__global__ void __launch_bounds__(kThreads, kMinBlocks) sw_score_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int next;
  int2* ring = reinterpret_cast<int2*>(smem);
  int* red = reinterpret_cast<int*>(smem + kRingBytes);
  int* lut = red + kRedInts;
  int* table = lut + 256;
  // table[t][bias block][q], a warp a (t, block) row: folded, sub[q][t] +
  // (lo + block) + gapo, and a last block of masks for rows past the
  // query; else block 0 holds sub[q][t] + gapo and the rest are masks.
  // Row alpha (columns past the target) is all masks.
  // the matrix is staged in the ring's memory first, in one coalesced read
  int* staged = reinterpret_cast<int*>(ring);
  for (int i = threadIdx.x; i < a.alpha * a.alpha; i += kThreads) staged[i] = a.sub[i];
  __syncthreads();
  const int q = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < (a.alpha + 1) * (kSpan + 1); row += kWarps) {
    const int t = row / (kSpan + 1), blk = row - t * (kSpan + 1);
    int v = kMask;
    if (t < a.alpha && q < a.alpha && blk < (F ? kSpan : 1))
      v = staged[q * a.alpha + t] + a.gapo + (F ? a.lo + blk : 0);
    table[t * kTStride + blk * kBStride + q] = v;
  }
  for (int i = threadIdx.x; i < 256; i += kThreads)
    lut[i] = min(static_cast<int>(a.code_lut[i]), a.alpha - 1) * kTStride * 4;
  __syncthreads();
  const char* tb = reinterpret_cast<const char*>(table);
  const Gaps g{a.gapo, a.gape, 2 * a.gapo};
  __shared__ int steps_sh[4], rows_sh[4];
  const int wid = threadIdx.x >> 5;
  for (int bc = 0; bc < kBlockClasses; ++bc) {
    const int per = 1 << bc, ws = kWarps >> bc;  // pairs a block, warps a pair
    if (ws < 1 || a.bcount[bc] == 0) continue;
    for (;;) {
      if (threadIdx.x == 0) next = atomicAdd(a.counters + bc, per);
      __syncthreads();
      const int k = next + wid / ws;
      __syncthreads();
      if (k - wid / ws >= a.bcount[bc]) break;
      BlockPair bp{k < a.bcount[bc], 0, 0, 0, 0, 0};
      if (bp.valid) {
        bp.p = a.order[a.bstart[bc] + k];
        const int qi = a.qidx[bp.p], ti = a.tidx[bp.p];
        bp.qlen = a.qlens[qi];
        bp.tlen = a.lengths[ti];
        bp.qo = a.qoffsets[qi];
        bp.to = a.offsets[ti];
        const bool outgrown = bp.qlen > kStripRows && bp.tlen > a.strip_cols;
        if (outgrown || bp.qlen == 0 || bp.tlen == 0) {
          if ((threadIdx.x & (ws * 32 - 1)) == 0) a.out[bp.p] = outgrown ? -1 : 0;
          bp.valid = false;
        }
      }
      // one R for the block: in a call that fills the card the fewest rows
      // whose strips fit every pair's group, else by the lone pair's length
      if ((threadIdx.x & (ws * 32 - 1)) == 0)
        rows_sh[wid / ws] = !bp.valid ? 0 : a.fill ? group_rows(bp.qlen, ws) : block_rows(bp.qlen);
      __syncthreads();
      int r = kMaxR / 4;
      for (int i = 0; i < per; ++i) r = max(r, rows_sh[i]);
      block_sweep_r<kMaxR / 4, F>(r, a, ring, red, steps_sh, tb, lut, g, ws, bp);
    }
  }
  warp_classes<kClasses - 1, F>(a, tb, lut, g);
}

// (SMs, blocks of the kernel's instance resident) on the current device
// with the shared memory of an alpha-letter matrix, the first time for a
// device and alpha also setting the instance's dynamic shared memory
// limit; a negative count is minus a CUDA error.
template <bool F>
int resident_blocks(int alpha, int* sms_out) {
  static int cache[kMaxDevices][kMaxAlpha + 1][2];  // SMs, resident blocks + 1
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int* c = dev < kMaxDevices ? cache[dev][alpha] : nullptr;
  if (c && c[1]) {
    *sms_out = c[0];
    return c[1] - 1;
  }
  int sms = 0, per_sm = 0;
  const int bytes = static_cast<int>(smem_bytes(alpha));
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sw_score_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sw_score_kernel<F>, kThreads,
                                                        bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (c) {
    c[0] = sms;
    c[1] = per_sm * sms + 1;
  }
  *sms_out = sms;
  return per_sm * sms;
}

template <bool F>
int launch(const Args& a, int64_t need, int alpha, cudaStream_t s) {
  int sms = 0;
  const int resident = resident_blocks<F>(alpha, &sms);
  if (resident < 0) return resident;
  if (resident == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  // as many blocks as the pairs need, but at least one an SM, so that a
  // small call spreads over the card; at most the resident blocks
  const int64_t want = need > sms ? need : sms;
  const int grid = static_cast<int>(want < resident ? want : resident);
  sw_score_kernel<F><<<grid, kThreads, smem_bytes(alpha), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The longest query of the warp path (one strip), the warp-path classes,
// the rows class c holds, a plan's values, the counters' ints and the
// warps a block.
extern "C" int sw_score_strip_rows() { return kStripRows; }
extern "C" int sw_score_classes() { return kClasses; }
extern "C" int sw_score_class_rows(int c) {
  return c >= 0 && c < kClasses ? class_lanes(c) * class_r(c) : 0;
}
extern "C" int sw_score_plan_size() { return kPlan; }
extern "C" int sw_score_counters() { return kCounters; }
extern "C" int sw_score_block_warps() { return kWarps; }

// The resident blocks of the instance a bias range of span values takes:
// the rows of the wrap scratch a launch may use; negative: a CUDA error.
extern "C" int sw_score_resident_blocks(int alpha, int span) {
  if (alpha < 1 || alpha > kMaxAlpha) return -1;
  int sms = 0;
  return span <= kSpan ? resident_blocks<true>(alpha, &sms) : resident_blocks<false>(alpha, &sms);
}

// The registers a thread, local memory bytes a thread (spills) and
// dynamic shared memory bytes a block at alpha of the instance a bias
// range of span values takes; 0 or a CUDA error.
extern "C" int sw_score_attributes(int alpha, int span, int32_t* regs, int32_t* local_bytes,
                                   int32_t* smem) {
  cudaFuncAttributes attr;
  const cudaError_t err = span <= kSpan ? cudaFuncGetAttributes(&attr, sw_score_kernel<true>)
                                        : cudaFuncGetAttributes(&attr, sw_score_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int32_t>(attr.localSizeBytes);
  *smem = static_cast<int32_t>(smem_bytes(alpha));
  return 0;
}

// qcodes uint8[TQ] (codes < alpha), qoffsets int64[NQ], qlens int32[NQ],
// bias int8[TQ]; rows uint8[T], offsets int64[N], lengths int32[N],
// code_lut uint8[256]; qidx, tidx, order int32[b]; plan, in host memory,
// int64[sw_score_plan_size()]: sw_score_strip_rows(), the least and the
// most bias of the queries, 1 when the call fills the card (a block-path
// pair's lanes hold the fewest rows whose strips fit its group) or 0 (a
// lone pair's by its length), the block-path pairs of 1, 2 and 4 pairs a
// block (a query that wraps only in the first), then the pairs of each
// warp-path class c
// (queries of up to sw_score_class_rows(c) rows), c ascending; the order
// holds the block path's pairs first, by block class, then the warp
// classes from the highest down. sub int32[alpha, alpha] with alpha <=
// 32; gap_open >= gap_extend >= 0; out int32[b]; counters
// int32[sw_score_counters()] scratch. strips holds int32[2 *
// sw_score_resident_blocks(alpha, span) * strip_cols], or is null when
// strip_cols is 0. A pair whose query is longer than sw_score_strip_rows()
// and whose target is longer than strip_cols scores -1; a pair the plan
// puts in a class its query outgrows, or whose query has a bias outside
// the plan's range, -2. Returns the launch's cudaGetLastError() (0 =
// launched), -1 for bad sizes or gaps, -2 for strip columns without their
// scratch, -3 for a plan of another kernel or other pairs, or minus a CUDA
// error of the occupancy query.
extern "C" int sw_score(const uint8_t* qcodes, const int64_t* qoffsets, const int32_t* qlens,
                        const int8_t* bias, const uint8_t* rows, const int64_t* offsets,
                        const int32_t* lengths, const uint8_t* code_lut, const int32_t* qidx,
                        const int32_t* tidx, const int32_t* order, const int64_t* plan, int64_t b,
                        const int32_t* sub, int alpha, int gap_open, int gap_extend, int32_t* out,
                        int32_t* counters, int32_t* strips, int64_t strip_cols, void* stream) {
  if (alpha < 1 || alpha > kMaxAlpha || b > INT32_MAX || gap_extend < 0 || gap_open < gap_extend ||
      strip_cols < 0)
    return -1;
  if (strip_cols > 0 && strips == nullptr) return -2;
  const int64_t lo = plan[1], hi = plan[2], fill = plan[3];
  if (plan[0] != kStripRows || lo < -128 || hi > 127 || fill < 0 || fill > 1) return -3;
  // an empty range (no query residue) folds at 0
  const bool fold = hi - lo < kSpan;
  Args a{qcodes, qoffsets, qlens, bias, rows, offsets, lengths, code_lut, qidx, tidx, order,
         sub, alpha, gap_open, gap_extend, out, counters,
         strip_cols ? reinterpret_cast<int2*>(strips) : nullptr, strip_cols,
         static_cast<int>(hi < lo ? 0 : lo), static_cast<int>(hi < lo ? 0 : hi),
         static_cast<int>(fill), {}, {}, {}, {}};
  int64_t total = 0, warps = 0;
  for (int bc = 0; bc < kBlockClasses; ++bc) {
    const int64_t n = plan[4 + bc];
    if (n < 0 || (n > 0 && (kWarps >> bc) < 1)) return -3;
    a.bstart[bc] = static_cast<int>(total);
    a.bcount[bc] = static_cast<int>(n);
    total += n;
    warps += (n + (1 << bc) - 1) / (1 << bc) * kWarps;
  }
  for (int c = kClasses - 1; c >= 0; --c) {
    const int64_t n = plan[4 + kBlockClasses + c];
    if (n < 0) return -3;
    a.start[c] = static_cast<int>(total);
    a.count[c] = static_cast<int>(n);
    total += n;
    warps += (n + 32 / class_lanes(c) - 1) / (32 / class_lanes(c));
  }
  if (total != b) return -3;
  if (b <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(counters, 0, kCounters * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t need = (warps + kWarps - 1) / kWarps;
  return fold ? launch<true>(a, need, alpha, s) : launch<false>(a, need, alpha, s);
}
