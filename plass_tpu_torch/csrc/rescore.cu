// Ungapped diagonal rescores of (qrow, trow, diag) hits on the sequence
// database's own flat byte array: three kernels, each with its own
// __global__ functions.
//
// K2, END_TO_END (--rescore-mode 3), replaces the Pallas TPU kernel
// plass_tpu/ops/pallas_rescore.py (_rescore_pairs_pallas ->
// _kernel_gathered_body + _score_and_canon + _reduce_windows, the default
// block-8 gathered variant) in three variants of one template:
//   rescore_e2e                  has_rev=False, generic matrix (protein)
//   rescore_e2e_rev, uniform 0   has_rev=True, generic matrix
//   rescore_e2e_rev, uniform 1   has_rev=True with the `fast` uniform
//                                matrix (pallas_rescore.py:74-86), the
//                                nucleotide path
// B10, HAMMING (--rescore-mode 0), replaces
// plass_tpu/ops/device_rescore.py:107-110 (mode 0 of rescore_pairs, which
// XLA ran there):
//   rescore_hamming, qrev null   forward hits (protein)
//   rescore_hamming, qrev given  with reverse hits (nucleotide)
// B12, ALIGNMENT (--rescore-mode 2), which the JAX package computes on the
// host only (plass_tpu/ops/rescore.py:71-85 and its ungapped_best,
// :155-176):
//   rescore_align, qrev null     forward hits (protein)
//   rescore_align, qrev given    with reverse hits; uniform selects the
//                                uniform-matrix scoring (nucleotide)
//
// Operands: rows uint8[total] holds every sequence back to back (record
// terminators included, never scored); row r is the lengths[r] bytes from
// rows[offsets[r]]. A residue's char is its byte, its code
// code_lut[byte]. There is no padded [N, W] copy of the database. A
// reverse hit (qrev) reads the query back to front and complemented
// (rescorediagonal.cpp:173-179): code comp[q[qlen-1-(qoff+j)]], and its
// char is that code's canonical char code2char[code], not the raw byte.
//
// END_TO_END, per hit, over the overlap window of length ov
// (pallas_rescore.py:150-171):
//   s[j]  = sub[q[qoff + j], t[toff + j]]
//   first = 1 if either char at j = 0 is '*', else 0
//   last  = ov - 1, less 1 if either char there is '*' (and ov - 1 > 0)
//   score = max(0, sum s[first..last]); idents counts case-folded char
//   matches over the same window; ov <= 0 gives score 0, first = last = -1.
// The uniform variant scores (q == t && q != X) ? match : mismatch instead
// of looking the matrix up.
//
// What bounds all three on Hopper: not the bytes. A call moves tens of MB
// (the rows once, ~30 B per hit), about 0.01 ms of HBM time at 3.35 TB/s,
// and the rows of a read-sized database stay in the 50 MB L2. What costs is
// the chain hit -> row offset and length -> window bytes, and then the
// instructions each residue takes, issued by lanes of which a warp's
// slowest sets the pace. The TPU kernel streamed whole padded rows into
// VMEM and rolled the window to lane 0; nothing of that layout is kept.
//
// K2:
//   * a lane per hit first: the 32 lanes of a warp load 32 hits' (q, t,
//     diag, rev) coalesced, then the two rows' (offset, length), and
//     derive the window; three trips for 32 hits, before any row byte;
//   * then kGroup lanes per hit: a lane scores 16 window bytes per step
//     from five aligned 4-byte words per side, funnel-shifted to the
//     window's own alignment (row starts in the flat array are arbitrary),
//     all ten loads started before the first is used. Word loads that would
//     leave [0, total) are replaced by guarded byte loads. Two lanes per
//     hit measured best on read- and ORF-sized windows (8, 4, 2 and 1 were
//     tried);
//   * a reverse hit loads the covering words ascending and mirrors the 16
//     bytes in registers (__byte_perm); its code and char come from a
//     shared-memory table byte -> (matrix row, char) per strand, filled per
//     block from code_lut, comp and code2char; in the uniform variant the
//     table holds the code itself, with X replaced by a value that matches
//     nothing, and the score is mismatch * n + (match - mismatch) * equal;
//   * the '*' tests read the window bytes already in registers: every
//     residue is scored alike, and the lane that holds j = 0 (or j = ov-1)
//     takes that residue out again and raises a bit in the packed identity
//     count when it is a '*';
//   * windows longer than kLongWindow would serialise a lane group while
//     its neighbours idle, so the first pass queues them on the device
//     (one atomicAdd per warp) and a second pass gives each a whole warp,
//     512 bytes per step. No host round trip: the second pass reads the
//     queue's length on the device. B10 and B12 queue theirs the same way.
//
// B10, HAMMING: the count of identical raw chars over the whole overlap
// window (no case folding, no '*' skip) as both score and idents, first =
// last = -1; ov <= 0 gives (0, -1, -1, 0). An earlier design ran K2's
// template, which looks every query byte up in a table and compares a
// byte at a time, though a forward hit needs no table. Here the 16 bytes a
// lane loads per side are compared four at a time (x = q ^ t; a zero byte
// of x is an equal pair: ~(((x & 0x7f7f7f7f) + 0x7f7f7f7f) | x |
// 0x7f7f7f7f) keeps the high bit of each, and __popc counts them), the last
// chunk's bytes past the window masked off; a reverse hit first maps its
// 16 mirrored query bytes through a 256-byte shared table byte -> the
// canonical char of the complemented code. kHamGroup lanes count a hit
// in turns, as K2's kGroup do, each a contiguous piece of whole chunks; 2
// measured best (1 and 4 were tried; 1 up to 22% slower), and 16-byte
// vector loads of the rows were no faster. The work a residue is now
// small, so the hit -> row -> window chain and the launches bound it.
//
// B12, ALIGNMENT: the best local ungapped segment of each window. With
// c[p] the running sum of s[0..p] and c[-1] = 0, the host's loop (score +=
// s; score <= 0 resets it and sets min_pos = p; a strictly greater score
// sets the maximum, its end p and its start min_pos + 1) is
//   score_p = c[p] - min c[-1..p], the minimum taken at its LATEST index,
//   end     = the FIRST p with the largest score_p (strict >),
//   start   = that p's minimum index + 1,
// and a window whose scores never exceed 0 gives (0, 0, 0). '*' is scored
// like any residue (the host scores mode 2 through the matrix on the raw
// chars and skips nothing). idents counts case-folded equal chars over
// [start, end]; ov <= 0 gives (0, -1, -1, 0), no positive score (0, 0, 0,
// 0). Candidates (C12): the host's hits keep only a diagonal's low 16 bits
// u16, and its ungapped_best scores every diagonal that shares them and
// overlaps the rows, in this order: -k * 65536 + u16 for k = 1 ... 1 +
// tlen / 32768, then k * 65536 + u16 for k = 0 ... qlen / 65536; the first
// strictly greater score wins, and the record reports the winner's
// diagonal. B12 writes it as a fifth output; where no candidate scores
// above 0 it keeps the hit's own diagonal and outputs (the host drops such
// a hit, and so does the port's rescore). A second candidate overlaps only
// when qlen + tlen > 65536, so only such hits take the candidates, in the
// long pass.
// An earlier design scanned each window by one lane in the hits' own
// order, keeping four running values a residue, and counted the
// identities in a second load of [start, end]; a warp waited for its
// longest window. What this design does about each:
//   * a block sorts its 256 hits by the window's 16-byte chunks (a
//     counting sort in shared memory), so that a warp's lanes
//     scan windows of one length and finish together; results go back to
//     the hits' order through shared memory and leave coalesced;
//   * the identities ride in the scan: the count at the last reset and at
//     the best end give idents = I[end] - I[start - 1], so nothing is
//     loaded twice;
//   * a lane that scans a whole window keeps only the host's running
//     score, its last reset and the best (no sum, no maximum prefix:
//     nothing folds it); a position and the identity count there share a
//     register, so a reset costs one add and one select, a new best two
//     and one; the reset and the strict maximum are each one DPX
//     instruction with its predicate (__vibmax_s32); full chunks skip the
//     window-end test;
//   * windows over kLongWindow, and hits with candidates, take the long
//     pass: a warp a window, cut into 32 contiguous pieces whose summaries
//     (sum; least prefix with its latest index; greatest prefix with its
//     first index; the best segment that starts inside; each with its
//     identity count) fold left to right in a shuffle tree that keeps both
//     tie rules; for each candidate in the host's order, keeping the
//     first strictly greater score. Its blocks leave at once when the
//     queue is empty.
// Tried and measured slower or no faster (PERF.md): the hits left
// unsorted, teams of 2, 4 and 8 lanes a window folding contiguous pieces,
// two windows a lane scanned side by side, more blocks an SM through fewer
// registers, 16-byte vector loads of the rows, and a single launch whose
// blocks took their own long windows (no queue, but a block with many
// long windows held its SM).
// PERF.md has the times and the share of the bound reached.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxAlpha = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kGroup = 2;                      // K2: lanes per hit, first pass
constexpr int kGroupsPerWarp = 32 / kGroup;    // K2: hits per warp and round
constexpr int kHamGroup = 2;                   // B10: lanes per hit, first pass
constexpr int kChunk = 16;                     // bytes a lane scores per step
constexpr int kLongWindow = 512;               // longer windows: second pass
constexpr int kLongBlocks = 132 * 4;           // second pass: warps stride the queue
constexpr int kWrap = 1 << 16;                 // B12: candidates this far apart
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kStar = '*';
constexpr uint32_t kFold = 0xDF;  // ~0x20: case-folded identity
// the identity count is below 2^18; two bits above it carry the '*' tests
constexpr int kStarFirst = 1 << 24;
constexpr int kStarLast = 1 << 25;
constexpr int kIdentMask = kStarFirst - 1;

struct Args {
  const uint8_t* rows;
  int64_t total;
  const int64_t* offsets;
  const int32_t* lengths;
  const uint8_t* code_lut;
  const int32_t* qrow;
  const int32_t* trow;
  const int32_t* diag;
  const uint8_t* qrev;
  const int32_t* sub;
  const int32_t* comp;
  const uint8_t* code2char;
  int alpha;
  int match;
  int mismatch;
  int64_t h;
  int32_t* score;
  int32_t* first;
  int32_t* last;
  int32_t* idents;
  int32_t* queue;     // [0] number of queued long hits, [1..] their indices
  int32_t* diag_out;  // B12: the winning diagonal
};

struct Tables {
  int32_t sub[kMaxAlpha * kMaxAlpha];
  // [256 * reverse + byte] -> key | char << 16. The key is the code's row
  // offset code * alpha into sub; in the uniform variant it is the code
  // itself, or kNoMatch for X, which equals no target code.
  uint32_t query[512];
  uint8_t lut[256];  // byte -> code
};
constexpr uint32_t kNoMatch = 0xff;

// Codes are clamped to the alphabet so that no table index leaves shared
// memory whatever the operands hold.
template <bool kRev, bool kUniform>
__device__ __forceinline__ void load_tables(const Args& a, Tables& tb) {
  const uint32_t top = a.alpha - 1;
  if (!kUniform)
    for (int i = threadIdx.x; i < a.alpha * a.alpha; i += blockDim.x) tb.sub[i] = a.sub[i];
  for (int i = threadIdx.x; i < (kRev ? 512 : 256); i += blockDim.x) {
    const uint32_t byte = i & 255;
    uint32_t code = min(static_cast<uint32_t>(a.code_lut[byte]), top);
    uint32_t ch = byte;
    if (i < 256) tb.lut[i] = code;
    if (kRev && i >= 256) {  // the reverse strand: complemented, canonical char
      code = min(static_cast<uint32_t>(a.comp[code]), top);
      ch = a.code2char[code];
    }
    const uint32_t key = kUniform ? (code == top ? kNoMatch : code) : code * a.alpha;
    tb.query[i] = key | (ch << 16);
  }
  __syncthreads();
}

// The window of one hit: ov residues, the target's from rows[taddr]
// ascending, the query's from rows[qaddr] ascending (descending when rv).
struct Window {
  int64_t qaddr;
  int64_t taddr;
  int ov;
  bool rv;
};

// The window on diagonal d of rows qlen and tlen long, starting at
// rows[qo] and rows[to].
__device__ __forceinline__ Window window_at(int d, int qlen, int tlen, int64_t qo, int64_t to,
                                            bool rv) {
  Window w;
  w.rv = rv;
  const int dist = d >= 0 ? d : -d;
  const bool pos_ok = d >= 0 ? dist < qlen : dist < tlen;
  w.ov = pos_ok ? (d >= 0 ? min(tlen, qlen - dist) : min(tlen - dist, qlen)) : 0;
  const int qoff = d >= 0 ? dist : 0;
  w.qaddr = w.rv ? qo + qlen - 1 - qoff : qo + qoff;
  w.taddr = to + (d >= 0 ? 0 : dist);
  return w;
}

template <bool kRev>
__device__ __forceinline__ Window window_of(const Args& a, int64_t hit) {
  const int q = a.qrow[hit];
  const int t = a.trow[hit];
  const int d = a.diag[hit];
  const bool rv = kRev && a.qrev[hit] != 0;
  const int qlen = a.lengths[q];
  const int tlen = a.lengths[t];
  const int64_t qo = a.offsets[q];
  const int64_t to = a.offsets[t];
  return window_at(d, qlen, tlen, qo, to, rv);
}

// The aligned 4-byte word `wi` of rows; bytes outside [0, total) read as 0.
__device__ __forceinline__ uint32_t guarded_word(const uint8_t* rows, int64_t total,
                                                 int64_t wi) {
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t b = wi * 4 + i;
    if (b >= 0 && b < total) v |= static_cast<uint32_t>(rows[b]) << (8 * i);
  }
  return v;
}

// The 16 bytes rows[addr .. addr+16) as four little-endian words, from the
// five aligned words that cover them. addr may be negative or near the end:
// only bytes inside [0, total) are read.
__device__ __forceinline__ void load16(const uint8_t* rows, int64_t total, int64_t addr,
                                       uint32_t (&w)[4]) {
  const int64_t wi = addr >> 2;
  const uint32_t shift = (static_cast<uint32_t>(addr) & 3u) * 8u;
  uint32_t x[5];
  if (wi >= 0 && (wi + 5) * 4 <= total) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(rows) + wi;
#pragma unroll
    for (int i = 0; i < 5; ++i) x[i] = __ldg(p + i);
  } else {
#pragma unroll
    for (int i = 0; i < 5; ++i) x[i] = guarded_word(rows, total, wi + i);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = __funnelshift_r(x[i], x[i + 1], shift);
}

// One residue pair: the query byte through its strand's table, the target
// byte through lut. Returns the score; idm says whether the chars are
// equal case-folded, star whether either is '*'.
template <bool kUniform>
__device__ __forceinline__ int score_pair(const Args& a, const Tables& tb,
                                          const uint32_t* qtab, uint32_t qb, uint32_t tch,
                                          bool& idm, bool& star) {
  const uint32_t e = qtab[qb];
  const uint32_t qch = e >> 16;
  const uint32_t key = e & 0xffffu;
  const uint32_t tcode = tb.lut[tch];
  idm = ((qch ^ tch) & kFold) == 0;
  star = qch == kStar || tch == kStar;
  if (kUniform) return key == tcode ? a.match : a.mismatch;
  return tb.sub[key + tcode];
}

__device__ __forceinline__ uint32_t byte_at(const uint32_t (&w)[4], int k) {
  const uint32_t word = k < 8 ? (k < 4 ? w[0] : w[1]) : (k < 12 ? w[2] : w[3]);
  return (word >> (8 * (k & 3))) & 0xffu;
}

// The window bytes j0 .. j0+15 of both sides as four words each, byte k
// the residue j0 + k; a reverse hit's query bytes are loaded ascending and
// mirrored in registers.
template <bool kRev>
__device__ __forceinline__ void load_chunk(const Args& a, const Window& w, bool rv, int j0,
                                           uint32_t (&qw)[4], uint32_t (&tw)[4]) {
  load16(a.rows, a.total, rv ? w.qaddr - j0 - (kChunk - 1) : w.qaddr + j0, qw);
  load16(a.rows, a.total, w.taddr + j0, tw);
  if (kRev && rv) {  // mirror the 16 bytes: byte k becomes the query's j0 + k
    const uint32_t m0 = __byte_perm(qw[3], 0, 0x0123);
    const uint32_t m1 = __byte_perm(qw[2], 0, 0x0123);
    const uint32_t m2 = __byte_perm(qw[1], 0, 0x0123);
    const uint32_t m3 = __byte_perm(qw[0], 0, 0x0123);
    qw[0] = m0;
    qw[1] = m1;
    qw[2] = m2;
    qw[3] = m3;
  }
}

// Queue the warp's hits with is_long for the second pass: one atomicAdd a
// warp.
__device__ __forceinline__ void queue_long(const Args& a, bool is_long, int64_t hit, int lane) {
  const unsigned long_mask = __ballot_sync(kFull, is_long);
  if (long_mask) {
    int slot = 0;
    if (lane == 0) slot = atomicAdd(a.queue, __popc(long_mask));
    slot = __shfl_sync(kFull, slot, 0);
    if (is_long)
      a.queue[1 + slot + __popc(long_mask & ((1u << lane) - 1u))] = static_cast<int32_t>(hit);
  }
}

// ---------------------------------------------------------------------------
// K2: END_TO_END

// A team of team_size lanes scores one window, 16 bytes per lane and step.
// s gets the lane's share of the score sum; pk its share of the identity
// count plus kStarFirst / kStarLast where it met a '*' at j = 0 / j = ov-1.
// The residues at j = 0 and j = ov-1 are scored with the rest and taken
// out again by the lane that holds them when they are '*'.
template <bool kRev, bool kUniform>
__device__ __forceinline__ void score_window(const Args& a, const Tables& tb, const Window& w,
                                             int team_lane, int team_size, int& s, int& pk) {
  const bool rv = kRev && w.rv;
  const uint32_t* qtab = tb.query + (rv ? 256 : 0);
  const int last_j = w.ov - 1;
  for (int j0 = team_lane * kChunk; j0 < w.ov; j0 += team_size * kChunk) {
    uint32_t qw[4], tw[4];
    load_chunk<kRev>(a, w, rv, j0, qw, tw);
    const int n_in = min(kChunk, w.ov - j0);  // window residues in this chunk
    int hits = 0;  // uniform variant: matching pairs
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const uint32_t qb = (qw[k >> 2] >> (8 * (k & 3))) & 0xffu;
      const uint32_t tch = (tw[k >> 2] >> (8 * (k & 3))) & 0xffu;
      const uint32_t e = qtab[qb];
      const bool in = k < n_in;
      const uint32_t tcode = tb.lut[tch];
      if (kUniform)
        hits += (in && (e & 0xffffu) == tcode) ? 1 : 0;
      else
        s += in ? tb.sub[(e & 0xffffu) + tcode] : 0;
      pk += (in && (((e >> 16) ^ tch) & kFold) == 0) ? 1 : 0;
    }
    if (kUniform) s += a.mismatch * n_in + (a.match - a.mismatch) * hits;
    bool idm, star;
    if (j0 == 0) {
      const int sc = score_pair<kUniform>(a, tb, qtab, qw[0] & 0xffu, tw[0] & 0xffu, idm, star);
      if (star) {
        s -= sc;
        pk += kStarFirst - (idm ? 1 : 0);
      }
    }
    if (last_j > 0 && last_j >= j0 && last_j < j0 + kChunk) {
      const int k = last_j - j0;
      const int sc =
          score_pair<kUniform>(a, tb, qtab, byte_at(qw, k), byte_at(tw, k), idm, star);
      if (star) {
        s -= sc;
        pk += kStarLast - (idm ? 1 : 0);
      }
    }
  }
}

__device__ __forceinline__ void store_hit(const Args& a, int64_t hit, int ov, int s, int pk) {
  if (ov <= 0) {
    a.score[hit] = 0;
    a.first[hit] = -1;
    a.last[hit] = -1;
    a.idents[hit] = 0;
    return;
  }
  a.score[hit] = max(s, 0);
  a.first[hit] = (pk & kStarFirst) ? 1 : 0;
  a.last[hit] = ov - 1 - ((pk & kStarLast) ? 1 : 0);
  a.idents[hit] = pk & kIdentMask;
}

// kLongPass = false: 32 hits per warp, windows up to kLongWindow scored by
// kGroup-lane groups, longer ones queued. kLongPass = true: a warp per
// queued hit.
template <bool kRev, bool kUniform, bool kLongPass>
__global__ void __launch_bounds__(kThreads) rescore_e2e_kernel(const Args a) {
  __shared__ Tables tb;
  load_tables<kRev, kUniform>(a, tb);
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);

  if constexpr (kLongPass) {
    const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
    const int64_t count = a.queue[0];
    for (int64_t i = warp; i < count; i += n_warps) {
      const int64_t hit = a.queue[1 + i];
      const Window w = window_of<kRev>(a, hit);
      int s = 0, pk = 0;
      score_window<kRev, kUniform>(a, tb, w, lane, 32, s, pk);
      __syncwarp();
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(kFull, s, o);
        pk += __shfl_xor_sync(kFull, pk, o);
      }
      if (lane == 0) store_hit(a, hit, w.ov, s, pk);
    }
  } else {
    const int64_t hit = warp * 32 + lane;
    const bool valid = hit < a.h;
    Window mine{0, 0, 0, false};
    if (valid) mine = window_of<kRev>(a, hit);
    const bool is_long = mine.ov > kLongWindow;
    const int short_ov = is_long ? 0 : mine.ov;
    const int group = lane / kGroup;
    int my_s = 0, my_pk = 0;
#pragma unroll 1
    for (int r = 0; r < 32 / kGroupsPerWarp; ++r) {
      // group g scores the hit of lane r * kGroupsPerWarp + g
      const int src = r * kGroupsPerWarp + group;
      Window w;
      w.ov = __shfl_sync(kFull, short_ov, src);
      w.qaddr = __shfl_sync(kFull, mine.qaddr, src);
      w.taddr = __shfl_sync(kFull, mine.taddr, src);
      w.rv = __shfl_sync(kFull, static_cast<int>(mine.rv), src) != 0;
      int s = 0, pk = 0;
      score_window<kRev, kUniform>(a, tb, w, lane % kGroup, kGroup, s, pk);
      __syncwarp();
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1) {
        s += __shfl_xor_sync(kFull, s, o);
        pk += __shfl_xor_sync(kFull, pk, o);
      }
      // hand the sums to the lane that owns the hit
      const int owner_group = (lane % kGroupsPerWarp) * kGroup;
      const int s_r = __shfl_sync(kFull, s, owner_group);
      const int pk_r = __shfl_sync(kFull, pk, owner_group);
      if (lane / kGroupsPerWarp == r) {
        my_s = s_r;
        my_pk = pk_r;
      }
    }
    queue_long(a, is_long, hit, lane);
    if (valid && !is_long) store_hit(a, hit, mine.ov, my_s, my_pk);
  }
}

// ---------------------------------------------------------------------------
// B10: HAMMING

// Equal bytes among the first n_in of the 16 pairs (n_in may exceed 16).
__device__ __forceinline__ int equal_bytes(const uint32_t (&qw)[4], const uint32_t (&tw)[4],
                                           int n_in) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = qw[i] ^ tw[i];
    // the high bit of each zero byte of x, that is of each equal pair
    uint32_t z = ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x | 0x7f7f7f7fu);
    const int valid = n_in - 4 * i;  // pairs of this word inside the window
    if (valid < 4) z &= valid <= 0 ? 0u : 0xffffffffu >> (32 - 8 * valid);
    n += __popc(z);
  }
  return n;
}

// The four bytes of w through the byte table tab.
__device__ __forceinline__ uint32_t map4(const uint8_t* tab, uint32_t w) {
  return static_cast<uint32_t>(tab[w & 0xffu]) | static_cast<uint32_t>(tab[(w >> 8) & 0xffu]) << 8 |
         static_cast<uint32_t>(tab[(w >> 16) & 0xffu]) << 16 |
         static_cast<uint32_t>(tab[w >> 24]) << 24;
}

// A team of team_size lanes counts one window's equal raw chars, 16 pairs
// per lane and step; rchar maps a reverse hit's query byte to its char.
template <bool kRev>
__device__ __forceinline__ int hamming_window(const Args& a, const uint8_t* rchar,
                                              const Window& w, int team_lane, int team_size) {
  // contiguous pieces of whole chunks, one a lane
  const int per = ((w.ov + kChunk - 1) / kChunk + team_size - 1) / team_size * kChunk;
  const int lo = min(team_lane * per, w.ov);
  const int hi = min(lo + per, w.ov);
  const bool rv = kRev && w.rv;
  int n = 0;
  for (int j0 = lo; j0 < hi; j0 += kChunk) {
    uint32_t qw[4], tw[4];
    load_chunk<kRev>(a, w, rv, j0, qw, tw);
    if (kRev && rv) {
#pragma unroll
      for (int i = 0; i < 4; ++i) qw[i] = map4(rchar, qw[i]);
    }
    n += equal_bytes(qw, tw, hi - j0);
  }
  return n;
}

__device__ __forceinline__ void store_hamming(const Args& a, int64_t hit, int ov, int n) {
  a.score[hit] = ov <= 0 ? 0 : n;
  a.first[hit] = -1;
  a.last[hit] = -1;
  a.idents[hit] = ov <= 0 ? 0 : n;
}

// kLongPass = false: 32 hits per warp, windows up to kLongWindow counted
// by kHamGroup-lane teams in turns, longer ones queued. kLongPass = true:
// a warp per queued hit.
template <bool kRev, bool kLongPass>
__global__ void __launch_bounds__(kThreads) rescore_hamming_kernel(const Args a) {
  constexpr int kTeams = 32 / kHamGroup;  // hits per warp and round
  __shared__ uint8_t rchar[kRev ? 256 : 1];
  if (kLongPass && static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock >= a.queue[0]) return;
  if constexpr (kRev) {  // byte -> canonical char of its complemented code
    const uint32_t top = a.alpha - 1;
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      const uint32_t code = min(static_cast<uint32_t>(a.code_lut[i]), top);
      rchar[i] = a.code2char[min(static_cast<uint32_t>(a.comp[code]), top)];
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);

  if constexpr (kLongPass) {
    const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
    const int64_t count = a.queue[0];
    for (int64_t i = warp; i < count; i += n_warps) {
      const int64_t hit = a.queue[1 + i];
      const Window w = window_of<kRev>(a, hit);
      int n = hamming_window<kRev>(a, rchar, w, lane, 32);
      __syncwarp();
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
      if (lane == 0) store_hamming(a, hit, w.ov, n);
    }
  } else {
    const int64_t hit = warp * 32 + lane;
    const bool valid = hit < a.h;
    Window mine{0, 0, 0, false};
    if (valid) mine = window_of<kRev>(a, hit);
    const bool is_long = mine.ov > kLongWindow;
    const int short_ov = is_long ? 0 : mine.ov;
    int n = 0;
#pragma unroll 1
    for (int r = 0; r < kHamGroup; ++r) {
      // team g counts the hit of lane r * kTeams + g
      const int src = r * kTeams + lane / kHamGroup;
      Window w;
      w.ov = __shfl_sync(kFull, short_ov, src);
      w.qaddr = __shfl_sync(kFull, mine.qaddr, src);
      w.taddr = __shfl_sync(kFull, mine.taddr, src);
      w.rv = __shfl_sync(kFull, static_cast<int>(mine.rv), src) != 0;
      int team_n = hamming_window<kRev>(a, rchar, w, lane % kHamGroup, kHamGroup);
      __syncwarp();
#pragma unroll
      for (int o = kHamGroup / 2; o > 0; o >>= 1) team_n += __shfl_xor_sync(kFull, team_n, o);
      // hand the count to the lane that owns the hit
      const int n_r = __shfl_sync(kFull, team_n, (lane % kTeams) * kHamGroup);
      if (lane / kTeams == r) n = n_r;
    }
    queue_long(a, is_long, hit, lane);
    if (valid && !is_long) store_hamming(a, hit, mine.ov, n);
  }
}

// ---------------------------------------------------------------------------
// B12: ALIGNMENT

// The summary of the window residues [lo, hi), positions window-relative;
// identities count case-folded equal chars.
struct AlignSum {
  int sum, isum;              // s[lo] + ... + s[hi-1]; identities over [lo, hi)
  int mn, mn_at, imn;         // least prefix sum, the left edge (0 at lo-1) included,
                              // its latest index, identities over [lo, mn_at]
  int mx, mx_at, imx;         // greatest prefix sum over [lo, hi), its first index
                              // (kNegInf if empty), identities over [lo, mx_at]
  int best, start, end, bid;  // best segment that starts at lo or later, its first
                              // end, its identities; 0, 0, 0, 0 if none
};
constexpr int kNegInf = -(1 << 30);

// One residue pair of a chunk: its score s and its case-folded identity.
template <bool kUniform>
__device__ __forceinline__ int align_pair(const Args& a, const Tables& tb, const uint32_t* qtab,
                                          const uint32_t (&qw)[4], const uint32_t (&tw)[4],
                                          int k, int& eq) {
  const uint32_t qb = (qw[k >> 2] >> (8 * (k & 3))) & 0xffu;
  const uint32_t tch = (tw[k >> 2] >> (8 * (k & 3))) & 0xffu;
  const uint32_t e = qtab[qb];
  const uint32_t tcode = tb.lut[tch];
  eq = (((e >> 16) ^ tch) & kFold) == 0 ? 1 : 0;
  if (kUniform) return (e & 0xffffu) == tcode ? a.match : a.mismatch;
  return tb.sub[(e & 0xffffu) + tcode];
}

// The host's loop over the residues [j0, j0 + 16) of the chunk (qw, tw),
// the first n_in of them (all 16 unless kTail), into the summary r of a
// piece: score is the running score, ic the identities since the piece's
// start.
template <bool kUniform, bool kTail>
__device__ __forceinline__ void align_chunk(const Args& a, const Tables& tb, const uint32_t* qtab,
                                            const uint32_t (&qw)[4], const uint32_t (&tw)[4],
                                            int j0, int n_in, int& score, int& ic, AlignSum& r) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (kTail && k >= n_in) break;
    int eq;
    const int s = align_pair<kUniform>(a, tb, qtab, qw, tw, k, eq);
    ic += eq;
    const int p = j0 + k;
    r.sum += s;
    if (r.sum > r.mx) {  // strict: the first index keeps a tie
      r.mx = r.sum;
      r.mx_at = p;
      r.imx = ic;
    }
    bool reset, keep;
    score = __vibmax_s32(0, score + s, &reset);  // reset: score + s <= 0
    if (reset) {  // the running score resets: a new minimum, latest on ties
      r.mn_at = p;
      r.imn = ic;
    }
    r.best = __vibmax_s32(r.best, score, &keep);  // keep: best >= score
    if (!keep) {  // strict: the first end keeps a tie
      r.start = r.mn_at + 1;
      r.end = p;
      r.bid = ic - r.imn;
    }
  }
}

// The summary of the window residues [lo, hi): one lane, 16 bytes a load.
template <bool kRev, bool kUniform>
__device__ AlignSum align_scan(const Args& a, const Tables& tb, const Window& w, int lo, int hi) {
  const bool rv = kRev && w.rv;
  const uint32_t* qtab = tb.query + (rv ? 256 : 0);
  AlignSum r{0, 0, 0, lo - 1, 0, kNegInf, lo, 0, 0, 0, 0, 0};
  int score = 0, ic = 0;
  int j0 = lo;
  for (; j0 + kChunk <= hi; j0 += kChunk) {
    uint32_t qw[4], tw[4];
    load_chunk<kRev>(a, w, rv, j0, qw, tw);
    align_chunk<kUniform, false>(a, tb, qtab, qw, tw, j0, kChunk, score, ic, r);
  }
  if (j0 < hi) {
    uint32_t qw[4], tw[4];
    load_chunk<kRev>(a, w, rv, j0, qw, tw);
    align_chunk<kUniform, true>(a, tb, qtab, qw, tw, j0, hi - j0, score, ic, r);
  }
  r.isum = ic;
  r.mn = r.sum - score;
  return r;
}

// The first pass's form of the host's loop, for windows of at most
// kLongWindow residues: only the running score, its last reset and the
// best, with no sum and no greatest prefix (nothing folds this summary). A
// position and the identity count there, both below 2^16, ride in one
// register as (position << 16) | identities: at_min for the last reset
// (its index + 1, the start it gives), at_start and at_end for the best.
struct AlignShort {
  int score = 0, ic = 0, best = 0;
  uint32_t at_min = 0, at_start = 0, at_end = 0;  // the left edge: index -1, no identity
};

// The residues [j0, j0 + 16) of the chunk (qw, tw), the first n_in of
// them (all 16 unless kTail).
template <bool kUniform, bool kTail>
__device__ __forceinline__ void align_short_chunk(const Args& a, const Tables& tb,
                                                  const uint32_t* qtab, const uint32_t (&qw)[4],
                                                  const uint32_t (&tw)[4], int j0, int n_in,
                                                  AlignShort& r) {
  const uint32_t at_j0 = static_cast<uint32_t>(j0) << 16;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (kTail && k >= n_in) break;
    int eq;
    const int s = align_pair<kUniform>(a, tb, qtab, qw, tw, k, eq);
    r.ic += eq;
    bool reset, keep;
    r.score = __vibmax_s32(0, r.score + s, &reset);  // reset: score + s <= 0
    if (reset) r.at_min = at_j0 + (static_cast<uint32_t>(k + 1) << 16) + r.ic;
    r.best = __vibmax_s32(r.best, r.score, &keep);  // keep: best >= score
    if (!keep) {  // strict: the first end keeps a tie
      r.at_start = r.at_min;
      r.at_end = at_j0 + (static_cast<uint32_t>(k) << 16) + r.ic;
    }
  }
}

// The best segment of the whole window w: its score, start, end and
// identities.
template <bool kRev, bool kUniform>
__device__ __forceinline__ void align_short(const Args& a, const Tables& tb, const Window& w,
                                            int& best, int& start, int& end, int& bid) {
  const bool rv = kRev && w.rv;
  const uint32_t* qtab = tb.query + (rv ? 256 : 0);
  AlignShort r;
  int j0 = 0;
  for (; j0 + kChunk <= w.ov; j0 += kChunk) {
    uint32_t qw[4], tw[4];
    load_chunk<kRev>(a, w, rv, j0, qw, tw);
    align_short_chunk<kUniform, false>(a, tb, qtab, qw, tw, j0, kChunk, r);
  }
  if (j0 < w.ov) {
    uint32_t qw[4], tw[4];
    load_chunk<kRev>(a, w, rv, j0, qw, tw);
    align_short_chunk<kUniform, true>(a, tb, qtab, qw, tw, j0, w.ov - j0, r);
  }
  best = r.best;
  start = r.at_start >> 16;
  end = r.at_end >> 16;
  bid = static_cast<int>(r.at_end & 0xffffu) - static_cast<int>(r.at_start & 0xffffu);
}

// The summary of [lo, mid) followed by [mid, hi). A segment ending in the
// right piece starts in the left piece (at the left piece's minimum + 1,
// score L.sum + R.mx - L.mn at R.mx_at) or in the right piece (R.best at
// R.end): the larger wins, and on equal scores the earlier end, the right
// piece's own start at an equal end (its minimum is the later one). The
// left piece's best wins every tie, as it ends first. Identities add up as
// the sums do.
__device__ __forceinline__ AlignSum combine_align(const AlignSum& l, const AlignSum& r) {
  AlignSum c;
  c.sum = l.sum + r.sum;
  c.isum = l.isum + r.isum;
  const bool right_min = l.sum + r.mn <= l.mn;
  c.mn = right_min ? l.sum + r.mn : l.mn;
  c.mn_at = right_min ? r.mn_at : l.mn_at;
  c.imn = right_min ? l.isum + r.imn : l.imn;
  const bool right_max = r.mx != kNegInf && l.sum + r.mx > l.mx;
  c.mx = right_max ? l.sum + r.mx : l.mx;
  c.mx_at = right_max ? r.mx_at : l.mx_at;
  c.imx = right_max ? l.isum + r.imx : l.imx;
  const int across = r.mx == kNegInf ? kNegInf : l.sum + r.mx - l.mn;
  const bool take_across = across > r.best || (across == r.best && r.mx_at < r.end);
  int best = take_across ? across : r.best;
  int start = take_across ? l.mn_at + 1 : r.start;
  int end = take_across ? r.mx_at : r.end;
  int bid = take_across ? l.isum + r.imx - l.imn : r.bid;
  if (l.best >= best) {
    best = l.best;
    start = l.start;
    end = l.end;
    bid = l.bid;
  }
  c.best = best;
  c.start = start;
  c.end = end;
  c.bid = bid;
  return c;
}

__device__ __forceinline__ AlignSum shfl_down_align(const AlignSum& x, int o) {
  AlignSum y;
  y.sum = __shfl_down_sync(kFull, x.sum, o);
  y.isum = __shfl_down_sync(kFull, x.isum, o);
  y.mn = __shfl_down_sync(kFull, x.mn, o);
  y.mn_at = __shfl_down_sync(kFull, x.mn_at, o);
  y.imn = __shfl_down_sync(kFull, x.imn, o);
  y.mx = __shfl_down_sync(kFull, x.mx, o);
  y.mx_at = __shfl_down_sync(kFull, x.mx_at, o);
  y.imx = __shfl_down_sync(kFull, x.imx, o);
  y.best = __shfl_down_sync(kFull, x.best, o);
  y.start = __shfl_down_sync(kFull, x.start, o);
  y.end = __shfl_down_sync(kFull, x.end, o);
  y.bid = __shfl_down_sync(kFull, x.bid, o);
  return y;
}

__device__ __forceinline__ void store_align(const Args& a, int64_t hit, int ov, int best,
                                            int start, int end, int bid, int d) {
  a.score[hit] = best;
  a.first[hit] = ov <= 0 ? -1 : start;
  a.last[hit] = ov <= 0 ? -1 : end;
  a.idents[hit] = bid;
  a.diag_out[hit] = d;
}

// A warp scores one queued hit, a long window or one with candidates: for
// each candidate diagonal in the host's order, the window's 32 contiguous
// pieces, a lane each, folded left to right in a shuffle tree; the first
// strictly greater score wins.
template <bool kRev, bool kUniform>
__device__ void align_long(const Args& a, const Tables& tb, int64_t hit, int lane) {
  const int q = a.qrow[hit];
  const int t = a.trow[hit];
  const int d = a.diag[hit];
  const bool rv = kRev && a.qrev[hit] != 0;
  const int qlen = a.lengths[q];
  const int tlen = a.lengths[t];
  const int64_t qo = a.offsets[q];
  const int64_t to = a.offsets[t];
  // the host's candidates: -k * kWrap + u16 for k = 1 .. n_neg, then
  // k * kWrap + u16 for k = 0 .. n_pos - 1; those that overlap
  const int64_t u16 = static_cast<uint32_t>(d) & (kWrap - 1);
  const int n_neg = 1 + tlen / (kWrap / 2);
  const int n_pos = 1 + qlen / kWrap;
  int best = 0, start = 0, end = 0, bid = 0, win_d = d;
  for (int c = 0; c < n_neg + n_pos; ++c) {
    const int64_t cd = c < n_neg ? u16 - static_cast<int64_t>(c + 1) * kWrap
                                 : u16 + static_cast<int64_t>(c - n_neg) * kWrap;
    if (cd < 0 ? -cd >= tlen : cd >= qlen) continue;
    const Window w = window_at(static_cast<int>(cd), qlen, tlen, qo, to, rv);
    const int piece = (w.ov + 31) / 32;
    const int lo = min(lane * piece, w.ov);
    AlignSum r = align_scan<kRev, kUniform>(a, tb, w, lo, min(lo + piece, w.ov));
    __syncwarp();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const AlignSum right = shfl_down_align(r, o);
      if (lane + o < 32) r = combine_align(r, right);
    }
    const int r_best = __shfl_sync(kFull, r.best, 0);
    if (r_best > best) {  // strict: the earlier candidate keeps a tie
      best = r_best;
      start = __shfl_sync(kFull, r.start, 0);
      end = __shfl_sync(kFull, r.end, 0);
      bid = __shfl_sync(kFull, r.bid, 0);
      win_d = static_cast<int>(cd);
    }
  }
  // no candidate above 0: the hit's own diagonal and its (0, 0, 0, 0), or
  // (0, -1, -1, 0) without overlap
  const int ov = best > 0 ? 1 : window_at(d, qlen, tlen, qo, to, rv).ov;
  if (lane == 0) store_align(a, hit, ov, best, start, end, bid, win_d);
}

// The first pass's block: its hits' windows in scan order, and the
// results by the hits' own order.
struct AlignSlots {
  int64_t qaddr[kThreads];
  int64_t taddr[kThreads];
  int ov[kThreads];
  int tag[kThreads];  // the hit's index in the block | rv << 16
  int base[kLongWindow / kChunk + 2];
  int res[4][kThreads];
};

// kLongPass = false: a block's 256 hits, those with windows up to
// kLongWindow and rows of qlen + tlen <= kWrap sorted by their windows'
// chunks and scanned a whole window a lane, the others queued. kLongPass = true: a warp per queued hit (align_long).
template <bool kRev, bool kUniform, bool kLongPass>
__global__ void __launch_bounds__(kThreads) rescore_align_kernel(const Args a) {
  __shared__ Tables tb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if constexpr (kLongPass) {
    const int64_t count = a.queue[0];
    if (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock >= count) return;  // no hit here
    load_tables<kRev, kUniform>(a, tb);
    const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (tid >> 5);
    const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
    for (int64_t i = warp; i < count; i += n_warps)
      align_long<kRev, kUniform>(a, tb, a.queue[1 + i], lane);
  } else {
    __shared__ AlignSlots sl;
    constexpr int kBuckets = kLongWindow / kChunk + 1;  // chunks of a short window: 0 .. 32
    if (tid < kBuckets + 1) sl.base[tid] = 0;
    load_tables<kRev, kUniform>(a, tb);
    const int64_t hit = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
    Window mine{0, 0, 0, false};
    int d = 0;
    bool wide = false;
    if (hit < a.h) {
      const int q = a.qrow[hit];
      const int t = a.trow[hit];
      d = a.diag[hit];
      const bool rv = kRev && a.qrev[hit] != 0;
      const int qlen = a.lengths[q];
      const int tlen = a.lengths[t];
      mine = window_at(d, qlen, tlen, a.offsets[q], a.offsets[t], rv);
      wide = static_cast<int64_t>(qlen) + tlen > kWrap;
    }
    const bool is_long = mine.ov > kLongWindow || wide;
    queue_long(a, is_long, hit, lane);
    const int ov = is_long ? 0 : mine.ov;
    // a counting sort by chunks, in shared memory
    const int b = (ov + kChunk - 1) / kChunk;
    const int rank = atomicAdd(&sl.base[b + 1], 1);
    __syncthreads();
    if (tid < 32) {  // exclusive prefix: base[b] = hits in buckets below b
      int v = sl.base[tid + 1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, v, o);
        if (tid >= o) v += u;
      }
      sl.base[tid + 1] = v;  // bucket 32 is the last to need its base
    }
    __syncthreads();
    const int slot = sl.base[b] + rank;
    sl.qaddr[slot] = mine.qaddr;
    sl.taddr[slot] = mine.taddr;
    sl.ov[slot] = ov;
    sl.tag[slot] = tid | (mine.rv ? 1 << 16 : 0);
    __syncthreads();
    // the window of slot tid: after the sort, a warp's windows have one
    // length in chunks
    const Window w{sl.qaddr[tid], sl.taddr[tid], sl.ov[tid], (sl.tag[tid] >> 16) != 0};
    int best, start, end, bid;
    align_short<kRev, kUniform>(a, tb, w, best, start, end, bid);
    const int own = sl.tag[tid] & 0xffff;
    sl.res[0][own] = best;
    sl.res[1][own] = start;
    sl.res[2][own] = end;
    sl.res[3][own] = bid;
    __syncthreads();
    if (hit < a.h && !is_long)
      store_align(a, hit, mine.ov, sl.res[0][tid], sl.res[1][tid], sl.res[2][tid],
                  sl.res[3][tid], d);
  }
}

// ---------------------------------------------------------------------------

// The first pass over every hit, then the second over the queued ones.
int launch_passes(const Args& a, void* stream, void (*first)(Args), void (*second)(Args)) {
  if (a.alpha < 1 || a.alpha > kMaxAlpha || a.h > INT32_MAX) return -1;
  if (reinterpret_cast<uintptr_t>(a.rows) % 4 != 0) return -2;
  if (a.h <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(a.queue, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (a.h + kThreads - 1) / kThreads;
  first<<<blocks, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  second<<<kLongBlocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRev, bool kUniform>
int launch_e2e(const Args& a, void* stream) {
  return launch_passes(a, stream, rescore_e2e_kernel<kRev, kUniform, false>,
                       rescore_e2e_kernel<kRev, kUniform, true>);
}

template <bool kRev>
int launch_hamming(const Args& a, void* stream) {
  return launch_passes(a, stream, rescore_hamming_kernel<kRev, false>,
                       rescore_hamming_kernel<kRev, true>);
}

template <bool kRev, bool kUniform>
int launch_align(const Args& a, void* stream) {
  return launch_passes(a, stream, rescore_align_kernel<kRev, kUniform, false>,
                       rescore_align_kernel<kRev, kUniform, true>);
}

}  // namespace

// rows: uint8[total], 4-byte aligned; offsets: int64[n_rows]; lengths:
// int32[n_rows]; code_lut: uint8[256]; qrow/trow/diag: int32[h]; sub:
// int32[alpha, alpha] with alpha <= 32; queue: int32[1 + h] scratch.
// Forward hits only, scored through the matrix (the protein path).
// Returns the launches' cudaGetLastError() (0 = launched), -1 for an
// alphabet that does not fit the shared-memory matrix or h >= 2^31, -2 for
// misaligned rows.
extern "C" int rescore_e2e(const uint8_t* rows, int64_t total, const int64_t* offsets,
                           const int32_t* lengths, const uint8_t* code_lut,
                           const int32_t* qrow, const int32_t* trow, const int32_t* diag,
                           const int32_t* sub, int alpha, int64_t h, int32_t* score,
                           int32_t* first, int32_t* last, int32_t* idents, int32_t* queue,
                           void* stream) {
  const Args a{rows, total, offsets, lengths, code_lut, qrow, trow, diag, nullptr, sub,
               nullptr, nullptr, alpha, 0, 0, h, score, first, last, idents, queue};
  return launch_e2e<false, false>(a, stream);
}

// As rescore_e2e, with reverse hits: qrev uint8[h] (0/1), comp int32[alpha]
// (values < alpha), code2char uint8[alpha]. uniform != 0 selects the
// uniform-matrix variant, which scores match/mismatch and never reads sub.
extern "C" int rescore_e2e_rev(const uint8_t* rows, int64_t total, const int64_t* offsets,
                               const int32_t* lengths, const uint8_t* code_lut,
                               const int32_t* qrow, const int32_t* trow, const int32_t* diag,
                               const uint8_t* qrev, const int32_t* sub, const int32_t* comp,
                               const uint8_t* code2char, int alpha, int uniform, int match,
                               int mismatch, int64_t h, int32_t* score, int32_t* first,
                               int32_t* last, int32_t* idents, int32_t* queue, void* stream) {
  const Args a{rows, total, offsets, lengths, code_lut, qrow, trow, diag, qrev, sub,
               comp, code2char, alpha, match, mismatch, h, score, first, last, idents, queue};
  return uniform ? launch_e2e<true, true>(a, stream) : launch_e2e<true, false>(a, stream);
}

// HAMMING (--rescore-mode 0) on the same operands: qrev null for forward
// hits only; with qrev, comp and code2char as rescore_e2e_rev takes them.
// No matrix. score = idents = identical raw chars over the window, first
// = last = -1. Returns as rescore_e2e.
extern "C" int rescore_hamming(const uint8_t* rows, int64_t total, const int64_t* offsets,
                               const int32_t* lengths, const uint8_t* code_lut,
                               const int32_t* qrow, const int32_t* trow, const int32_t* diag,
                               const uint8_t* qrev, const int32_t* comp,
                               const uint8_t* code2char, int alpha, int64_t h, int32_t* score,
                               int32_t* first, int32_t* last, int32_t* idents, int32_t* queue,
                               void* stream) {
  const Args a{rows, total, offsets, lengths, code_lut, qrow, trow, diag, qrev, nullptr,
               comp, code2char, alpha, 0, 0, h, score, first, last, idents, queue};
  return qrev ? launch_hamming<true>(a, stream) : launch_hamming<false>(a, stream);
}

// ALIGNMENT (--rescore-mode 2, B12) on rescore_e2e_rev's operands: qrev,
// comp and code2char null for forward hits only (the protein path), given
// for reverse hits; uniform != 0 (with reverse hits) scores match/mismatch
// and never reads sub. score, first, last, idents = the best local segment's
// score, start, end and case-folded identities on the winning candidate
// diagonal, diag_out: int32[h] that diagonal; (0, -1, -1, 0) without
// overlap, (0, 0, 0, 0) without a positive score, both on the hit's own
// diagonal. Returns as rescore_e2e.
extern "C" int rescore_align(const uint8_t* rows, int64_t total, const int64_t* offsets,
                             const int32_t* lengths, const uint8_t* code_lut,
                             const int32_t* qrow, const int32_t* trow, const int32_t* diag,
                             const uint8_t* qrev, const int32_t* sub, const int32_t* comp,
                             const uint8_t* code2char, int alpha, int uniform, int match,
                             int mismatch, int64_t h, int32_t* score, int32_t* first,
                             int32_t* last, int32_t* idents, int32_t* diag_out, int32_t* queue,
                             void* stream) {
  const Args a{rows,  total, offsets, lengths, code_lut, qrow,  trow,     diag,
               qrev,  sub,   comp,    code2char, alpha,  match, mismatch, h,
               score, first, last,    idents,  queue,    diag_out};
  if (!qrev) return launch_align<false, false>(a, stream);
  return uniform ? launch_align<true, true>(a, stream) : launch_align<true, false>(a, stream);
}
