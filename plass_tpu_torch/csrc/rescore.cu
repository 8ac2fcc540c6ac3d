// END_TO_END ungapped diagonal rescore of (qrow, trow, diag) hits, on the
// sequence database's own flat byte array.
//
// Replaces the Pallas TPU kernel plass_tpu/ops/pallas_rescore.py
// (_rescore_pairs_pallas -> _kernel_gathered_body + _score_and_canon +
// _reduce_windows, the default block-8 gathered variant) in three variants
// of one template:
//   rescore_e2e                  has_rev=False, generic matrix (protein)
//   rescore_e2e_rev, uniform 0   has_rev=True, generic matrix
//   rescore_e2e_rev, uniform 1   has_rev=True with the `fast` uniform
//                                matrix (pallas_rescore.py:74-86), the
//                                nucleotide path
// and, from the same template, the HAMMING rescore of --rescore-mode 0
// (plass_tpu/ops/device_rescore.py:107-110, mode 0 of rescore_pairs, which
// XLA ran there):
//   rescore_hamming, qrev null   forward hits (protein)
//   rescore_hamming, qrev given  with reverse hits (nucleotide)
// HAMMING counts the identical raw chars over the whole overlap window (no
// case folding, no '*' skip; a reverse hit's query chars are the canonical
// chars of its complemented codes, as above) and returns it as both score
// and idents, with first = last = -1.
// The template's third form is the ALIGNMENT rescore of --rescore-mode 2
// (B12), which the JAX package computes on the host only
// (plass_tpu/ops/rescore.py:71-85, computeSubstitutionStartEndDistance):
//   rescore_align, qrev null     forward hits (protein)
//   rescore_align, qrev given    with reverse hits; uniform selects the
//                                uniform-matrix scoring (nucleotide)
// It returns the best local ungapped segment of each window; see "ALIGNMENT"
// below.
//
// Operands: rows uint8[total] holds every sequence back to back (record
// terminators included, never scored); row r is the lengths[r] bytes from
// rows[offsets[r]]. A residue's char is its byte, its code
// code_lut[byte]. There is no padded [N, W] copy of the database.
//
// END_TO_END, per hit, over the overlap window of length ov
// (pallas_rescore.py:150-171):
//   s[j]  = sub[q[qoff + j], t[toff + j]]
//   first = 1 if either char at j = 0 is '*', else 0
//   last  = ov - 1, less 1 if either char there is '*' (and ov - 1 > 0)
//   score = max(0, sum s[first..last]); idents counts case-folded char
//   matches over the same window; ov <= 0 gives score 0, first = last = -1.
// A reverse hit (qrev) reads the query back to front and complemented
// (rescorediagonal.cpp:173-179): code comp[q[qlen-1-(qoff+j)]], and its char
// is that code's canonical char code2char[code], not the raw byte, for the
// '*' test and the identity count alike. The uniform variant scores
// (q == t && q != X) ? match : mismatch instead of looking the matrix up.
//
// What bounds it on Hopper: not the bytes. A call moves tens of MB (the
// rows once, ~30 B per hit), about 0.01 ms of HBM time at 3.35 TB/s, and the
// rows of a read-sized database stay in the 50 MB L2. What costs is the
// chain hit -> row offset and length -> window bytes, and then the work per
// residue: two or three shared-memory lookups (query table, target code,
// matrix) and a dozen integer instructions. The TPU kernel streamed whole
// padded rows into VMEM and rolled the window to lane 0; nothing of that
// layout is kept. The design:
//   * a lane per hit first: the 32 lanes of a warp load 32 hits' (q, t,
//     diag, rev) coalesced, then the two rows' (offset, length), and
//     derive the window; three trips for 32 hits, before any row byte;
//   * then kGroup lanes per hit: a lane scores 16 window bytes per step
//     from five aligned 4-byte words per side, funnel-shifted to the
//     window's own alignment (row starts in the flat array are arbitrary),
//     all ten loads started before the first is used. Word loads that would
//     leave [0, total) are replaced by guarded byte loads. Two lanes per
//     hit measured best on read- and ORF-sized windows (8, 4, 2 and 1 were
//     tried): 16 hits per warp and round keep every lane busy, where wider
//     groups idle on the last, partial step of a 50-residue window;
//   * a reverse hit loads the covering words ascending and mirrors the 16
//     bytes in registers (__byte_perm); its code and char come from a
//     shared-memory table byte -> (matrix row, char) per strand, filled per
//     block from code_lut, comp and code2char, so the complement costs
//     neither a trip nor an instruction; in the uniform variant the table
//     holds the code itself, with X replaced by a value that matches
//     nothing, and the score is mismatch * n + (match - mismatch) * equal;
//   * the '*' tests read the window bytes already in registers: every
//     residue is scored alike, and the lane that holds j = 0 (or j = ov-1)
//     takes that residue out again and raises a bit in the packed identity
//     count when it is a '*';
//   * windows longer than kLongWindow would serialise a lane group while
//     its neighbours idle, so the first pass queues them on the device
//     (one atomicAdd per warp) and a second pass of the same template gives
//     each a whole warp, 512 bytes per step. No host round trip: the second
//     pass reads the queue's length on the device.
// Results leave through shuffles so that each lane stores its own hit's
// four outputs coalesced. A persisting L2 window on `rows` was not tried:
// the rows are re-read from L2 already. PERF.md has the times and the
// share of the bound reached.
//
// ALIGNMENT (kAlign), per hit: with c[p] the running sum of s[0..p] and
// c[-1] = 0, the host's loop (score += s; score <= 0 resets it and sets
// min_pos = p; a strictly greater score sets the maximum, its end p and its
// start min_pos + 1) is
//   score_p = c[p] - min c[-1..p], the minimum taken at its LATEST index,
//   end     = the FIRST p with the largest score_p (strict >),
//   start   = that p's minimum index + 1,
// and a window whose scores never exceed 0 gives (0, 0, 0). '*' is scored
// like any residue (the host scores mode 2 through the matrix on the raw
// chars and skips nothing). idents counts case-folded equal chars over
// [start, end]; ov <= 0 gives (0, -1, -1, 0), no positive score (0, 0, 0, 0).
// The maximum is a serial recurrence. A window of at most kLongWindow
// residues is scanned by one lane, 16 bytes per load as above, and then
// counted over [start, end] by the same lane. A longer window is cut into 32
// contiguous pieces, one a lane of the second pass's warp; each lane scans
// its piece into a summary (sum; minimum prefix with its latest index,
// the piece's own left edge included; maximum prefix with its first index;
// the best segment that starts inside the piece) and the warp folds the
// summaries left to right (combine_align), keeping both tie rules. Rows
// longer than 32,768 are scored on the hit's own diagonal alone, as the
// END_TO_END form scores them, where the host's ungapped_best also tries
// the diagonals 65,536 apart that share the 16 bits its hits store (the
// port's matcher keeps the whole diagonal). What bounds it: as for K2, the
// chain hit -> row -> window bytes and the work per residue, here a
// dependent chain (sum, minimum, maximum) that a lane cannot split.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxAlpha = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kGroup = 2;                      // lanes per hit, first pass
constexpr int kGroupsPerWarp = 32 / kGroup;    // hits per warp and round
constexpr int kChunk = 16;                     // bytes a lane scores per step
constexpr int kLongWindow = 512;               // longer windows: second pass
constexpr int kLongBlocks = 132 * 4;           // second pass: warps stride the queue
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
  int32_t* queue;  // [0] number of queued long hits, [1..] their indices
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
template <bool kRev, bool kUniform, bool kHamming>
__device__ __forceinline__ void load_tables(const Args& a, Tables& tb) {
  const uint32_t top = a.alpha - 1;
  if (!kUniform && !kHamming)
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

template <bool kRev>
__device__ __forceinline__ Window window_of(const Args& a, int64_t hit) {
  const int q = a.qrow[hit];
  const int t = a.trow[hit];
  const int d = a.diag[hit];
  Window w;
  w.rv = kRev && a.qrev[hit] != 0;
  const int qlen = a.lengths[q];
  const int tlen = a.lengths[t];
  const int64_t qo = a.offsets[q];
  const int64_t to = a.offsets[t];
  const int dist = d >= 0 ? d : -d;
  const bool pos_ok = d >= 0 ? dist < qlen : dist < tlen;
  w.ov = pos_ok ? (d >= 0 ? min(tlen, qlen - dist) : min(tlen - dist, qlen)) : 0;
  const int qoff = d >= 0 ? dist : 0;
  w.qaddr = w.rv ? qo + qlen - 1 - qoff : qo + qoff;
  w.taddr = to + (d >= 0 ? 0 : dist);
  return w;
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

// A team of team_size lanes scores one window, 16 bytes per lane and step.
// s gets the lane's share of the score sum; pk its share of the identity
// count plus kStarFirst / kStarLast where it met a '*' at j = 0 / j = ov-1.
// The residues at j = 0 and j = ov-1 are scored with the rest and taken
// out again by the lane that holds them when they are '*'. kHamming: pk
// counts equal raw chars over the whole window, s stays 0.
template <bool kRev, bool kUniform, bool kHamming>
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
      if (kHamming) {
        pk += (in && (e >> 16) == tch) ? 1 : 0;
        continue;
      }
      const uint32_t tcode = tb.lut[tch];
      if (kUniform)
        hits += (in && (e & 0xffffu) == tcode) ? 1 : 0;
      else
        s += in ? tb.sub[(e & 0xffffu) + tcode] : 0;
      pk += (in && (((e >> 16) ^ tch) & kFold) == 0) ? 1 : 0;
    }
    if (kHamming) continue;
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

template <bool kHamming>
__device__ __forceinline__ void store_hit(const Args& a, int64_t hit, int ov, int s, int pk) {
  if (ov <= 0 || kHamming) {
    a.score[hit] = ov <= 0 ? 0 : pk & kIdentMask;
    a.first[hit] = -1;
    a.last[hit] = -1;
    a.idents[hit] = ov <= 0 ? 0 : pk & kIdentMask;
    return;
  }
  a.score[hit] = max(s, 0);
  a.first[hit] = (pk & kStarFirst) ? 1 : 0;
  a.last[hit] = ov - 1 - ((pk & kStarLast) ? 1 : 0);
  a.idents[hit] = pk & kIdentMask;
}

// ALIGNMENT: the summary of the window residues [lo, hi), positions
// window-relative.
struct AlignSum {
  int sum;               // s[lo] + ... + s[hi-1]
  int mn, mn_at;         // least prefix sum, the left edge (0 at lo-1) included; latest index
  int mx, mx_at;         // greatest prefix sum over [lo, hi), first index; kNegInf if empty
  int best, start, end;  // best segment that starts at lo or later, its first end; 0, 0, 0 if none
};
constexpr int kNegInf = -(1 << 30);

// The host's loop over [lo, hi), one lane, 16 bytes per load.
template <bool kRev, bool kUniform>
__device__ AlignSum align_scan(const Args& a, const Tables& tb, const Window& w, int lo, int hi) {
  const bool rv = kRev && w.rv;
  const uint32_t* qtab = tb.query + (rv ? 256 : 0);
  AlignSum r{0, 0, lo - 1, kNegInf, lo, 0, 0, 0};
  for (int j0 = lo; j0 < hi; j0 += kChunk) {
    uint32_t qw[4], tw[4];
    load_chunk<kRev>(a, w, rv, j0, qw, tw);
    const int n_in = min(kChunk, hi - j0);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < n_in) {
        bool idm, star;
        r.sum += score_pair<kUniform>(a, tb, qtab, byte_at(qw, k), byte_at(tw, k), idm, star);
        const int run = r.sum - r.mn;
        if (r.sum > r.mx) {
          r.mx = r.sum;
          r.mx_at = j0 + k;
        }
        if (run <= 0) {  // the running score resets: a new minimum, latest on ties
          r.mn = r.sum;
          r.mn_at = j0 + k;
        } else if (run > r.best) {  // strict: the first end keeps a tie
          r.best = run;
          r.start = r.mn_at + 1;
          r.end = j0 + k;
        }
      }
    }
  }
  return r;
}

// The summary of [lo, mid) followed by [mid, hi). A segment ending in the
// right piece starts in the left piece (at the left piece's minimum + 1,
// score L.sum + R.mx - L.mn at R.mx_at) or in the right piece (R.best at
// R.end): the larger wins, and on equal scores the earlier end, the right
// piece's own start at an equal end (its minimum is the later one). The
// left piece's best wins every tie, as it ends first.
__device__ __forceinline__ AlignSum combine_align(const AlignSum& l, const AlignSum& r) {
  AlignSum c;
  c.sum = l.sum + r.sum;
  const bool right_min = l.sum + r.mn <= l.mn;
  c.mn = right_min ? l.sum + r.mn : l.mn;
  c.mn_at = right_min ? r.mn_at : l.mn_at;
  const bool right_max = r.mx != kNegInf && l.sum + r.mx > l.mx;
  c.mx = right_max ? l.sum + r.mx : l.mx;
  c.mx_at = right_max ? r.mx_at : l.mx_at;
  const int across = r.mx == kNegInf ? kNegInf : l.sum + r.mx - l.mn;
  const bool take_across = across > r.best || (across == r.best && r.mx_at < r.end);
  int best = take_across ? across : r.best;
  int start = take_across ? l.mn_at + 1 : r.start;
  int end = take_across ? r.mx_at : r.end;
  if (l.best >= best) {
    best = l.best;
    start = l.start;
    end = l.end;
  }
  c.best = best;
  c.start = start;
  c.end = end;
  return c;
}

__device__ __forceinline__ AlignSum shfl_down_align(const AlignSum& x, int o) {
  AlignSum y;
  y.sum = __shfl_down_sync(kFull, x.sum, o);
  y.mn = __shfl_down_sync(kFull, x.mn, o);
  y.mn_at = __shfl_down_sync(kFull, x.mn_at, o);
  y.mx = __shfl_down_sync(kFull, x.mx, o);
  y.mx_at = __shfl_down_sync(kFull, x.mx_at, o);
  y.best = __shfl_down_sync(kFull, x.best, o);
  y.start = __shfl_down_sync(kFull, x.start, o);
  y.end = __shfl_down_sync(kFull, x.end, o);
  return y;
}

// Case-folded equal chars over the window residues [lo, hi): team_lane's
// share of a team of team_size lanes.
template <bool kRev>
__device__ int count_idents(const Args& a, const Tables& tb, const Window& w, int lo, int hi,
                            int team_lane, int team_size) {
  const bool rv = kRev && w.rv;
  const uint32_t* qtab = tb.query + (rv ? 256 : 0);
  int n = 0;
  for (int j0 = lo + team_lane * kChunk; j0 < hi; j0 += team_size * kChunk) {
    uint32_t qw[4], tw[4];
    load_chunk<kRev>(a, w, rv, j0, qw, tw);
    const int n_in = min(kChunk, hi - j0);
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      n += (k < n_in && (((qtab[byte_at(qw, k)] >> 16) ^ byte_at(tw, k)) & kFold) == 0) ? 1 : 0;
  }
  return n;
}

__device__ __forceinline__ void store_align(const Args& a, int64_t hit, int ov, const AlignSum& r,
                                            int idents) {
  a.score[hit] = r.best;
  a.first[hit] = ov <= 0 ? -1 : r.start;
  a.last[hit] = ov <= 0 ? -1 : r.end;
  a.idents[hit] = idents;
}

// kLongPass = false: 32 hits per warp, windows up to kLongWindow scored by
// kGroup-lane groups (kAlign: by the hit's own lane), longer ones queued.
// kLongPass = true: a warp per queued hit.
template <bool kRev, bool kUniform, bool kHamming, bool kAlign, bool kLongPass>
__global__ void __launch_bounds__(kThreads) rescore_e2e_kernel(const Args a) {
  __shared__ Tables tb;
  load_tables<kRev, kUniform, kHamming>(a, tb);
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);

  if constexpr (kLongPass) {
    const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
    const int64_t count = a.queue[0];
    for (int64_t i = warp; i < count; i += n_warps) {
      const int64_t hit = a.queue[1 + i];
      const Window w = window_of<kRev>(a, hit);
      if constexpr (kAlign) {
        // 32 contiguous pieces, folded left to right in a tree
        const int piece = (w.ov + 31) / 32;
        const int lo = min(lane * piece, w.ov);
        AlignSum r = align_scan<kRev, kUniform>(a, tb, w, lo, min(lo + piece, w.ov));
        __syncwarp();
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const AlignSum right = shfl_down_align(r, o);
          if (lane + o < 32) r = combine_align(r, right);
        }
        r.best = __shfl_sync(kFull, r.best, 0);
        r.start = __shfl_sync(kFull, r.start, 0);
        r.end = __shfl_sync(kFull, r.end, 0);
        int n = r.best > 0 ? count_idents<kRev>(a, tb, w, r.start, r.end + 1, lane, 32) : 0;
        __syncwarp();
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
        if (lane == 0) store_align(a, hit, w.ov, r, n);
        continue;
      }
      int s = 0, pk = 0;
      score_window<kRev, kUniform, kHamming>(a, tb, w, lane, 32, s, pk);
      __syncwarp();
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(kFull, s, o);
        pk += __shfl_xor_sync(kFull, pk, o);
      }
      if (lane == 0) store_hit<kHamming>(a, hit, w.ov, s, pk);
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
    if constexpr (kAlign) {
      if (valid && !is_long) {
        const AlignSum r = align_scan<kRev, kUniform>(a, tb, mine, 0, mine.ov);
        const int n =
            r.best > 0 ? count_idents<kRev>(a, tb, mine, r.start, r.end + 1, 0, 1) : 0;
        store_align(a, hit, mine.ov, r, n);
      }
    }
#pragma unroll 1
    for (int r = 0; r < (kAlign ? 0 : 32 / kGroupsPerWarp); ++r) {
      // group g scores the hit of lane r * kGroupsPerWarp + g
      const int src = r * kGroupsPerWarp + group;
      Window w;
      w.ov = __shfl_sync(kFull, short_ov, src);
      w.qaddr = __shfl_sync(kFull, mine.qaddr, src);
      w.taddr = __shfl_sync(kFull, mine.taddr, src);
      w.rv = __shfl_sync(kFull, static_cast<int>(mine.rv), src) != 0;
      int s = 0, pk = 0;
      score_window<kRev, kUniform, kHamming>(a, tb, w, lane % kGroup, kGroup, s, pk);
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
    const unsigned long_mask = __ballot_sync(kFull, is_long);
    if (long_mask) {
      int slot = 0;
      if (lane == 0) slot = atomicAdd(a.queue, __popc(long_mask));
      slot = __shfl_sync(kFull, slot, 0);
      if (is_long)
        a.queue[1 + slot + __popc(long_mask & ((1u << lane) - 1u))] = static_cast<int32_t>(hit);
    }
    if (!kAlign && valid && !is_long) store_hit<kHamming>(a, hit, mine.ov, my_s, my_pk);
  }
}

template <bool kRev, bool kUniform, bool kHamming = false, bool kAlign = false>
int launch(const Args& a, void* stream) {
  if (a.alpha < 1 || a.alpha > kMaxAlpha || a.h > INT32_MAX) return -1;
  if (reinterpret_cast<uintptr_t>(a.rows) % 4 != 0) return -2;
  if (a.h <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(a.queue, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (a.h + kThreads - 1) / kThreads;
  rescore_e2e_kernel<kRev, kUniform, kHamming, kAlign, false><<<blocks, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rescore_e2e_kernel<kRev, kUniform, kHamming, kAlign, true><<<kLongBlocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
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
  return launch<false, false>(a, stream);
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
  return uniform ? launch<true, true>(a, stream) : launch<true, false>(a, stream);
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
  return qrev ? launch<true, false, true>(a, stream) : launch<false, false, true>(a, stream);
}

// ALIGNMENT (--rescore-mode 2, B12) on rescore_e2e_rev's operands: qrev,
// comp and code2char null for forward hits only (the protein path), given
// for reverse hits; uniform != 0 (with reverse hits) scores match/mismatch
// and never reads sub. score, first, last, idents = the best local segment's
// score, start, end and case-folded identities; (0, -1, -1, 0) without
// overlap, (0, 0, 0, 0) without a positive score. Returns as rescore_e2e.
extern "C" int rescore_align(const uint8_t* rows, int64_t total, const int64_t* offsets,
                             const int32_t* lengths, const uint8_t* code_lut,
                             const int32_t* qrow, const int32_t* trow, const int32_t* diag,
                             const uint8_t* qrev, const int32_t* sub, const int32_t* comp,
                             const uint8_t* code2char, int alpha, int uniform, int match,
                             int mismatch, int64_t h, int32_t* score, int32_t* first,
                             int32_t* last, int32_t* idents, int32_t* queue, void* stream) {
  const Args a{rows, total, offsets, lengths, code_lut, qrow, trow, diag, qrev, sub,
               comp, code2char, alpha, match, mismatch, h, score, first, last, idents, queue};
  if (!qrev) return launch<false, false, false, true>(a, stream);
  return uniform ? launch<true, true, false, true>(a, stream)
                 : launch<true, false, false, true>(a, stream);
}
