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
    load16(a.rows, a.total, rv ? w.qaddr - j0 - (kChunk - 1) : w.qaddr + j0, qw);
    load16(a.rows, a.total, w.taddr + j0, tw);
    if (rv) {  // mirror the 16 bytes: byte k becomes the query's j0 + k
      const uint32_t m0 = __byte_perm(qw[3], 0, 0x0123);
      const uint32_t m1 = __byte_perm(qw[2], 0, 0x0123);
      const uint32_t m2 = __byte_perm(qw[1], 0, 0x0123);
      const uint32_t m3 = __byte_perm(qw[0], 0, 0x0123);
      qw[0] = m0;
      qw[1] = m1;
      qw[2] = m2;
      qw[3] = m3;
    }
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

// kLongPass = false: 32 hits per warp, windows up to kLongWindow scored by
// kGroup-lane groups, longer ones queued. kLongPass = true: a warp per queued hit.
template <bool kRev, bool kUniform, bool kHamming, bool kLongPass>
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
    if (valid && !is_long) store_hit<kHamming>(a, hit, mine.ov, my_s, my_pk);
  }
}

template <bool kRev, bool kUniform, bool kHamming = false>
int launch(const Args& a, void* stream) {
  if (a.alpha < 1 || a.alpha > kMaxAlpha || a.h > INT32_MAX) return -1;
  if (reinterpret_cast<uintptr_t>(a.rows) % 4 != 0) return -2;
  if (a.h <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(a.queue, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (a.h + kThreads - 1) / kThreads;
  rescore_e2e_kernel<kRev, kUniform, kHamming, false><<<blocks, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rescore_e2e_kernel<kRev, kUniform, kHamming, true><<<kLongBlocks, kThreads, 0, s>>>(a);
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
