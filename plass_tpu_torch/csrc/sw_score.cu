// Best local Smith-Waterman score with affine gaps for (query, target)
// pairs: the score-only prefilter of the amino-acid aligner.
//
// Replaces plass_tpu/ops/device_align.py:32 (sw_score_batch, an XLA
// lax.scan over target columns of padded [B, LQ] states). Per pair, over
// query rows i and target columns j:
//   E(i,j) = max(H(i,j-1) - gapo, E(i,j-1) - gape)              along the target
//   F(i,j) = max_{k<i} (H0(k,j) - gapo - (i-1-k) * gape)          along the query
//   H0(i,j) = max(0, H(i-1,j-1) + sub[q_i][t_j] + bias_i, E(i,j))
//   H(i,j) = max(H0(i,j), F(i,j)),  score = max over all H
// with H = 0 and E = -inf before the first row and column. F from H0
// rather than H is exact because gapo >= gape (11/1, 5/2): a gap opened
// after a cell whose H came from F is never better than extending that F.
// bias_i is the query's rounded composition bias (int8), added to every
// target letter as the host aligner's striped profile does, so the score
// equals the native ssw score exactly.
//
// Operands are flat, nothing is padded: the queries' codes and bias as
// uint8/int8 rows with int64 offsets and int32 lengths; the target DB's
// own bytes (rows, offsets, lengths) read through a 256-entry code table;
// int32 pair indices (qidx, tidx) and an optional processing order; the
// int32 [alpha, alpha] matrix. The output is int32[b].
//
// What bounds it on Hopper: integer operations, not bytes. A pair of
// lengths m and n reads m + n bytes and does m * n cells of about 16
// int32 operations (an add and a max for E, two adds and two maxes for H0,
// the profile address and lookup, two adds and a max for the outgoing F,
// then a max each for H and the best, and the F recurrence again). The
// design:
//   * one warp per pair; warps take pairs from an atomic counter, in the
//     order the wrapper gives (longest first), so that a long pair does
//     not start last;
//   * the query is cut into strips of 32 * R rows, R in {1, 2, 4, 8, 16}
//     chosen per pair as the least that holds the query (else 16); lane l
//     keeps the R contiguous rows l*R .. l*R+R-1 of the strip: their codes,
//     bias, H and E live in registers for the whole target sweep;
//   * the target is walked one column at a time; each lane loads one
//     target byte of the next 32 and the column's matrix row offset is
//     broadcast with __shfl_sync; the matrix sits in shared memory, and a
//     lane's lookups at one column fall in one row of it (no bank
//     conflicts);
//   * H(i-1, j-1) of a lane's first row comes from the lane below it with
//     __shfl_up_sync; F is closed in two passes: each lane's own rows give
//     the F that leaves it, a warp prefix max of (that F + its row offset
//     * gape) gives the F that enters each lane, and the lane's rows are
//     finished sequentially;
//   * a query longer than 512 rows (contigs up to 65,535) is swept strip
//     after strip; between strips only two ints per target column pass
//     (H of the strip's last row and the F leaving it), in a global
//     scratch of warps x columns that the wrapper allocates;
//   * rows past the query's end get a bias of -2^28: their cells never
//     exceed the best of the real rows and they feed only rows below them,
//     so no mask is needed in the inner loop.
// Hopper's DPX instructions (__viaddmax_s32 fuses add and max) and packing
// several short pairs into one warp are left for later. PERF.md has the
// times.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxAlpha = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxBlocks = 132 * 2;   // about the blocks resident at ~100 registers
constexpr int kMaxR = 16;             // rows per lane; a strip is 32 * kMaxR rows
constexpr int kNeg = -(1 << 30);
constexpr int kMaskBias = -(1 << 28);
constexpr unsigned kFull = 0xffffffffu;

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
  const int32_t* order;  // may be null: pairs in index order
  int64_t b;
  const int32_t* sub;
  int alpha;
  int gapo;
  int gape;
  int32_t* out;
  int32_t* counter;      // the next pair to take
  int2* strips;          // [warps, strip_cols] (H, F) per column; null without long queries
  int64_t strip_cols;
};

struct Smem {
  int sub[kMaxAlpha * kMaxAlpha];  // [t][q]
  int lut[256];  // byte -> code * alpha, the code's row offset into sub
};

// The best score of one pair with R rows per lane; qlen, tlen > 0.
template <int R>
__device__ __forceinline__ int sw_pair(const Args& a, const Smem& sm, int64_t qo, int qlen,
                                       int64_t to, int tlen, int2* strip, int lane) {
  constexpr int S = 32 * R;
  const int gapo = a.gapo;
  const int gape = a.gape;
  const int step = R * gape;
  const int n_strips = (qlen + S - 1) / S;
  int best = 0;
  for (int st = 0; st < n_strips; ++st) {
    const bool first_strip = st == 0;
    const bool last_strip = st == n_strips - 1;
    int q[R], b[R], h[R], e[R], h0[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = st * S + lane * R + r;
      q[r] = i < qlen ? a.qcodes[qo + i] : 0;
      b[r] = i < qlen ? a.bias[qo + i] : kMaskBias;
      h[r] = 0;
      e[r] = kNeg;
    }
    int prev_hb = 0;  // lane 0: H of the row above the strip, previous column
    for (int j0 = 0; j0 < tlen; j0 += 32) {
      const int tcol = j0 + lane < tlen ? sm.lut[a.rows[to + j0 + lane]] : 0;
      const int jn = min(32, tlen - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const int j = j0 + jj;
        const int* subrow = sm.sub + __shfl_sync(kFull, tcol, jj);
        int carry_h = 0, carry_f = kNeg;  // from the strip above, at lane 0
        if (!first_strip && lane == 0) {
          const int2 v = strip[j];
          carry_h = v.x;
          carry_f = v.y;
        }
        const int up = __shfl_up_sync(kFull, h[R - 1], 1);
        int diag = lane == 0 ? prev_hb : up;
        prev_hb = carry_h;
        // pass 1: E, H0 and the F that leaves the lane's rows
        int f_out = kNeg;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int s = subrow[q[r]] + b[r];
          e[r] = max(h[r] - gapo, e[r] - gape);
          const int hd = h[r];
          h0[r] = max(max(diag + s, e[r]), 0);
          diag = hd;
          f_out = max(f_out - gape, h0[r] - gapo);
        }
        // the F entering each lane: a prefix max in units shifted by the
        // lane's row offset; lane 0 takes the strip above's
        int k = f_out + (lane + 1) * step;
        if (lane == 0) k = max(k, carry_f);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(kFull, k, o);
          if (lane >= o) k = max(k, t);
        }
        const int ex = __shfl_up_sync(kFull, k, 1);
        int f = lane == 0 ? carry_f : ex - lane * step;
        // pass 2: H and the best
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int hv = max(h0[r], f);
          best = max(best, hv);
          h[r] = hv;
          f = max(f - gape, h0[r] - gapo);
        }
        if (!last_strip && lane == 31) strip[j] = make_int2(h[R - 1], f);
      }
    }
    __syncwarp();  // the strip's boundary is written before the next reads it
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(kFull, best, o));
  return best;
}

__global__ void __launch_bounds__(kThreads) sw_score_kernel(const Args a) {
  __shared__ Smem sm;
  const int top = a.alpha - 1;
  // transposed: the row of a target code holds sub[q][t] for every q
  for (int i = threadIdx.x; i < a.alpha * a.alpha; i += blockDim.x)
    sm.sub[i] = a.sub[(i % a.alpha) * a.alpha + i / a.alpha];
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    sm.lut[i] = min(static_cast<int>(a.code_lut[i]), top) * a.alpha;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  int2* strip = a.strips ? a.strips + warp * a.strip_cols : nullptr;
  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(a.counter, 1);
    k = __shfl_sync(kFull, k, 0);
    if (k >= a.b) break;
    const int64_t p = a.order ? a.order[k] : k;
    const int qi = a.qidx[p];
    const int ti = a.tidx[p];
    const int qlen = a.qlens[qi];
    const int tlen = a.lengths[ti];
    const int64_t qo = a.qoffsets[qi];
    const int64_t to = a.offsets[ti];
    int best = 0;
    if (qlen > 32 * kMaxR && tlen > a.strip_cols) {
      best = -1;  // the strip scratch is too short for this pair
    } else if (qlen > 0 && tlen > 0) {
      if (qlen <= 32)
        best = sw_pair<1>(a, sm, qo, qlen, to, tlen, strip, lane);
      else if (qlen <= 64)
        best = sw_pair<2>(a, sm, qo, qlen, to, tlen, strip, lane);
      else if (qlen <= 128)
        best = sw_pair<4>(a, sm, qo, qlen, to, tlen, strip, lane);
      else if (qlen <= 256)
        best = sw_pair<8>(a, sm, qo, qlen, to, tlen, strip, lane);
      else
        best = sw_pair<kMaxR>(a, sm, qo, qlen, to, tlen, strip, lane);
    }
    if (lane == 0) a.out[p] = best;
  }
}

int64_t n_blocks(int64_t b) {
  const int64_t need = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return need < kMaxBlocks ? need : kMaxBlocks;
}

}  // namespace

// The warps sw_score launches for b pairs: the rows of its strip scratch.
extern "C" int64_t sw_score_warps(int64_t b) { return n_blocks(b) * kWarpsPerBlock; }

// The longest query a pair may have without the strip scratch.
extern "C" int sw_score_strip_rows() { return 32 * kMaxR; }

// qcodes uint8[TQ], qoffsets int64[NQ], qlens int32[NQ], bias int8[TQ];
// rows uint8[T], offsets int64[N], lengths int32[N], code_lut uint8[256];
// qidx, tidx int32[b]; order int32[b] or null; sub int32[alpha, alpha]
// with alpha <= 32; gap_open >= gap_extend >= 0; out int32[b]; counter
// int32[1] scratch. strips holds int32[2 * sw_score_warps(b) *
// strip_cols], or is null when strip_cols is 0; a pair whose query is
// longer than sw_score_strip_rows() and whose target is longer than
// strip_cols scores -1. Returns the launch's cudaGetLastError() (0 =
// launched), -1 for bad sizes or gaps, -2 for strip columns without their
// scratch.
extern "C" int sw_score(const uint8_t* qcodes, const int64_t* qoffsets, const int32_t* qlens,
                        const int8_t* bias, const uint8_t* rows, const int64_t* offsets,
                        const int32_t* lengths, const uint8_t* code_lut, const int32_t* qidx,
                        const int32_t* tidx, const int32_t* order, int64_t b, const int32_t* sub,
                        int alpha, int gap_open, int gap_extend, int32_t* out, int32_t* counter,
                        int32_t* strips, int64_t strip_cols, void* stream) {
  if (alpha < 1 || alpha > kMaxAlpha || b > INT32_MAX || gap_extend < 0 || gap_open < gap_extend ||
      strip_cols < 0)
    return -1;
  if (strip_cols > 0 && strips == nullptr) return -2;
  if (b <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{qcodes, qoffsets, qlens, bias, rows, offsets, lengths, code_lut,
               qidx, tidx, order, b, sub, alpha, gap_open, gap_extend, out, counter,
               strip_cols ? reinterpret_cast<int2*>(strips) : nullptr, strip_cols};
  sw_score_kernel<<<n_blocks(b), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
