// END_TO_END ungapped diagonal rescore of (qrow, trow, diag) hits.
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
//
// Per hit, over the overlap window of length ov (pallas_rescore.py:150-171):
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
// What bounds it on Hopper: latency of the random row reads. Each hit reads
// two windows of ov bytes from rows chosen by index, twice (codes and
// chars), and does a few integer operations per byte; at ~10^5 hits a call
// is a few MB of scattered reads. The TPU kernel streamed whole rows into
// VMEM, rolled the window to lane 0 and looked the scores up with a one-hot
// MXU contraction; for reverse hits it streamed a second, flipped copy of
// every row, because a roll cannot reverse. Here one warp takes one hit: the
// 32 lanes stride over the window reading the uint8 rows by index (no
// power-of-two width, no roll); a reverse hit reads descending addresses,
// still contiguous across the warp, so no flipped copy exists. The matrix,
// the complement and the canonical chars sit in shared memory, and warp
// shuffles reduce the score and identity sums. Packing codes and chars into
// one array and wider loads are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxAlpha = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kStar = '*';
constexpr uint8_t kFold = 0xDF;  // ~0x20: case-folded identity

// Code and char of the query at window position pos = qoff + j.
template <bool kRev>
__device__ __forceinline__ void query_at(const uint8_t* qc, const uint8_t* qch, bool rv,
                                         int qlen, int pos, const int32_t* s_comp,
                                         const uint8_t* s_c2c, int& code, int& ch) {
  if (kRev && rv) {
    code = s_comp[qc[qlen - 1 - pos]];
    ch = s_c2c[code];
  } else {
    code = qc[pos];
    ch = qch[pos];
  }
}

template <bool kUniform>
__device__ __forceinline__ int score_of(int qcode, int tcode, const int32_t* s_sub, int alpha,
                                        int match, int mismatch) {
  if (kUniform) return (qcode == tcode && qcode != alpha - 1) ? match : mismatch;
  return s_sub[qcode * alpha + tcode];
}

template <bool kRev, bool kUniform>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    rescore_e2e_kernel(const uint8_t* __restrict__ codes,
                       const uint8_t* __restrict__ chars, int64_t width,
                       const int32_t* __restrict__ lengths,
                       const int32_t* __restrict__ qrow,
                       const int32_t* __restrict__ trow,
                       const int32_t* __restrict__ diag,
                       const uint8_t* __restrict__ qrev,
                       const int32_t* __restrict__ sub,
                       const int32_t* __restrict__ comp,
                       const uint8_t* __restrict__ code2char, int alpha,
                       int match, int mismatch, int64_t h,
                       int32_t* __restrict__ score_out,
                       int32_t* __restrict__ first_out,
                       int32_t* __restrict__ last_out,
                       int32_t* __restrict__ idents_out) {
  __shared__ int32_t s_sub[kMaxAlpha * kMaxAlpha];
  __shared__ int32_t s_comp[kMaxAlpha];
  __shared__ uint8_t s_c2c[kMaxAlpha];
  if (!kUniform)
    for (int i = threadIdx.x; i < alpha * alpha; i += blockDim.x) s_sub[i] = sub[i];
  if (kRev)
    for (int i = threadIdx.x; i < alpha; i += blockDim.x) {
      s_comp[i] = comp[i];
      s_c2c[i] = code2char[i];
    }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t hit =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (hit >= h) return;  // whole warps leave together; no barrier follows

  const int q = qrow[hit];
  const int t = trow[hit];
  const int d = diag[hit];
  const int qlen = lengths[q];
  const int tlen = lengths[t];
  const int dist = d >= 0 ? d : -d;
  const bool pos_ok = d >= 0 ? dist < qlen : dist < tlen;
  const int ov = pos_ok ? (d >= 0 ? min(tlen, qlen - dist) : min(tlen - dist, qlen)) : 0;
  if (ov <= 0) {
    if (lane == 0) {
      score_out[hit] = 0;
      first_out[hit] = -1;
      last_out[hit] = -1;
      idents_out[hit] = 0;
    }
    return;
  }
  const bool rv = kRev && qrev[hit] != 0;
  const int qoff = d >= 0 ? dist : 0;
  const int64_t qbase = static_cast<int64_t>(q) * width;
  const int64_t tbase = static_cast<int64_t>(t) * width + (d >= 0 ? 0 : dist);
  const uint8_t* qc = codes + qbase;
  const uint8_t* qch = chars + qbase;
  const uint8_t* tc = codes + tbase;
  const uint8_t* tch = chars + tbase;

  int code, ch;
  query_at<kRev>(qc, qch, rv, qlen, qoff, s_comp, s_c2c, code, ch);
  const int first = (ch == kStar || tch[0] == kStar) ? 1 : 0;
  const int last_idx = ov - 1;
  int last = last_idx;
  if (last_idx > 0) {
    query_at<kRev>(qc, qch, rv, qlen, qoff + last_idx, s_comp, s_c2c, code, ch);
    if (ch == kStar || tch[last_idx] == kStar) last -= 1;
  }

  int s = 0;
  int idn = 0;
  for (int j = first + lane; j <= last; j += 32) {
    query_at<kRev>(qc, qch, rv, qlen, qoff + j, s_comp, s_c2c, code, ch);
    s += score_of<kUniform>(code, tc[j], s_sub, alpha, match, mismatch);
    idn += (ch & kFold) == (tch[j] & kFold);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(kFull, s, o);
    idn += __shfl_xor_sync(kFull, idn, o);
  }
  if (lane == 0) {
    score_out[hit] = max(s, 0);
    first_out[hit] = first;
    last_out[hit] = last;
    idents_out[hit] = idn;
  }
}

template <bool kRev, bool kUniform>
int launch(const uint8_t* codes, const uint8_t* chars, int64_t width, const int32_t* lengths,
           const int32_t* qrow, const int32_t* trow, const int32_t* diag, const uint8_t* qrev,
           const int32_t* sub, const int32_t* comp, const uint8_t* code2char, int alpha,
           int match, int mismatch, int64_t h, int32_t* score, int32_t* first, int32_t* last,
           int32_t* idents, void* stream) {
  if (alpha < 1 || alpha > kMaxAlpha) return -1;
  if (h <= 0) return 0;
  const int64_t blocks = (h + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rescore_e2e_kernel<kRev, kUniform><<<blocks, kWarpsPerBlock * 32, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      codes, chars, width, lengths, qrow, trow, diag, qrev, sub, comp, code2char, alpha, match,
      mismatch, h, score, first, last, idents);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// codes/chars: uint8[n_rows, width]; lengths: int32[n_rows];
// qrow/trow/diag: int32[h]; sub: int32[alpha, alpha] with alpha <= 32.
// Forward hits only, scored through the matrix (the protein path).
// Returns the launch's cudaGetLastError() (0 = launched), or -1 for an
// alphabet that does not fit the shared-memory matrix.
extern "C" int rescore_e2e(const uint8_t* codes, const uint8_t* chars,
                           int64_t width, const int32_t* lengths,
                           const int32_t* qrow, const int32_t* trow,
                           const int32_t* diag, const int32_t* sub, int alpha,
                           int64_t h, int32_t* score, int32_t* first,
                           int32_t* last, int32_t* idents, void* stream) {
  return launch<false, false>(codes, chars, width, lengths, qrow, trow, diag, nullptr, sub,
                              nullptr, nullptr, alpha, 0, 0, h, score, first, last, idents,
                              stream);
}

// As rescore_e2e, with reverse hits: qrev uint8[h] (0/1), comp int32[alpha]
// (values < alpha), code2char uint8[alpha]. uniform != 0 selects the
// uniform-matrix variant, which scores match/mismatch and never reads sub.
extern "C" int rescore_e2e_rev(const uint8_t* codes, const uint8_t* chars,
                               int64_t width, const int32_t* lengths,
                               const int32_t* qrow, const int32_t* trow,
                               const int32_t* diag, const uint8_t* qrev,
                               const int32_t* sub, const int32_t* comp,
                               const uint8_t* code2char, int alpha, int uniform,
                               int match, int mismatch, int64_t h, int32_t* score,
                               int32_t* first, int32_t* last, int32_t* idents,
                               void* stream) {
  if (uniform)
    return launch<true, true>(codes, chars, width, lengths, qrow, trow, diag, qrev, sub, comp,
                              code2char, alpha, match, mismatch, h, score, first, last,
                              idents, stream);
  return launch<true, false>(codes, chars, width, lengths, qrow, trow, diag, qrev, sub, comp,
                             code2char, alpha, match, mismatch, h, score, first, last, idents,
                             stream);
}
