// END_TO_END ungapped diagonal rescore of (qrow, trow, diag) hits.
//
// Replaces the Pallas TPU kernel plass_tpu/ops/pallas_rescore.py
// (_rescore_pairs_pallas -> _kernel_gathered_body + _score_and_canon +
// _reduce_windows, the default block-8 gathered variant) on the protein
// path: has_rev=False and a generic (blosum62) substitution matrix.
//
// Per hit, over the overlap window of length ov (pallas_rescore.py:150-171):
//   s[j]  = sub[q[qoff + j], t[toff + j]]
//   first = 1 if either char at j = 0 is '*', else 0
//   last  = ov - 1, less 1 if either char there is '*' (and ov - 1 > 0)
//   score = max(0, sum s[first..last]); idents counts case-folded char
//   matches over the same window; ov <= 0 gives score 0, first = last = -1.
//
// What bounds it on Hopper: latency of the random row reads. Each hit reads
// two windows of ov bytes from rows chosen by index, twice (codes and
// chars), and does a few integer operations per byte; at ~10^5 hits a call
// is a few MB of scattered reads. The TPU kernel streamed whole rows into
// VMEM, rolled the window to lane 0 and looked the scores up with a one-hot
// MXU contraction. Here one warp takes one hit: the 32 lanes stride over
// the window reading the uint8 rows by index (no power-of-two width, no
// roll), the 21x21 matrix sits in shared memory, and warp shuffles reduce
// the score and identity sums. Packing codes and chars into one array and
// wider loads are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxAlpha = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kStar = '*';
constexpr uint8_t kFold = 0xDF;  // ~0x20: case-folded identity

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    rescore_e2e_kernel(const uint8_t* __restrict__ codes,
                       const uint8_t* __restrict__ chars, int64_t width,
                       const int32_t* __restrict__ lengths,
                       const int32_t* __restrict__ qrow,
                       const int32_t* __restrict__ trow,
                       const int32_t* __restrict__ diag,
                       const int32_t* __restrict__ sub, int alpha, int64_t h,
                       int32_t* __restrict__ score_out,
                       int32_t* __restrict__ first_out,
                       int32_t* __restrict__ last_out,
                       int32_t* __restrict__ idents_out) {
  __shared__ int32_t s_sub[kMaxAlpha * kMaxAlpha];
  for (int i = threadIdx.x; i < alpha * alpha; i += blockDim.x) s_sub[i] = sub[i];
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
  const int64_t qbase = static_cast<int64_t>(q) * width + (d >= 0 ? dist : 0);
  const int64_t tbase = static_cast<int64_t>(t) * width + (d >= 0 ? 0 : dist);
  const uint8_t* qc = codes + qbase;
  const uint8_t* tc = codes + tbase;
  const uint8_t* qch = chars + qbase;
  const uint8_t* tch = chars + tbase;

  const int first = (qch[0] == kStar || tch[0] == kStar) ? 1 : 0;
  const int last_idx = ov - 1;
  const int last =
      last_idx - ((last_idx > 0 && (qch[last_idx] == kStar || tch[last_idx] == kStar)) ? 1 : 0);

  int s = 0;
  int idn = 0;
  for (int j = first + lane; j <= last; j += 32) {
    s += s_sub[qc[j] * alpha + tc[j]];
    idn += (qch[j] & kFold) == (tch[j] & kFold);
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

}  // namespace

// codes/chars: uint8[n_rows, width]; lengths: int32[n_rows];
// qrow/trow/diag: int32[h]; sub: int32[alpha, alpha] with alpha <= 32.
// Returns the launch's cudaGetLastError() (0 = launched), or -1 for an
// alphabet that does not fit the shared-memory matrix.
extern "C" int rescore_e2e(const uint8_t* codes, const uint8_t* chars,
                           int64_t width, const int32_t* lengths,
                           const int32_t* qrow, const int32_t* trow,
                           const int32_t* diag, const int32_t* sub, int alpha,
                           int64_t h, int32_t* score, int32_t* first,
                           int32_t* last, int32_t* idents, void* stream) {
  if (alpha < 1 || alpha > kMaxAlpha) return -1;
  if (h <= 0) return 0;
  const int64_t blocks = (h + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rescore_e2e_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      codes, chars, width, lengths, qrow, trow, diag, sub, alpha, h, score,
      first, last, idents);
  return static_cast<int>(cudaGetLastError());
}
