// Best ungapped-diagonal score over all diagonals with saturated uint8
// arithmetic (reference: SmithWaterman::ungapped_alignment,
// lib/mmseqs/src/alignment/StripedSmithWaterman.cpp:1105-1163). The striped
// SIMD recurrence is cell-equivalent to the scalar saturated DP
// S(i,j) = max(0, sat255(S(i-1,j-1) + qprof[x_j][i]) - bias); trailing
// padded positions carry values through non-increasing ops and cannot raise
// the max, so the result is independent of the vector width.
#include <immintrin.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// True 256-bit left shift by one byte (simd.h:183-187 _mm256_shift_left<1>).
static inline __m256i shift_left1(__m256i a) {
    __m256i mask = _mm256_permute2x128_si256(a, a, _MM_SHUFFLE(0, 0, 3, 0));
    return _mm256_alignr_epi8(a, mask, 15);
}

}  // namespace

extern "C" {

// qprof: [A][L] uint8 profile bytes (= score + bias, saturated-cast),
// bias: the profile offset; t: target numeric sequence of length T.
int32_t ungapped_max_score(const uint8_t* qprof, int64_t L, int64_t A,
                           uint8_t bias, const uint8_t* t, int64_t T) {
    uint8_t best = 0;
    for (int64_t d = -(T - 1); d < L; ++d) {
        int64_t qs = d >= 0 ? d : 0;
        int64_t ts = d >= 0 ? 0 : -d;
        int64_t m = std::min(L - qs, T - ts);
        uint8_t s = 0;
        for (int64_t k = 0; k < m; ++k) {
            uint16_t add = (uint16_t)s + (uint16_t)qprof[(int64_t)t[ts + k] * L + qs + k];
            s = add > 255 ? 255 : (uint8_t)add;
            s = s > bias ? s - bias : 0;
            if (s > best) best = s;
        }
    }
    return best;
}

// Batched all-targets variant: builds the striped profile once from the
// [A][L] linear profile and runs the reference band recurrence per target.
// tdata: concatenated numeric target sequences; toffs/tlens per target.
// out[n]: best saturated-uint8 score per target.
void ungapped_all(const uint8_t* qprof, int64_t L, int64_t A, uint8_t bias,
                  const uint8_t* tdata, const int64_t* toffs,
                  const int64_t* tlens, int64_t n, int32_t* out) {
    const int lanes = 32;
    const int64_t W = (L + lanes - 1) / lanes;  // band width in vectors
    // striped slot: vector i, lane b <-> query position i + b*W
    std::vector<uint8_t> striped((size_t)A * W * lanes, bias);
    for (int64_t a = 0; a < A; ++a) {
        for (int64_t p = 0; p < L; ++p) {
            int64_t i = p % W, b = p / W;
            striped[(size_t)(a * W + i) * lanes + b] = qprof[a * L + p];
        }
    }
    const __m256i* prof = (const __m256i*)striped.data();
    const __m256i off = _mm256_set1_epi8((char)bias);
#pragma omp parallel for schedule(dynamic, 8)
    for (int64_t ti = 0; ti < n; ++ti) {
        const uint8_t* t = tdata + toffs[ti];
        const int64_t T = tlens[ti];
        // unaligned-load buffers (vector<__m256i> would need 32B alignment)
        std::vector<uint8_t> bufA(W * 32, 0), bufB(W * 32, 0);
        __m256i* s_curr = (__m256i*)bufA.data();
        __m256i* s_prev = (__m256i*)bufB.data();
        __m256i smax = _mm256_setzero_si256();
        for (int64_t j = 0; j < T; ++j) {
            const __m256i* qji = prof + (int64_t)t[j] * W;
            __m256i S = shift_left1(_mm256_loadu_si256(s_curr + W - 1));
            std::swap(s_prev, s_curr);
            for (int64_t i = 0; i < W; ++i) {
                S = _mm256_adds_epu8(S, _mm256_loadu_si256(qji + i));
                S = _mm256_subs_epu8(S, off);
                _mm256_storeu_si256(s_curr + i, S);
                smax = _mm256_max_epu8(smax, S);
                S = _mm256_loadu_si256(s_prev + i);
            }
        }
        uint8_t tmp[32];
        _mm256_storeu_si256((__m256i*)tmp, smax);
        uint8_t best = 0;
        for (int k = 0; k < 32; ++k) best = std::max(best, tmp[k]);
        out[ti] = best;
    }
}

}  // extern "C"
