// PSSM / profile computation with exact reference float semantics.
//
// Re-implements the algorithms of lib/mmseqs/src/alignment/PSSMCalculator.cpp
// (sequence weights: Henikoff 1994; context-specific weights: Steinegger &
// Soeding 2014; substitution-matrix pseudocounts; 2-bit log-odds char PSSM)
// including the SIMD-approximation details that are observable in the output
// bytes: the AVX2 _mm256_rcp_ps + one Newton-Raphson step used for the
// weight contributions (PSSMCalculator.cpp:386-400) and the SSE ScalarProd20
// summation tree (lib/simd/simd.h:508-560). The reference binaries on this
// target are AVX2 builds, so VECSIZE_INT=8 / 32-byte blocks.
#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <algorithm>
#include <immintrin.h>

namespace {

const int NAA = 20;     // MultipleAlignment.h:17
const int ANY = 20;
const int GAP = 21;
const int ENDGAP = 22;
const int PROFILE_AA_SIZE = 20;

// MathUtil::flog2 (MathUtil.h:107-119): 5th-order polynomial approximation
static inline float flog2(float x) {
    if (x <= 0) return -128;
    int px;
    memcpy(&px, &x, 4);
    float e = (float)(((px & 0x7F800000) >> 23) - 0x7f);
    px = (px & 0x007FFFFF) | 0x3f800000;
    memcpy(&x, &px, 4);
    // the polynomial constants are double literals in the reference, so the
    // whole expression evaluates in double before narrowing back to float
    x -= 1.0;
    x *= (1.441740 + x * (-0.7077702 + x * (0.4123442 + x * (-0.1903190 + x * 0.0440047))));
    return x + e;
}

// MathUtil::fpow2 (MathUtil.h:121-146)
static inline double fpow2(float x) {
    if (x >= 128) return 3.402823466e+38;
    if (x <= -125) return 0.0f;
    float tx = (x - 0.5f) + (3 << 22);
    int lx;
    memcpy(&lx, &tx, 4);
    lx -= 0x4b400000;
    float dx = x - (float)(lx);
    x = 1.0f + dx * (0.693019f + dx * (0.241404f + dx * (0.0520749f + dx * 0.0134929f)));
    int px;
    memcpy(&px, &x, 4);
    px += (lx << 23);
    memcpy(&x, &px, 4);
    return x;
}

// MathUtil::NormalizeTo1 (MathUtil.h:241-257)
static inline void normalize_to_1(float* a, int len, const double* def) {
    float sum = 0.0f;
    for (int k = 0; k < len; k++) sum += a[k];
    if (sum != 0.0f) {
        float fac = 1.0 / sum;
        for (int i = 0; i < len; i++) a[i] *= fac;
    } else if (def) {
        for (int i = 0; i < len; i++) a[i] = def[i];
    }
}

// ScalarProd20 (lib/simd/simd.h:508-560): SSE pairwise-sum tree
static inline float scalar_prod20(const float* qi, const float* tj) {
    __m128 P1 = _mm_mul_ps(_mm_loadu_ps(qi), _mm_loadu_ps(tj));
    __m128 P2 = _mm_mul_ps(_mm_loadu_ps(qi + 4), _mm_loadu_ps(tj + 4));
    __m128 R1 = _mm_add_ps(P1, P2);
    __m128 P3 = _mm_mul_ps(_mm_loadu_ps(qi + 8), _mm_loadu_ps(tj + 8));
    __m128 P4 = _mm_mul_ps(_mm_loadu_ps(qi + 12), _mm_loadu_ps(tj + 12));
    __m128 R2 = _mm_add_ps(P3, P4);
    __m128 P5 = _mm_mul_ps(_mm_loadu_ps(qi + 16), _mm_loadu_ps(tj + 16));
    __m128 R = _mm_add_ps(_mm_add_ps(R1, R2), P5);
    __m128 P = _mm_shuffle_ps(R, R, _MM_SHUFFLE(2, 0, 2, 0));
    R = _mm_shuffle_ps(R, R, _MM_SHUFFLE(3, 1, 3, 1));
    R = _mm_add_ps(R, P);
    P = _mm_shuffle_ps(R, R, _MM_SHUFFLE(2, 0, 2, 0));
    R = _mm_shuffle_ps(R, R, _MM_SHUFFLE(3, 1, 3, 1));
    R = _mm_add_ps(R, P);
    float res;
    _mm_store_ss(&res, R);
    return res;
}

// PSSMCalculator::computeSequenceWeights (PSSMCalculator.cpp:203-262)
static void compute_sequence_weights(float* seqWeight, int64_t queryLength,
                                     int64_t setSize, const char* const* X) {
    std::fill(seqWeight, seqWeight + setSize, 1e-6f);
    int* number_res = new int[setSize];
    for (int64_t k = 0; k < setSize; ++k) {
        int nr = 0;
        for (int64_t pos = 0; pos < queryLength; pos++)
            if (X[k][pos] != GAP) nr++;
        number_res[k] = nr;
    }
    int nl[PROFILE_AA_SIZE];
    for (int64_t pos = 0; pos < queryLength; pos++) {
        std::fill(nl, nl + PROFILE_AA_SIZE, 0);
        for (int64_t k = 0; k < setSize; ++k) {
            if (X[k][pos] != GAP) {
                unsigned int aa = (unsigned char)X[k][pos];
                if (aa < PROFILE_AA_SIZE) nl[aa]++;
            }
        }
        int distinct = 0;
        for (int aa = 0; aa < PROFILE_AA_SIZE; ++aa) if (nl[aa]) ++distinct;
        for (int64_t k = 0; k < setSize; ++k) {
            if (X[k][pos] != GAP && distinct != 0) {
                unsigned int aa = (unsigned char)X[k][pos];
                if (aa < PROFILE_AA_SIZE)
                    seqWeight[k] += 1.0f / (float(nl[aa]) * float(distinct) * (float(number_res[k]) + 30.0f));
            }
        }
    }
    delete[] number_res;
}

// PSSMCalculator::computeMatchWeights (PSSMCalculator.cpp:283-298)
static void compute_match_weights(float* matchWeight, const float* seqWeight,
                                  int64_t setSize, int64_t queryLength,
                                  const char* const* X, const double* pBack) {
    for (int64_t pos = 0; pos < queryLength; pos++) {
        memset(matchWeight + pos * PROFILE_AA_SIZE, 0, PROFILE_AA_SIZE * sizeof(float));
        for (int64_t k = 0; k < setSize; ++k) {
            if (X[k][pos] != GAP) {
                unsigned int aa = (unsigned char)X[k][pos];
                if (aa < PROFILE_AA_SIZE)
                    matchWeight[pos * PROFILE_AA_SIZE + aa] += seqWeight[k];
            }
        }
        normalize_to_1(&matchWeight[pos * PROFILE_AA_SIZE], PROFILE_AA_SIZE, pBack);
    }
}

// PSSMCalculator::computeNeff_M (PSSMCalculator.cpp:165-189)
static void compute_neff_m(const float* frequency, const float* seqWeight, float* Neff_M,
                           int64_t queryLength, int64_t setSize, const char* const* X) {
    float Neff_HMM = 0.0f;
    for (int64_t pos = 0; pos < queryLength; pos++) {
        float sum = 0.0f;
        for (int aa = 0; aa < PROFILE_AA_SIZE; ++aa) {
            float f = frequency[pos * PROFILE_AA_SIZE + aa];
            if (f > 1E-10) sum -= f * flog2(f);
        }
        Neff_HMM += fpow2(sum);
    }
    Neff_HMM /= queryLength;
    float Nlim = fmax(10.0, Neff_HMM + 1.0);
    float scale = flog2((Nlim - Neff_HMM) / (Nlim - 1.0));
    for (int64_t pos = 0; pos < queryLength; pos++) {
        float w_M = -1.0 / setSize;
        for (int64_t k = 0; k < setSize; ++k)
            if (X[k][pos] != GAP) w_M += seqWeight[k];
        Neff_M[pos] = (w_M < 0) ? 1.0 : Nlim - (Nlim - 1.0) * fpow2(scale * w_M);
    }
}

// PSSMCalculator::computeContextSpecificWeights (PSSMCalculator.cpp:300-464)
// 32-byte AVX2 block layout: NAA+3=23 floats round up to 32-float rows.
static void compute_context_specific_weights(float* matchWeight, const float* wg,
                                             float* Neff_M, int64_t queryLength,
                                             int64_t setSize, char** X,
                                             const double* pBack) {
    const float MAXENDGAPFRAC = 0.1;
    const int NCOLMIN = 20;
    const int ROW = 32;  // NAA+3=23 rounded to VECSIZE_FLOAT(8), aligned 32B

    int nseqi = 0;
    int* n = (int*)aligned_alloc(32, ROW * (queryLength + 2) * sizeof(int));
    float* w_contrib = (float*)aligned_alloc(32, ROW * (queryLength + 1) * sizeof(float));
    float* wi = (float*)malloc(setSize * sizeof(float));
    int* naa = (int*)malloc((queryLength + 1) * sizeof(int));
    float* f = (float*)malloc((queryLength + 1) * (NAA + 3) * sizeof(float));
    memset(n, 0, ROW * queryLength * sizeof(int));
    memset(w_contrib, 0, ROW * queryLength * sizeof(float));

    // insert endgaps
    for (int64_t k = 0; k < setSize; ++k) {
        for (int64_t i = 0; i < queryLength && X[k][i] == GAP; ++i) X[k][i] = ENDGAP;
        for (int64_t i = queryLength - 1; i >= 0 && X[k][i] == GAP; i--) X[k][i] = ENDGAP;
    }

    for (int64_t i = 0; i < queryLength; i++) {
        bool change = false;
        for (int64_t k = 0; k < setSize; ++k) {
            if ((i == 0 && X[k][i] < ANY) ||
                (i != 0 && X[k][i - 1] >= ANY && X[k][i] < ANY)) {
                change = true;
                nseqi++;
                for (int64_t j = 0; j < queryLength; ++j) n[j * ROW + (int)X[k][j]]++;
            } else if (i != 0 && X[k][i - 1] < ANY && X[k][i] >= ANY) {
                change = true;
                nseqi--;
                for (int64_t j = 0; j < queryLength; ++j) n[j * ROW + (int)X[k][j]]--;
            }
        }
        if (change) {
            for (int64_t k = 0; k < setSize; ++k) wi[k] = 1E-8;
            int jmin, jmax;
            for (jmin = 0; jmin < (int)queryLength && n[jmin * ROW + ENDGAP] > MAXENDGAPFRAC * nseqi; ++jmin) {}
            for (jmax = queryLength - 1; jmax >= 0 && n[jmax * ROW + ENDGAP] > MAXENDGAPFRAC * nseqi; --jmax) {}
            int ncol = jmax - jmin + 1;

            if (ncol < NCOLMIN) {
                for (int64_t k = 0; k < setSize; ++k)
                    wi[k] = (X[k][i] < ANY) ? wg[k] : 0.0f;
            } else {
                for (int j = jmin; j <= jmax; ++j) {
                    naa[j] = 0;
                    for (int a = 0; a < ANY; ++a) naa[j] += (n[j * ROW + a] ? 1 : 0);
                }
                for (int j = jmin; j <= jmax; ++j) {
                    // AVX2 approximate reciprocal + 1 Newton-Raphson step
                    // (PSSMCalculator.cpp:386-400); aa_size = (20+8-1)/8 = 3
                    __m256 naa_j = _mm256_cvtepi32_ps(_mm256_set1_epi32(naa[j]));
                    const __m256i* nj = (const __m256i*)(n + j * ROW);
                    for (int a = 0; a < 3; ++a) {
                        __m256 nja = _mm256_cvtepi32_ps(_mm256_load_si256(nj + a));
                        __m256 res = _mm256_mul_ps(nja, naa_j);
                        __m256 rcp = _mm256_rcp_ps(res);
                        __m256 mul = _mm256_mul_ps(res, _mm256_mul_ps(rcp, rcp));
                        _mm256_store_ps(w_contrib + j * ROW + a * 8,
                                        _mm256_sub_ps(_mm256_add_ps(rcp, rcp), mul));
                    }
                    for (int a = ANY; a < NAA + 3; ++a) w_contrib[j * ROW + a] = 0.0f;
                }
                for (int64_t k = 0; k < setSize; ++k) {
                    if (X[k][i] >= ANY) continue;
                    for (int j = jmin; j <= jmax; ++j)
                        wi[k] += w_contrib[j * ROW + (int)X[k][j]];
                }
            }

            Neff_M[i] = 0.0;
            for (int j = jmin; j <= jmax; ++j)
                memset(f + j * (NAA + 3), 0, ANY * sizeof(float));
            for (int64_t k = 0; k < setSize; ++k) {
                if (X[k][i] >= ANY) continue;
                for (int j = jmin; j <= jmax; ++j)
                    f[j * (NAA + 3) + (int)X[k][j]] += wi[k];
            }
            for (int j = jmin; j <= jmax; ++j) {
                normalize_to_1(f + j * (NAA + 3), NAA, NULL);
                for (int a = 0; a < 20; ++a)
                    if (f[j * (NAA + 3) + a] > 1E-10)
                        Neff_M[i] -= f[j * (NAA + 3) + a] * flog2(f[j * (NAA + 3) + a]);
            }
            Neff_M[i] = (ncol > 0) ? (float)fpow2(Neff_M[i] / ncol) : 1.0;
        } else {
            Neff_M[i] = (i == 0) ? 0.0f : Neff_M[i - 1];
        }

        for (int a = 0; a < 20; ++a) matchWeight[i * PROFILE_AA_SIZE + a] = 0.0;
        for (int64_t k = 0; k < setSize; ++k)
            matchWeight[i * PROFILE_AA_SIZE + (int)X[k][i]] += wi[k];
        normalize_to_1(matchWeight + i * PROFILE_AA_SIZE, NAA, pBack);
    }
    // remove end gaps
    for (int64_t k = 0; k < setSize; ++k) {
        for (int64_t i = 0; i < queryLength && X[k][i] == ENDGAP; ++i) X[k][i] = GAP;
        for (int64_t i = queryLength - 1; i >= 0 && X[k][i] == ENDGAP; i--) X[k][i] = GAP;
    }
    free(n); free(w_contrib); free(wi); free(naa); free(f);
}

}  // namespace

extern "C" {

// msa: setSize rows x rowStride cols, values 0..19, 20=X, 21=GAP. The MSA
// columns used are [0, queryLength); rows must be padded with GAP beyond.
// Outputs: pssm (queryLength*20 int8), profile (float), neff (float),
// consensus (uint8 aa nums). Mirrors PSSMCalculator::computePSSMFromMSA.
void pssm_compute(char* msa, int64_t setSize, int64_t queryLength,
                  int64_t rowStride, int wg, float pca, float pcb,
                  const double* pBack, const float* pseudoR /*21*32 aligned rows*/,
                  char* pssmOut, float* profileOut, float* neffOut,
                  unsigned char* consensusOut) {
    char** X = new char*[setSize];
    for (int64_t k = 0; k < setSize; ++k) X[k] = msa + k * rowStride;

    float* seqWeight = new float[setSize];
    // +32 floats: the ANY/GAP/ENDGAP spill of the per-column accumulation
    // writes up to 3 floats past row i (harmless in the reference's
    // (maxSeqLen+1)*20 buffer, PSSMCalculator.cpp:455-458)
    size_t bufBytes = ((queryLength * PROFILE_AA_SIZE + 32) * sizeof(float) + 31) / 32 * 32;
    float* matchWeight = (float*)aligned_alloc(32, bufBytes);
    float* pcWeight = (float*)aligned_alloc(32, bufBytes);

    compute_sequence_weights(seqWeight, queryLength, setSize, X);
    {   // MathUtil::NormalizeTo1 over seqWeight
        normalize_to_1(seqWeight, setSize, NULL);
    }
    if (!wg) {
        compute_context_specific_weights(matchWeight, seqWeight, neffOut, queryLength, setSize, X, pBack);
    } else {
        compute_match_weights(matchWeight, seqWeight, setSize, queryLength, X, pBack);
        compute_neff_m(matchWeight, seqWeight, neffOut, queryLength, setSize, X);
    }

    // computeConsensusSequence (PSSMCalculator.cpp:466-482); emits aa nums
    for (int64_t pos = 0; pos < queryLength; pos++) {
        float maxw = 1E-8;
        int maxa = ANY;
        for (int aa = 0; aa < PROFILE_AA_SIZE; ++aa) {
            float prob = matchWeight[pos * PROFILE_AA_SIZE + aa];
            // float - double comparison promotes to double (PSSMCalculator.cpp:471)
            if (prob - pBack[aa] > maxw) {
                maxw = prob - pBack[aa];
                maxa = aa;
            }
        }
        consensusOut[pos] = (unsigned char)maxa;
    }

    if (pca > 0.0) {
        // preparePseudoCounts (PSSMCalculator.cpp:150-158)
        for (int64_t pos = 0; pos < queryLength; pos++)
            for (int aa = 0; aa < PROFILE_AA_SIZE; aa++)
                pcWeight[pos * PROFILE_AA_SIZE + aa] =
                    scalar_prod20(pseudoR + aa * 32, &matchWeight[pos * PROFILE_AA_SIZE]);
        // computePseudoCounts (PSSMCalculator.cpp:264-281)
        for (int64_t pos = 0; pos < queryLength; pos++) {
            float tau = fmin(1.0, pca / (1.0 + neffOut[pos] / pcb));
            for (int aa = 0; aa < PROFILE_AA_SIZE; ++aa) {
                float pc = tau * pcWeight[pos * PROFILE_AA_SIZE + aa];
                float sig = (1.0 - tau) * matchWeight[pos * PROFILE_AA_SIZE + aa];
                profileOut[pos * PROFILE_AA_SIZE + aa] = sig + pc;
            }
        }
    } else {
        for (int64_t pos = 0; pos < queryLength; pos++)
            for (int aa = 0; aa < PROFILE_AA_SIZE; ++aa)
                profileOut[pos * PROFILE_AA_SIZE + aa] = matchWeight[pos * PROFILE_AA_SIZE + aa];
    }

    // computeLogPSSM (PSSMCalculator.cpp:135-148), bitFactor 2.0, bias 0.0
    for (int64_t pos = 0; pos < queryLength; pos++) {
        for (int aa = 0; aa < PROFILE_AA_SIZE; aa++) {
            const float aaProb = profileOut[pos * PROFILE_AA_SIZE + aa];
            float logProb = flog2(aaProb / (float)pBack[aa]);
            const float pssmVal = 2.0f * logProb + 0.0f;
            float trunc = std::min(pssmVal, 127.0f);
            trunc = std::max(-128.0f, trunc);
            pssmOut[pos * PROFILE_AA_SIZE + aa] = (char)((trunc < 0.0) ? trunc - 0.5 : trunc + 0.5);
        }
    }

    delete[] X;
    delete[] seqWeight;
    free(matchWeight);
    free(pcWeight);
}

// MathUtil::convertNeffToChar (MathUtil.h:216-219)
unsigned char pssm_neff_to_char(float neff) {
    float retVal = std::min(255.0f, 1.0f + 64.0f * flog2(neff));
    unsigned char c = (unsigned char)(retVal + 0.5);
    return std::max((unsigned char)1, c);
}

// Sequence::scoreMask = convertFloatToChar(prob)+1 (Sequence.h:469-473,
// MathUtil.h minifloat with 3 exponent / 5 mantissa bits)
unsigned char pssm_score_mask(float v) {
    const int MANTISSA_BITS = 5, EXPONENT_BITS = 3;
    const int EXPONENT_MAX = (1 << EXPONENT_BITS) - 1;
    const int EXCESS = (1 << EXPONENT_BITS) - 2;
    const int MANTISSA_MAX = (1 << MANTISSA_BITS) - 1;
    const int HIDDEN_BIT = 1 << MANTISSA_BITS;
    const float ONE_FLOAT = (float)(1 << (MANTISSA_BITS + 1));
    const int MINIFLOAT_MAX = (EXPONENT_MAX << MANTISSA_BITS) | MANTISSA_MAX;
    unsigned char charProb;
    if (std::isnan(v) || v <= 0.0f) {
        charProb = 0;
    } else if (v >= 2.0f) {
        charProb = MINIFLOAT_MAX;
    } else {
        int exp;
        float r = frexpf(v, &exp);
        if ((exp += EXCESS) > EXPONENT_MAX) {
            charProb = MINIFLOAT_MAX;
        } else if (-exp >= MANTISSA_BITS) {
            charProb = 0;
        } else {
            int mantissa = (int)(r * ONE_FLOAT);
            charProb = exp > 0 ? (exp << MANTISSA_BITS) | (mantissa & ~HIDDEN_BIT)
                               : (mantissa >> (1 - exp)) & MANTISSA_MAX;
        }
    }
    return charProb + 1;
}

// Sequence::scoreUnmask (Sequence.h:475-478)
// standalone computeSequenceWeights over a row-strided MSA (used by
// msa2result's weighted match-ratio masking, msa2result.cpp:327)
void pssm_seq_weights(const unsigned char* msa, int64_t setSize,
                      int64_t rowStride, int64_t queryLength, float* out) {
    const char** X = new const char*[setSize];
    for (int64_t k = 0; k < setSize; ++k)
        X[k] = (const char*)(msa + k * rowStride);
    compute_sequence_weights(out, queryLength, setSize, X);
    delete[] X;
}

float pssm_score_unmask(unsigned char score) {
    const int MANTISSA_BITS = 5, EXPONENT_BITS = 3;
    const int EXPONENT_MAX = (1 << EXPONENT_BITS) - 1;
    const int EXCESS = (1 << EXPONENT_BITS) - 2;
    const int MANTISSA_MAX = (1 << MANTISSA_BITS) - 1;
    const int HIDDEN_BIT = 1 << MANTISSA_BITS;
    const float ONE_FLOAT = (float)(1 << (MANTISSA_BITS + 1));
    char a = (char)(score - 1);
    int mantissa = a & MANTISSA_MAX;
    int exponent = (a >> MANTISSA_BITS) & EXPONENT_MAX;
    return ldexpf((exponent > 0 ? HIDDEN_BIT | mantissa : mantissa << 1) / ONE_FLOAT,
                  exponent - EXCESS);
}

float pssm_neff_to_float(unsigned char c) {
    return (float)fpow2(((float)c - 1.0f) / 64.0f);
}

float pssm_scalar_prod20(const float* a, const float* b) {
    return scalar_prod20(a, b);
}

float pssm_flog2(float x) {
    return flog2(x);
}

}  // extern "C"
