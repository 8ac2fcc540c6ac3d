// ProfileStates discretization kernels — exact float-semantics replicas of
// the reference's context-state assignment (ProfileStates.cpp:308-448,
// ProfileStates.h:61-106). Used by profile2cs (profile2cs.cpp:16-105) and
// convertprofiledb. The reference compiles with AVX2, so the squared-diff
// reduction runs in 8 float lanes accumulated per chunk and then summed
// lane-by-lane; we reproduce that accumulation order scalar-wise.
#include <cfloat>
#include <cstdint>
#include <cstring>

// MathUtil::flog2 (MathUtil.h:107-119)
static inline float ps_flog2(float x) {
    if (x <= 0) return -128;
    int px;
    memcpy(&px, &x, 4);
    float e = (float)(((px & 0x7F800000) >> 23) - 0x7f);
    px = (px & 0x007FFFFF) | 0x3f800000;
    memcpy(&x, &px, 4);
    x -= 1.0;
    x *= (1.441740 + x * (-0.7077702 + x * (0.4123442 + x * (-0.1903190 + x * 0.0440047))));
    return x + e;
}

// MathUtil::fpow2 (MathUtil.h:121-146)
static inline double ps_fpow2_impl(float x) {
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

// ProfileStates::score(profileA, background, profileB) — the HHBlits
// column score: flog2(sum_aa B[aa]*A[aa]/bg[aa]) (ProfileStates.h:96-103).
static inline float ps_score_impl(const float* a, const float* b,
                                  const float* bg) {
    float result = 0.0f;
    for (int aa = 0; aa < 20; aa++) {
        result += b[aa] * a[aa] / bg[aa];
    }
    return ps_flog2(result);
}

extern "C" {

double ps_fpow2(float x) { return ps_fpow2_impl(x); }

float ps_score(const float* a, const float* b, const float* bg) {
    return ps_score_impl(a, b, bg);
}

// discProfScores[k][l] = score(profiles[k], profiles[l])
// (ProfileStates.cpp:248-263); out is (K, ceilK) zero-initialised.
void ps_disc_scores(const float* states, const float* bg, int64_t K,
                    int64_t ceilK, float* out) {
    for (int64_t k = 0; k < K; k++) {
        for (int64_t l = 0; l < K; l++) {
            out[k * ceilK + l] =
                ps_score_impl(states + k * 20, states + l * 20, bg);
        }
    }
}

// ProfileStates::discretize (ProfileStates.cpp:308-397). prof is (L,20)
// probability columns; states (K,20); prior and disc zero-padded to ceilK
// (mirrors the reference's zero-padded repScore/discProfScores reads past
// alphSize, which contribute exactly 0 to the sum).
void ps_discretize(const float* prof, int64_t L, const float* states,
                   const float* prior, const float* disc, const float* bg,
                   int64_t K, int64_t ceilK, uint8_t* out) {
    float repScore[256];
    memset(repScore, 0, sizeof(repScore));
    for (int64_t i = 0; i < L; i++) {
        const float* col = prof + i * 20;
        float minDiffScore = FLT_MAX;
        char closestState = 0;
        for (int64_t k = 0; k < K; k++) {
            repScore[k] = ps_score_impl(col, states + k * 20, bg);
        }
        for (int64_t k = 0; k < K; k++) {
            float lanes[8] = {0, 0, 0, 0, 0, 0, 0, 0};
            const float* dk = disc + k * ceilK;
            for (int64_t l = 0; l < ceilK; l += 8) {
                for (int j = 0; j < 8; j++) {
                    float diff = repScore[l + j] - dk[l + j];
                    lanes[j] += prior[l + j] * (diff * diff);
                }
            }
            float curDiffScore = 0.0f;
            for (int j = 0; j < 8; j++) curDiffScore += lanes[j];
            if (curDiffScore < minDiffScore) {
                minDiffScore = curDiffScore;
                closestState = (char)k;
            }
        }
        out[i] = (uint8_t)closestState;
    }
}

// ProfileStates::discretizeCs219 (ProfileStates.cpp:401-423): posterior
// argmax of prior[k] * score(state_k, column); first max wins (strict >).
void ps_discretize_cs219(const float* prof, int64_t L, const float* states,
                         const float* prior, const float* bg, int64_t K,
                         uint8_t* out) {
    for (int64_t i = 0; i < L; i++) {
        const float* col = prof + i * 20;
        double max = -FLT_MAX;
        int64_t k_max = 0;
        for (int64_t k = 0; k < K; k++) {
            float rep = prior[k] * ps_score_impl(states + k * 20, col, bg);
            k_max = (rep > max) ? k : k_max;
            max = (rep > max) ? rep : max;
        }
        out[i] = (uint8_t)k_max;
    }
}

}  // extern "C"

// ---- Profile-query scoring (Sequence::mapProfile mapScores=true,
// Sequence.cpp:330-363) ----------------------------------------------

// Sequence.h:480-483 probaToBitScore = flog2(proba / pBack)
// profile_score[pos][aa] = round-half-away(bitScore * 2) * 4 (short),
// X-state clamp (<= -128) to -1; then optional global composition-bias
// correction (SubstitutionMatrix::calcGlobalAaBiasCorrection,
// SubstitutionMatrix.cpp:216-257); then the rankedDescSort20 sorting
// network (Util.cpp:144-170); profile_for_alignment[aa][pos] = score / 4.
extern "C" void pq_map_profile(const float* prob /*L*20*/,
                               const double* pback, int64_t L,
                               int comp_bias,
                               int16_t* sorted_scores /*L*20*/,
                               uint32_t* sorted_index /*L*20*/,
                               int8_t* aln_profile /*20*L*/) {
    int16_t* scores = new int16_t[L * 20];
    for (int64_t pos = 0; pos < L; pos++) {
        for (int aa = 0; aa < 20; aa++) {
            double proba = (double)prob[pos * 20 + aa];
            float bitScore = ps_flog2((float)(proba / pback[aa]));
            if (bitScore <= -128) bitScore = -1;
            double bitScore8 = bitScore * 2.0 + 0.0;
            short v = (short)((bitScore8 < 0.0) ? bitScore8 - 0.5
                                                : bitScore8 + 0.5);
            scores[pos * 20 + aa] = (int16_t)(v * 4);
        }
    }
    if (comp_bias) {
        float* pNull = new float[L];
        for (int64_t pos = 0; pos < L; pos++) {
            pNull[pos] = 0.0f;
            for (int aa = 0; aa < 20; aa++) {
                pNull[pos] += pback[aa] * (float)scores[pos * 20 + aa];
            }
        }
        const int windowSize = 40;
        // the reference updates profileScores in place per position i,
        // but reads neighbours j != i from the ALREADY-UPDATED array for
        // j < i — replicate in-place semantics
        for (int64_t i = 0; i < L; i++) {
            int minPos = (int)((i - windowSize / 2) > 0 ? i - windowSize / 2 : 0);
            int maxPos = (int)((i + windowSize / 2) < L ? i + windowSize / 2 : L);
            int windowLength = maxPos - minPos;
            float aaSum[20];
            for (int aa = 0; aa < 20; aa++) aaSum[aa] = 0.0f;
            for (int j = minPos; j < maxPos; j++) {
                if (j == (int)i) continue;
                for (int aa = 0; aa < 20; aa++) {
                    aaSum[aa] += scores[j * 20 + aa] - pNull[j];
                }
            }
            for (int aa = 0; aa < 20; aa++) {
                scores[i * 20 + aa] = (int16_t)(int)(
                    scores[i * 20 + aa] - aaSum[aa] / windowLength);
            }
        }
        delete[] pNull;
    }
    // profile_for_alignment is the /4-scaled matrix (Sequence.cpp:356-362)
    for (int64_t pos = 0; pos < L; pos++) {
        for (int aa = 0; aa < 20; aa++) {
            aln_profile[aa * L + pos] = (int8_t)(scores[pos * 20 + aa] / 4);
        }
    }
    // rankedDescSort20 network per position
    for (int64_t pos = 0; pos < L; pos++) {
        int16_t* val = sorted_scores + pos * 20;
        uint32_t* index = sorted_index + pos * 20;
        for (int aa = 0; aa < 20; aa++) {
            val[aa] = scores[pos * 20 + aa];
            index[aa] = aa;
        }
#define SWAP(x, y) { if (val[x] < val[y]) { int16_t t1 = val[x]; val[x] = val[y]; val[y] = t1; uint32_t t2 = index[x]; index[x] = index[y]; index[y] = t2; } }
        SWAP(0,16);SWAP(1,17);SWAP(2,18);SWAP(3,19);SWAP(4,12);SWAP(5,13);SWAP(6,14);SWAP(7,15);
        SWAP(0,8);SWAP(1,9);SWAP(2,10);SWAP(3,11);
        SWAP(8,16);SWAP(9,17);SWAP(10,18);SWAP(11,19);SWAP(0,4);SWAP(1,5);SWAP(2,6);SWAP(3,7);
        SWAP(8,12);SWAP(9,13);SWAP(10,14);SWAP(11,15);SWAP(4,16);SWAP(5,17);SWAP(6,18);SWAP(7,19);SWAP(0,2);SWAP(1,3);
        SWAP(4,8);SWAP(5,9);SWAP(6,10);SWAP(7,11);SWAP(12,16);SWAP(13,17);SWAP(14,18);SWAP(15,19);SWAP(0,1);
        SWAP(4,6);SWAP(5,7);SWAP(8,10);SWAP(9,11);SWAP(12,14);SWAP(13,15);SWAP(16,18);SWAP(17,19);
        SWAP(2,16);SWAP(3,17);SWAP(6,12);SWAP(7,13);SWAP(18,19);
        SWAP(2,8);SWAP(3,9);SWAP(10,16);SWAP(11,17);
        SWAP(2,4);SWAP(3,5);SWAP(6,8);SWAP(7,9);SWAP(10,12);SWAP(11,13);SWAP(14,16);SWAP(15,17);
        SWAP(2,3);SWAP(4,5);SWAP(6,7);SWAP(8,9);SWAP(10,11);SWAP(12,13);SWAP(14,15);SWAP(16,17);
        SWAP(1,16);SWAP(3,18);SWAP(5,12);SWAP(7,14);
        SWAP(1,8);SWAP(3,10);SWAP(9,16);SWAP(11,18);
        SWAP(1,4);SWAP(3,6);SWAP(5,8);SWAP(7,10);SWAP(9,12);SWAP(11,14);SWAP(13,16);SWAP(15,18);
        SWAP(1,2);SWAP(3,4);SWAP(5,6);SWAP(7,8);SWAP(9,10);SWAP(11,12);SWAP(13,14);SWAP(15,16);SWAP(17,18);
#undef SWAP
    }
    delete[] scores;
}
