// Exact scalar emulation of the striped Smith-Waterman kernels used by the
// reference aligner (lib/mmseqs/src/alignment/StripedSmithWaterman.cpp,
// sw_sse2_byte/sw_sse2_word), at the reference build's SSE4.1 vector width
// (16 8-bit lanes / 8 16-bit lanes).
//
// The striped layout is observable: the lazy-F correction loop rewrites H
// but deliberately not E ("disallow adjacent insertion then deletion"), so
// E values depend on the order in which F propagates through the stripes.
// This emulation walks the same (segment, lane) schedule with the same
// saturating arithmetic, bit for bit.
//
// Built as a shared library, driven from Python via ctypes.
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <utility>

namespace {

inline uint8_t sat_add8(uint8_t a, uint8_t b) {
    unsigned v = unsigned(a) + unsigned(b);
    return v > 255 ? 255 : uint8_t(v);
}
inline uint8_t sat_sub8(uint8_t a, uint8_t b) { return a > b ? a - b : 0; }
inline uint16_t sat_add16(uint16_t a, uint16_t b) {
    unsigned v = unsigned(a) + unsigned(b);
    return v > 65535 ? 65535 : uint16_t(v);
}
inline uint16_t sat_sub16(uint16_t a, uint16_t b) { return a > b ? a - b : 0; }

}  // namespace

extern "C" {

// profile: aaSize * segLen * LANES entries, layout [nt][segment][lane]
// out: {score, ref(end_db), read(end_query), score2, ref2, overflow}
void ssw_byte(const uint8_t *db_sequence, int ref_dir, int32_t db_length,
              int32_t query_length, uint8_t gap_open, uint8_t gap_extend,
              const uint8_t *profile, uint8_t terminate, uint8_t bias,
              int32_t maskLen, uint8_t *maxColumnOut, int32_t *out) {
    const int LANES = 16;
    const int32_t segLen = (query_length + LANES - 1) / LANES;
    const int32_t stripe = segLen * LANES;

    uint8_t *Hs = (uint8_t *)calloc(stripe, 1);   // pvHStore
    uint8_t *Hl = (uint8_t *)calloc(stripe, 1);   // pvHLoad
    uint8_t *E = (uint8_t *)calloc(stripe, 1);
    uint8_t *Hmax = (uint8_t *)calloc(stripe, 1);
    uint8_t *maxColumn = maxColumnOut;
    memset(maxColumn, 0, db_length);

    uint8_t max = 0;
    int32_t end_query = query_length - 1;
    int32_t end_db = -1;
    uint8_t vMaxScore[16] = {0};
    uint8_t vMaxMark[16] = {0};
    bool overflow = false;

    int32_t begin = 0, end = db_length, step = 1;
    if (ref_dir == 1) { begin = db_length - 1; end = -1; step = -1; }

    uint8_t vH[16], vF[16], vMaxColumn[16], e[16];
    for (int32_t i = begin; i != end; i += step) {
        memset(vF, 0, 16);
        memset(vMaxColumn, 0, 16);
        // vH = pvHStore[segLen-1] shifted left one lane
        vH[0] = 0;
        for (int l = 1; l < 16; l++) vH[l] = Hs[(segLen - 1) * LANES + (l - 1)];
        const uint8_t *vP = profile + (size_t)db_sequence[i] * stripe;
        std::swap(Hs, Hl);
        for (int32_t j = 0; j < segLen; ++j) {
            for (int l = 0; l < 16; l++) {
                uint8_t h = sat_sub8(sat_add8(vH[l], vP[j * LANES + l]), bias);
                uint8_t ee = E[j * LANES + l];
                if (ee > h) h = ee;
                if (vF[l] > h) h = vF[l];
                if (h > vMaxColumn[l]) vMaxColumn[l] = h;
                Hs[j * LANES + l] = h;
                uint8_t h2 = sat_sub8(h, gap_open);
                uint8_t en = sat_sub8(ee, gap_extend);
                if (h2 > en) en = h2;
                E[j * LANES + l] = en;
                uint8_t fn = sat_sub8(vF[l], gap_extend);
                if (h2 > fn) fn = h2;
                vF[l] = fn;
                vH[l] = Hl[j * LANES + l];
            }
        }
        // lazy-F
        int32_t j = 0;
        for (int l = 0; l < 16; l++) vH[l] = Hs[l];
        {   // vF = shiftl(vF)
            for (int l = 15; l > 0; l--) vF[l] = vF[l - 1];
            vF[0] = 0;
        }
        for (;;) {
            bool all_zero = true;
            for (int l = 0; l < 16; l++) {
                uint8_t t = sat_sub8(vF[l], sat_sub8(vH[l], gap_open));
                if (t != 0) { all_zero = false; break; }
            }
            if (all_zero) break;
            for (int l = 0; l < 16; l++) {
                if (vF[l] > vH[l]) vH[l] = vF[l];
                if (vH[l] > vMaxColumn[l]) vMaxColumn[l] = vH[l];
                Hs[j * LANES + l] = vH[l];
                vF[l] = sat_sub8(vF[l], gap_extend);
            }
            j++;
            if (j >= segLen) {
                j = 0;
                for (int l = 15; l > 0; l--) vF[l] = vF[l - 1];
                vF[0] = 0;
            }
            for (int l = 0; l < 16; l++) vH[l] = Hs[j * LANES + l];
        }

        for (int l = 0; l < 16; l++)
            if (vMaxColumn[l] > vMaxScore[l]) vMaxScore[l] = vMaxColumn[l];
        bool changed = false;
        for (int l = 0; l < 16; l++)
            if (vMaxMark[l] != vMaxScore[l]) { changed = true; break; }
        if (changed) {
            uint8_t temp = 0;
            memcpy(vMaxMark, vMaxScore, 16);
            for (int l = 0; l < 16; l++) if (vMaxScore[l] > temp) temp = vMaxScore[l];
            if (temp > max) {
                max = temp;
                if ((int)max + (int)bias >= 255) { overflow = true; break; }
                end_db = i;
                memcpy(Hmax, Hs, stripe);
            }
        }
        uint8_t cmax = 0;
        for (int l = 0; l < 16; l++) if (vMaxColumn[l] > cmax) cmax = vMaxColumn[l];
        maxColumn[i] = cmax;
        if (cmax == terminate) break;
    }

    // trace ending position on query: min striped position with H == max
    for (int32_t s = 0; s < stripe; ++s) {
        if (Hmax[s] == max) {
            int32_t temp = s / LANES + (s % LANES) * segLen;
            if (temp < end_query) end_query = temp;
        }
    }

    int32_t score = ((int)max + (int)bias >= 255) ? 255 : max;
    int32_t score2 = 0, ref2 = 0;
    int32_t edge = (end_db - maskLen) > 0 ? (end_db - maskLen) : 0;
    for (int32_t i = 0; i < edge; i++)
        if (maxColumn[i] > score2) { score2 = maxColumn[i]; ref2 = i; }
    edge = (end_db + maskLen) > db_length ? db_length : (end_db + maskLen);
    for (int32_t i = edge + 1; i < db_length; i++)
        if (maxColumn[i] > score2) { score2 = maxColumn[i]; ref2 = i; }

    out[0] = score; out[1] = end_db; out[2] = end_query;
    out[3] = score2; out[4] = ref2; out[5] = overflow ? 1 : 0;
    free(Hs); free(Hl); free(E); free(Hmax);
}

void ssw_word(const uint8_t *db_sequence, int ref_dir, int32_t db_length,
              int32_t query_length, uint16_t gap_open, uint16_t gap_extend,
              const uint16_t *profile, uint16_t terminate, int32_t maskLen,
              uint16_t *maxColumnOut, int32_t *out) {
    const int LANES = 8;
    const int32_t segLen = (query_length + LANES - 1) / LANES;
    const int32_t stripe = segLen * LANES;

    uint16_t *Hs = (uint16_t *)calloc(stripe, 2);
    uint16_t *Hl = (uint16_t *)calloc(stripe, 2);
    uint16_t *E = (uint16_t *)calloc(stripe, 2);
    uint16_t *Hmax = (uint16_t *)calloc(stripe, 2);
    uint16_t *maxColumn = maxColumnOut;
    memset(maxColumn, 0, (size_t)db_length * 2);

    uint16_t max = 0;
    int32_t end_query = query_length - 1;
    int32_t end_db = 0;
    uint16_t vMaxScore[8] = {0};
    uint16_t vMaxMark[8] = {0};

    int32_t begin = 0, end = db_length, step = 1;
    if (ref_dir == 1) { begin = db_length - 1; end = -1; step = -1; }

    uint16_t vH[8], vF[8], vMaxColumn[8];
    for (int32_t i = begin; i != end; i += step) {
        memset(vF, 0, sizeof(vF));
        memset(vMaxColumn, 0, sizeof(vMaxColumn));
        vH[0] = 0;
        for (int l = 1; l < 8; l++) vH[l] = Hs[(segLen - 1) * LANES + (l - 1)];
        const uint16_t *vP = profile + (size_t)db_sequence[i] * stripe;
        std::swap(Hs, Hl);
        for (int32_t j = 0; j < segLen; ++j) {
            for (int l = 0; l < 8; l++) {
                // signed saturated add of the (biased by +0 here) profile:
                // the word profile stores signed scores; adds_epi16 semantics
                // simdi16_adds: signed saturating add; negatives are then
                // absorbed by the signed max against E/F (both >= 0)
                int32_t h32 = (int32_t)(int16_t)vH[l] + (int32_t)(int16_t)vP[j * LANES + l];
                if (h32 > 32767) h32 = 32767;
                if (h32 < 0) h32 = 0;
                uint16_t h = (uint16_t)h32;
                uint16_t ee = E[j * LANES + l];
                if (ee > h) h = ee;
                if (vF[l] > h) h = vF[l];
                if (h > vMaxColumn[l]) vMaxColumn[l] = h;
                Hs[j * LANES + l] = h;
                uint16_t h2 = sat_sub16(h, gap_open);
                uint16_t en = sat_sub16(ee, gap_extend);
                if (h2 > en) en = h2;
                E[j * LANES + l] = en;
                uint16_t fn = sat_sub16(vF[l], gap_extend);
                if (h2 > fn) fn = h2;
                vF[l] = fn;
                vH[l] = Hl[j * LANES + l];
            }
        }
        // lazy-F (word variant: k-bounded nested loop with signed-gt break,
        // StripedSmithWaterman.cpp:612-624)
        for (int32_t k = 0; k < 8; ++k) {
            for (int l = 7; l > 0; l--) vF[l] = vF[l - 1];
            vF[0] = 0;
            bool done = false;
            for (int32_t j = 0; j < segLen; ++j) {
                uint16_t vHcur[8];
                for (int l = 0; l < 8; l++) {
                    uint16_t h = Hs[j * LANES + l];
                    // signed 16-bit max
                    if ((int16_t)vF[l] > (int16_t)h) h = vF[l];
                    if ((int16_t)h > (int16_t)vMaxColumn[l]) vMaxColumn[l] = h;
                    Hs[j * LANES + l] = h;
                    vHcur[l] = sat_sub16(h, gap_open);
                    vF[l] = sat_sub16(vF[l], gap_extend);
                }
                bool any = false;
                for (int l = 0; l < 8; l++)
                    if ((int16_t)vF[l] > (int16_t)vHcur[l]) { any = true; break; }
                if (!any) { done = true; break; }
            }
            if (done) break;
        }

        for (int l = 0; l < 8; l++)
            if (vMaxColumn[l] > vMaxScore[l]) vMaxScore[l] = vMaxColumn[l];
        bool changed = false;
        for (int l = 0; l < 8; l++)
            if (vMaxMark[l] != vMaxScore[l]) { changed = true; break; }
        if (changed) {
            uint16_t temp = 0;
            memcpy(vMaxMark, vMaxScore, sizeof(vMaxMark));
            for (int l = 0; l < 8; l++) if (vMaxScore[l] > temp) temp = vMaxScore[l];
            if (temp > max) {
                max = temp;
                end_db = i;
                memcpy(Hmax, Hs, (size_t)stripe * 2);
            }
        }
        uint16_t cmax = 0;
        for (int l = 0; l < 8; l++) if (vMaxColumn[l] > cmax) cmax = vMaxColumn[l];
        maxColumn[i] = cmax;
        if (cmax == terminate) break;
    }

    for (int32_t s = 0; s < stripe; ++s) {
        if (Hmax[s] == max) {
            int32_t temp = s / LANES + (s % LANES) * segLen;
            if (temp < end_query) end_query = temp;
        }
    }

    int32_t score2 = 0, ref2 = 0;
    int32_t edge = (end_db - maskLen) > 0 ? (end_db - maskLen) : 0;
    for (int32_t i = 0; i < edge; i++)
        if (maxColumn[i] > score2) { score2 = maxColumn[i]; ref2 = i; }
    edge = (end_db + maskLen) > db_length ? db_length : (end_db + maskLen);
    // note: the word variant starts at `edge`, not `edge + 1`
    // (StripedSmithWaterman.cpp:678)
    for (int32_t i = edge; i < db_length; i++)
        if (maxColumn[i] > score2) { score2 = maxColumn[i]; ref2 = i; }

    out[0] = max; out[1] = end_db; out[2] = end_query;
    out[3] = score2; out[4] = ref2; out[5] = 0;
    free(Hs); free(Hl); free(E); free(Hmax);
}

}  // extern "C"
