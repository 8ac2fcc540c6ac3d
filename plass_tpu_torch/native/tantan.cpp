// Low-complexity / tandem-repeat masking.
//
// Reference semantics: the vendored tantan forward-backward HMM
// (lib/mmseqs/src/commons/tantan.cpp, gap-free fast path — IndexBuilder
// calls maskSequences with firstGapProb = otherGapProb = 0,
// IndexBuilder.cpp:139-149). States: background + one foreground state per
// repeat offset 1..maxRepeatOffset. Emission likelihood ratios
// P(a,b)/(pa*pb) come from the substitution matrix probabilities
// (BaseMatrix.h:80-93). Per-letter repeat probabilities are computed with
// the exact float32 letterProbs buffer and 16-step rescaling of the
// reference, then letters with P(repeat) >= minMaskProb are replaced by
// the mask letter (X).
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" int64_t tantan_mask(
        uint8_t *seq, int64_t L,
        const double *lratio, int32_t alph,
        int32_t max_offset,
        double repeat_prob, double repeat_end_prob, double decay,
        double min_mask_prob, uint8_t mask_char) {
    if (L <= 0) return 0;
    const double b2b = 1.0 - repeat_prob;
    const double f2b = repeat_end_prob;
    const double f2f0 = 1.0 - repeat_end_prob;
    // firstRepeatOffsetProb(decay, maxRepeatOffset)
    double first = (decay < 1.0 || decay > 1.0)
        ? (1.0 - decay) / (1.0 - std::pow(decay, max_offset))
        : 1.0 / max_offset;
    std::vector<double> b2f(max_offset);
    double p = repeat_prob * first;
    for (int32_t i = 0; i < max_offset; i++) { b2f[i] = p; p *= decay; }

    std::vector<double> fg(max_offset, 0.0);
    std::vector<double> scale(L / 16 + 1, 1.0);
    std::vector<float> letter(L);

    // forward
    double b = 1.0;
    for (int64_t t = 0; t < L; t++) {
        const double *lr = lratio + (int64_t)seq[t] * alph;
        int32_t mo = t < max_offset ? (int32_t)t : max_offset;
        double from_fg = 0.0;
        for (int32_t i = 0; i < mo; i++) {
            double f = fg[i];
            from_fg += f;
            fg[i] = (b * b2f[i] + f * f2f0) * lr[seq[t - i - 1]];
        }
        b = b * b2b + from_fg * f2b;
        if (t % 16 == 15) {
            double s = 1.0 / b;
            scale[t / 16] = s;
            b *= s;
            for (int32_t i = 0; i < max_offset; i++) fg[i] *= s;
        }
        letter[t] = (float)b;
    }
    double from_fg = 0.0;
    for (int32_t i = 0; i < max_offset; i++) from_fg += fg[i];
    double z = b * b2b + from_fg * f2b;
    if (!(z > 0)) return -1;

    // backward
    b = b2b;
    for (int32_t i = 0; i < max_offset; i++) fg[i] = f2b;
    for (int64_t t = L - 1; t >= 0; t--) {
        double non_repeat = (double)letter[t] * b / z;
        letter[t] = 1.0f - (float)non_repeat;
        if (t % 16 == 15) {
            double s = scale[t / 16];
            b *= s;
            for (int32_t i = 0; i < max_offset; i++) fg[i] *= s;
        }
        const double *lr = lratio + (int64_t)seq[t] * alph;
        int32_t mo = t < max_offset ? (int32_t)t : max_offset;
        double to_bg = f2b * b;
        double to_fg = 0.0;
        for (int32_t i = 0; i < mo; i++) {
            double f = fg[i] * lr[seq[t - i - 1]];
            to_fg += b2f[i] * f;
            fg[i] = to_bg + f2f0 * f;
        }
        b = b2b * b + to_fg;
    }

    int64_t masked = 0;
    for (int64_t t = 0; t < L; t++) {
        if (letter[t] >= min_mask_prob) {
            seq[t] = mask_char;
            masked++;
        }
    }
    return masked;
}
