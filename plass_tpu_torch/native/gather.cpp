// Record gather/scatter for the host data plane: per-record memcpy between
// a flat record store and (a) another flat layout or (b) padded device
// batches.  These replace numpy fancy-index gathers whose int64 index
// temporaries cost ~30 bytes of memory traffic per payload byte — the
// dominant cost of the extend stage's output-DB rebuild at bench scale
// (the greedy kernel itself is ~4 ms; the numpy gather was ~150-500 ms).
#include <cstdint>
#include <cstring>

#include <omp.h>

extern "C" {

// dst[dst_off[i] : dst_off[i]+lens[i]] = src[src_off[i] : src_off[i]+lens[i]]
void gather_records(const uint8_t *src, const int64_t *src_off,
                    const int64_t *lens, const int64_t *dst_off, int64_t n,
                    uint8_t *dst) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i)
        memcpy(dst + dst_off[i], src + src_off[i], (size_t)lens[i]);
}

// Row-padded batch fill: dst[i*row_stride : +lens[i]] = lut[src[src_off[i]..]]
// (lut = 256-entry byte map, e.g. aa2num; pass identity for raw chars).
// Padding bytes beyond lens[i] are left untouched (caller pre-fills).
void pad_records(const uint8_t *src, const int64_t *src_off,
                 const int32_t *lens, int64_t n, const uint8_t *lut,
                 uint8_t *dst, int64_t row_stride) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t *s = src + src_off[i];
        uint8_t *d = dst + i * row_stride;
        int32_t len = lens[i];
        for (int32_t j = 0; j < len; ++j) d[j] = lut[s[j]];
    }
}

}  // extern "C"
