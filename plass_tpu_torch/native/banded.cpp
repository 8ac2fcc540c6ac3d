// Banded affine-gap backtrace over the optimal-alignment rectangle.
//
// Reference semantics: SmithWaterman::banded_sw
// (lib/mmseqs/src/alignment/StripedSmithWaterman.cpp:781-984). After the
// striped forward/reverse passes have fixed the alignment rectangle
// [qStart..qEnd] x [tStart..tEnd] and its score, the cigar is produced by a
// banded DP over that rectangle, with the band doubled until the banded
// optimum reaches the known score. Direction tie-breaking is load-bearing
// for byte parity of backtraces:
//   - H: diagonal wins ties against gap states (temp1 <= temp2 -> diag);
//   - between gap states, E (query gap, 'I') wins only strictly (e1 > f1);
//   - within E/F, "open" wins ties against "extend" only strictly.
// Band coordinates: u = j - max(i - w, 0) + 1 per row.
#include <cstdint>
#include <cstring>
#include <vector>

// profile_mode: score = mat[tseq[j] * q_total + q_start + i] (query-profile
// PSSM, banded_sw<PROFILE>, StripedSmithWaterman.cpp:252-256,866)
extern "C" int64_t banded_backtrace(
        const uint8_t *tseq, int32_t tlen,
        const uint8_t *qseq, int32_t qlen,
        const int8_t *comp_bias,        // per query row (rounded int8)
        const int8_t *mat, int32_t alph,
        int32_t gap_open, int32_t gap_extend,
        int32_t band_width, int32_t score,
        uint8_t *out_ops, int64_t out_cap,
        int32_t profile_mode, int32_t q_start, int32_t q_total) {
    if (qlen <= 0 || tlen <= 0) return -1;
    std::vector<int32_t> h_prev, e_prev, h_curr;
    std::vector<int8_t> dir;
    int64_t width = 0, width_d = 0;
    int32_t max_seen = 0;

    while (true) {
        width = (int64_t)band_width * 2 + 3;
        width_d = (int64_t)band_width * 2 + 1;
        h_prev.assign(width + 1, 0);
        e_prev.assign(width + 1, 0);
        h_curr.assign(width + 1, 0);
        dir.assign(width_d * (int64_t)qlen * 3, 0);
        max_seen = 0;

        int64_t last_u = 0;
        for (int32_t i = 0; i < qlen; i++) {
            int32_t beg = i - band_width > 0 ? i - band_width : 0;
            int32_t end = i + band_width < tlen - 1 ? i + band_width
                                                    : tlen - 1;
            int64_t edge = end + 1 < width - 1 ? end + 1 : width - 1;
            int32_t f = 0;
            h_prev[0] = e_prev[0] = h_prev[edge] = e_prev[edge] = 0;
            h_curr[0] = 0;
            int8_t *dline = dir.data() + width_d * (int64_t)i * 3;
            int32_t x_curr = (i - band_width) > 0 ? (i - band_width) : 0;
            int32_t x_up = (i - 1 - band_width) > 0 ? (i - 1 - band_width)
                                                    : 0;
            int64_t u = 0;
            for (int32_t j = beg; j <= end; j++) {
                u = j - x_curr + 1;                  // set_u(u, w, i, j)
                int64_t eu = j - x_up + 1;           // set_u(e, w, i-1, j)
                int64_t bu = j - 1 - x_curr + 1;     // set_u(b, w, i, j-1)
                int64_t du = j - 1 - x_up + 1;       // set_u(d, w, i-1, j-1)
                int64_t base = (j - x_curr) * 3;

                int32_t t1 = (i == 0) ? -gap_open : h_prev[eu] - gap_open;
                int32_t t2 = (i == 0) ? -gap_extend : e_prev[eu] - gap_extend;
                int32_t e = t1 > t2 ? t1 : t2;
                e_prev[u] = e;                       // E written in place
                dline[base + 0] = t1 > t2 ? 3 : 2;

                t1 = h_curr[bu] - gap_open;
                t2 = f - gap_extend;
                f = t1 > t2 ? t1 : t2;
                dline[base + 1] = t1 > t2 ? 5 : 4;

                int32_t e1 = e > 0 ? e : 0;
                int32_t f1 = f > 0 ? f : 0;
                int32_t best_gap = e1 > f1 ? e1 : f1;
                int32_t sc = profile_mode
                    ? (int32_t)mat[(int32_t)tseq[j] * q_total
                                   + (q_start + i)]
                    : (int32_t)mat[(int32_t)qseq[i] * alph + tseq[j]]
                      + (int32_t)comp_bias[i];
                int32_t diag = h_prev[du] + sc;
                h_curr[u] = best_gap > diag ? best_gap : diag;
                if (h_curr[u] > max_seen) max_seen = h_curr[u];
                if (best_gap <= diag) {
                    dline[base + 2] = 1;
                } else {
                    dline[base + 2] = e1 > f1 ? dline[base + 0]
                                              : dline[base + 1];
                }
            }
            last_u = u;
            for (int64_t z = 1; z <= last_u; z++) h_prev[z] = h_curr[z];
        }
        if (max_seen >= score) break;
        band_width *= 2;
        if ((int64_t)band_width > (int64_t)tlen + qlen + 2) return -1;
    }

    // trace back from the rectangle corner
    int32_t i = qlen - 1, j = tlen - 1;
    int32_t state = 2;  // 0 = E, 1 = F, 2 = H
    int64_t n = 0;
    const int8_t *dline = dir.data() + width_d * (int64_t)i * 3;
    while (i > 0 || j > 0) {
        if (n >= out_cap) return -1;
        int32_t x = (i - band_width) > 0 ? (i - band_width) : 0;
        int64_t pos = (int64_t)(j - x) * 3 + state;
        int8_t d = dline[pos];
        switch (d) {
            case 1: --i; --j; state = 2; dline -= width_d * 3;
                out_ops[n++] = 'M'; break;
            case 2: --i; state = 0; dline -= width_d * 3;
                out_ops[n++] = 'I'; break;
            case 3: --i; state = 2; dline -= width_d * 3;
                out_ops[n++] = 'I'; break;
            case 4: --j; state = 1; out_ops[n++] = 'D'; break;
            case 5: --j; state = 2; out_ops[n++] = 'D'; break;
            default: return -1;
        }
    }
    // final cell: the reference appends one 'M' (closing run if the last
    // op was M, else a separate 1M run — StripedSmithWaterman.cpp:945-960)
    if (n >= out_cap) return -1;
    out_ops[n++] = 'M';
    // ops were emitted end-to-start; reverse to forward order
    for (int64_t a = 0, b = n - 1; a < b; a++, b--) {
        uint8_t tmp = out_ops[a]; out_ops[a] = out_ops[b]; out_ops[b] = tmp;
    }
    return n;
}
