// proteinaln2nucl scoring for backtrace-free (pure-M) records: per hit,
// rescore the tripled-coordinate nucleotide window with the nucleotide
// ASCII matrix and count identities — the per-record python/dict loop
// cost 2.3 s of the 2.7 s guided bench iteration at scale 4.
// Reference: src/util/proteinaln2nucl.cpp (coordinate x3 mapping, score
// walk); parsed seqId replicates Util::fastSeqIdToBuffer + strtod
// (truncated f32 milli-units — see ops/rescore.py:format_seq_id).
#include <cstdint>

extern "C" void aln2nucl_score(
    int64_t m,
    const uint8_t* data, const int64_t* off,   // nucl payloads by row id
    const int32_t* qid, const int32_t* tid,
    const int32_t* qstart, const int32_t* tstart,
    const int32_t* nwin,                        // window length (3*alnLen)
    const int16_t* ascii_mat,                   // [256*256]
    int32_t* raw_score, double* parsed_seqid) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; i++) {
        const uint8_t* q = data + off[qid[i]] + qstart[i];
        const uint8_t* t = data + off[tid[i]] + tstart[i];
        const int32_t n = nwin[i];
        int64_t score = 0;
        int32_t idc = 0;
        for (int32_t j = 0; j < n; j++) {
            score += ascii_mat[(int32_t)q[j] * 256 + (int32_t)t[j]];
            idc += q[j] == t[j];
        }
        raw_score[i] = (int32_t)score;
        double parsed;
        if (n == 0) {
            parsed = 0.0;
        } else {
            const float s = (float)idc / (float)n;
            if (s == 1.0f) {
                parsed = 1.0;
            } else {
                const int v = (int)(s * 1000.0f);
                parsed = (double)v / 1000.0;
            }
        }
        parsed_seqid[i] = parsed;
    }
}
