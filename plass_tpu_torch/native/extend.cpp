// Native greedy contig extension for the protein assembler
// (reference: src/assembler/assembleresult.cpp; exact port of the host
// Python oracle in plass_tpu/assembler/extend.py — same queue order,
// same deferred re-scoring, same status flags).
//
// Inputs arrive pre-flattened; the bit-score -> score-per-column rescale
// happens on the Python side (vectorized) so this kernel only sees the
// integer queue scores and rescaled seq ids.
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <queue>
#include <string>
#include <vector>

#include <omp.h>

namespace {

struct Cand {
    uint32_t db_key;
    int32_t db_id;       // row index into the sequence arrays
    int32_t score;
    double seq_id;
    int32_t aln_len;
    int32_t qstart, qend, qlen;
    int32_t dbstart, dbend, dblen;
};

struct CandLess {
    // priority: (score desc, aln_len desc, smaller db_key wins)
    bool operator()(const Cand &a, const Cand &b) const {
        if (a.score != b.score) return a.score < b.score;
        if (a.aln_len != b.aln_len) return a.aln_len < b.aln_len;
        return a.db_key > b.db_key;
    }
};

constexpr uint8_t WAS_IN_ALIGNMENT = 0x40;
constexpr uint8_t WAS_CANDIDATE = 0x10;
constexpr uint8_t WAS_CONSUMED = 0x80;
constexpr uint8_t IS_CONTIG = 0x20;

// END_TO_END ungapped rescore along a diagonal
// (DistanceCalculator::computeGlobalSubstitutionStartEndDistance semantics
// via ops/rescore.py ungapped_by_diagonal mode 3)
struct Ungapped {
    int64_t score;
    int32_t start, end, diag_len, dist;
};

inline Ungapped e2e_diagonal(const uint8_t *q, int32_t qlen, const uint8_t *t,
                             int32_t tlen, int32_t diag,
                             const int16_t *ascii_mat) {
    Ungapped r{0, -1, -1, 0, 0};
    int32_t dist = diag >= 0 ? diag : -diag;
    r.dist = dist;
    const uint8_t *qq, *tt;
    int32_t ov;
    if (diag >= 0) {
        if (dist >= qlen) return r;
        ov = std::min(tlen, qlen - dist);
        qq = q + dist;
        tt = t;
    } else {
        if (dist >= tlen) return r;
        ov = std::min(tlen - dist, qlen);
        qq = q;
        tt = t + dist;
    }
    r.diag_len = ov;
    int32_t first = (qq[0] == '*' || tt[0] == '*') ? 1 : 0;
    int32_t last = ov - 1;
    if (last > 0 && (qq[last] == '*' || tt[last] == '*')) last--;
    int64_t sc = 0;
    for (int32_t p = first; p <= last; ++p)
        sc += ascii_mat[(size_t)qq[p] * 256 + tt[p]];
    if (sc < 0) sc = 0;
    r.score = sc;
    r.start = first;
    r.end = last;
    return r;
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 if out_buf overflowed (caller retries bigger).
int assemble_greedy(
    const uint8_t *seq_data, const int64_t *seq_off, const int32_t *seq_len,
    const uint32_t *keys, int32_t n_seqs,
    const int64_t *aln_off,   // n_seqs + 1, record ranges per query (id order)
    const uint32_t *a_dbkey, const int32_t *a_dbid, const int32_t *a_score,
    const double *a_seqid, const int32_t *a_alnlen, const int32_t *a_qs,
    const int32_t *a_qe, const int32_t *a_qlen, const int32_t *a_ts,
    const int32_t *a_te, const int32_t *a_tlen,
    const int16_t *ascii_mat, double seq_id_thr, int64_t max_seq_len,
    uint8_t *flags,           // n_seqs, in/out (zeroed by caller)
    uint8_t *out_buf, int64_t out_cap,
    int64_t *out_off, int64_t *out_len, uint8_t *out_is_contig) {
    // per-thread contig buffers, serially placed afterwards (deterministic
    // per-query slots); flags ORs are atomic like the reference's
    // __sync_or_and_fetch (assembleresult.cpp:187)
    struct TOut {
        std::string buf;
        std::vector<int32_t> qpos;
        std::vector<int64_t> off, len;
    };
    int n_threads = omp_get_max_threads();
    std::vector<TOut> touts((size_t)n_threads);

#pragma omp parallel
    {
    TOut &to = touts[(size_t)omp_get_thread_num()];
    std::string query;
    std::vector<Cand> deferred;
#pragma omp for schedule(dynamic, 16)
    for (int32_t qpos = 0; qpos < n_seqs; ++qpos) {
        out_is_contig[qpos] = 0;
        int64_t rec_lo = aln_off[qpos], rec_hi = aln_off[qpos + 1];
        if (rec_lo == rec_hi) continue;
        uint32_t qkey = keys[qpos];
        query.assign((const char *)(seq_data + seq_off[qpos]),
                     (size_t)seq_len[qpos]);
        int64_t orig_qlen = seq_len[qpos];

        std::priority_queue<Cand, std::vector<Cand>, CandLess> heap;
        int64_t n_aln = rec_hi - rec_lo;
        for (int64_t r = rec_lo; r < rec_hi; ++r) {
            Cand c{a_dbkey[r], a_dbid[r], a_score[r], a_seqid[r], a_alnlen[r],
                   a_qs[r], a_qe[r], a_qlen[r], a_ts[r], a_te[r], a_tlen[r]};
            heap.push(c);
            if (n_aln > 1)
                __atomic_fetch_or(&flags[a_dbid[r]], WAS_IN_ALIGNMENT,
                                  __ATOMIC_RELAXED);
        }

        bool could_extend = false;
        while (!heap.empty()) {
            int64_t left_off = 0, right_off = 0;
            deferred.clear();
            for (;;) {
                // selectFragmentToExtend
                bool found = false;
                Cand best;
                while (!heap.empty()) {
                    best = heap.top();
                    heap.pop();
                    bool not_both = !(best.dbstart == 0 && best.qstart == 0);
                    bool right_s = best.dbstart == 0 &&
                                   best.dbend != best.dblen - 1;
                    bool left_s = best.qstart == 0 &&
                                  best.qend != best.qlen - 1;
                    if ((right_s || left_s) && not_both &&
                        best.db_key != qkey) {
                        found = true;
                        break;
                    }
                }
                if (!found) break;
                int32_t tid = best.db_id;
                const uint8_t *tseq = seq_data + seq_off[tid];
                int32_t tlen = seq_len[tid];
                if (best.dbstart == 0) {
                    if ((int64_t)(tlen - (best.dbend + 1)) <= right_off)
                        continue;
                } else if (best.qstart == 0) {
                    if ((int64_t)best.dbstart <= left_off) continue;
                }
                __atomic_fetch_or(&flags[tid], WAS_CANDIDATE, __ATOMIC_RELAXED);

                if (best.dbstart == 0 && best.qend == orig_qlen - 1) {
                    if (right_off > 0) {
                        deferred.push_back(best);
                        continue;
                    }
                    int64_t frag_len = tlen - (best.dbend + 1);
                    query.append((const char *)(tseq + best.dbend + 1),
                                 (size_t)frag_len);
                    right_off += frag_len;
                    __atomic_fetch_or(&flags[tid], WAS_CONSUMED, __ATOMIC_RELAXED);
                } else if (best.qstart == 0 && best.dbend == tlen - 1) {
                    if (left_off > 0) {
                        deferred.push_back(best);
                        continue;
                    }
                    int64_t frag_len = best.dbstart;
                    if ((int64_t)query.size() + frag_len >= max_seq_len)
                        break;
                    query.insert(0, (const char *)tseq, (size_t)frag_len);
                    left_off += frag_len;
                    __atomic_fetch_or(&flags[tid], WAS_CONSUMED, __ATOMIC_RELAXED);
                }
            }
            if (left_off > 0 || right_off > 0) could_extend = true;
            if (!heap.empty()) break;  // max-seq-len break path
            orig_qlen = (int64_t)query.size();
            const uint8_t *qarr = (const uint8_t *)query.data();
            for (const Cand &c0 : deferred) {
                Cand c = c0;
                int32_t tid = c.db_id;
                const uint8_t *tseq = seq_data + seq_off[tid];
                int32_t tlen = seq_len[tid];
                int32_t diag = (int32_t)(c.qstart + left_off) - c.dbstart;
                Ungapped u = e2e_diagonal(qarr, (int32_t)query.size(), tseq,
                                          tlen, diag, ascii_mat);
                int32_t qs, qe, ts, te;
                if (diag >= 0) {
                    qs = u.start + u.dist;
                    qe = u.end + u.dist;
                    ts = u.start;
                    te = u.end;
                } else {
                    qs = u.start;
                    qe = u.end;
                    ts = u.start + u.dist;
                    te = u.end + u.dist;
                }
                int64_t idcnt = 0;
                for (int32_t p = qs; p < qe; ++p)
                    idcnt += (qarr[p] == tseq[ts + (p - qs)]) ? 1 : 0;
                c.seq_id = (qe != qs) ? (double)idcnt / (double)(qe - qs) : 0.0;
                c.qlen = (int32_t)query.size();
                c.dblen = tlen;
                c.aln_len = u.diag_len;
                c.score = (int32_t)(((double)u.score / (u.diag_len + 0.5)) * 100.0);
                c.qstart = qs;
                c.qend = qe;
                c.dbstart = ts;
                c.dbend = te;
                if (c.seq_id >= seq_id_thr) heap.push(c);
            }
        }

        if (could_extend) {
            __atomic_fetch_or(&flags[qpos], IS_CONTIG, __ATOMIC_RELAXED);
            out_is_contig[qpos] = 1;
            to.qpos.push_back(qpos);
            to.off.push_back((int64_t)to.buf.size());
            to.len.push_back((int64_t)query.size());
            to.buf.append(query);
        }
    }
    }  // omp parallel

    // deterministic placement: per-query slots, copied serially
    int64_t out_pos = 0;
    for (TOut &to : touts) {
        for (size_t i = 0; i < to.qpos.size(); ++i) {
            if (out_pos + to.len[i] > out_cap) return 1;
            memcpy(out_buf + out_pos, to.buf.data() + to.off[i],
                   (size_t)to.len[i]);
            out_off[to.qpos[i]] = out_pos;
            out_len[to.qpos[i]] = to.len[i];
            out_pos += to.len[i];
        }
    }
    return 0;
}

}  // extern "C"
