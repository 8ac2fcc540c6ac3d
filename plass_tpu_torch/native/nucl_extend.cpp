// Native greedy contig extension for the nucleotide and guided assemblers
// (reference: src/assembler/nuclassembleresult.cpp and
// guidedassembleresult.cpp; exact ports of the host Python oracles in
// plass_tpu/assembler/nucl_extend.py / guided_extend.py — same Bayesian
// Beta-posterior queue order, same deferred re-scoring, same status flags).
//
// The candidate queue is std::priority_queue, which on libstdc++ IS the
// exact heap algorithm the Python LibstdcxxHeap class replicates (the
// posterior comparator is not a strict weak ordering, so pop order is
// defined by the algorithm, not just the ordering).
//
// Inputs arrive pre-flattened; the bit-score -> score-per-column rescale
// (nucl) / the 3-digit seqId text round trip + threshold pre-filter
// (guided) happen on the Python side, vectorized.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

#include <omp.h>

namespace {

struct Cand {
    uint32_t db_key;
    int32_t db_id;
    int32_t score;
    double seq_id;
    int32_t aln_len;
    int32_t qstart, qend, qlen;
    int32_t dbstart, dbend, dblen;
};

constexpr uint8_t WAS_IN_ALIGNMENT = 0x40;
constexpr uint8_t WAS_CANDIDATE = 0x10;
constexpr uint8_t WAS_CONSUMED = 0x80;
constexpr uint8_t IS_CONTIG = 0x20;

// CompareNuclResultByScore::operator() (nuclassembleresult.cpp:36-70):
// true when r1 ranks below r2.  Mismatch counts use float32 arithmetic
// exactly as the C++ reference / the Python oracle.
inline uint64_t mm_count(double seq_id, int32_t aln_len) {
    float f = 1.0f - (float)seq_id;
    f = f * (float)aln_len;
    double d = (double)f + 0.5;
    if (std::isnan(d) || d < 0.0) return 0;
    return (uint64_t)d;
}

struct PosteriorLess {
    bool operator()(const Cand &r1, const Cand &r2) const {
        uint64_t mm1 = mm_count(r1.seq_id, r1.aln_len);
        uint64_t mm2 = mm_count(r2.seq_id, r2.aln_len);
        double alpha1 = (double)(mm1 + 1);
        int64_t alpha2 = (int64_t)(mm2 + 1);
        double beta1 = (double)(r1.aln_len - (int64_t)mm1 + 1);
        double beta2 = (double)(r2.aln_len - (int64_t)mm2 + 1);

        double log_c = (std::lgamma(beta1 + beta2) +
                        std::lgamma(alpha1 + beta1)) -
                       (std::lgamma(alpha1 + beta1 + beta2) +
                        std::lgamma(beta1));
        double log_r = 0.0;
        double p = 0.0;
        for (int64_t idx = 0; idx < alpha2; ++idx) {
            p += std::exp(log_r + log_c);
            log_r = (std::log(alpha1 + (double)idx) +
                     std::log(beta2 + (double)idx) -
                     (std::log((double)(idx + 1)) +
                      std::log((double)idx + alpha1 + beta1 + beta2)) +
                     log_r);
        }
        if (p < 0.45) return true;
        if (p > 0.55) return false;
        int64_t rem1 = (int64_t)r1.dblen - r1.aln_len;
        int64_t rem2 = (int64_t)r2.dblen - r2.aln_len;
        if (rem1 < rem2) return true;
        if (rem1 > rem2) return false;
        return true;
    }
};

typedef std::priority_queue<Cand, std::vector<Cand>, PosteriorLess> NuclHeap;

// selectNuclFragmentToExtend (nuclassembleresult.cpp:74-91)
inline bool select_nucl_fragment(NuclHeap &heap, uint32_t qkey, Cand &out) {
    while (!heap.empty()) {
        Cand res = heap.top();
        heap.pop();
        bool not_both = !(res.dbstart == 0 && res.qstart == 0);
        bool right_s = res.dbstart == 0 && res.dbend != res.dblen - 1;
        bool left_s = res.qstart == 0 && res.qend != res.qlen - 1;
        if ((right_s || left_s) && not_both && res.db_key != qkey) {
            out = res;
            return true;
        }
    }
    return false;
}

// END_TO_END ungapped rescore along a diagonal (ops/rescore.py mode 3)
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

// getNuclRevFragment as a char-level LUT pass (revcomp_char maps each
// nucleotide char to its complement with X -> 'N'), order reversed
inline void revcomp_into(const uint8_t *src, int64_t n,
                         const uint8_t *revcomp_char, std::string &dst) {
    dst.resize((size_t)n);
    for (int64_t i = 0; i < n; ++i)
        dst[(size_t)(n - 1 - i)] = (char)revcomp_char[src[i]];
}

inline void atomic_or(uint8_t *p, uint8_t v) {
    __atomic_fetch_or(p, v, __ATOMIC_RELAXED);
}

struct ThreadOut {
    std::string buf;            // concatenated contig payloads
    std::string aa_buf;         // guided: amino-acid payloads
    std::vector<int32_t> qpos;  // which query each contig belongs to
    std::vector<int64_t> off, len, aa_off, aa_len;
};

}  // namespace

extern "C" {

// Nucleotide greedy extension (nuclassembleresult.cpp).  Contigs land in
// per-query slots (out_off/out_len indexed by query id); the caller glues
// pass-through records.  Returns 0, or 1 if out_buf overflowed.
int nucl_assemble_greedy(
    const uint8_t *seq_data, const int64_t *seq_off, const int32_t *seq_len,
    const uint32_t *keys, int32_t n_seqs,
    const int64_t *aln_off,
    const uint32_t *a_dbkey, const int32_t *a_dbid, const int32_t *a_score,
    const double *a_seqid, const int32_t *a_alnlen, const int32_t *a_qs,
    const int32_t *a_qe, const int32_t *a_qlen, const int32_t *a_ts,
    const int32_t *a_te, const int32_t *a_tlen,
    const int16_t *ascii_mat, const uint8_t *revcomp_char,
    double seq_id_thr, int64_t max_seq_len,
    uint8_t *flags, uint8_t *out_buf, int64_t out_cap,
    int64_t *out_off, int64_t *out_len, uint8_t *out_is_contig) {
    int n_threads = omp_get_max_threads();
    std::vector<ThreadOut> touts((size_t)n_threads);

#pragma omp parallel
    {
        ThreadOut &to = touts[(size_t)omp_get_thread_num()];
        std::string query, rc_scratch;
        std::vector<Cand> deferred;
        std::unordered_map<int32_t, bool> use_reverse;

#pragma omp for schedule(dynamic, 16)
        for (int32_t qpos = 0; qpos < n_seqs; ++qpos) {
            out_is_contig[qpos] = 0;
            int64_t rec_lo = aln_off[qpos], rec_hi = aln_off[qpos + 1];
            if (rec_lo == rec_hi) continue;
            uint32_t qkey = keys[qpos];
            query.assign((const char *)(seq_data + seq_off[qpos]),
                         (size_t)seq_len[qpos]);
            int64_t orig_qlen = seq_len[qpos];

            use_reverse.clear();
            NuclHeap heap;
            int64_t n_aln = rec_hi - rec_lo;
            for (int64_t r = rec_lo; r < rec_hi; ++r) {
                int32_t qs = a_qs[r], qe = a_qe[r];
                int32_t ts = a_ts[r], te = a_te[r];
                int32_t tlen = a_tlen[r];
                int32_t tid = a_dbid[r];
                if (qs > qe) {
                    use_reverse[tid] = true;
                    std::swap(qs, qe);
                    int32_t nts = tlen - te - 1, nte = tlen - ts - 1;
                    ts = nts;
                    te = nte;
                } else {
                    use_reverse[tid] = false;
                }
                Cand c{a_dbkey[r], tid, a_score[r], a_seqid[r], a_alnlen[r],
                       qs, qe, a_qlen[r], ts, te, tlen};
                heap.push(c);
                if (n_aln > 1) atomic_or(&flags[tid], WAS_IN_ALIGNMENT);
            }

            bool could_extend = false;
            while (!heap.empty()) {
                int64_t left_off = 0, right_off = 0;
                deferred.clear();
                for (;;) {
                    Cand best;
                    if (!select_nucl_fragment(heap, qkey, best)) break;
                    int32_t tid = best.db_id;
                    const uint8_t *tseq = seq_data + seq_off[tid];
                    int32_t tlen = seq_len[tid];
                    if (best.dbstart == 0) {
                        if ((int64_t)(tlen - (best.dbend + 1)) <= right_off)
                            continue;
                    } else if (best.qstart == 0) {
                        if ((int64_t)best.dbstart <= left_off) continue;
                    }
                    atomic_or(&flags[tid], WAS_CANDIDATE);
                    auto rev_it = use_reverse.find(tid);
                    bool rev = rev_it != use_reverse.end() && rev_it->second;

                    if (best.dbstart == 0 && best.qend == orig_qlen - 1) {
                        // right extension (length-guarded both sides,
                        // nuclassembleresult.cpp:271-275)
                        if (right_off > 0) {
                            deferred.push_back(best);
                            continue;
                        }
                        int64_t frag_len = tlen - (best.dbend + 1);
                        if ((int64_t)query.size() + frag_len >= max_seq_len)
                            break;
                        if (rev) {
                            revcomp_into(tseq, frag_len, revcomp_char,
                                         rc_scratch);
                            query.append(rc_scratch);
                        } else {
                            query.append((const char *)(tseq + best.dbend + 1),
                                         (size_t)frag_len);
                        }
                        right_off += frag_len;
                        atomic_or(&flags[tid], WAS_CONSUMED);
                    } else if (best.qstart == 0 && best.dbend == tlen - 1) {
                        // left extension
                        if (left_off > 0) {
                            deferred.push_back(best);
                            continue;
                        }
                        int64_t frag_len = best.dbstart;
                        if ((int64_t)query.size() + frag_len >= max_seq_len)
                            break;
                        if (rev) {
                            revcomp_into(tseq + (tlen - frag_len), frag_len,
                                         revcomp_char, rc_scratch);
                            query.insert(0, rc_scratch);
                        } else {
                            query.insert(0, (const char *)tseq,
                                         (size_t)frag_len);
                        }
                        left_off += frag_len;
                        atomic_or(&flags[tid], WAS_CONSUMED);
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
                    auto rev_it = use_reverse.find(tid);
                    if (rev_it != use_reverse.end() && rev_it->second) {
                        revcomp_into(tseq, tlen, revcomp_char, rc_scratch);
                        tseq = (const uint8_t *)rc_scratch.data();
                    }
                    int32_t diag = (int32_t)(c.qstart + left_off) - c.dbstart;
                    Ungapped u = e2e_diagonal(qarr, (int32_t)query.size(),
                                              tseq, tlen, diag, ascii_mat);
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
                    c.seq_id = (qe != qs)
                                   ? (double)idcnt / (double)(qe - qs)
                                   : std::nan("");
                    c.qlen = (int32_t)query.size();
                    c.dblen = tlen;
                    c.aln_len = u.diag_len;
                    c.score = (int32_t)(((double)u.score / (u.diag_len + 0.5))
                                        * 100.0);
                    c.qstart = qs;
                    c.qend = qe;
                    c.dbstart = ts;
                    c.dbend = te;
                    if (c.seq_id >= seq_id_thr) heap.push(c);  // NaN fails
                }
            }

            if (could_extend) {
                atomic_or(&flags[qpos], IS_CONTIG);
                out_is_contig[qpos] = 1;
                to.qpos.push_back(qpos);
                to.off.push_back((int64_t)to.buf.size());
                to.len.push_back((int64_t)query.size());
                to.buf.append(query);
            }
        }
    }

    // deterministic placement: per-query slots, copied serially
    int64_t out_pos = 0;
    for (ThreadOut &to : touts) {
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

// Protein-guided lockstep extension (guidedassembleresult.cpp): nucl + aa
// sequence sets share row indices; candidates are pre-filtered by the
// caller (parsed seqId >= threshold).  Two output buffers.
int guided_assemble_greedy(
    const uint8_t *nucl_data, const int64_t *nucl_off, const int32_t *nucl_len,
    const uint8_t *aa_data, const int64_t *aa_off, const int32_t *aa_len,
    const uint32_t *keys, int32_t n_seqs,
    const int64_t *aln_off,
    const int32_t *n_aln_raw,  // pre-filter record counts (the
                               // WAS_IN_ALIGNMENT condition counts records
                               // BEFORE the seqId threshold filter,
                               // guidedassembleresult.cpp:195-205)
    const uint32_t *a_dbkey, const int32_t *a_dbid, const int32_t *a_score,
    const double *a_seqid, const int32_t *a_alnlen, const int32_t *a_qs,
    const int32_t *a_qe, const int32_t *a_qlen, const int32_t *a_ts,
    const int32_t *a_te, const int32_t *a_tlen,
    const int16_t *ascii_mat, double seq_id_thr, int64_t max_seq_len,
    uint8_t *flags,
    uint8_t *nucl_out, int64_t nucl_cap, int64_t *n_out_off, int64_t *n_out_len,
    uint8_t *aa_out, int64_t aa_cap, int64_t *a_out_off, int64_t *a_out_len,
    uint8_t *out_is_contig) {
    int n_threads = omp_get_max_threads();
    std::vector<ThreadOut> touts((size_t)n_threads);

#pragma omp parallel
    {
        ThreadOut &to = touts[(size_t)omp_get_thread_num()];
        std::string query, aa_query;
        std::vector<Cand> deferred;

#pragma omp for schedule(dynamic, 16)
        for (int32_t qpos = 0; qpos < n_seqs; ++qpos) {
            out_is_contig[qpos] = 0;
            int64_t rec_lo = aln_off[qpos], rec_hi = aln_off[qpos + 1];
            if (rec_lo == rec_hi) continue;
            uint32_t qkey = keys[qpos];
            query.assign((const char *)(nucl_data + nucl_off[qpos]),
                         (size_t)nucl_len[qpos]);
            aa_query.assign((const char *)(aa_data + aa_off[qpos]),
                            (size_t)aa_len[qpos]);
            int64_t orig_qlen = nucl_len[qpos];
            bool exclude_left = !aa_query.empty() && aa_query.front() == '*';
            bool exclude_right = !aa_query.empty() && aa_query.back() == '*';

            NuclHeap heap;
            int64_t n_aln = n_aln_raw[qpos];
            for (int64_t r = rec_lo; r < rec_hi; ++r) {
                Cand c{a_dbkey[r], a_dbid[r], a_score[r], a_seqid[r],
                       a_alnlen[r], a_qs[r], a_qe[r], a_qlen[r], a_ts[r],
                       a_te[r], a_tlen[r]};
                heap.push(c);
                if (n_aln > 1)
                    atomic_or(&flags[a_dbid[r]], WAS_IN_ALIGNMENT);
            }

            bool could_extend = false;
            while (!heap.empty()) {
                int64_t left_off = 0, right_off = 0;
                deferred.clear();
                for (;;) {
                    Cand best;
                    if (!select_nucl_fragment(heap, qkey, best)) break;
                    int32_t tid = best.db_id;
                    const uint8_t *tseq = nucl_data + nucl_off[tid];
                    int32_t tlen = nucl_len[tid];
                    const uint8_t *aa_t = aa_data + aa_off[tid];
                    int32_t aa_tlen = aa_len[tid];
                    // stop-codon barriers (guidedassembleresult.cpp:232-243)
                    if (best.dbstart == 0) {
                        if ((int64_t)(tlen - (best.dbend + 1)) <= right_off ||
                            exclude_right || (aa_tlen > 0 && aa_t[0] == '*'))
                            continue;
                    } else if (best.qstart == 0) {
                        if ((int64_t)best.dbstart <= left_off ||
                            exclude_left ||
                            (aa_tlen > 0 && aa_t[aa_tlen - 1] == '*'))
                            continue;
                    }
                    atomic_or(&flags[tid], WAS_CANDIDATE);

                    if (best.dbstart == 0 && best.qend == orig_qlen - 1) {
                        // right extension: nucl tail + aa tail in lockstep
                        if (right_off > 0) {
                            deferred.push_back(best);
                            continue;
                        }
                        int64_t frag_len = tlen - (best.dbend + 1);
                        if ((int64_t)query.size() + frag_len >= max_seq_len)
                            break;
                        int64_t aa_frag_len =
                            ((int64_t)tlen / 3 - (int64_t)best.dbend / 3) - 1;
                        query.append((const char *)(tseq + best.dbend + 1),
                                     (size_t)frag_len);
                        int64_t start = (int64_t)best.dbend / 3 + 1;
                        if (aa_frag_len > 0 && start < aa_tlen) {
                            int64_t take =
                                std::min(aa_frag_len, (int64_t)aa_tlen - start);
                            aa_query.append((const char *)(aa_t + start),
                                            (size_t)take);
                        }
                        right_off += frag_len;
                        atomic_or(&flags[tid], WAS_CONSUMED);
                    } else if (best.qstart == 0 && best.dbend == tlen - 1) {
                        // left extension
                        if (left_off > 0) {
                            deferred.push_back(best);
                            continue;
                        }
                        int64_t frag_len = best.dbstart;
                        if ((int64_t)query.size() + frag_len >= max_seq_len)
                            break;
                        int64_t has_start =
                            (aa_tlen > 0 && aa_t[0] == '*') ? 1 : 0;
                        query.insert(0, (const char *)tseq, (size_t)frag_len);
                        int64_t take = std::min(frag_len / 3 + has_start,
                                                (int64_t)aa_tlen);
                        if (take > 0)
                            aa_query.insert(0, (const char *)aa_t,
                                            (size_t)take);
                        left_off += frag_len;
                        atomic_or(&flags[tid], WAS_CONSUMED);
                    }
                }
                if (left_off > 0 || right_off > 0) could_extend = true;
                if (!heap.empty()) break;
                orig_qlen = (int64_t)query.size();
                const uint8_t *qarr = (const uint8_t *)query.data();
                for (const Cand &c0 : deferred) {
                    Cand c = c0;
                    int32_t tid = c.db_id;
                    const uint8_t *tseq = nucl_data + nucl_off[tid];
                    int32_t tlen = nucl_len[tid];
                    int32_t diag = (int32_t)(c.qstart + left_off) - c.dbstart;
                    Ungapped u = e2e_diagonal(qarr, (int32_t)query.size(),
                                              tseq, tlen, diag, ascii_mat);
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
                    c.seq_id = (qe != qs)
                                   ? (double)idcnt / (double)(qe - qs)
                                   : std::nan("");
                    c.qlen = (int32_t)query.size();
                    c.dblen = tlen;
                    c.aln_len = u.diag_len;
                    c.score = (int32_t)(((double)u.score / (u.diag_len + 0.5))
                                        * 100.0);
                    c.qstart = qs;
                    c.qend = qe;
                    c.dbstart = ts;
                    c.dbend = te;
                    if (c.seq_id >= seq_id_thr) heap.push(c);
                }
            }

            if (could_extend) {
                atomic_or(&flags[qpos], IS_CONTIG);
                out_is_contig[qpos] = 1;
                to.qpos.push_back(qpos);
                to.off.push_back((int64_t)to.buf.size());
                to.len.push_back((int64_t)query.size());
                to.buf.append(query);
                to.aa_off.push_back((int64_t)to.aa_buf.size());
                to.aa_len.push_back((int64_t)aa_query.size());
                to.aa_buf.append(aa_query);
            }
        }
    }

    int64_t n_pos = 0, a_pos = 0;
    for (ThreadOut &to : touts) {
        for (size_t i = 0; i < to.qpos.size(); ++i) {
            if (n_pos + to.len[i] > nucl_cap ||
                a_pos + to.aa_len[i] > aa_cap)
                return 1;
            memcpy(nucl_out + n_pos, to.buf.data() + to.off[i],
                   (size_t)to.len[i]);
            n_out_off[to.qpos[i]] = n_pos;
            n_out_len[to.qpos[i]] = to.len[i];
            n_pos += to.len[i];
            memcpy(aa_out + a_pos, to.aa_buf.data() + to.aa_off[i],
                   (size_t)to.aa_len[i]);
            a_out_off[to.qpos[i]] = a_pos;
            a_out_len[to.qpos[i]] = to.aa_len[i];
            a_pos += to.aa_len[i];
        }
    }
    return 0;
}

}  // extern "C"
