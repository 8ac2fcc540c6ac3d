// Host post-processing of device rescore results: E-values, coordinates,
// coverage/seqId filters and RESULT_DTYPE record assembly, OpenMP-parallel
// over rows.  Replaces ~40 single-threaded numpy passes over the full hit
// array (~0.4 s at bench scale 64) with one multi-threaded pass.
//
// Mirrors ops/backend.py:_rescore_finish exactly (same operation order,
// f64 arithmetic); the E-value is the ALP finite-size area formula
// (reference: lib/mmseqs/lib/alp/sls_pvalues.cpp:366-490,
// EvalueComputation.h:18-45 — see ops/evalue.py for the vectorized port).
// erfc/exp come from libm, which may differ from scipy's cephes in the
// final ulp; the eval FIELD is never consumed downstream (the extender
// reads score/seqId/coords only), and the eval<=thr / seqId>=thr gates
// flip only for values exactly at the threshold boundary.
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// numpy's RESULT_DTYPE is packed (itemsize 56, f64 at unaligned offset 20)
#pragma pack(push, 1)
struct Rec {
    uint32_t dbKey;
    int32_t score;
    float qcov;
    float dbcov;
    float seqId;
    double eval;
    int32_t alnLength;
    int32_t qStartPos;
    int32_t qEndPos;
    int32_t qLen;
    int32_t dbStartPos;
    int32_t dbEndPos;
    int32_t dbLen;
};
#pragma pack(pop)
static_assert(sizeof(Rec) == 56, "RESULT_DTYPE layout");

constexpr double kSqrtHalf = 0.70710678118654752440;   // sqrt(0.5)
constexpr double kConstVal = 0.39894228040143267794;   // 1/sqrt(2*pi)
constexpr double kLn2 = 0.69314718055994530942;

}  // namespace

extern "C" void rescore_finish(
    int64_t m,
    const int64_t* tk, const int32_t* dg,
    const int32_t* qrow, const int32_t* trow,
    const int32_t* lengths,
    const uint8_t* qrev,
    const int64_t* score, const int32_t* first, const int32_t* last,
    const int32_t* ov, const int64_t* dist, const double* idents,
    // dparams: [lam, K, log_K, a_I, b_I, a_J, b_J, alpha_I, beta_I,
    //           alpha_J, beta_J, sigma, tau, vi_y_thr, vj_y_thr, c_y_thr,
    //           db_res_count, eval_thr, seq_id_thr, cov_thr]
    const double* dp,
    int32_t seq_id_mode, int32_t cov_mode, int64_t aln_len_thr,
    Rec* rec, uint8_t* keep_out) {
    const double lam = dp[0], K = dp[1], log_K = dp[2];
    const double a_I = dp[3], b_I = dp[4], a_J = dp[5], b_J = dp[6];
    const double alpha_I = dp[7], beta_I = dp[8];
    const double alpha_J = dp[9], beta_J = dp[10];
    const double sigma = dp[11], tau = dp[12];
    const double vi_y_thr = dp[13], vj_y_thr = dp[14], c_y_thr = dp[15];
    const double mres = dp[16];
    const double eval_thr = dp[17], seq_id_thr = dp[18], cov_thr = dp[19];
    const double eps = 1.1920928955078125e-07;  // np.finfo(np.float32).eps

#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; i++) {
        const int64_t qlen = (int64_t)lengths[qrow[i]];
        const int64_t tlen = (int64_t)lengths[trow[i]];
        const double y = (double)score[i];

        // epa first, then area (association matters for subnormal
        // E-values, EvalueComputation.h:36-40)
        const double epa = K * std::exp(-lam * y);
        const double n = (double)qlen;
        const double m_li_y = mres - (a_I * y + b_I);
        double vi_y = alpha_I * y + beta_I;
        if (vi_y < vi_y_thr) vi_y = vi_y_thr;
        const double sqrt_vi = std::sqrt(vi_y);
        const double m_F = sqrt_vi == 0.0 ? 1e100 : m_li_y / sqrt_vi;
        const double P_m = 0.5 * std::erfc(-kSqrtHalf * m_F);
        const double E_m = -kConstVal * std::exp(-0.5 * m_F * m_F);
        const double p1 = m_li_y * P_m - sqrt_vi * E_m;
        const double n_lj_y = n - (a_J * y + b_J);
        double vj_y = alpha_J * y + beta_J;
        if (vj_y < vj_y_thr) vj_y = vj_y_thr;
        const double sqrt_vj = std::sqrt(vj_y);
        const double n_F = sqrt_vj == 0.0 ? 1e100 : n_lj_y / sqrt_vj;
        const double P_n = 0.5 * std::erfc(-kSqrtHalf * n_F);
        const double E_n = -kConstVal * std::exp(-0.5 * n_F * n_F);
        const double p2 = n_lj_y * P_n - sqrt_vj * E_n;
        double c_y = sigma * y + tau;
        if (c_y < c_y_thr) c_y = c_y_thr;
        const double area = p1 * p2 + c_y * P_m * P_n;
        const double evalue = epa * area;

        // (bit_score + 0.5) truncated toward zero, as .astype(np.int64)
        const int64_t bit =
            (int64_t)((lam * y - log_K) / kLn2 + 0.5);

        const int64_t aln_len = (int64_t)last[i] - first[i] + 1;
        const bool pos_diag = dg[i] >= 0;
        const int64_t d = dist[i];
        int64_t qs = pos_diag ? first[i] + d : first[i];
        int64_t qe = pos_diag ? last[i] + d : last[i];
        const int64_t ts = pos_diag ? first[i] : first[i] + d;
        const int64_t te = pos_diag ? last[i] : last[i] + d;

        double denom;
        if (seq_id_mode == 1)
            denom = (double)(qlen < tlen ? qlen : tlen);
        else if (seq_id_mode == 2)
            denom = (double)(qlen > tlen ? qlen : tlen);
        else
            denom = (double)aln_len;
        const bool is_identity = qrow[i] == trow[i];
        double seq_id = idents[i] / denom;
        if (!(evalue <= eval_thr || is_identity)) seq_id = 0.0;

        const int64_t q_hi = qs > qe ? qs : qe;
        const int64_t q_lo = qs < qe ? qs : qe;
        const int64_t t_hi = ts > te ? ts : te;
        const int64_t t_lo = ts < te ? ts : te;
        const double qcov =
            (double)((qlen < q_hi ? qlen : q_hi) - q_lo + 1) / (double)qlen;
        const double tcov =
            (double)((tlen < t_hi ? tlen : t_hi) - t_lo + 1) / (double)tlen;
        if (qrev[i]) {  // rescorediagonal.cpp:294-297
            qs = qlen - qs - 1;
            qe = qlen - qe - 1;
        }

        bool has_cov;
        if (cov_mode == 0)
            has_cov = qcov >= cov_thr && tcov >= cov_thr;
        else if (cov_mode == 1)
            has_cov = tcov >= cov_thr;
        else if (cov_mode == 2)
            has_cov = qcov >= cov_thr;
        else
            has_cov = true;

        bool keep = ov[i] > 0 &&
            (is_identity ||
             (aln_len >= aln_len_thr && has_cov &&
              seq_id >= seq_id_thr - eps && evalue <= eval_thr));
        if (cov_thr > 0 && (cov_mode == 0 || cov_mode == 2)) {
            const double small = (double)(qlen < tlen ? qlen : tlen);
            const double big = (double)(qlen > tlen ? qlen : tlen);
            if (cov_mode == 0)
                keep = keep && small / big >= cov_thr;
            else
                keep = keep && big * cov_thr <= small;
        }

        Rec r;
        r.dbKey = (uint32_t)tk[i];
        r.score = (int32_t)bit;
        r.qcov = (float)qcov;
        r.dbcov = (float)tcov;
        r.seqId = (float)seq_id;
        r.eval = evalue;
        r.alnLength = (int32_t)aln_len;
        r.qStartPos = (int32_t)qs;
        r.qEndPos = (int32_t)qe;
        r.qLen = (int32_t)qlen;
        r.dbStartPos = (int32_t)ts;
        r.dbEndPos = (int32_t)te;
        r.dbLen = (int32_t)tlen;
        std::memcpy(&rec[i], &r, sizeof(Rec));
        keep_out[i] = keep ? 1 : 0;
    }
}
