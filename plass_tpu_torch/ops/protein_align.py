"""Gapped protein alignment (`align` for amino-acid DBs).

Reference: lib/mmseqs/src/alignment/StripedSmithWaterman.cpp (ssw_init,
ssw_align: forward byte/word kernel, reverse pass for start coords,
scoreIdentical), SubstitutionMatrix::calcLocalAaBiasCorrection
(SubstitutionMatrix.cpp:92-121), Matcher::getSWResult protein branch
(Matcher.cpp:61-187: SCORE_COV mode, estimateSeqIdByScorePerCol) and
Alignment.cpp orchestration. The striped DP kernels run in the native
library (ssw.cpp, banded.cpp of the JAX package's native/, built by the
port's native/) because their lazy-F semantics are
vector-layout-dependent; profiles are built here. With enough candidate
pairs on a card, every pair is first scored by the device Smith-Waterman
(ops/device_align.py, kernel B9) and E-value failures are rejected
without a host call. Profile queries (seqdb.HMM_PROFILE, through
ops/profile_query.py) always take the host path, as in the JAX package.
"""
import ctypes

import numpy as np

from .. import constants, native
from ..data import seqdb
from ..utils.device import pick_device
from .evalue import EvalueComputer
from .nucl_align import _can_be_covered, _has_cov
from .profile_query import ProfileQuery
from .rescore import format_seq_id

BYTE_LANES = 16
WORD_LANES = 8

# When no residue aligns (dbEndPos1 == -1), ssw_align returns with r.evalue
# never written (StripedSmithWaterman.cpp:144-148,188-190); the reference
# binary deterministically leaks the stack bit pattern of integer 48
# (2.372e-322), which downstream tools print verbatim.
_SSW_NO_ALN_EVALUE = float(np.array(48, dtype=np.int64).view(np.float64))


def calc_local_aa_bias(sub, pback, qnum):
    """SubstitutionMatrix::calcLocalAaBiasCorrection: windowed average
    subtraction + background expectation, float32 per reference.

    Vectorised over the positions with the reference's own roundings (the
    JAX package's version loops over them): each position's float32
    accumulator takes `float += double` per alphabet letter in order."""
    qnum = np.asarray(qnum, dtype=np.int64)
    n = len(qnum)
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    sub_i = sub.astype(np.int64)
    rows = sub.shape[0]
    bg = pback[:rows].astype(np.float64)
    # per-row double increment pBack[a]*float(sub[row][a])
    incr = bg[None, :] * sub_i.astype(np.float32).astype(np.float64)
    # window sums of sub[q_i][q_k] over k in [i-20, i+20): per row letter,
    # prefix sums along the query
    pre = np.zeros((rows, n + 1), dtype=np.int64)
    pre[:, 1:] = np.cumsum(sub_i[:, qnum], axis=1)
    pos = np.arange(n)
    lo = np.maximum(0, pos - 20)
    hi = np.minimum(n, pos + 20)
    s = pre[qnum, hi] - pre[qnum, lo] - sub_i[qnum, qnum]
    acc = (s.astype(np.float32).astype(np.float64)
           / (-1.0 * (hi - lo))).astype(np.float32)
    for a in range(rows):
        acc = (acc.astype(np.float64) + incr[qnum, a]).astype(np.float32)
    return acc.astype(np.float64)


class ProteinAligner:
    """SmithWaterman profile holder + ssw_align per target."""

    def __init__(self, matrix=None, aa_bias_correction=True):
        mat = matrix or constants.blosum62()
        self.mat = mat
        self.sub8 = mat.sub.astype(np.int8)
        self.alpha = mat.alphabet_size
        self.bias_corr = aa_bias_correction
        self.nat = native.lib()

    def init_query_profile(self, aln_profile, qnum):
        """ssw_init with a query profile (StripedSmithWaterman.cpp:698-760):
        per-position PSSM (aa-major, L-stride), X row zeroed, no
        composition bias."""
        self.is_profile = True
        self.qnum = np.asarray(qnum, dtype=np.uint8)
        L = aln_profile.shape[1]
        self.L = L
        # mat rows: 20 PSSM rows + zeroed X row (ssw_init memset,
        # StripedSmithWaterman.cpp:711-714)
        mat = np.zeros((self.alpha, L), dtype=np.int8)
        mat[:20] = aln_profile
        self.profile_mat = mat
        self.comp = np.zeros(L, dtype=np.int8)
        self.bias = abs(min(int(aln_profile.min(initial=0)), 0))
        # profile_word_linear[i][j] = mat[i*L + j]
        # (StripedSmithWaterman.cpp:748-752)
        self._set_columns(mat.astype(np.int32))

    def _set_columns(self, linear):
        """The query's score columns linear[a][i] (int32 [alphabet, L]),
        kept for scoreIdentical and the reverse pass, and striped into the
        byte and word profiles."""
        self.linear = linear
        self.profile_byte = self._striped(linear, self.bias, BYTE_LANES,
                                          np.uint8)
        self.profile_word = self._striped(linear, 0, WORD_LANES, np.int16)

    def _striped(self, cols, bias, lanes, dtype):
        """createQueryProfile: score columns cols[a][i] in the striped
        layout, slot (j, l) holding query position j + l * seg."""
        L = cols.shape[1]
        seg = (L + lanes - 1) // lanes
        prof = np.full((self.alpha, seg * lanes), bias, dtype=np.int32)
        pos = np.arange(seg * lanes)
        pp = pos // lanes + (pos % lanes) * seg
        valid = pp < L
        pv = pp[valid]
        for nt in range(self.alpha):
            prof[nt, valid] = cols[nt, pv] + bias
        return np.ascontiguousarray(prof.astype(dtype))

    def init_query(self, qnum):
        self.is_profile = False
        self.qnum = np.asarray(qnum, dtype=np.uint8)
        L = len(qnum)
        self.L = L
        if self.bias_corr:
            tmp = calc_local_aa_bias(self.sub8, self.mat.pback, self.qnum)
            comp = np.where(tmp < 0.0, tmp - 0.5, tmp + 0.5).astype(np.int8)
            comp_min = min(int(comp.min(initial=0)), 0)
        else:
            comp = np.zeros(L, dtype=np.int8)
            comp_min = 0
        self.comp = comp
        self.bias = abs(int(self.sub8.min())) + abs(comp_min)
        self._set_columns(self.sub8.astype(np.int32)[:, self.qnum]
                          + comp.astype(np.int32)[None, :])

    def _run_byte(self, dbnum, ref_dir, db_len, q_len, gapo, gape, profile,
                  terminate, bias, mask_len):
        out = np.zeros(6, dtype=np.int32)
        maxcol = np.zeros(max(db_len, 1), dtype=np.uint8)
        self.nat.ssw_byte(
            dbnum.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ref_dir,
            db_len, q_len, gapo, gape,
            profile.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            terminate, bias, mask_len,
            maxcol.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def _run_word(self, dbnum, ref_dir, db_len, q_len, gapo, gape, profile,
                  terminate, mask_len):
        out = np.zeros(6, dtype=np.int32)
        maxcol = np.zeros(max(db_len, 1), dtype=np.uint16)
        self.nat.ssw_word(
            dbnum.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ref_dir,
            db_len, q_len, gapo, gape,
            profile.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            terminate, mask_len,
            maxcol.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def _rev_profile(self, q_len_rev, bias, lanes, dtype):
        """Reverse profile over q[qEnd - p] for p in [0, qEnd]
        (createQueryProfile on query_rev_sequence with offset)."""
        return self._striped(self.linear[:, q_len_rev - 1::-1], bias, lanes,
                             dtype)

    def ssw_align(self, dbnum, gap_open, gap_extend, alignment_mode,
                  eval_thr, evaluer, cov_mode, cov_thr, mask_len):
        dbnum = np.ascontiguousarray(dbnum, dtype=np.uint8)
        db_len = len(dbnum)
        L = self.L
        r = {"score1": 0, "dbStart": -1, "dbEnd": -1, "qStart": -1,
             "qEnd": -1, "qCov": 0.0, "tCov": 0.0,
             "evalue": _SSW_NO_ALN_EVALUE}
        b = self._run_byte(dbnum, 0, db_len, L, gap_open, gap_extend,
                           self.profile_byte, 255, self.bias, mask_len)
        word = 0
        if b[5]:  # byte overflow -> word kernel
            b = self._run_word(dbnum, 0, db_len, L, gap_open, gap_extend,
                               self.profile_word, 65535, mask_len)
            word = 1
        r["score1"] = int(b[0])
        r["dbEnd"] = int(b[1])
        r["qEnd"] = int(b[2])
        if r["dbEnd"] == -1:
            return r
        r["evalue"] = float(evaluer.evalue(r["score1"], L))
        low_eval = r["evalue"] > eval_thr
        r["qCov"] = _cov32(0, r["qEnd"], L)
        r["tCov"] = _cov32(0, r["dbEnd"], db_len)
        low_cov = not _has_cov(cov_thr, cov_mode, r["qCov"], r["tCov"])
        if alignment_mode == 0 or (alignment_mode in (1, 2)
                                   and (low_eval or low_cov)):
            return r
        # reverse pass for the start coordinates
        q_len_rev = r["qEnd"] + 1
        if word == 0:
            prof = self._rev_profile(q_len_rev, self.bias, BYTE_LANES,
                                     np.uint8)
            rv = self._run_byte(dbnum, 1, r["dbEnd"] + 1, q_len_rev,
                                gap_open, gap_extend, prof, r["score1"],
                                self.bias, mask_len)
        else:
            prof = self._rev_profile(q_len_rev, 0, WORD_LANES, np.int16)
            rv = self._run_word(dbnum, 1, r["dbEnd"] + 1, q_len_rev,
                                gap_open, gap_extend, prof, r["score1"],
                                mask_len)
        r["dbStart"] = int(rv[1])
        r["qStart"] = r["qEnd"] - int(rv[2])
        r["qCov"] = _cov32(r["qStart"], r["qEnd"], L)
        r["tCov"] = _cov32(r["dbStart"], r["dbEnd"], db_len)
        low_cov = not _has_cov(cov_thr, cov_mode, r["qCov"], r["tCov"])
        if alignment_mode == 1 or low_cov:
            return r
        # cigar over the alignment rectangle (banded_sw,
        # StripedSmithWaterman.cpp:246-268,781-984)
        r["cigar"] = self._banded_cigar(dbnum, r, gap_open, gap_extend)
        return r

    def _banded_cigar(self, dbnum, r, gap_open, gap_extend):
        t_len = r["dbEnd"] - r["dbStart"] + 1
        q_len = r["qEnd"] - r["qStart"] + 1
        band = abs(t_len - q_len) + 1
        tseq = np.ascontiguousarray(dbnum[r["dbStart"]:r["dbEnd"] + 1])
        qseq = np.ascontiguousarray(self.qnum[r["qStart"]:r["qEnd"] + 1])
        comp = np.ascontiguousarray(self.comp[r["qStart"]:r["qEnd"] + 1])
        mat = np.ascontiguousarray(self.profile_mat) if self.is_profile \
            else np.ascontiguousarray(self.sub8)
        cap = (q_len + t_len + 2)
        out = np.zeros(cap, dtype=np.uint8)
        n = self.nat.banded_backtrace(
            tseq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t_len,
            qseq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), q_len,
            comp.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), self.alpha,
            gap_open, gap_extend, band, r["score1"],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
            1 if self.is_profile else 0,
            r["qStart"] if self.is_profile else 0,
            self.L if self.is_profile else 0)
        if n < 0:
            return None
        return out[:n].tobytes().decode()

    def score_identical(self, dbnum, evaluer):
        """SmithWaterman::scoreIdentical with int16 accumulation."""
        L = self.L
        score = int(self.linear[dbnum[np.arange(L)], np.arange(L)].sum())
        score = ((score + 0x8000) & 0xFFFF) - 0x8000  # short accumulator
        return {"score1": int(score), "qStart": 0, "qEnd": L - 1,
                "dbStart": 0, "dbEnd": L - 1, "qCov": 1.0, "tCov": 1.0,
                "evalue": float(evaluer.evalue(int(score), L))}


def _cov32(start, end, length):
    return float(np.float32(min(length, max(start, end)) - min(start, end)
                            + 1) / np.float32(length))


def estimate_seq_id_by_score_per_col(score, qlen, tlen):
    """Matcher::estimateSeqIdByScorePerCol (Matcher.cpp:205-209)."""
    # (score / float(len)) is float32; * 0.1656 + 0.1141 promote to double
    # (double literals), the result is stored back into a float
    per_col = float(np.float32(score) / np.float32(max(qlen, tlen)))
    est = float(np.float32(per_col * 0.1656 + 0.1141))
    return max(0.0, min(est, 1.0))


def compute_seq_id(seq_id_mode, aa_ids, qlen, tlen, aln_len):
    """Util::computeSeqId (Util.cpp:588-598); mode 0 = ALN_LEN default."""
    if seq_id_mode == 1:  # SEQ_ID_SHORT
        return float(np.float32(aa_ids) / np.float32(min(qlen, tlen)))
    if seq_id_mode == 2:  # SEQ_ID_LONG
        return float(np.float32(aa_ids) / np.float32(max(qlen, tlen)))
    return float(np.float32(aa_ids) / np.float32(max(aln_len, 1)))


def init_sw_mode(alignment_mode, cov_thr, seq_id_thr):
    """Alignment::initSWMode (Alignment.cpp:174-198), returning Matcher's
    numbering (ssw_align's alignmentMode): 0 = SCORE_ONLY, 1 = SCORE_COV,
    2 = SCORE_COV_SEQID."""
    if alignment_mode == 0:  # FAST_AUTO
        if cov_thr > 0.0 and seq_id_thr == 0.0:
            return 1
        if cov_thr > 0.0 and seq_id_thr > 0.0:
            return 2
        return 0
    if alignment_mode == 2:
        return 1
    if alignment_mode == 3:
        return 2
    return 0


def align_protein(db, hits, seq_id_thr=0.0, cov_thr=0.0, cov_mode=0,
                  eval_thr=1e-3, aln_len_thr=0, gap_open=11, gap_extend=1,
                  comp_bias_corr=True, max_accept=2**31 - 1,
                  max_reject=2**31 - 1, evaluer=None, tdb=None,
                  alignment_mode=2, add_backtrace=False,
                  include_identity=False, seq_id_mode=0, realign=False,
                  realign_max_seqs=2**31 - 1, device_prefilter=None,
                  device="cuda", counts=None):
    """`align` for amino-acid DBs (Alignment.cpp:250-470 semantics).

    db: query DB; tdb: target DB (None = same DB, enables identity
    shortcuts like sameQTDB). hits: {query_key: [(target, score, diag),
    ...]}. alignment_mode: 0 auto / 2 score+cov / 3 +real seq.id via
    banded backtrace (forced to 3 by add_backtrace, Alignment.cpp:35-37).
    Returns {query_key: [result dict]} sorted by Matcher::compareHits.

    device_prefilter (None = on a card with at least 512 candidate pairs):
    score every candidate pair with the batched SW (ops/device_align.py)
    in one call on `device` and reject E-value failures without a host
    ssw call — bit-equivalent, because the kernel computes the exact ssw
    maximum and E-value rejection depends on the score alone; survivors
    still run the native path for positions/backtraces. True on the CPU
    runs the kernel's plain version. device: "cuda" (the default; without
    a card it raises), "cuda:<i>" or "cpu".

    counts: an optional dict to which the call adds its distinct
    non-identity candidate pairs ("candidate_pairs"), the pairs scored on
    `device` first ("device_pairs") and those rejected by that score
    without a host ssw call ("device_rejected").

    A profile query DB (seqdb.HMM_PROFILE) aligns each query's
    position-specific matrix on the host and is never scored on `device`
    first, as in the JAX package.
    """
    device = pick_device(device)
    mat = constants.blosum62()
    same_db = tdb is None
    if tdb is None:
        tdb = db
    if evaluer is None:
        evaluer = EvalueComputer.for_matrix("blosum62_11_1",
                                            tdb.total_residues())
    if add_backtrace:
        alignment_mode = 3
    realigner = None
    realign_sw_mode = 0
    realign_cov = cov_thr
    if realign:
        # Alignment ctor (Alignment.cpp:47-56,165-171): first pass runs in
        # SCORE_ONLY with covThr 0; the realign pass uses the -0.2-biased
        # matrix and initSWMode(max(mode, SCORE_COV), 0, 0); the forced
        # backtrace (Alignment.cpp:52-55) comes AFTER that, so without -a
        # the realigned results carry empty "0M" backtraces and
        # score-per-column seqIds
        realign_sw_mode = init_sw_mode(max(alignment_mode, 2), 0.0, 0.0)
        alignment_mode = 1  # ALIGNMENT_MODE_SCORE_ONLY
        realign_cov = cov_thr
        cov_thr = 0.0
        if add_backtrace is False:
            add_backtrace = True
        realigner = ProteinAligner(constants.blosum62_pref(),
                                   comp_bias_corr)
    sw_mode = init_sw_mode(alignment_mode, cov_thr, seq_id_thr)
    aligner = ProteinAligner(mat, comp_bias_corr)
    out = {}
    is_profile_query = db.dbtype == seqdb.HMM_PROFILE
    pre_scores = None if is_profile_query else _maybe_device_prefilter(
        db, tdb, hits, mat, comp_bias_corr, gap_open, gap_extend,
        include_identity, same_db, device_prefilter, device)
    device_rejected = 0
    for qkey in sorted(hits):
        hlist = hits[qkey]
        if not hlist:
            out[qkey] = []
            continue
        qid = db.key_to_id(qkey)
        if is_profile_query:
            pq = ProfileQuery(db.get_data(qid).tobytes(),
                              comp_bias=comp_bias_corr)
            qnum = pq.qnum
            aligner.init_query_profile(pq.aln_profile, pq.qnum)
        else:
            qnum = mat.aa2num[np.asarray(db.get_seq(qid))]
            aligner.init_query(qnum)
        L = len(qnum)
        mask_len = L // 2
        results = []
        passed = rejected = 0
        for (tkey, _score, _diag) in hlist:
            if passed >= max_accept or rejected >= max_reject:
                break
            tid = tdb.key_to_id(tkey)
            tnum = mat.aa2num[np.asarray(tdb.get_seq(tid))]
            tlen = len(tnum)
            if not _can_be_covered(cov_thr, cov_mode, L, tlen):
                rejected += 1
                continue
            is_identity = (qkey == tkey) and (include_identity or same_db)
            if pre_scores is not None and not is_identity:
                sc = pre_scores.get((qkey, tkey))
                # the acceptance criterion below requires eval <= eval_thr
                # (an AND term), so an exact-score E-value failure rejects
                # without the positions the native pass would compute
                if sc is not None and \
                        float(evaluer.evalue(sc, L)) > eval_thr:
                    rejected += 1
                    device_rejected += 1
                    continue
            r = sw_pair(aligner, evaluer, tnum, tkey, is_identity, sw_mode,
                        seq_id_mode, gap_open, gap_extend, eval_thr,
                        cov_mode, cov_thr, mask_len,
                        add_backtrace=add_backtrace)
            if is_identity:
                # the MAIN pass overwrites identity cov/seqId with 1.0
                # (Alignment.cpp:389-394); the realign pass below does not
                r["qcov"] = r["tcov"] = 1.0
                r["seqId"] = 1.0
            ok = is_identity or (
                (r["eval"] <= eval_thr) and (r["seqId"] >= seq_id_thr)
                and _has_cov(cov_thr, cov_mode, r["qcov"], r["tcov"])
                and r["alnLength"] >= aln_len_thr)
            if ok:
                results.append(r)
                passed += 1
                rejected = 0
            else:
                rejected += 1
        if realigner is not None:
            # recompute boundaries with the biased matrix, keep score/eval
            # (Alignment.cpp:415-449)
            if is_profile_query:
                realigner.init_query_profile(pq.aln_profile, pq.qnum)
            else:
                realigner.init_query(qnum)
            re_results = []
            for r in results:
                if len(re_results) >= realign_max_seqs:
                    break
                tid = tdb.key_to_id(r["dbKey"])
                tnum = mat.aa2num[np.asarray(tdb.get_seq(tid))]
                is_identity = (qkey == r["dbKey"]) and (include_identity
                                                        or same_db)
                # getSWResult(..., covMode=(int)realignCov, covThr=0,
                # eval FLT_MAX, realignSwMode) — the reference passes
                # realignCov in the covMode slot (Alignment.cpp:429)
                rr = sw_pair(realigner, evaluer, tnum, r["dbKey"],
                             is_identity, realign_sw_mode, seq_id_mode,
                             gap_open, gap_extend, 3.402823466e+38,
                             int(realign_cov), 0.0, L // 2,
                             add_backtrace=add_backtrace)
                cov_ok = _has_cov(realign_cov, cov_mode, rr["qcov"],
                                  rr["tcov"])
                if cov_ok or is_identity:
                    rr["score"] = r["score"]
                    rr["eval"] = r["eval"]
                    re_results.append(rr)
            results = re_results
        results.sort(key=lambda r: (r["eval"], -r["score"], r["dbLen"],
                                    r["dbKey"]))
        out[qkey] = results
    if counts is not None:
        for name, n in (
                ("candidate_pairs",
                 len(candidate_pairs(hits, include_identity, same_db))),
                ("device_pairs", len(pre_scores or ())),
                ("device_rejected", device_rejected)):
            counts[name] = counts.get(name, 0) + n
    return out


def lca_align_protein(db, hits, tdb=None, alignment_mode=0, cov_thr=0.0,
                      cov_mode=0, seq_id_thr=0.0, eval_thr=1e-3,
                      aln_len_thr=0, gap_open=11, gap_extend=1,
                      comp_bias_corr=True, max_accept=2**31 - 1,
                      max_reject=2**31 - 1, seq_id_mode=0,
                      include_identity=False, evaluer=None):
    """`lcaalign` — approximate 2bLCA (Alignment.cpp:39-45 ctor config,
    run() lca block :451-506): align candidates score-only, realign the
    top hit with coordinates, then re-align the top hit's *target
    fragment* against every candidate, keeping hits whose E-value beats
    the top hit's. Returns {query_key: [result dict]}."""
    mat = constants.blosum62()
    same_db = tdb is None
    if tdb is None:
        tdb = db
    if evaluer is None:
        evaluer = EvalueComputer.for_matrix("blosum62_11_1",
                                            tdb.total_residues())
    # ctor: lcaSwMode from max(mode, SCORE_ONLY) at zero thresholds;
    # realign forces realignSwMode from max(mode, SCORE_COV), member
    # covThr zeroed, realignCov keeps the requested coverage
    lca_sw_mode = init_sw_mode(max(alignment_mode, 1), 0.0, 0.0)
    realign_sw_mode = init_sw_mode(max(alignment_mode, 2), 0.0, 0.0)
    # swMode = initSWMode(lcaSwMode, covThr, seqIdThr) — the Matcher-mode
    # value is re-interpreted as an ALIGNMENT_MODE (reference quirk)
    sw_mode = init_sw_mode(lca_sw_mode, cov_thr, seq_id_thr)
    realign_cov = cov_thr
    flt_max = 3.4028234663852886e38
    aligner = ProteinAligner(mat, comp_bias_corr)
    out = {}
    for qkey in sorted(hits):
        hlist = hits[qkey]
        if not hlist:
            out[qkey] = []
            continue
        qid = db.key_to_id(qkey)
        qnum = mat.aa2num[np.asarray(db.get_seq(qid))]
        aligner.init_query(qnum)
        mask_len = len(qnum) // 2
        results = []
        passed = rejected = 0
        for (tkey, _score, _diag) in hlist:
            if passed >= max_accept or rejected >= max_reject:
                break
            tid = tdb.key_to_id(tkey)
            tnum = mat.aa2num[np.asarray(tdb.get_seq(tid))]
            # canBeCovered uses canCovThr = the original covThr even
            # though the realign path zeroes the member covThr
            if not _can_be_covered(cov_thr, cov_mode, len(qnum),
                                   len(tnum)):
                rejected += 1
                continue
            is_identity = (qkey == tkey) and (include_identity or same_db)
            r = sw_pair(aligner, evaluer, tnum, tkey, is_identity, sw_mode,
                        seq_id_mode, gap_open, gap_extend, eval_thr,
                        cov_mode, 0.0, mask_len)
            if is_identity:
                # main-pass identity overwrite (Alignment.cpp:389-394)
                r["qcov"] = r["tcov"] = 1.0
                r["seqId"] = 1.0
            ok = is_identity or (
                (r["eval"] <= eval_thr) and (r["seqId"] >= seq_id_thr)
                and r["alnLength"] >= aln_len_thr)
            if ok:
                results.append(r)
                passed += 1
                rejected = 0
            else:
                rejected += 1
        results.sort(key=lambda r: (r["eval"], -r["score"], r["dbLen"],
                                    r["dbKey"]))
        if not results:
            out[qkey] = []
            continue
        # realign pass, realignMaxSeqs=1: top hit only, coordinates via
        # SCORE_COV; covMode arg receives (int)realignCov (reference
        # quirk, Alignment.cpp:429)
        top = results[0]
        tid = tdb.key_to_id(top["dbKey"])
        tnum = mat.aa2num[np.asarray(tdb.get_seq(tid))]
        is_identity = (qkey == top["dbKey"]) and (include_identity
                                                  or same_db)
        rtop = sw_pair(aligner, evaluer, tnum, top["dbKey"], is_identity,
                       realign_sw_mode, seq_id_mode, gap_open, gap_extend,
                       flt_max, int(realign_cov), 0.0, mask_len)
        if not (_has_cov(realign_cov, cov_mode, rtop["qcov"], rtop["tcov"])
                or is_identity):
            out[qkey] = []
            continue
        rtop["score"] = top["score"]
        rtop["eval"] = top["eval"]
        # lca pass: query becomes the top hit's aligned target fragment
        frag = tnum[rtop["dbStartPos"]:rtop["dbEndPos"] + 1]
        aligner.init_query(frag)
        mask_len = len(frag) // 2
        top_eval = rtop["eval"]
        final = []
        rejected = 0
        for (tkey, _score, _diag) in hlist:
            if rejected >= max_reject:
                break
            tid2 = tdb.key_to_id(tkey)
            tnum2 = mat.aa2num[np.asarray(tdb.get_seq(tid2))]
            r = sw_pair(aligner, evaluer, tnum2, tkey, False, lca_sw_mode,
                        seq_id_mode, gap_open, gap_extend, top_eval,
                        cov_mode, realign_cov, mask_len)
            ok = ((r["eval"] <= top_eval) and (r["seqId"] >= seq_id_thr)
                  and _has_cov(realign_cov, cov_mode, r["qcov"], r["tcov"])
                  and r["alnLength"] >= aln_len_thr)
            if ok:
                final.append(r)
                rejected = 0
            else:
                rejected += 1
        final.sort(key=lambda r: (r["eval"], -r["score"], r["dbLen"],
                                  r["dbKey"]))
        out[qkey] = final
    return out


# the fewest candidate pairs for which the aligner scores them on a card
# first, as the JAX package decides on an accelerator
DEVICE_PREFILTER_PAIRS = 512


def candidate_pairs(hits, include_identity, same_db):
    """The distinct non-identity (qkey, tkey) pairs of `hits`, in order."""
    pairs = []
    for q, hlist in hits.items():
        for (t, _s, _d) in hlist:
            if (q == t) and (include_identity or same_db):
                continue
            pairs.append((q, t))
    return list(dict.fromkeys(pairs))


def query_profile_row(db, qid, mat, comp_bias_corr):
    """(codes uint8[L], comp int8[L]) of query `qid`: the exact integer
    profile row the native ssw builds, sub[a][q_i] + comp[i]."""
    qnum = mat.aa2num[np.asarray(db.get_seq(qid))]
    if comp_bias_corr:
        tmp = calc_local_aa_bias(mat.sub.astype(np.int8), mat.pback, qnum)
        comp = np.where(tmp < 0.0, tmp - 0.5, tmp + 0.5).astype(np.int8)
    else:
        comp = np.zeros(len(qnum), dtype=np.int8)
    return qnum, comp


def _maybe_device_prefilter(db, tdb, hits, mat, comp_bias_corr, gap_open,
                            gap_extend, include_identity, same_db,
                            device_prefilter, device):
    """Batch-score all non-identity candidate pairs on `device`
    (ops/device_align.py) when worthwhile. Returns {(qkey, tkey): score}
    or None."""
    pairs = candidate_pairs(hits, include_identity, same_db)
    if device_prefilter is None:
        device_prefilter = (device.type == "cuda"
                            and len(pairs) >= DEVICE_PREFILTER_PAIRS)
    if not device_prefilter or not pairs:
        return None

    from .device_align import batch_pair_scores
    return batch_pair_scores(
        db, tdb, pairs,
        lambda qid: query_profile_row(db, qid, mat, comp_bias_corr),
        gap_open, gap_extend, device)


def sw_pair(aligner, evaluer, tnum, tkey, is_identity, sw_mode, seq_id_mode,
            gap_open, gap_extend, eval_thr, cov_mode, cov_thr, mask_len,
            add_backtrace=False):
    """One Matcher::getSWResult call + seqId/alnLength derivation for the
    amino-acid branch (Matcher.cpp:61-187). The aligner must have its query
    initialized. Returns the result dict (with qcov/tcov); the caller applies
    Alignment::checkCriteria."""
    qnum = aligner.qnum
    L = aligner.L
    backtrace = ""
    aa_ids = 0
    if is_identity:
        a = aligner.score_identical(tnum, evaluer)
        if sw_mode == 2:
            backtrace = "M" * L
            aa_ids = L
    else:
        a = aligner.ssw_align(tnum, gap_open, gap_extend, sw_mode,
                              eval_thr, evaluer, cov_mode, cov_thr,
                              mask_len)
        if sw_mode == 2 and a.get("cigar") is not None:
            backtrace = a["cigar"]
            aa_ids = _count_ids(qnum, tnum, a["qStart"],
                                a["dbStart"], backtrace)
    qs, qe = a["qStart"], a["qEnd"]
    ts, te = a["dbStart"], a["dbEnd"]
    tlen = len(tnum)
    # Matcher::getSWResult: unsigned coordinate arithmetic
    # (negative starts wrap, filtered by criteria anyway)
    q_diff = (qe - qs) & 0xFFFFFFFF
    t_diff = (te - ts) & 0xFFFFFFFF
    aln_len = (max(q_diff, t_diff) + 1) & 0xFFFFFFFF
    # qcov/dbcov stay 0.0 in SCORE_ONLY mode (Matcher.cpp:133-146)
    qcov, tcov = (a["qCov"], a["tCov"]) if sw_mode in (1, 2) else (0.0, 0.0)
    if sw_mode == 2:
        if backtrace:
            aln_len = len(backtrace)
        seq_id = compute_seq_id(seq_id_mode, aa_ids, L, tlen, aln_len)
    elif sw_mode == 1:  # SCORE_COV (Matcher.cpp:159-165)
        seq_id = estimate_seq_id_by_score_per_col(
            a["score1"], max(q_diff, 1), max(t_diff, 1))
    else:  # SCORE_ONLY: end positions, not spans (Matcher.cpp:166-171)
        seq_id = estimate_seq_id_by_score_per_col(
            a["score1"], max(qe & 0xFFFFFFFF, 1), max(te & 0xFFFFFFFF, 1))
    # identity coverage comes from scoreIdentical's qCov=tCov=1.0 through
    # the mode gate above (SCORE_ONLY still zeroes it, Matcher.cpp:143-146);
    # the main alignment pass separately forces cov/seqId to 1.0
    # (Alignment.cpp:389-394) — that is the caller's job, not ours
    bit = int(evaluer.bit_score(a["score1"]) + 0.5)
    r = {
        "dbKey": int(tkey), "score": bit, "qcov": qcov,
        "tcov": tcov, "seqId": seq_id, "eval": a["evalue"],
        "alnLength": int(aln_len), "qStartPos": qs,
        "qEndPos": qe, "qLen": L, "dbStartPos": ts,
        "dbEndPos": te, "dbLen": tlen,
    }
    if add_backtrace:
        r["backtrace"] = backtrace
    return r


def _count_ids(qnum, tnum, q_start, t_start, backtrace):
    """Count identical aligned residues along a backtrace
    (Matcher.cpp:96-131)."""
    qp, tp = q_start, t_start
    ids = 0
    for op in backtrace:
        if op == "M":
            if qp < len(qnum) and tp < len(tnum) and qnum[qp] == tnum[tp]:
                ids += 1
            qp += 1
            tp += 1
        elif op == "I":
            qp += 1
        else:
            tp += 1
    return ids


def protein_align_results_to_db(results, add_backtrace=False,
                                key_order=None):
    """Serialize (Matcher::resultToBuffer; backtrace column with -a).
    key_order: physical record order (the reference writes in query
    data-file order); defaults to ascending key."""
    w = seqdb.DBWriter(seqdb.ALIGNMENT_RES)
    keys = key_order if key_order is not None else sorted(results)
    for key in keys:
        lines = []
        for r in results[key]:
            line = (
                f"{r['dbKey']}\t{r['score']}\t{format_seq_id(r['seqId'])}\t"
                f"{r['eval']:.3E}\t{r['qStartPos']}\t{r['qEndPos']}\t"
                f"{r['qLen']}\t{r['dbStartPos']}\t{r['dbEndPos']}\t"
                f"{r['dbLen']}")
            if add_backtrace:
                line += "\t" + compress_cigar(r.get("backtrace", ""))
            lines.append(line + "\n")
        w.write(key, "".join(lines).encode(), add_newline=False)
    return w.finish()


def compress_cigar(backtrace):
    """Matcher::compressAlignment (Matcher.cpp:211-230): run-length
    encode, always writing the count; the state machine starts at
    ('M', 0) so an empty backtrace yields "0M" and one not starting with
    M gets an "0M" prefix (reference behavior)."""
    out = []
    state = "M"
    counter = 0
    for c in backtrace:
        if c != state:
            out.append(f"{counter}{state}")
            state = c
            counter = 1
        else:
            counter += 1
    out.append(f"{counter}{state}")
    return "".join(out)


def update_result_by_rescoring_backtrace(query_seq, target_seq, ascii_mat,
                                         evaluer, gap_open, gap_extend, res):
    """Matcher::updateResultByRescoringBacktrace (Matcher.cpp:372-440):
    Smith-Waterman-style max-subsegment rescoring of an existing backtrace;
    query_seq/target_seq are ASCII bytes, ascii_mat a char-indexed LUT."""
    bt = res["backtrace"]
    max_score = 0
    max_bt_end = max_bt_start = 0
    max_q_end = max_q_start = 0
    max_t_start = max_t_end = 0
    min_pos = -1
    min_q = res["qStartPos"] - 1
    min_t = res["dbStartPos"] - 1
    score = 0
    identical = 0
    max_id = 0
    qpos = res["qStartPos"]
    tpos = res["dbStartPos"]
    gap_is_open = False
    for pos, letter in enumerate(bt):
        if letter == "M":
            curr = int(ascii_mat[query_seq[qpos], target_seq[tpos]])
            identical += query_seq[qpos] == target_seq[tpos]
            gap_is_open = False
        else:
            curr = -gap_extend if gap_is_open else -gap_open
            gap_is_open = True
        score += curr
        if score <= 0:
            score = 0
            identical = 0
            min_pos = pos
            min_q = qpos - 1 if letter == "D" else qpos
            min_t = tpos - 1 if letter == "I" else tpos
        if score > max_score:
            max_bt_end = pos
            max_q_end = qpos
            max_t_end = tpos
            max_bt_start = min_pos + 1
            max_q_start = min_q + 1
            max_t_start = min_t + 1
            max_score = score
            max_id = identical
        if letter in ("M", "I"):
            qpos += 1
        if letter in ("M", "D"):
            tpos += 1
    res["qStartPos"] = max_q_start
    res["qEndPos"] = max_q_end
    res["dbStartPos"] = max_t_start
    res["dbEndPos"] = max_t_end
    res["score"] = int(evaluer.bit_score(max_score))
    res["eval"] = float(evaluer.evalue(max_score, res["qLen"]))
    aln_len = (max_bt_end - max_bt_start) + 1
    res["alnLength"] = aln_len
    res["seqId"] = np.float32(max_id) / np.float32(aln_len)
    res["backtrace"] = bt[max_bt_start:max_bt_start + aln_len]
    return res
