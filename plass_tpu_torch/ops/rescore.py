"""Ungapped diagonal rescoring (reference: lib/mmseqs/src/alignment/
rescorediagonal.cpp:45-379, DistanceCalculator.h:115-220).

Modes (Parameters.h:263-267): HAMMING(0), SUBSTITUTION(1), ALIGNMENT(2)
(best local stretch), END_TO_END(3) (global along the overlap, used by
plass/penguin), WINDOW_QUALITY(4).

This module holds the array-parallel scoring core used by both the NumPy
host path and the device path (ops/device_rescore.py). Alignment results
use the Matcher::result_t field set (Matcher.h:27-91).
"""
import os
from dataclasses import dataclass

import numpy as np

from .. import constants
from ..data import seqdb
from .evalue import EvalueComputer

RESCORE_HAMMING = 0
RESCORE_SUBSTITUTION = 1
RESCORE_ALIGNMENT = 2
RESCORE_END_TO_END = 3
RESCORE_WINDOW_QUALITY = 4

COV_MODE_BIDIRECTIONAL = 0
COV_MODE_TARGET = 1
COV_MODE_QUERY = 2

RESULT_DTYPE = np.dtype([
    ("dbKey", np.uint32), ("score", np.int32), ("qcov", np.float32),
    ("dbcov", np.float32), ("seqId", np.float32), ("eval", np.float64),
    ("alnLength", np.int32), ("qStartPos", np.int32), ("qEndPos", np.int32),
    ("qLen", np.int32), ("dbStartPos", np.int32), ("dbEndPos", np.int32),
    ("dbLen", np.int32),
])


def ungapped_by_diagonal(qnum, tnum, diagonal, ascii_mat, mode, qchars=None,
                         tchars=None):
    """DistanceCalculator::ungappedAlignmentByDiagonal for one pair.

    qnum/tnum: uint8 char arrays (raw ASCII); scoring via ascii_mat LUT.
    Returns (score, start, end, diagonal_len, dist_to_diag) with start/end
    relative to the overlap window.
    """
    qlen, tlen = len(qnum), len(tnum)
    dist = abs(int(diagonal))
    if diagonal >= 0:
        if dist >= qlen:
            return 0, -1, -1, 0, dist
        ov = min(tlen, qlen - dist)
        q = qnum[dist: dist + ov]
        t = tnum[:ov]
    else:
        if dist >= tlen:
            return 0, -1, -1, 0, dist
        ov = min(tlen - dist, qlen)
        q = qnum[:ov]
        t = tnum[dist: dist + ov]

    if mode == RESCORE_HAMMING:
        return int((q == t).sum()), -1, -1, ov, dist
    scores = ascii_mat[q, t].astype(np.int64)
    if mode == RESCORE_SUBSTITUTION:
        # best local prefix-max (computeSubstitutionDistance, local)
        c = np.cumsum(scores)
        run_min = np.minimum.accumulate(np.concatenate([[0], c]))[:-1]
        best = int(np.maximum(c - run_min, 0).max(initial=0))
        return best, -1, -1, ov, dist
    if mode == RESCORE_ALIGNMENT:
        # best local subsegment with start/end (computeSubstitutionStartEndDistance)
        score = 0
        max_score = 0
        max_start = max_end = 0
        min_pos = -1
        for p in range(ov):
            score += int(scores[p])
            if score <= 0:
                score = 0
                min_pos = p
            if score > max_score:
                max_score = score
                max_end = p
                max_start = min_pos + 1
        return max_score, max_start, max_end, ov, dist
    if mode == RESCORE_END_TO_END:
        # global along overlap, skipping leading/trailing '*'
        first = 1 if (q[0] == ord("*") or t[0] == ord("*")) else 0
        last = ov - 1
        if last > 0 and (q[last] == ord("*") or t[last] == ord("*")):
            last -= 1
        sc = int(scores[first: last + 1].sum()) if last >= first else 0
        sc = max(sc, 0)
        return sc, first, last, ov, dist
    raise ValueError(f"unsupported rescore mode {mode}")


@dataclass
class RescoreParams:
    rescore_mode: int = RESCORE_END_TO_END
    seq_id_thr: float = 0.0
    cov_thr: float = 0.0
    cov_mode: int = COV_MODE_BIDIRECTIONAL
    eval_thr: float = 0.001
    aln_len_thr: int = 0
    seq_id_mode: int = 0
    include_identity: bool = False
    add_backtrace: bool = False
    sort_results: int = 0
    filter_hits: bool = False
    global_seq_id: bool = False
    wrapped_scoring: bool = False
    score_per_col_thr: float = 0.0  # from parse_precision_lib when filter_hits


def parse_precision_lib(cov_mode, seq_id_thr, cov_thr, precision=0.99):
    """rescorediagonal.cpp:95-105 + parsePrecisionLib: first calibration row
    at the snapped (cov, seqId) grid point with precision >= target."""
    name = ("CovSeqidQscPercMinDiag.lib" if cov_mode == COV_MODE_BIDIRECTIONAL
            else "CovSeqidQscPercMinDiagTargetCov.lib")
    path = os.path.join(constants.DATA_DIR, name)
    int_seq_id = int((seq_id_thr + 0.0001) * 100)
    target_seq_id = np.float32((int_seq_id - int_seq_id % 5) / 100.0)
    target_cov = np.float32(int((cov_thr + 0.0001) * 10) / 10.0)
    eps = np.float32(np.finfo(np.float32).eps)
    with open(path) as f:
        for line in f:
            vals = line.split(" ")
            cov = np.float32(float(vals[0]))
            seqid = np.float32(float(vals[1]))
            spc = float(vals[2])
            prec = float(vals[3])
            if (abs(cov - target_cov) < eps and abs(seqid - target_seq_id) < eps
                    and prec >= precision):
                return spc
    return 0.0


def _compute_seq_id(mode, ids, qlen, tlen, alnlen):
    """Util::computeSeqId (Util.cpp:588-598) — float32 division."""
    if mode == 1:
        return float(np.float32(ids) / np.float32(min(qlen, tlen)))
    if mode == 2:
        return float(np.float32(ids) / np.float32(max(qlen, tlen)))
    return float(np.float32(ids) / np.float32(alnlen))


def _cov(start, end, length):
    return (min(length, max(start, end)) - min(start, end) + 1) / float(length)


def ungapped_best(qnum, tnum, diagonal, ascii_mat, mode):
    """DistanceCalculator::computeUngappedAlignment: scan the +-65536
    diagonal candidates of the stored 16-bit diagonal, keep the best score
    (strict >, negative divisions first). Returns (score, start, end,
    diag_len, dist, diag) with the reconstructed real diagonal.
    (DistanceCalculator.h:95-114)"""
    u16 = int(diagonal) & 0xFFFF
    qlen, tlen = len(qnum), len(tnum)
    best = (0, -1, -1, 0, 0, 0)
    for d in range(1, 2 + tlen // 32768):
        real = -d * 65536 + u16
        sc, st, en, dl, dist = ungapped_by_diagonal(qnum, tnum, real,
                                                    ascii_mat, mode)
        if sc > best[0]:
            best = (sc, st, en, dl, dist, real)
    for d in range(0, 1 + qlen // 65536):
        real = d * 65536 + u16
        sc, st, en, dl, dist = ungapped_by_diagonal(qnum, tnum, real,
                                                    ascii_mat, mode)
        if sc > best[0]:
            best = (sc, st, en, dl, dist, real)
    return best


def ungapped_best_wrapped(q2x, tnum, diagonal, ascii_mat, mode):
    """DistanceCalculator::computeUngappedWrappedAlignment
    (DistanceCalculator.h:57-93): q2x is the doubled query; candidate
    windows start inside the first copy, scored against the target on
    diagonal 0; the winning shift becomes the reported diagonal (always
    >= 0) and distance. diagonalLen is overridden to min(tlen, half)."""
    u16 = int(diagonal) & 0xFFFF
    half = len(q2x) // 2
    tlen = len(tnum)
    best = (0, -1, -1, 0, 0, 0)
    d = 1
    while (-d * 65536 + u16) > -tlen:
        real = (-d * 65536 + u16) + half
        sc, st, en, _, _ = ungapped_by_diagonal(q2x[real: real + half], tnum,
                                                0, ascii_mat, mode)
        if sc > best[0]:
            best = (sc, st, en, 0, abs(real), real)
        d += 1
    d = 0
    while (d * 65536 + u16) < half:
        real = d * 65536 + u16
        sc, st, en, _, _ = ungapped_by_diagonal(q2x[real: real + half], tnum,
                                                0, ascii_mat, mode)
        if sc > best[0]:
            best = (sc, st, en, 0, abs(real), real)
        d += 1
    return (best[0], best[1], best[2], min(tlen, half), best[4], best[5])


def _has_cov(cov_thr, cov_mode, qcov, tcov):
    if cov_mode == COV_MODE_BIDIRECTIONAL:
        return qcov >= cov_thr and tcov >= cov_thr
    if cov_mode == COV_MODE_TARGET:
        return tcov >= cov_thr
    if cov_mode == COV_MODE_QUERY:
        return qcov >= cov_thr
    return True


def _can_be_covered(cov_thr, cov_mode, qlen, tlen):
    """Util::canBeCovered (Util.cpp:533-550), float32 ratio compares."""
    q, t = np.float32(qlen), np.float32(tlen)
    thr = np.float32(cov_thr)
    if cov_mode == COV_MODE_BIDIRECTIONAL:
        return bool((q / t >= thr) and (t / q >= thr))
    if cov_mode == COV_MODE_QUERY:
        return bool(t / q >= thr)
    if cov_mode == COV_MODE_TARGET:
        return bool(q / t >= thr)
    return True


def rescore_diagonal(db, hits, params=None, evaluer=None, tdb=None):
    """rescorediagonal over an in-memory hits dict.

    hits: {query_key: [(target_key, pref_score, diagonal), ...]} — signed
    pref_score < 0 marks reverse-strand hits (nucleotide only).
    tdb: target DB when different from the query DB (identity hits are
    then never taken, sameQTDB=false). Returns
    {query_key: np.ndarray[RESULT_DTYPE]} alignment records.
    """
    params = params or RescoreParams()
    same_db = tdb is None
    if tdb is None:
        tdb = db
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES
    mat = constants.nucleotide() if is_nucl else constants.blosum62()
    if evaluer is None:
        evaluer = EvalueComputer.for_matrix(
            "nucleotide_ungapped" if is_nucl else "blosum62_ungapped",
            tdb.total_residues())
    ascii_mat = mat.ascii_mat
    lut = db.id_lookup_array()
    tlut = tdb.id_lookup_array()

    # nucleotide reverse-complement of raw chars (rescorediagonal.cpp:173-179):
    # revcomp through the numeric alphabet, X -> 'X' char
    def revcomp_chars(arr):
        num = mat.aa2num[arr]
        rev = mat.reverse[num]
        return mat.num2aa[rev][::-1]

    out = {}
    for qkey, hlist in hits.items():
        qid = lut[qkey]
        orig_qlen = db.seq_len(qid)
        qseq = np.asarray(db.get_seq(qid))
        if params.wrapped_scoring:
            qseq = np.concatenate([qseq, qseq])
        qlen = len(qseq)
        qrev = revcomp_chars(qseq) if is_nucl else None
        results = []
        for (tkey, pref_score, diagonal) in hlist:
            tid = int(tlut[tkey])
            is_reverse = is_nucl and pref_score < 0
            qseq_use = qrev if is_reverse else qseq
            tseq = np.asarray(tdb.get_seq(tid))
            tlen = len(tseq)
            is_identity = same_db and (qid == tid)
            if not _can_be_covered(params.cov_thr, params.cov_mode,
                                   orig_qlen, tlen):
                continue
            if params.wrapped_scoring:
                if tlen > orig_qlen:
                    continue  # rescorediagonal.cpp:215-219
                score, start, end, diag_len, dist, diag = ungapped_best_wrapped(
                    qseq_use, tseq, diagonal, ascii_mat, params.rescore_mode)
            else:
                score, start, end, diag_len, dist, diag = ungapped_best(
                    qseq_use, tseq, diagonal, ascii_mat, params.rescore_mode)
            tcov = diag_len / float(tlen)
            qcov = diag_len / float(orig_qlen)
            if params.rescore_mode == RESCORE_HAMMING:
                seq_id = _compute_seq_id(params.seq_id_mode, score, orig_qlen,
                                         tlen, diag_len)
                aln_len = diag_len
                has_cov = _has_cov(params.cov_thr, params.cov_mode,
                                   np.float32(qcov), np.float32(tcov))
                has_seq_id = seq_id >= (params.seq_id_thr
                                        - np.finfo(np.float32).eps)
                if is_identity or (aln_len >= params.aln_len_thr and has_cov
                                   and has_seq_id):
                    pscore = int(100 * seq_id)
                    results.append((tkey, -pscore if is_reverse else pscore,
                                    diag))
                continue
            if params.rescore_mode == RESCORE_SUBSTITUTION:
                # short prefilter output with bit score; survives via the
                # precision-lib score-per-column filter (rescorediagonal.cpp
                # :243-332: seqId stays 0 and alnLen 0 in this mode)
                evalue = float(evaluer.evalue(score, orig_qlen))
                bit_score = int(evaluer.bit_score(score) + 0.5)
                spc = float(np.float32(score) / np.float32(diag_len)) \
                    if diag_len else float("nan")
                has_to_filter = (params.filter_hits
                                 and spc >= params.score_per_col_thr)
                has_cov = _has_cov(params.cov_thr, params.cov_mode,
                                   np.float32(qcov), np.float32(tcov))
                has_seq_id = 0.0 >= (params.seq_id_thr
                                     - np.finfo(np.float32).eps)
                has_eval = evalue <= params.eval_thr
                if is_identity or has_to_filter or (
                        0 >= params.aln_len_thr and has_cov and has_seq_id
                        and has_eval):
                    results.append((tkey, -bit_score if is_reverse
                                    else bit_score, diag))
                continue
            if diag_len == 0:
                continue
            evalue = float(evaluer.evalue(score, orig_qlen))
            bit_score = int(evaluer.bit_score(score) + 0.5)
            aln_len = end - start + 1
            if diag >= 0:
                qs, qe = start + dist, end + dist
                ts, te = start, end
            else:
                qs, qe = start, end
                ts, te = start + dist, end + dist
            seq_id = 0.0
            if evalue <= params.eval_thr or is_identity:
                qwin = qseq_use[qs: qe + 1] & np.uint8(~0x20 & 0xFF)
                twin = tseq[ts: te + 1] & np.uint8(~0x20 & 0xFF)
                ids = int((qwin == twin).sum())
                seq_id = _compute_seq_id(params.seq_id_mode, ids, orig_qlen,
                                         tlen, aln_len)
            qcov = _cov(qs, qe, orig_qlen)
            tcov = _cov(ts, te, tlen)
            if is_reverse:
                qs = qlen - qs - 1
                qe = qlen - qe - 1
            has_cov = _has_cov(params.cov_thr, params.cov_mode, qcov, tcov)
            has_seq_id = seq_id >= (params.seq_id_thr - np.finfo(np.float32).eps)
            has_eval = evalue <= params.eval_thr
            has_aln_len = aln_len >= params.aln_len_thr
            if is_identity or (has_aln_len and has_cov and has_seq_id and has_eval):
                results.append((tkey, bit_score, qcov, tcov, seq_id, evalue,
                                aln_len, qs, qe, orig_qlen, ts, te, tlen))
        if params.rescore_mode in (RESCORE_HAMMING, RESCORE_SUBSTITUTION):
            out[qkey] = results
        else:
            out[qkey] = np.array(results, dtype=RESULT_DTYPE)
    return out


def format_seq_id(seq_id):
    """Util::fastSeqIdToBuffer (Util.cpp:278-307): '1.00' for identity (the
    last char is overwritten by the field separator), otherwise truncated
    (not rounded) milli-units with zero padding."""
    s = float(np.float32(seq_id))
    if s == 1.0:
        return "1.00"
    v = int(np.float32(seq_id) * np.float32(1000.0))  # float32 multiply, then truncate
    if s < 0.01:
        return f"0.00{v}"
    if s < 0.10:
        return f"0.0{v}"
    return f"0.{v}"


def format_result_line(r, backtrace=None):
    bt = f"\t{backtrace}" if backtrace is not None else ""
    return (f"{r['dbKey']}\t{r['score']}\t{format_seq_id(r['seqId'])}\t"
            f"{r['eval']:.3E}\t{r['qStartPos']}\t{r['qEndPos']}\t{r['qLen']}\t"
            f"{r['dbStartPos']}\t{r['dbEndPos']}\t{r['dbLen']}{bt}\n")


def results_to_db(results, add_backtrace=False):
    """Serialize alignment results to an MMseqs alignment DB
    (Matcher::resultToBuffer format, Matcher.cpp). With add_backtrace, the
    rescorediagonal backtrace is the literal "<alnLen>M" string
    (rescorediagonal.cpp:287-291)."""
    writer = seqdb.DBWriter(seqdb.ALIGNMENT_RES)
    for key in sorted(results):
        lines = [format_result_line(
            r, f"{r['alnLength']}M" if add_backtrace else None)
            for r in results[key]]
        writer.write(key, "".join(lines).encode(), add_newline=False)
    return writer.finish()
