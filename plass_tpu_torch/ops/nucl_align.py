"""Gapped nucleotide alignment module (`align` for nucleotide DBs).

Reference: lib/mmseqs/src/alignment/BandedNucleotideAligner.cpp (ksw2
two-pass extension around the best ungapped diagonal stretch),
Matcher.cpp getSWResult (nucl branch: alignmentMode forced to
SCORE_COV_SEQID, alnLength = backtrace size, reverse swaps target coords),
Alignment.cpp:330-415 (accept/reject orchestration: canBeCovered
pre-filter, rejected counter resets on accept, identity coverage/seqId
overrides, Matcher::compareHits output sort) and checkCriteria:555-575.
"""
import numpy as np

from .. import constants
from ..data import seqdb
from .evalue import EvalueComputer
from .ksw2 import ksw_extz, M_OP, I_OP, D_OP
from .rescore import (RESCORE_ALIGNMENT, format_seq_id, ungapped_best,
                      ungapped_best_wrapped)


class BandedNuclAligner:
    """Per-query banded aligner (BandedNucleotideAligner semantics).

    The reference's SmithWaterman::seq_reverse(rev, seq, L) reverses L+1
    elements — it includes numSequence[L], one past the mapped sequence,
    which holds whatever a previous longer mapping left in the reused
    buffer (zero / 'A' initially). That stale byte becomes element 0 of
    every reversed array and participates in the reverse ksw2 pass whenever
    the ungapped anchor reaches a sequence end, shifting the reported
    extension coordinates by one. The persistent _qbuf/_rcbuf/_tbuf arrays
    emulate those reused buffers exactly."""

    def __init__(self, gapo=5, gape=2, zdrop=200, max_seq_len=200000):
        mat = constants.nucleotide()
        self.mat = mat
        self.ascii_mat = mat.ascii_mat
        self.m = mat.alphabet_size
        self.flat = mat.sub.astype(np.int32).reshape(-1)
        self.gapo = gapo
        self.gape = gape
        self.zdrop = zdrop
        cap = 2 * max_seq_len + 2
        self._qbuf = np.zeros(cap, dtype=np.int64)   # qSeq.numSequence
        self._rcbuf = np.zeros(cap, dtype=np.int64)  # queryRevCompSeq
        self._tbuf = np.zeros(cap, dtype=np.int64)   # dbSeq.numSequence

    def init_query(self, qchars):
        self.qchars = np.asarray(qchars)
        qnum = self.mat.aa2num[self.qchars].astype(np.int64)
        self.qnum = qnum
        L = len(qnum)
        comp = self.mat.reverse[qnum].astype(np.int64)
        rc = comp[::-1]  # reverse complement, original orientation reversed
        self.qrevcomp_num = rc
        self.qrevcomp_chars = self.mat.num2aa[rc]
        # seq_reverse(querySeqRev, numSequence, L) includes numSequence[L]
        q_junk = int(self._qbuf[L]) if L < len(self._qbuf) else 0
        self._qbuf[:L] = qnum
        self.qrev = np.concatenate([[q_junk], qnum[::-1]])
        rc_junk = int(self._rcbuf[L]) if L < len(self._rcbuf) else 0
        self._rcbuf[:L] = rc
        self.qrevcomp_rev = np.concatenate([[rc_junk], rc[::-1]])

    def map_target(self, tchars):
        """dbSeq.mapSequence + seq_reverse: returns (tnum, trev_with_junk)."""
        tnum = self.mat.aa2num[np.asarray(tchars)].astype(np.int64)
        L = len(tnum)
        t_junk = int(self._tbuf[L]) if L < len(self._tbuf) else 0
        self._tbuf[:L] = tnum
        return tnum, np.concatenate([[t_junk], tnum[::-1]])

    def align(self, tchars, diagonal, reverse, evaluer, wrapped=False,
              mapped=None):
        """Returns dict with score, coords, covs, evalue, aa_ids, backtrace."""
        qchars = self.qrevcomp_chars if reverse else self.qchars
        qnum = self.qrevcomp_num if reverse else self.qnum
        qrev = self.qrevcomp_rev if reverse else self.qrev
        tchars = np.asarray(tchars)
        tnum, trev = mapped if mapped is not None else self.map_target(tchars)
        qlen = len(qchars)
        tlen = len(tnum)
        orig_qlen = qlen // 2 if wrapped else qlen

        if wrapped:
            score, start, end, _, dist, diag = ungapped_best_wrapped(
                qchars, tchars, diagonal, self.ascii_mat, RESCORE_ALIGNMENT)
        else:
            score, start, end, _, dist, diag = ungapped_best(
                qchars, tchars, diagonal, self.ascii_mat, RESCORE_ALIGNMENT)
        if diag >= 0:
            q_s, q_e = start + dist, end + dist
            t_s, t_e = start, end
        else:
            q_s, q_e = start, end
            t_s, t_e = start + dist, end + dist

        if q_e - q_s == orig_qlen - 1 and t_s == 0 and t_e == tlen - 1:
            # full-coverage ungapped shortcut (BandedNucleotideAligner.cpp:129)
            aa_ids = int((qnum[q_s: q_e + 1]
                          == tnum[t_s: t_s + (q_e - q_s) + 1]).sum())
            qcov = _cov(q_s, q_e, qlen)
            if wrapped:
                qcov = min(1.0, qcov * 2)
            return {
                "score": int(score), "qstart": q_s, "qend": q_e,
                "tstart": t_s, "tend": t_e,
                "qcov": qcov, "tcov": _cov(t_s, t_e, tlen),
                "evalue": float(evaluer.evalue(score, orig_qlen)),
                "aa_ids": aa_ids, "backtrace": "M" * orig_qlen,
            }

        # two-pass ksw2 extension from the ungapped end; qrev/trev carry the
        # reference's one-past-the-end stale element at index 0, so these
        # indices address the L+1-element reversed arrays exactly as the C++
        q_start_rev = (qlen - q_e) - 1
        t_start_rev = (tlen - t_e) - 1
        qrev_len = qlen - q_start_rev
        if wrapped and qrev_len > orig_qlen:
            qrev_len = orig_qlen
        ez = ksw_extz(qrev[q_start_rev: q_start_rev + qrev_len],
                      trev[t_start_rev: tlen], self.flat, self.m, self.gapo,
                      self.gape, 64, self.zdrop, score_only=True)
        q_start = qlen - (q_start_rev + ez.max_q) - 1
        t_start = tlen - (t_start_rev + ez.max_t) - 1
        qfwd_len = qlen - q_start
        if wrapped and qfwd_len > orig_qlen:
            qfwd_len = orig_qlen
        ez2 = ksw_extz(qnum[q_start: q_start + qfwd_len], tnum[t_start:],
                       self.flat, self.m, self.gapo, self.gape, 64,
                       self.zdrop, score_only=False)
        if ez.max_q > ez2.max_q and ez.max_t > ez2.max_t:
            # redo on the reversed sequences; the redo's max coords are used
            # verbatim (BandedNucleotideAligner.cpp:192-215)
            ez2 = ksw_extz(qrev[q_start_rev: q_start_rev + qrev_len],
                           trev[t_start_rev: tlen], self.flat, self.m,
                           self.gapo, self.gape, 64, self.zdrop,
                           score_only=False)
            cigar = list(reversed(ez2.cigar))
        else:
            cigar = ez2.cigar
        result_q_s = q_start
        result_q_e = q_start + ez2.max_q
        result_t_s = t_start
        result_t_e = t_start + ez2.max_t
        qcov = _cov(result_q_s, result_q_e, qlen)
        if wrapped:
            qcov = min(1.0, qcov * 2)
        # walk cigar for identities + backtrace (numeric codes: X == X counts)
        aa_ids = 0
        bt = []
        qpos, tpos = result_q_s, result_t_s
        for op, length in cigar:
            if op == M_OP:
                aa_ids += int((tnum[tpos: tpos + length]
                               == qnum[qpos: qpos + length]).sum())
                bt.append("M" * length)
                qpos += length
                tpos += length
            elif op == I_OP:
                bt.append("I" * length)
                qpos += length
            else:
                bt.append("D" * length)
                tpos += length
        return {
            "score": int(ez2.max), "qstart": result_q_s, "qend": result_q_e,
            "tstart": result_t_s, "tend": result_t_e,
            "qcov": qcov, "tcov": _cov(result_t_s, result_t_e, tlen),
            "evalue": float(evaluer.evalue(ez2.max, orig_qlen)),
            "aa_ids": aa_ids, "backtrace": "".join(bt),
        }


def _cov(start, end, length):
    """SmithWaterman::computeCov."""
    return float(np.float32(
        (min(length, max(start, end)) - min(start, end) + 1)) / np.float32(length))


def align_nucl(db, hits, seq_id_thr=0.0, cov_thr=0.0, cov_mode=0,
               eval_thr=1e-3, aln_len_thr=0, seq_id_mode=0, gapo=5, gape=2,
               zdrop=200, wrapped_scoring=False, max_accept=2**31 - 1,
               max_reject=2**31 - 1, evaluer=None):
    """`align` command for a nucleotide DB against itself (sameQTDB).

    hits: {query_key: [(target, pref_score, diag), ...]}. Returns
    {query_key: [result dict]} sorted by Matcher::compareHits.
    """
    if evaluer is None:
        evaluer = EvalueComputer.for_matrix("nucleotide_gapped_5_2",
                                            db.total_residues())
    aligner = BandedNuclAligner(gapo, gape, zdrop)
    out = {}
    for qkey in sorted(hits):
        hlist = hits[qkey]
        if not hlist:
            out[qkey] = []
            continue
        qid = db.key_to_id(qkey)
        qchars = np.asarray(db.get_seq(qid))
        orig_qlen = len(qchars)
        if wrapped_scoring:
            qchars = np.concatenate([qchars, qchars])
        aligner.init_query(qchars)
        results = []
        passed = rejected = 0
        for (tkey, pref, diag) in hlist:
            if passed >= max_accept or rejected >= max_reject:
                break
            tid = db.key_to_id(tkey)
            tchars = np.asarray(db.get_seq(tid))
            tlen = len(tchars)
            # dbSeq.mapSequence happens before the coverage check
            # (Alignment.cpp:369-381) — the reused-buffer byte must advance
            mapped = aligner.map_target(tchars)
            if not _can_be_covered(cov_thr, cov_mode, orig_qlen, tlen):
                rejected += 1
                continue
            is_identity = tid == qid
            reverse = pref < 0
            a = aligner.align(tchars, int(diag) & 0xFFFF, reverse, evaluer,
                              wrapped_scoring, mapped=mapped)
            aln_len = len(a["backtrace"])
            seq_id = _seq_id(seq_id_mode, a["aa_ids"], orig_qlen, tlen, aln_len)
            qcov, tcov = a["qcov"], a["tcov"]
            if is_identity:
                qcov = tcov = seq_id = 1.0
            bit = int(evaluer.bit_score(a["score"]) + 0.5)
            qs, qe = a["qstart"], a["qend"]
            ts, te = a["tstart"], a["tend"]
            if reverse:
                ts, te = te, ts
            ok = is_identity or (
                (a["evalue"] <= eval_thr) and (seq_id >= seq_id_thr)
                and _has_cov(cov_thr, cov_mode, qcov, tcov)
                and aln_len >= aln_len_thr)
            if ok:
                results.append({
                    "dbKey": int(tkey), "score": bit, "qcov": qcov,
                    "tcov": tcov, "seqId": seq_id, "eval": a["evalue"],
                    "alnLength": aln_len, "qStartPos": qs, "qEndPos": qe,
                    "qLen": orig_qlen, "dbStartPos": ts, "dbEndPos": te,
                    "dbLen": tlen,
                })
                passed += 1
                rejected = 0
            else:
                rejected += 1
        results.sort(key=lambda r: (r["eval"], -r["score"], r["dbLen"],
                                    r["dbKey"]))
        out[qkey] = results
    return out


def _seq_id(mode, ids, qlen, tlen, alnlen):
    if mode == 1:
        return float(np.float32(ids) / np.float32(min(qlen, tlen)))
    if mode == 2:
        return float(np.float32(ids) / np.float32(max(qlen, tlen)))
    return float(np.float32(ids) / np.float32(alnlen)) if alnlen else 0.0


def _has_cov(cov_thr, cov_mode, qcov, tcov):
    if cov_mode == 0:
        return qcov >= cov_thr and tcov >= cov_thr
    if cov_mode == 1:
        return tcov >= cov_thr
    if cov_mode == 2:
        return qcov >= cov_thr
    return True


def _can_be_covered(cov_thr, cov_mode, qlen, tlen):
    q, t = np.float32(qlen), np.float32(tlen)
    thr = np.float32(cov_thr)
    if cov_mode == 0:
        return bool((q / t >= thr) and (t / q >= thr))
    if cov_mode == 2:
        return bool(t / q >= thr)
    if cov_mode == 1:
        return bool(q / t >= thr)
    return True


def align_results_to_db(results):
    """Serialize `align` output (Matcher::resultToBuffer, no backtrace)."""
    w = seqdb.DBWriter(seqdb.ALIGNMENT_RES)
    for key in sorted(results):
        lines = []
        for r in results[key]:
            lines.append(
                f"{r['dbKey']}\t{r['score']}\t{format_seq_id(r['seqId'])}\t"
                f"{r['eval']:.3E}\t{r['qStartPos']}\t{r['qEndPos']}\t"
                f"{r['qLen']}\t{r['dbStartPos']}\t{r['dbEndPos']}\t"
                f"{r['dbLen']}\n")
        w.write(key, "".join(lines).encode(), add_newline=False)
    return w.finish()
