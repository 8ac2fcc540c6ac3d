"""Nucleotide greedy extension (reference: src/assembler/
nuclassembleresult.cpp), run by the native kernel native/nucl_extend.cpp
after the END_TO_END rescore and by the Python pass here after the HAMMING
rescore (--rescore-mode 0), as in the JAX package.

Same skeleton as the protein pass (assembler/extend.py) with three changes:
 - the candidate queue is ordered by a Bayesian posterior comparison of the
   two overlaps' mismatch rates via Beta(mm+1, aln-mm+1) posteriors,
   evaluated with an exact lgamma series (nuclassembleresult.cpp:36-70);
   ties (0.45 < p < 0.55) prefer the larger unaligned target remainder
 - the initial rescore keeps seqId unscaled (only score-per-column x100)
 - the max-seq-len guard applies to both extension directions

The comparator is not a strict weak ordering (the 0.45/0.55 deadband), so
the pop order depends on the exact heap algorithm; the kernel and
LibstdcxxHeap replicate libstdc++'s std::priority_queue bit for bit.
"""
import math

import numpy as np

from .. import constants
from ..data import seqdb
from ..ops.evalue import EvalueComputer
from ..ops.rescore import (RESCORE_ALIGNMENT, RESCORE_END_TO_END,
                           RESCORE_HAMMING, ungapped_by_diagonal)
from .extend import (_Cand, _rev_fragment, WAS_IN_ALIGNMENT, WAS_CANDIDATE,
                     WAS_CONSUMED, IS_CONTIG)


def _posterior_less(r1, r2):
    """CompareNuclResultByScore::operator() — true if r1 ranks below r2."""
    def mm_count(res):
        # float arithmetic exactly as C++: (1 - seqId[f32]) * alnLen in f32,
        # + 0.5 in f64, truncated to unsigned
        f = np.float32(1.0) - np.float32(res.seq_id)
        f = np.float32(f * np.float32(res.aln_len))
        d = float(f) + 0.5
        if math.isnan(d) or d < 0:
            return 0
        return int(d)

    mm1 = mm_count(r1)
    mm2 = mm_count(r2)
    alpha1 = mm1 + 1
    alpha2 = mm2 + 1
    beta1 = r1.aln_len - mm1 + 1
    beta2 = r2.aln_len - mm2 + 1

    log_c = (math.lgamma(beta1 + beta2) + math.lgamma(alpha1 + beta1)) \
        - (math.lgamma(alpha1 + beta1 + beta2) + math.lgamma(beta1))
    log_r = 0.0
    p = 0.0
    for idx in range(alpha2):
        p += math.exp(log_r + log_c)
        log_r = (math.log(alpha1 + idx) + math.log(beta2 + idx)
                 - (math.log(idx + 1) + math.log(idx + alpha1 + beta1 + beta2))
                 + log_r)
    if p < 0.45:
        return True
    if p > 0.55:
        return False
    if r1.dblen - r1.aln_len < r2.dblen - r2.aln_len:
        return True
    if r1.dblen - r1.aln_len > r2.dblen - r2.aln_len:
        return False
    return True


class LibstdcxxHeap:
    """std::priority_queue with libstdc++'s exact heap algorithms.

    comp(a, b) true means a orders BELOW b (a is 'less'). Required because
    the nucleotide comparator is not a strict weak ordering — pop order is
    defined by the algorithm, not just the ordering.
    """

    def __init__(self, comp):
        self.c = []
        self.comp = comp

    def __len__(self):
        return len(self.c)

    def push(self, value):
        self.c.append(value)
        self._push_heap(len(self.c) - 1, 0, value)

    def top(self):
        return self.c[0]

    def pop(self):
        c = self.c
        last = len(c) - 1
        value = c[last]
        top = c[0]
        c[last] = top
        if last > 0:
            self._adjust_heap(0, last, value)
        c.pop()
        return top

    def _push_heap(self, hole, top, value):
        c = self.c
        while hole > top:
            parent = (hole - 1) // 2
            if self.comp(c[parent], value):
                c[hole] = c[parent]
                hole = parent
            else:
                break
        c[hole] = value

    def _adjust_heap(self, hole, length, value):
        c = self.c
        top = hole
        second = hole
        while second < (length - 1) // 2:
            second = 2 * (second + 1)
            if self.comp(c[second], c[second - 1]):
                second -= 1
            c[hole] = c[second]
            hole = second
        if (length & 1) == 0 and second == (length - 2) // 2:
            second = 2 * (second + 1)
            c[hole] = c[second - 1]
            hole = second - 1
        self._push_heap(hole, top, value)


def _select_nucl_fragment(heap, query_key):
    """selectNuclFragmentToExtend (nuclassembleresult.cpp:74-91)."""
    while len(heap):
        res = heap.pop()
        not_both_start = not (res.dbstart == 0 and res.qstart == 0)
        right_start = res.dbstart == 0 and (res.dbend != res.dblen - 1)
        left_start = res.qstart == 0 and (res.qend != res.qlen - 1)
        is_not_identity = res.db_key != query_key
        if (right_start or left_start) and not_both_start and is_not_identity:
            return res
    return None




def nucl_assemble(db, alignments, seq_id_thr=0.99, max_seq_len=200000,
                  keep_target=True, rescore_mode=RESCORE_END_TO_END,
                  evaluer=None):
    """nuclassembleresults: db + per-query alignments -> (extended DB,
    per-sequence flags). After the END_TO_END rescore the native kernel
    runs the pass (a failure of it raises); after the HAMMING and the
    ALIGNMENT rescores the Python pass does, as in the JAX package; any
    other mode raises."""
    if rescore_mode == RESCORE_END_TO_END:
        return _nucl_assemble_native(db, alignments, seq_id_thr,
                                     max_seq_len, keep_target, evaluer)
    if rescore_mode not in (RESCORE_HAMMING, RESCORE_ALIGNMENT):
        raise NotImplementedError(
            f"nucl_assemble supports the END_TO_END (mode "
            f"{RESCORE_END_TO_END}), ALIGNMENT (mode {RESCORE_ALIGNMENT}) "
            f"and HAMMING (mode {RESCORE_HAMMING}) rescores, not mode "
            f"{rescore_mode}")
    return _nucl_assemble_python(db, alignments, seq_id_thr, max_seq_len,
                                 keep_target, rescore_mode, evaluer)


def _nucl_assemble_python(db, alignments, seq_id_thr, max_seq_len,
                          keep_target, rescore_mode, evaluer):
    """The pass in Python (the JAX package's nucl_assemble without the
    native kernel)."""
    if isinstance(alignments, dict) and "qk" in alignments \
            and "rec" in alignments:
        from .extend import _flat_to_dict
        alignments = _flat_to_dict(db, alignments)
    mat = constants.nucleotide()
    ascii_mat = mat.ascii_mat
    if evaluer is None:
        evaluer = EvalueComputer.for_matrix("nucleotide_ungapped",
                                            db.total_residues())
    lut = db.id_lookup_array()
    was_extended = np.zeros(db.size, dtype=np.uint8)
    writer = seqdb.DBWriter(db.dbtype)

    for qpos in range(db.size):
        qkey = int(db.keys[qpos])
        query = bytearray(db.get_seq_bytes(qpos))
        orig_qlen = len(query)
        recs = alignments.get(qkey)
        if recs is None or len(recs) == 0:
            continue

        use_reverse = {}
        heap = LibstdcxxHeap(_posterior_less)
        n_aln = len(recs)
        for r in recs:
            raw = int(evaluer.raw_score_from_bit(float(r["score"])) + 0.5)
            aln_len = int(r["alnLength"])
            spc = raw / (aln_len + 0.5)
            score = int(spc * 100)
            qs, qe = int(r["qStartPos"]), int(r["qEndPos"])
            ts, te = int(r["dbStartPos"]), int(r["dbEndPos"])
            tlen = int(r["dbLen"])
            tid = int(lut[int(r["dbKey"])])
            if qs > qe:
                use_reverse[tid] = True
                qs, qe = qe, qs
                ts, te = tlen - te - 1, tlen - ts - 1
            else:
                use_reverse[tid] = False
            cand = _Cand(int(r["dbKey"]), score, float(r["seqId"]), aln_len,
                         qs, qe, int(r["qLen"]), ts, te, tlen)
            heap.push(cand)
            if n_aln > 1:
                was_extended[tid] |= WAS_IN_ALIGNMENT

        query_could_be_extended = False
        while len(heap):
            left_off = 0
            right_off = 0
            deferred = []
            while True:
                best = _select_nucl_fragment(heap, qkey)
                if best is None:
                    break
                tid = int(lut[best.db_key])
                tseq = np.asarray(db.get_seq(tid))
                tlen = len(tseq)
                if best.dbstart == 0:
                    if (tlen - (best.dbend + 1)) <= right_off:
                        continue
                elif best.qstart == 0:
                    if best.dbstart <= left_off:
                        continue
                was_extended[tid] |= WAS_CANDIDATE

                if best.dbstart == 0 and best.qend == orig_qlen - 1:
                    # right extension (length-guarded, nuclassembleresult.cpp:271)
                    if right_off > 0:
                        deferred.append(best)
                        continue
                    frag_len = tlen - (best.dbend + 1)
                    if len(query) + frag_len >= max_seq_len:
                        break
                    if use_reverse.get(tid, False):
                        frag = bytes(_rev_fragment(tseq[:frag_len], mat)) if frag_len else b""
                    else:
                        frag = tseq[best.dbend + 1:].tobytes()
                    query.extend(frag)
                    right_off += frag_len
                    was_extended[tid] |= WAS_CONSUMED
                elif best.qstart == 0 and best.dbend == tlen - 1:
                    # left extension
                    if left_off > 0:
                        deferred.append(best)
                        continue
                    frag_len = best.dbstart
                    if len(query) + frag_len >= max_seq_len:
                        break
                    if use_reverse.get(tid, False):
                        frag = bytes(_rev_fragment(tseq[tlen - frag_len:], mat))
                    else:
                        frag = bytes(tseq[:frag_len].tobytes())
                    query[:0] = frag
                    left_off += frag_len
                    was_extended[tid] |= WAS_CONSUMED

            if left_off > 0 or right_off > 0:
                query_could_be_extended = True
            if len(heap):
                break
            orig_qlen = len(query)
            qarr = np.frombuffer(bytes(query), dtype=np.uint8)
            for cand in deferred:
                tid = int(lut[cand.db_key])
                tseq = np.asarray(db.get_seq(tid))
                if use_reverse.get(tid, False):
                    tseq = _rev_fragment(tseq, mat)
                diag = (cand.qstart + left_off) - cand.dbstart
                score, start, end, diag_len, dist = ungapped_by_diagonal(
                    qarr, tseq, diag, ascii_mat, rescore_mode)
                if diag >= 0:
                    qs, qe = start + dist, end + dist
                    ts, te = start, end
                else:
                    qs, qe = start, end
                    ts, te = start + dist, end + dist
                idcnt = int((qarr[qs:qe] == tseq[ts:ts + (qe - qs)]).sum()) if qe > qs else 0
                cand.seq_id = idcnt / float(qe - qs) if qe != qs else float("nan")
                cand.qlen = len(query)
                cand.dblen = len(tseq)
                cand.aln_len = diag_len
                cand.score = int((score / (diag_len + 0.5)) * 100)
                cand.qstart, cand.qend = qs, qe
                cand.dbstart, cand.dbend = ts, te
                if cand.seq_id >= seq_id_thr:
                    heap.push(cand)

        if query_could_be_extended:
            was_extended[qpos] |= IS_CONTIG
            writer.write(qkey, bytes(query))

    for i in range(db.size):
        is_not_contig = not (was_extended[i] & IS_CONTIG)
        was_not_consumed = not (was_extended[i] & WAS_CONSUMED)
        if is_not_contig and (keep_target or was_not_consumed):
            writer.write(int(db.keys[i]), db.get_seq_bytes(i))

    return writer.finish(sort_by_key=True), was_extended


def revcomp_char_lut():
    """256-byte char-level reverse-complement LUT replicating
    getRevFragment's numeric round trip (aa2num -> reverse -> num2aa with
    X -> 'N', assembleresult.cpp:59-68) for every possible byte."""
    mat = constants.nucleotide()
    num = mat.aa2num[np.arange(256, dtype=np.int64)]
    chars = mat.num2aa[mat.reverse[num]]
    return np.ascontiguousarray(
        np.where(chars == ord("X"), np.uint8(ord("N")), chars).astype(np.uint8))


def _nucl_assemble_native(db, alignments, seq_id_thr, max_seq_len,
                          keep_target, evaluer):
    """Flatten inputs, run native/nucl_extend.cpp, rebuild the writer
    output in the oracle's exact order. The coordinate swap for reverse-
    strand hits and the per-query use_reverse map live in the kernel."""
    import ctypes
    from .extend import (_flat_seqs, _flatten_records, _native_output_db,
                         _native_ptr as ptr)
    from .. import native

    mat = constants.nucleotide()
    if evaluer is None:
        evaluer = EvalueComputer.for_matrix("nucleotide_ungapped",
                                            db.total_residues())
    n = db.size
    lut = db.id_lookup_array()
    seq_data, seq_off, seq_lens = _flat_seqs(db)
    keys = db.keys.astype(np.uint32)
    # nucleotide initial rescore keeps seqId unscaled
    # (nuclassembleresult.cpp:176-184)
    aln_off, a = _flatten_records(db, alignments, evaluer, lut,
                                  scale_seq_id=False)

    ascii_mat = np.ascontiguousarray(mat.ascii_mat.astype(np.int16))
    rc_lut = revcomp_char_lut()
    flags = np.zeros(n, dtype=np.uint8)
    out_off = np.zeros(n, dtype=np.int64)
    out_len = np.zeros(n, dtype=np.int64)
    out_is_contig = np.zeros(n, dtype=np.uint8)
    cap = int(seq_off[-1]) + int(a["tlen"].sum()) + 1024
    lib = native.lib()

    while True:
        out_buf = np.empty(cap, dtype=np.uint8)
        rc = lib.nucl_assemble_greedy(
            ptr(seq_data, ctypes.c_uint8), ptr(seq_off, ctypes.c_int64),
            ptr(seq_lens, ctypes.c_int32), ptr(keys, ctypes.c_uint32),
            np.int32(n), ptr(aln_off, ctypes.c_int64),
            ptr(a["dbkey"], ctypes.c_uint32), ptr(a["dbid"], ctypes.c_int32),
            ptr(a["score"], ctypes.c_int32), ptr(a["seqid"], ctypes.c_double),
            ptr(a["alnlen"], ctypes.c_int32), ptr(a["qs"], ctypes.c_int32),
            ptr(a["qe"], ctypes.c_int32), ptr(a["qlen"], ctypes.c_int32),
            ptr(a["ts"], ctypes.c_int32), ptr(a["te"], ctypes.c_int32),
            ptr(a["tlen"], ctypes.c_int32), ptr(ascii_mat, ctypes.c_int16),
            ptr(rc_lut, ctypes.c_uint8), float(seq_id_thr),
            int(max_seq_len), ptr(flags, ctypes.c_uint8),
            ptr(out_buf, ctypes.c_uint8), np.int64(cap),
            ptr(out_off, ctypes.c_int64), ptr(out_len, ctypes.c_int64),
            ptr(out_is_contig, ctypes.c_uint8))
        if rc == 0:
            break
        cap *= 2
        flags[:] = 0

    return _native_output_db(db, keys, seq_data, seq_off, seq_lens, flags,
                             out_buf, out_off, out_len, out_is_contig,
                             keep_target), flags
