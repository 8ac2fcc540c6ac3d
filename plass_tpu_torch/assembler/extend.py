"""Greedy contig extension (reference: src/assembler/assembleresult.cpp).

Per query: candidates are rescored to integer score-per-column, ordered in a
priority queue by (score, alnLength, smaller dbKey), and popped while they
touch an end of the query without being fully contained
(selectFragmentToExtend, assembleresult.cpp:40-57). The first eligible
right / left extension per round is applied by appending the unaligned
target tail / head; remaining candidates are re-scored against the grown
query via an ungapped diagonal alignment and re-queued if they still pass
the sequence-identity threshold (assembleresult.cpp:193-313).

Status bitmask per sequence (assembleresult.cpp:187-341):
 0x40 appeared in some alignment list, 0x10 was popped as a candidate,
 0x80 was consumed into a contig, 0x20 became a contig.
Sequences that did not become contigs are passed through unchanged when
keep_target (default) or never consumed.

Queries are independent -> the pass is batch-parallel; this host version is
the reference oracle for the batched device path.
"""
import heapq

import numpy as np

from .. import constants
from ..data import seqdb
from ..ops.evalue import EvalueComputer
from ..ops.rescore import RESCORE_END_TO_END, ungapped_by_diagonal

WAS_IN_ALIGNMENT = 0x40
WAS_CANDIDATE = 0x10
WAS_CONSUMED = 0x80
IS_CONTIG = 0x20


class _Cand:
    __slots__ = ("score", "aln_len", "db_key", "seq_id", "qlen", "dblen",
                 "qstart", "qend", "dbstart", "dbend")

    def __init__(self, db_key, score, seq_id, aln_len, qstart, qend, qlen,
                 dbstart, dbend, dblen):
        self.db_key = db_key
        self.score = score
        self.seq_id = seq_id
        self.aln_len = aln_len
        self.qstart = qstart
        self.qend = qend
        self.qlen = qlen
        self.dbstart = dbstart
        self.dbend = dbend
        self.dblen = dblen

    def sort_key(self):
        # max-heap on (score, alnLength, smaller dbKey wins ties)
        return (-self.score, -self.aln_len, self.db_key)


def _select_fragment(heap, query_key):
    """selectFragmentToExtend: pop until a candidate touches an end of the
    query or target without being a full containment or the identity."""
    while heap:
        _, _, res = heapq.heappop(heap)
        not_both_start = not (res.dbstart == 0 and res.qstart == 0)
        right_start = res.dbstart == 0 and (res.dbend != res.dblen - 1)
        left_start = res.qstart == 0 and (res.qend != res.qlen - 1)
        is_not_identity = res.db_key != query_key
        if (right_start or left_start) and not_both_start and is_not_identity:
            return res
    return None


def _rev_fragment(frag, nucl_mat):
    """getRevFragment (assembleresult.cpp:59-68): numeric revcomp, X -> 'N'."""
    num = nucl_mat.aa2num[frag]
    rev = nucl_mat.reverse[num][::-1]
    chars = nucl_mat.num2aa[rev]
    chars = np.where(chars == ord("X"), np.uint8(ord("N")), chars)
    return chars.astype(np.uint8)


def assemble(db, alignments, seq_id_thr=0.9, max_seq_len=65535,
             keep_target=True, rescore_mode=RESCORE_END_TO_END,
             evaluer=None, use_native=True):
    """assembleresults: db + per-query alignment records -> extended DB.

    alignments: {query_key: np.ndarray[RESULT_DTYPE]} from ops.rescore.
    Returns a SeqDB with contigs (extended queries) and pass-through
    sequences. After the END_TO_END rescore the protein path runs in the
    native kernel (native/extend.cpp, same semantics; a failure of it
    raises) unless use_native=False; every other case runs the Python
    pass.
    """
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES
    is_flat = isinstance(alignments, dict) and "qk" in alignments \
        and "rec" in alignments
    if use_native and not is_nucl and rescore_mode == RESCORE_END_TO_END:
        return _assemble_native(db, alignments, seq_id_thr, max_seq_len,
                                keep_target, evaluer)
    if is_flat:
        # expand the flat format for the python paths
        alignments = _flat_to_dict(db, alignments)
    mat = constants.nucleotide() if is_nucl else constants.blosum62()
    ascii_mat = mat.ascii_mat
    if evaluer is None:
        evaluer = EvalueComputer.for_matrix(
            "nucleotide_ungapped" if is_nucl else "blosum62_ungapped",
            db.total_residues())

    lut = db.id_lookup_array()
    was_extended = np.zeros(db.size, dtype=np.uint8)
    writer = seqdb.DBWriter(db.dbtype)

    ln2 = np.log(2.0)

    for qpos in range(db.size):
        qkey = int(db.keys[qpos])
        query = bytearray(db.get_seq_bytes(qpos))
        orig_qlen = len(query)
        recs = alignments.get(qkey)
        if recs is None or len(recs) == 0:
            continue

        use_reverse = {}
        heap = []
        seq = 0
        n_aln = len(recs)
        for r in recs:
            # initial rescore: bit score -> raw -> score-per-column x100
            raw = int(evaluer.raw_score_from_bit(float(r["score"])) + 0.5)
            aln_len = int(r["alnLength"])
            spc = raw / (aln_len + 0.5)
            score = int(spc * 100)
            ids = float(r["seqId"]) * aln_len
            seq_id = ids / (aln_len + 0.5)
            qs, qe = int(r["qStartPos"]), int(r["qEndPos"])
            ts, te = int(r["dbStartPos"]), int(r["dbEndPos"])
            tlen = int(r["dbLen"])
            tid = int(lut[int(r["dbKey"])])
            if is_nucl:
                if qs > qe:
                    use_reverse[tid] = True
                    qs, qe = qe, qs
                    ts, te = tlen - te - 1, tlen - ts - 1
                else:
                    use_reverse[tid] = False
            cand = _Cand(int(r["dbKey"]), score, seq_id, aln_len, qs, qe,
                         int(r["qLen"]), ts, te, tlen)
            heapq.heappush(heap, (cand.sort_key(), seq, cand))
            seq += 1
            if n_aln > 1:
                was_extended[tid] |= WAS_IN_ALIGNMENT

        query_could_be_extended = False
        while heap:
            left_off = 0
            right_off = 0
            deferred = []
            while True:
                best = _select_fragment(heap, qkey)
                if best is None:
                    break
                tid = int(lut[best.db_key])
                tseq = np.asarray(db.get_seq(tid))
                tlen = len(tseq)
                # does the alignment still extend the (possibly grown) query?
                if best.dbstart == 0:
                    if (tlen - (best.dbend + 1)) <= right_off:
                        continue
                elif best.qstart == 0:
                    if best.dbstart <= left_off:
                        continue
                was_extended[tid] |= WAS_CANDIDATE

                if best.dbstart == 0 and best.qend == orig_qlen - 1:
                    # right extension
                    if right_off > 0:
                        deferred.append(best)
                        continue
                    frag_len = tlen - (best.dbend + 1)
                    if use_reverse.get(tid, False):
                        # coords are in the revcomp frame: the tail there is the
                        # revcomp of the first fragLen original chars
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
            if heap:
                # only possible after a max-seq-len break
                break
            orig_qlen = len(query)  # querySeqLen updated after the round
            qarr = np.frombuffer(bytes(query), dtype=np.uint8)
            for cand in deferred:
                tid = int(lut[cand.db_key])
                tseq = np.asarray(db.get_seq(tid))
                if use_reverse.get(tid, False):
                    tseq = _rev_fragment(tseq, mat)
                diag = (cand.qstart + left_off) - cand.dbstart
                score, start, end, diag_len, dist = ungapped_by_diagonal(
                    qarr, tseq, diag, ascii_mat, rescore_mode)
                # updateAlignment (assembleresult.cpp:70-108)
                if diag >= 0:
                    qs, qe = start + dist, end + dist
                    ts, te = start, end
                else:
                    qs, qe = start, end
                    ts, te = start + dist, end + dist
                idcnt = int((qarr[qs:qe] == tseq[ts:ts + (qe - qs)]).sum()) if qe > qs else 0
                seq_id = idcnt / float(qe - qs) if qe != qs else 0.0
                cand.seq_id = seq_id
                cand.qlen = len(query)
                cand.dblen = len(tseq)
                cand.aln_len = diag_len
                spc = score / (diag_len + 0.5)
                cand.score = int(spc * 100)
                cand.qstart, cand.qend = qs, qe
                cand.dbstart, cand.dbend = ts, te
                if cand.seq_id >= seq_id_thr:
                    heapq.heappush(heap, (cand.sort_key(), seq, cand))
                    seq += 1

        if query_could_be_extended:
            was_extended[qpos] |= IS_CONTIG
            writer.write(qkey, bytes(query))

    # pass through sequences that did not become contigs
    for i in range(db.size):
        is_not_contig = not (was_extended[i] & IS_CONTIG)
        was_not_consumed = not (was_extended[i] & WAS_CONSUMED)
        if is_not_contig and (keep_target or was_not_consumed):
            writer.write(int(db.keys[i]), db.get_seq_bytes(i))

    return writer.finish(sort_by_key=True), was_extended


def _flat_to_dict(db, flat):
    """Expand the {'qk', 'rec'} flat format to the per-key dict format."""
    from ..ops.rescore import RESULT_DTYPE
    qk = np.asarray(flat["qk"])
    rec = flat["rec"]
    out = {}
    boundaries = np.nonzero(np.diff(qk))[0] + 1
    starts = np.concatenate([[0], boundaries]) if len(qk) else []
    ends = np.concatenate([boundaries, [len(qk)]]) if len(qk) else []
    for s0, e0 in zip(starts, ends):
        out[int(qk[s0])] = rec[s0:e0]
    for k in db.keys:
        out.setdefault(int(k), np.zeros(0, dtype=RESULT_DTYPE))
    return out


def _flatten_records(db, alignments, evaluer, lut, scale_seq_id):
    """Flatten per-query alignment records (dict or return_flat format) into
    id-ordered arrays for the native kernels, applying the initial rescale:
    bit -> raw -> score-per-column x100; seqId is additionally scaled by
    aln/(aln+0.5) on the protein path (assembleresult.cpp:161-169) but kept
    raw on the nucleotide one (nuclassembleresult.cpp:176-184)."""
    n = db.size
    keys = db.keys.astype(np.uint32)
    if isinstance(alignments, dict) and "qk" in alignments \
            and "rec" in alignments:
        # flat format from rescore_diagonal_jax(return_flat=True):
        # records grouped by ascending query key
        qk_flat = np.asarray(alignments["qk"], dtype=np.int64)
        recs = alignments["rec"]
        m = len(qk_flat)
        counts = np.zeros(n, dtype=np.int64)
        np.add.at(counts, np.searchsorted(keys.astype(np.int64), qk_flat), 1)
        aln_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=aln_off[1:])
    else:
        groups = [alignments.get(int(k)) for k in keys]
        counts = np.array([0 if g is None else len(g) for g in groups],
                          dtype=np.int64)
        aln_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=aln_off[1:])
        m = int(aln_off[-1])
        recs = (np.concatenate([g for g in groups if g is not None and len(g)])
                if m else np.zeros(0, dtype=None))
    if m:
        raw = np.floor(evaluer.raw_score_from_bit(
            recs["score"].astype(np.float64)) + 0.5)
        aln_len = recs["alnLength"].astype(np.int64)
        score = ((raw / (aln_len + 0.5)) * 100).astype(np.int32)
        if scale_seq_id:
            seq_id = (recs["seqId"].astype(np.float64) * aln_len) \
                / (aln_len + 0.5)
        else:
            seq_id = recs["seqId"].astype(np.float64)
        dbid = lut[recs["dbKey"].astype(np.int64)].astype(np.int32)
        a = dict(
            dbkey=np.ascontiguousarray(recs["dbKey"].astype(np.uint32)),
            dbid=np.ascontiguousarray(dbid),
            score=np.ascontiguousarray(score),
            seqid=np.ascontiguousarray(seq_id),
            alnlen=np.ascontiguousarray(recs["alnLength"].astype(np.int32)),
            qs=np.ascontiguousarray(recs["qStartPos"].astype(np.int32)),
            qe=np.ascontiguousarray(recs["qEndPos"].astype(np.int32)),
            qlen=np.ascontiguousarray(recs["qLen"].astype(np.int32)),
            ts=np.ascontiguousarray(recs["dbStartPos"].astype(np.int32)),
            te=np.ascontiguousarray(recs["dbEndPos"].astype(np.int32)),
            tlen=np.ascontiguousarray(recs["dbLen"].astype(np.int32)))
    else:
        z32 = np.zeros(0, dtype=np.int32)
        a = dict(dbkey=np.zeros(0, dtype=np.uint32), dbid=z32, score=z32,
                 seqid=np.zeros(0, dtype=np.float64), alnlen=z32, qs=z32,
                 qe=z32, qlen=z32, ts=z32, te=z32, tlen=z32)
    return aln_off, a


def _native_ptr(arr, ct):
    import ctypes
    return arr.ctypes.data_as(ctypes.POINTER(ct))


def _native_output_db(db, keys, seq_data, seq_off, seq_lens, flags, out_buf,
                      out_off, out_len, out_is_contig, keep_target):
    """Build the output SeqDB directly with vectorized record placement —
    same bytes as DBWriter (payload + "\\n\\x00", write order = contigs in
    id order then pass-through, index key-sorted) without ~N Python round
    trips through per-record write() calls."""
    from ..data import seqdb as seqdb_mod

    import ctypes
    from .. import native

    contig_rows = np.nonzero(out_is_contig)[0]
    not_contig = (flags & IS_CONTIG) == 0
    not_consumed = (flags & WAS_CONSUMED) == 0
    keep = not_contig & (not_consumed | keep_target)
    keep_rows = np.nonzero(keep)[0]

    c_len = out_len[contig_rows].astype(np.int64)
    k_len = seq_lens[keep_rows].astype(np.int64)
    rec_lens = np.concatenate([c_len, k_len]) + 2
    dst_off = np.zeros(len(rec_lens), dtype=np.int64)
    if len(rec_lens) > 1:
        np.cumsum(rec_lens[:-1], out=dst_off[1:])
    data = np.empty(int(rec_lens.sum()), dtype=np.uint8)
    nc = len(contig_rows)
    lib = native.lib()

    def _gather(src, src_off, lens, dst_offs):
        lib.gather_records(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _native_ptr(np.ascontiguousarray(src_off, dtype=np.int64),
                        ctypes.c_int64),
            _native_ptr(np.ascontiguousarray(lens, dtype=np.int64),
                        ctypes.c_int64),
            _native_ptr(np.ascontiguousarray(dst_offs, dtype=np.int64),
                        ctypes.c_int64),
            np.int64(len(lens)), _native_ptr(data, ctypes.c_uint8))

    if nc:
        _gather(out_buf, out_off[contig_rows], c_len, dst_off[:nc])
    if len(keep_rows):
        _gather(seq_data, seq_off[keep_rows], k_len, dst_off[nc:])
    data[dst_off + rec_lens - 2] = np.uint8(ord("\n"))
    data[dst_off + rec_lens - 1] = 0
    out_keys = np.concatenate([keys[contig_rows], keys[keep_rows]])
    order = np.argsort(out_keys, kind="stable")
    return seqdb_mod.SeqDB(data, out_keys[order], dst_off[order],
                           rec_lens[order], db.dbtype)


def _flat_seqs(db):
    """Flat sequence arrays in id order, cached per SeqDB (rebuilt once per
    DB instead of once per iteration)."""
    cache = getattr(db, "_flat_idorder", None)
    if cache is None:
        import ctypes
        from .. import native

        n = db.size
        seq_lens = db.seq_lens().astype(np.int32)
        seq_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(seq_lens, out=seq_off[1:])
        total = int(seq_off[-1])
        seq_data = np.empty(total, dtype=np.uint8)
        src = np.asarray(db.data)
        native.lib().gather_records(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _native_ptr(np.ascontiguousarray(db.offsets, dtype=np.int64),
                        ctypes.c_int64),
            _native_ptr(seq_lens.astype(np.int64), ctypes.c_int64),
            _native_ptr(seq_off[:-1], ctypes.c_int64),
            np.int64(n), _native_ptr(seq_data, ctypes.c_uint8))
        cache = db._flat_idorder = (seq_data, seq_off, seq_lens)
    return cache


def _assemble_native(db, alignments, seq_id_thr, max_seq_len, keep_target,
                     evaluer):
    """Flatten inputs, run native/extend.cpp, rebuild the writer output in
    the oracle's exact order (contigs in id order, then pass-through)."""
    import ctypes
    from .. import native

    mat = constants.blosum62()
    if evaluer is None:
        evaluer = EvalueComputer.for_matrix("blosum62_ungapped",
                                            db.total_residues())
    n = db.size
    lut = db.id_lookup_array()
    seq_data, seq_off, seq_lens = _flat_seqs(db)

    # flatten alignment records per query in id order with the initial
    # rescale (bit -> raw -> score-per-column x100; seqId x aln/(aln+.5))
    keys = db.keys.astype(np.uint32)
    aln_off, a = _flatten_records(db, alignments, evaluer, lut,
                                  scale_seq_id=True)

    ascii_mat = np.ascontiguousarray(mat.ascii_mat.astype(np.int16))
    flags = np.zeros(n, dtype=np.uint8)
    out_off = np.zeros(n, dtype=np.int64)
    out_len = np.zeros(n, dtype=np.int64)
    out_is_contig = np.zeros(n, dtype=np.uint8)
    cap = int(seq_off[-1]) + int(a["tlen"].sum()) + 1024
    lib = native.lib()

    def ptr(arr, ct):
        return arr.ctypes.data_as(ctypes.POINTER(ct))

    while True:
        out_buf = np.empty(cap, dtype=np.uint8)
        rc = lib.assemble_greedy(
            ptr(seq_data, ctypes.c_uint8), ptr(seq_off, ctypes.c_int64),
            ptr(seq_lens, ctypes.c_int32), ptr(keys, ctypes.c_uint32),
            np.int32(n), ptr(aln_off, ctypes.c_int64),
            ptr(a["dbkey"], ctypes.c_uint32), ptr(a["dbid"], ctypes.c_int32),
            ptr(a["score"], ctypes.c_int32), ptr(a["seqid"], ctypes.c_double),
            ptr(a["alnlen"], ctypes.c_int32), ptr(a["qs"], ctypes.c_int32),
            ptr(a["qe"], ctypes.c_int32), ptr(a["qlen"], ctypes.c_int32),
            ptr(a["ts"], ctypes.c_int32), ptr(a["te"], ctypes.c_int32),
            ptr(a["tlen"], ctypes.c_int32), ptr(ascii_mat, ctypes.c_int16),
            float(seq_id_thr), int(max_seq_len),
            ptr(flags, ctypes.c_uint8), ptr(out_buf, ctypes.c_uint8),
            np.int64(cap), ptr(out_off, ctypes.c_int64),
            ptr(out_len, ctypes.c_int64), ptr(out_is_contig, ctypes.c_uint8))
        if rc == 0:
            break
        cap *= 2
        flags[:] = 0

    return _native_output_db(db, keys, seq_data, seq_off, seq_lens, flags,
                             out_buf, out_off, out_len, out_is_contig,
                             keep_target), flags
