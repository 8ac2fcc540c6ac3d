"""Protein-guided nucleotide greedy extension (the `guidedassembleresults`
command): the native kernel native/nucl_extend.cpp
(guided_assemble_greedy) on row-aligned DBs at the END_TO_END rescore,
a Python pass otherwise.

Reference: src/assembler/guidedassembleresult.cpp. The skeleton is the
nucleotide extender (assembler/nucl_extend.py) with the same Bayesian
Beta-posterior candidate queue (CompareResultBySeqId, lines 23-76 — bit-for-
bit the nuclassembleresult comparator, so the libstdc++ heap replica is
reused), plus:
 - candidates enter the queue only if their NUCLEOTIDE seqId (as parsed
   back from the alignment text, 3-digit truncation) passes the threshold
   (line 197-201); alnLength is recomputed as max(span)+1 by the record
   parser (Matcher::parseAlignmentRecord), not taken from proteinaln2nucl
 - stop-codon barriers: no right extension when the query's amino-acid
   sequence ends with '*' or the target's starts with '*'; mirrored for the
   left side (lines 232-243)
 - the amino-acid contig is grown in lockstep with the nucleotide contig
   (right: aa fragment at dbEnd/3+1 of length tLen/3-dbEnd/3-1; left:
   dbStart/3 + hasStart leading residues, lines 266-300)
 - both nucleotide and amino-acid results are written (the aa output feeds
   the next guided iteration's kmermatcher)

A copy of the JAX package's plass_tpu.assembler.guided_extend. The native
kernel needs the two DBs row-aligned and the END_TO_END rescore (the
deferred candidates' re-scoring is that mode's); the Python pass serves the
rest, as in the JAX package. A failure of the native kernel raises.
"""
import ctypes

import numpy as np

from .. import constants, native
from ..data import seqdb
from ..ops.rescore import (RESCORE_END_TO_END, format_seq_id,
                           ungapped_by_diagonal)
from .extend import (IS_CONTIG, WAS_CANDIDATE, WAS_CONSUMED,
                     WAS_IN_ALIGNMENT, _Cand, _flat_seqs, _native_output_db,
                     _native_ptr as ptr)
from .nucl_extend import LibstdcxxHeap, _posterior_less, _select_nucl_fragment


def _parsed_seq_id(seq_id):
    """The reference re-reads seqId from the 3-digit text column
    (Matcher::parseAlignmentRecord via strtod); replicate the round trip."""
    return float(format_seq_id(seq_id))


def _is_flat(alignments):
    return isinstance(alignments, dict) and "qk" in alignments


def guided_assemble(nucl_db, aa_db, alignments, seq_id_thr=0.99,
                    max_seq_len=200000, keep_target=True,
                    rescore_mode=RESCORE_END_TO_END):
    """alignments: protein_aln_to_nucl's flat nucleotide-coordinate records,
    or {query_key: [proteinaln2nucl record dicts]}.

    Returns (nucl_out, aa_out, was_extended); the two output DBs hold the
    same keys in the same order. Row-aligned DBs at the END_TO_END rescore
    run in the native kernel, which takes the flat records only (records
    as dicts there raise TypeError; records_to_flat makes the flat form);
    other DBs and rescore modes take the Python pass."""
    if rescore_mode == RESCORE_END_TO_END \
            and np.array_equal(nucl_db.keys, aa_db.keys):
        if not (_is_flat(alignments) and "n_aln_raw" in alignments):
            raise TypeError("guided_assemble takes the flat records of "
                            "protein_aln_to_nucl")
        return _guided_assemble_native(nucl_db, aa_db, alignments,
                                       seq_id_thr, max_seq_len, keep_target)
    if _is_flat(alignments):
        alignments = _flat_to_dicts(alignments)
    return _guided_assemble_python(nucl_db, aa_db, alignments, seq_id_thr,
                                   max_seq_len, keep_target, rescore_mode)


def _guided_assemble_python(nucl_db, aa_db, alignments, seq_id_thr,
                            max_seq_len, keep_target, rescore_mode):
    """The extension loop of guidedassembleresult.cpp:160-330, one query
    after another, with the amino-acid DB read by key."""
    mat = constants.nucleotide()
    ascii_mat = mat.ascii_mat
    lut = nucl_db.id_lookup_array()
    was_extended = np.zeros(nucl_db.size, dtype=np.uint8)
    nucl_writer = seqdb.DBWriter(nucl_db.dbtype)
    aa_writer = seqdb.DBWriter(aa_db.dbtype)

    for qpos in range(nucl_db.size):
        qkey = int(nucl_db.keys[qpos])
        nucl_query = bytearray(nucl_db.get_seq_bytes(qpos))
        aa_qid = aa_db.key_to_id(qkey)
        aa_query = bytearray(aa_db.get_seq_bytes(aa_qid))
        orig_qlen = len(nucl_query)
        exclude_left = aa_query[:1] == b"*"
        exclude_right = aa_query[-1:] == b"*"

        recs = alignments.get(qkey, [])
        heap = LibstdcxxHeap(_posterior_less)
        n_aln = len(recs)
        for r in recs:
            seq_id = _parsed_seq_id(r["seqId"])
            if seq_id < seq_id_thr:
                continue
            qs, qe = int(r["qStartPos"]), int(r["qEndPos"])
            ts, te = int(r["dbStartPos"]), int(r["dbEndPos"])
            aln_len = max(qe - qs, te - ts) + 1  # Matcher::computeAlnLength
            cand = _Cand(int(r["dbKey"]), int(r["score"]), seq_id, aln_len,
                         qs, qe, int(r["qLen"]), ts, te, int(r["dbLen"]))
            heap.push(cand)
            if n_aln > 1:
                was_extended[int(lut[cand.db_key])] |= WAS_IN_ALIGNMENT

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
                tseq = np.asarray(nucl_db.get_seq(tid))
                tlen = len(tseq)
                aa_t = aa_db.get_seq_bytes(aa_db.key_to_id(best.db_key))
                # stop-codon barriers (guidedassembleresult.cpp:232-243)
                if best.dbstart == 0:
                    if ((tlen - (best.dbend + 1)) <= right_off
                            or exclude_right or aa_t[:1] == b"*"):
                        continue
                elif best.qstart == 0:
                    if (best.dbstart <= left_off or exclude_left
                            or aa_t[-1:] == b"*"):
                        continue
                was_extended[tid] |= WAS_CANDIDATE

                if best.dbstart == 0 and best.qend == orig_qlen - 1:
                    # right extension
                    if right_off > 0:
                        deferred.append(best)
                        continue
                    frag_len = tlen - (best.dbend + 1)
                    if len(nucl_query) + frag_len >= max_seq_len:
                        break
                    aa_frag_len = (tlen // 3 - best.dbend // 3) - 1
                    nucl_query.extend(tseq[best.dbend + 1:].tobytes())
                    start = best.dbend // 3 + 1
                    aa_query.extend(aa_t[start: start + aa_frag_len])
                    right_off += frag_len
                    was_extended[tid] |= WAS_CONSUMED
                elif best.qstart == 0 and best.dbend == tlen - 1:
                    # left extension
                    if left_off > 0:
                        deferred.append(best)
                        continue
                    frag_len = best.dbstart
                    if len(nucl_query) + frag_len >= max_seq_len:
                        break
                    has_start = 1 if aa_t[:1] == b"*" else 0
                    nucl_query[:0] = tseq[:frag_len].tobytes()
                    aa_query[:0] = aa_t[: frag_len // 3 + has_start]
                    left_off += frag_len
                    was_extended[tid] |= WAS_CONSUMED

            if left_off > 0 or right_off > 0:
                query_could_be_extended = True
            if len(heap):
                break
            orig_qlen = len(nucl_query)
            qarr = np.frombuffer(bytes(nucl_query), dtype=np.uint8)
            for cand in deferred:
                tid = int(lut[cand.db_key])
                tseq = np.asarray(nucl_db.get_seq(tid))
                diag = (cand.qstart + left_off) - cand.dbstart
                score, start, end, diag_len, dist = ungapped_by_diagonal(
                    qarr, tseq, diag, ascii_mat, rescore_mode)
                if diag >= 0:
                    qs, qe = start + dist, end + dist
                    ts, te = start, end
                else:
                    qs, qe = start, end
                    ts, te = start + dist, end + dist
                idcnt = int((qarr[qs:qe] == tseq[ts:ts + (qe - qs)]).sum()) \
                    if qe > qs else 0
                cand.seq_id = idcnt / float(qe - qs) if qe != qs \
                    else float("nan")
                cand.qlen = len(nucl_query)
                cand.dblen = len(tseq)
                cand.aln_len = diag_len
                cand.score = int((score / (diag_len + 0.5)) * 100)
                cand.qstart, cand.qend = qs, qe
                cand.dbstart, cand.dbend = ts, te
                if cand.seq_id >= seq_id_thr:
                    heap.push(cand)

        if query_could_be_extended:
            was_extended[qpos] |= IS_CONTIG
            nucl_writer.write(qkey, bytes(nucl_query))
            aa_writer.write(qkey, bytes(aa_query))

    for i in range(nucl_db.size):
        is_not_contig = not (was_extended[i] & IS_CONTIG)
        was_not_consumed = not (was_extended[i] & WAS_CONSUMED)
        if is_not_contig and (keep_target or was_not_consumed):
            nucl_writer.write(int(nucl_db.keys[i]), nucl_db.get_seq_bytes(i))
            aa_writer.write(int(aa_db.keys[i]), aa_db.get_seq_bytes(i))

    return (nucl_writer.finish(sort_by_key=True),
            aa_writer.finish(sort_by_key=True), was_extended)


def _flat_to_dicts(f):
    """Expand protein_aln_to_nucl's flat format into per-query record
    dicts for the Python pass. seqId is already parsed, so the pass's
    _parsed_seq_id round trip is a no-op on it."""
    out = {}
    for i in range(len(f["qk"])):
        out.setdefault(int(f["qk"][i]), []).append({
            "dbKey": int(f["dbkey"][i]), "score": int(f["score"][i]),
            "seqId": float(f["seqid"][i]),
            "qStartPos": int(f["qs"][i]), "qEndPos": int(f["qe"][i]),
            "qLen": int(f["qlen"][i]), "dbStartPos": int(f["ts"][i]),
            "dbEndPos": int(f["te"][i]), "dbLen": int(f["tlen"][i]),
        })
    return out


def records_to_flat(nucl_db, alignments):
    """protein_aln_to_nucl's flat format from per-query record dicts
    ({query_key: [record dict]}, as an alignment DB is read back): the
    queries in `nucl_db`'s order, each seqId through its 3-digit text round
    trip (Matcher::parseAlignmentRecord), "n_aln_raw" the records a query
    had."""
    lut = nucl_db.id_lookup_array()
    recs = [(int(k), r) for k in nucl_db.keys
            for r in alignments.get(int(k), [])]
    col = {name: np.array([r[field] for _, r in recs], dtype=np.int64)
           for name, field in (("dbkey", "dbKey"), ("score", "score"),
                               ("qs", "qStartPos"), ("qe", "qEndPos"),
                               ("qlen", "qLen"), ("ts", "dbStartPos"),
                               ("te", "dbEndPos"), ("tlen", "dbLen"))}
    return dict(
        col, qk=np.array([k for k, _ in recs], dtype=np.int64),
        dbid=lut[col["dbkey"]] if len(recs) else col["dbkey"],
        seqid=np.array([_parsed_seq_id(r["seqId"]) for _, r in recs],
                       dtype=np.float64),
        n_aln_raw=np.array([len(alignments.get(int(k), []))
                            for k in nucl_db.keys], dtype=np.int32))


def _guided_assemble_native(nucl_db, aa_db, alignments, seq_id_thr,
                            max_seq_len, keep_target):
    """Filter the flat records by the parsed-text seqId threshold
    (guidedassembleresult.cpp:197-201), run the native lockstep kernel,
    rebuild both output DBs in the oracle's order."""
    mat = constants.nucleotide()
    n = nucl_db.size
    seq_data, seq_off, seq_lens = _flat_seqs(nucl_db)
    aa_data, aa_off_flat, aa_lens = _flat_seqs(aa_db)
    keys = nucl_db.keys.astype(np.uint32)

    # flat nucleotide-coordinate records straight from protein_aln_to_nucl:
    # seqId is already the parsed text round-trip value, so only the
    # threshold filter and per-query offsets remain
    f = alignments
    n_aln_raw = np.ascontiguousarray(f["n_aln_raw"].astype(np.int32))
    keep = f["seqid"] >= seq_id_thr
    qk_kept = f["qk"][keep]
    lo = np.searchsorted(qk_kept, keys.astype(np.int64), side="left")
    hi = np.searchsorted(qk_kept, keys.astype(np.int64), side="right")
    aln_off = np.zeros(n + 1, dtype=np.int64)
    aln_off[1:] = np.cumsum((hi - lo).astype(np.int64))
    span = np.maximum(f["qe"] - f["qs"], f["te"] - f["ts"]) + 1
    a = {
        "dbkey": f["dbkey"][keep].astype(np.uint32),
        "dbid": f["dbid"][keep].astype(np.int32),
        "score": f["score"][keep].astype(np.int32),
        "seqid": f["seqid"][keep].astype(np.float64),
        "alnlen": span[keep].astype(np.int32),
        "qs": f["qs"][keep].astype(np.int32),
        "qe": f["qe"][keep].astype(np.int32),
        "qlen": f["qlen"][keep].astype(np.int32),
        "ts": f["ts"][keep].astype(np.int32),
        "te": f["te"][keep].astype(np.int32),
        "tlen": f["tlen"][keep].astype(np.int32),
    }
    a = {k: np.ascontiguousarray(v) for k, v in a.items()}

    ascii_mat = np.ascontiguousarray(mat.ascii_mat.astype(np.int16))
    flags = np.zeros(n, dtype=np.uint8)
    n_out_off = np.zeros(n, dtype=np.int64)
    n_out_len = np.zeros(n, dtype=np.int64)
    a_out_off = np.zeros(n, dtype=np.int64)
    a_out_len = np.zeros(n, dtype=np.int64)
    out_is_contig = np.zeros(n, dtype=np.uint8)
    n_cap = int(seq_off[-1]) + int(a["tlen"].sum()) + 1024
    a_cap = int(aa_off_flat[-1]) + int(a["tlen"].sum()) // 3 + 1024
    lib = native.lib()

    while True:
        n_buf = np.empty(n_cap, dtype=np.uint8)
        a_buf = np.empty(a_cap, dtype=np.uint8)
        rc = lib.guided_assemble_greedy(
            ptr(seq_data, ctypes.c_uint8), ptr(seq_off, ctypes.c_int64),
            ptr(seq_lens, ctypes.c_int32),
            ptr(aa_data, ctypes.c_uint8), ptr(aa_off_flat, ctypes.c_int64),
            ptr(aa_lens, ctypes.c_int32),
            ptr(keys, ctypes.c_uint32), np.int32(n),
            ptr(aln_off, ctypes.c_int64), ptr(n_aln_raw, ctypes.c_int32),
            ptr(a["dbkey"], ctypes.c_uint32), ptr(a["dbid"], ctypes.c_int32),
            ptr(a["score"], ctypes.c_int32), ptr(a["seqid"], ctypes.c_double),
            ptr(a["alnlen"], ctypes.c_int32), ptr(a["qs"], ctypes.c_int32),
            ptr(a["qe"], ctypes.c_int32), ptr(a["qlen"], ctypes.c_int32),
            ptr(a["ts"], ctypes.c_int32), ptr(a["te"], ctypes.c_int32),
            ptr(a["tlen"], ctypes.c_int32), ptr(ascii_mat, ctypes.c_int16),
            float(seq_id_thr), int(max_seq_len),
            ptr(flags, ctypes.c_uint8),
            ptr(n_buf, ctypes.c_uint8), np.int64(n_cap),
            ptr(n_out_off, ctypes.c_int64), ptr(n_out_len, ctypes.c_int64),
            ptr(a_buf, ctypes.c_uint8), np.int64(a_cap),
            ptr(a_out_off, ctypes.c_int64), ptr(a_out_len, ctypes.c_int64),
            ptr(out_is_contig, ctypes.c_uint8))
        if rc == 0:
            break
        n_cap *= 2
        a_cap *= 2
        flags[:] = 0

    nucl_out = _native_output_db(nucl_db, keys, seq_data, seq_off, seq_lens,
                                 flags, n_buf, n_out_off, n_out_len,
                                 out_is_contig, keep_target)
    aa_out = _native_output_db(aa_db, keys, aa_data, aa_off_flat, aa_lens,
                               flags, a_buf, a_out_off, a_out_len,
                               out_is_contig, keep_target)
    return nucl_out, aa_out, flags
