"""Protein-guided nucleotide greedy extension (the `guidedassembleresults`
command), run by the native kernel native/nucl_extend.cpp
(guided_assemble_greedy).

Reference: src/assembler/guidedassembleresult.cpp. The skeleton is the
nucleotide extender (assembler/nucl_extend.py) with the same Bayesian
Beta-posterior candidate queue (CompareResultBySeqId, lines 23-76 — bit-for-
bit the nuclassembleresult comparator), plus:
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

The JAX package's plass_tpu.assembler.guided_extend holds the Python
reference of the same pass; the port runs the native kernel only, and a
failure of it raises.
"""
import ctypes

import numpy as np

from .. import constants, native
from ..ops.rescore import RESCORE_END_TO_END, format_seq_id
from .extend import _flat_seqs, _native_output_db, _native_ptr as ptr


def guided_assemble(nucl_db, aa_db, alignments, seq_id_thr=0.99,
                    max_seq_len=200000, keep_target=True,
                    rescore_mode=RESCORE_END_TO_END):
    """alignments: protein_aln_to_nucl's flat nucleotide-coordinate records.

    Returns (nucl_out, aa_out, was_extended); the two output DBs hold the
    same keys in the same order. Needs row-aligned input DBs and the
    END_TO_END rescore mode; anything else raises."""
    if rescore_mode != RESCORE_END_TO_END:
        raise NotImplementedError(
            f"guided_assemble supports only the END_TO_END rescore "
            f"(mode {RESCORE_END_TO_END}), not mode {rescore_mode}")
    if not np.array_equal(nucl_db.keys, aa_db.keys):
        raise ValueError("guided_assemble needs row-aligned nucl and aa DBs")
    if not (isinstance(alignments, dict) and "qk" in alignments
            and "n_aln_raw" in alignments):
        raise TypeError("guided_assemble takes the flat records of "
                        "protein_aln_to_nucl")
    return _guided_assemble_native(nucl_db, aa_db, alignments, seq_id_thr,
                                   max_seq_len, keep_target)


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
        seqid=np.array([float(format_seq_id(r["seqId"])) for _, r in recs],
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
