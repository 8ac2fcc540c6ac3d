"""Map protein-space ungapped alignments onto the underlying nucleotide ORF
coordinates (the `proteinaln2nucl` command).

Reference: src/util/proteinaln2nucl.cpp — coordinates scale by 3 with a -3
shift when the amino-acid sequence starts with '*' (an ORF-stop marker from
translatenucs --add-orf-stop); the score is recomputed over the nucleotide
characters with the nucleotide matrix; bit score is TRUNCATED (no +0.5);
E-value parameters are the gapped nucleotide ones.

The port keeps the flat path only: the records of the END_TO_END rescore
are pure-M (their implicit backtrace is "<alnLength>M"), so no gap cost
enters. The JAX package's plass_tpu.ops.proteinaln2nucl also walks records
that carry a gapped backtrace.
"""
import ctypes

import numpy as np

from .. import constants, native
from ..assembler.extend import _flat_seqs
from .evalue import EvalueComputer


def protein_aln_to_nucl(nucl_db, aa_db, alignments, evaluer=None):
    """alignments: rescore's flat format {"qk": int64[M], "rec":
    RESULT_DTYPE[M]} (rescore_diagonal_torch(return_flat=True)).

    Coordinate x3 mapping in numpy, window scoring + identity counting +
    parsed-seqId in one OpenMP pass (native/aln2nucl.cpp), bit scores in
    one vectorized evaluer call.  Requires the nucl/aa DBs row-aligned
    (the guided workflow's invariant).

    Returns {"qk": int64[M], "n_aln_raw": int32[n] (pre-filter record
    count per row, for WAS_IN_ALIGNMENT), "dbkey", "dbid", "score",
    "seqid" (text-round-trip parsed), "alnlen", "qs", "qe", "qlen",
    "ts", "te", "tlen"} in nucleotide coordinates, grouped by query in
    nucl_db row order — the input of guided_assemble."""
    if not (isinstance(alignments, dict) and "qk" in alignments
            and "rec" in alignments):
        raise TypeError("protein_aln_to_nucl takes the flat records of "
                        "rescore_diagonal_torch(return_flat=True)")
    if not np.array_equal(nucl_db.keys, aa_db.keys):
        raise ValueError("flat proteinaln2nucl needs row-aligned DBs")
    if evaluer is None:
        evaluer = EvalueComputer.for_matrix("nucleotide_gapped_5_2",
                                            nucl_db.total_residues())
    qk = np.asarray(alignments["qk"], dtype=np.int64)
    rec = alignments["rec"]
    m = len(qk)
    lut = nucl_db.id_lookup_array()
    n = nucl_db.size

    # per-row ORF-stop marker: aa payload starts with '*'
    aa_data, aa_off, aa_lens = _flat_seqs(aa_db)
    star = np.zeros(n, dtype=np.int32)
    nz = aa_lens > 0
    star[nz] = (aa_data[aa_off[:-1][nz]] == ord("*")).astype(np.int32)

    seq_data, seq_off, seq_lens = _flat_seqs(nucl_db)
    qid = lut[qk].astype(np.int32)
    tid = lut[rec["dbKey"].astype(np.int64)].astype(np.int32)
    q_start = rec["qStartPos"].astype(np.int32) * 3 - 3 * star[qid]
    q_end = rec["qEndPos"].astype(np.int32) * 3 + 2 - 3 * star[qid]
    db_start = rec["dbStartPos"].astype(np.int32) * 3 - 3 * star[tid]
    db_end = rec["dbEndPos"].astype(np.int32) * 3 + 2 - 3 * star[tid]
    nwin = rec["alnLength"].astype(np.int32) * 3

    raw_score = np.zeros(m, dtype=np.int32)
    parsed = np.zeros(m, dtype=np.float64)
    mat = constants.nucleotide()
    ascii16 = np.ascontiguousarray(mat.ascii_mat.astype(np.int16))

    def p(a, ct):
        a = np.ascontiguousarray(a)
        return a, a.ctypes.data_as(ctypes.POINTER(ct))

    qs_a, qs_p = p(q_start, ctypes.c_int32)
    ts_a, ts_p = p(db_start, ctypes.c_int32)
    qid_a, qid_p = p(qid, ctypes.c_int32)
    tid_a, tid_p = p(tid, ctypes.c_int32)
    nw_a, nw_p = p(nwin, ctypes.c_int32)
    native.lib().aln2nucl_score(
        m, seq_data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        seq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        qid_p, tid_p, qs_p, ts_p, nw_p,
        ascii16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        raw_score.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        parsed.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))

    bit = evaluer.bit_score(raw_score).astype(np.int64)  # truncated
    qlen = seq_lens[qid].astype(np.int32)
    tlen = seq_lens[tid].astype(np.int32)
    # the extender's alnLen is max(qe-qs, te-ts)+1 in nucl coords
    # (Matcher::computeAlnLength); for these ungapped windows both spans
    # are equal
    alnlen = (q_end - q_start + 1).astype(np.int32)
    # raw record count per row BEFORE the extender's seqId filter
    lo = np.searchsorted(qk, nucl_db.keys.astype(np.int64), side="left")
    hi = np.searchsorted(qk, nucl_db.keys.astype(np.int64), side="right")
    counts = (hi - lo).astype(np.int32)
    return {
        "qk": qk, "n_aln_raw": counts,
        "dbkey": rec["dbKey"].astype(np.uint32),
        "dbid": tid, "score": bit.astype(np.int32), "seqid": parsed,
        "alnlen": alnlen, "qs": q_start, "qe": q_end, "qlen": qlen,
        "ts": db_start, "te": db_end, "tlen": tlen,
    }
