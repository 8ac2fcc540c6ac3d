"""Nucleotide greedy extension (reference: src/assembler/
nuclassembleresult.cpp), run by the native kernel native/nucl_extend.cpp.

Same skeleton as the protein pass (assembler/extend.py) with three changes:
 - the candidate queue is ordered by a Bayesian posterior comparison of the
   two overlaps' mismatch rates via Beta(mm+1, aln-mm+1) posteriors,
   evaluated with an exact lgamma series (nuclassembleresult.cpp:36-70);
   ties (0.45 < p < 0.55) prefer the larger unaligned target remainder
 - the initial rescore keeps seqId unscaled (only score-per-column x100)
 - the max-seq-len guard applies to both extension directions

The comparator is not a strict weak ordering (the 0.45/0.55 deadband), so
the pop order depends on the exact heap algorithm; the kernel replicates
libstdc++'s std::priority_queue bit for bit. The JAX package's
plass_tpu.assembler.nucl_extend holds the Python reference of the same pass.
"""
import numpy as np

from .. import constants
from ..ops.evalue import EvalueComputer
from ..ops.rescore import RESCORE_END_TO_END


def nucl_assemble(db, alignments, seq_id_thr=0.99, max_seq_len=200000,
                  keep_target=True, rescore_mode=RESCORE_END_TO_END,
                  evaluer=None):
    """nuclassembleresults: db + per-query alignments -> (extended DB,
    per-sequence flags). Only the END_TO_END rescore is supported; any
    other mode raises, as does a failure of the native kernel."""
    if rescore_mode != RESCORE_END_TO_END:
        raise NotImplementedError(
            f"nucl_assemble supports only the END_TO_END rescore "
            f"(mode {RESCORE_END_TO_END}), not mode {rescore_mode}")
    return _nucl_assemble_native(db, alignments, seq_id_thr, max_seq_len,
                                 keep_target, evaluer)


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
