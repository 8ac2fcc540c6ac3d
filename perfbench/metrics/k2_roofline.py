"""K2 (csrc/rescore.cu, rescore_e2e and rescore_e2e_rev): share of the
bound, the larger of its bytes over 3.35 TB/s and its int32 operations
over the int32 rate (counts.rescore_counts)."""
from .. import counts, trace
from ._kernel import roofline_pct


def _bound(c):
    return counts.bound_seconds(*counts.rescore_counts(
        c["rows_bytes"], c["n_seqs"], c["hits"], c["window_residues"],
        c["reverse"], c["alpha"]))


def read(rec):
    return roofline_pct(rec, rec.k2, trace.K2_KERNEL, _bound)
