"""K1 (csrc/seg_scan.cu, the matcher's segmented scans): share of the
bound by bytes, scan_bytes(n, ncols) over 3.35 TB/s a launch."""
from .. import counts, trace
from ._kernel import roofline_pct


def _bound(c):
    return counts.bound_seconds(counts.scan_bytes(c["n"], c["ncols"]))


def read(rec):
    return roofline_pct(rec, rec.k1, trace.K1_KERNEL, _bound)
