"""The yardstick's arithmetic: the card's published peaks and the bytes
and operations the kernels' launches need, from their shapes.

Peaks of one NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data sheet, at
its full power limit of 700 W: 3.35 TB/s of memory bandwidth; int32 at
132 SMs x 64 int32 lanes x the 1,980 MHz boost clock.
"""

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def scan_bytes(n, ncols):
    """Bytes a segmented scan (K1) must move over n elements: a one-byte
    flag and ncols int32 in, ncols int32 out, per element."""
    return n * (1 + 8 * ncols)


def rescore_counts(rows_bytes, n_seqs, hits, window_residues, reverse,
                   alpha, n_out=4):
    """(bytes, int32 operations) an END_TO_END rescore launch (K2) needs:
    each operand read once and each output written once.

    rows_bytes: the DB's flat bytes; a launch reads a query and a target
    window of each hit, so the rows count at most 2 x window_residues and
    never more than the DB holds. Offsets (int64) and lengths (int32) of
    at most two rows a hit; qrow, trow, diag (int32) and, with reverse
    hits, a strand byte per hit; the byte-to-code table, the int32 matrix
    and, with reverse hits, the complement and code-to-char tables; n_out
    int32 outputs per hit. Two operations per window residue: a score
    and an identity."""
    n = min(rows_bytes, 2 * window_residues)
    n += min(n_seqs, 2 * hits) * (8 + 4)
    n += hits * 12 + (hits if reverse else 0)
    n += 256 + alpha * alpha * 4 + (alpha * 5 if reverse else 0)
    n += n_out * 4 * hits
    return n, 2 * window_residues


def bound_seconds(n_bytes, n_ops=0):
    """The least time the card could take: the larger of the bytes over
    its memory rate and the int32 operations over its int32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S)
