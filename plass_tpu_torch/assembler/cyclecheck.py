"""Circular-contig detection (reference: src/assembler/cyclecheck.cpp).

Split the contig into thirds; match 22-mers across thirds on diagonals
>= len/3; find the first diagonal whose +-1% band hit-rate exceeds 0.2 ->
the contig is circular with period `splitDiagonal`; optionally chop to one
period. K-mers are packed little-endian base-4 over the numeric alphabet
exactly like the reference's Indexer (X maps to digit 4, reproducing its
aliasing).
"""
import numpy as np

from .. import constants
from ..data import seqdb

HIT_RATE_THRESHOLD = 0.2


def _kmers(num, k):
    """little-endian base-4 packed k-mers at every position (Indexer::int2index
    with alphabetSize-1 = 4)."""
    L = len(num)
    n = L - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.int64)
    kidx = np.zeros(n, dtype=np.uint64)
    pw = np.uint64(1)
    for i in range(k):
        kidx += num[i: i + n].astype(np.uint64) * pw
        pw = pw * np.uint64(4)
    return kidx, np.arange(n, dtype=np.int64)


def _distinct_first_matches(a_kmer, a_pos, b_kmer, b_pos, seq_len, diag_hits,
                            third):
    """Merge-scan: for each DISTINCT kmer of a (first occurrence only), count
    all matching b entries at diagonals >= len/3 (cyclecheck.cpp:150-212)."""
    matches = 0
    i = j = 0
    na, nb = len(a_kmer), len(b_kmer)
    while i < na and j < nb:
        if a_kmer[i] < b_kmer[j]:
            # advance a to next distinct kmer
            k = a_kmer[i]
            i += 1
            while i < na and a_kmer[i] == k:
                i += 1
        elif a_kmer[i] > b_kmer[j]:
            j += 1
        else:
            k = a_kmer[i]
            pos = a_pos[i]
            while j < nb and b_kmer[j] == k:
                diag = int(b_pos[j]) - int(pos)
                if diag >= seq_len // 3:
                    diag_hits[diag - seq_len // 3] += 1
                    matches += 1
                j += 1
            i += 1
            while i < na and a_kmer[i] == k:
                i += 1
    return matches


def cycle_check_seq(seq_u8, k=22):
    """Returns split diagonal (cycle period) or 0."""
    mat = constants.nucleotide()
    num = mat.aa2num[seq_u8]
    seq_len = len(num)
    third = seq_len // 3
    if seq_len < k + 1:
        return 0
    kidx, pos = _kmers(num, k)
    front = pos < third + 1
    middle = (~front) & (pos < 2 * third + 1)
    back = (~front) & (~middle)

    def sorted_pair(mask):
        kk = kidx[mask]
        pp = pos[mask]
        order = np.lexsort((pp, kk))
        return kk[order], pp[order]

    fk, fp = sorted_pair(front)
    mk, mp = sorted_pair(middle)
    bk, bp = sorted_pair(back)

    diag_hits = np.zeros(2 * third + 1, dtype=np.int64)
    matches = 0
    # front vs back AND front vs middle share one scan over front
    # (cyclecheck.cpp:150-184): both b-streams advance against each distinct
    # front kmer
    i = j = kx = 0
    nf, nb, nm = len(fk), len(bk), len(mk)
    while i < nf and (j < nb or kx < nm):
        kmer = fk[i]
        p0 = fp[i]
        while j < nb and bk[j] < kmer:
            j += 1
        while kx < nm and mk[kx] < kmer:
            kx += 1
        while j < nb and bk[j] == kmer:
            diag = int(bp[j]) - int(p0)
            if diag >= seq_len // 3:
                diag_hits[diag - seq_len // 3] += 1
                matches += 1
            j += 1
        while kx < nm and mk[kx] == kmer:
            diag = int(mp[kx]) - int(p0)
            if diag >= seq_len // 3:
                diag_hits[diag - seq_len // 3] += 1
                matches += 1
            kx += 1
        i += 1
        while i < nf and fk[i] == kmer:
            i += 1
    # middle vs back
    matches += _distinct_first_matches(mk, mp, bk, bp, seq_len, diag_hits,
                                       third)

    if matches == 0:
        return 0
    for d in range(2 * third):
        if diag_hits[d] != 0:
            diag = d + third
            diaglen = seq_len - diag
            gap = int(diaglen * 0.01)
            lower = max(0, d - gap)
            upper = min(d + gap, 2 * third)
            band = int(diag_hits[lower: upper + 1][
                diag_hits[lower: upper + 1] <= diag_hits[d]].sum())
            rate = band / (diaglen - k + 1)
            if rate > HIT_RATE_THRESHOLD:
                return diag
    return 0


def cycle_check_db(db, chop_cycle=False, max_seq_len=200000, k=22):
    """cyclecheck: returns (cycle DB of [chopped] circular contigs,
    {key: split_diagonal})."""
    writer = seqdb.DBWriter(seqdb.NUCLEOTIDES)
    info = {}
    for i in range(db.size):
        s = np.asarray(db.get_seq(i))
        if len(s) >= max_seq_len:
            continue
        split = cycle_check_seq(s, k)
        if split != 0:
            key = int(db.keys[i])
            info[key] = split
            out = s[:split] if chop_cycle else s
            writer.write(key, out.tobytes())
    return writer.finish(), info
