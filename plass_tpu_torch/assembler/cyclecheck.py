"""Circular-contig detection (reference: src/assembler/cyclecheck.cpp).

Split the contig into thirds; match 22-mers across thirds on diagonals
>= len/3; find the first diagonal whose +-1% band hit-rate exceeds 0.2 ->
the contig is circular with period `splitDiagonal`; optionally chop to one
period. K-mers are packed little-endian base-4 over the numeric alphabet
exactly like the reference's Indexer (X maps to digit 4, reproducing its
aliasing).

cycle_check_seq is the plain version, one sequence at a time with a Python
merge loop. cycle_check_db computes the same splits for a whole DB at once:
every matching step of the merge pairs a k-mer entry with the FIRST
occurrence of the same k-mer in an earlier third (front->middle,
front->back, middle->back), so a stable sort by (sequence, k-mer) and two
running "first position" carries give every pair, a count of equal
(sequence, diagonal) pairs gives the non-zero histogram bins, and the band
test only visits those. The sort and the carries are torch ops on `device`;
the band test is numpy on the few non-zero bins.
"""
import numpy as np
import torch

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


# residues per batch of cycle_check_splits (about ten int64 tensors of this
# many elements live at once), and band entries per round of the band test
BATCH_RESIDUES = 1 << 24
BAND_BUDGET = 1 << 22
# bits of the sort key: the sequence number above a base-4 k-mer whose
# digits go up to 4 (X), so that it stays below 4/3 * 4^k < 2^(2k+1)
KEY_BITS = 62


def _batches(rows, lens, max_rows):
    """Consecutive slices of `rows` of at most BATCH_RESIDUES residues
    (at least one row) and max_rows rows."""
    start = 0
    while start < len(rows):
        total = np.cumsum(lens[rows[start:start + max_rows]])
        stop = start + max(1, int(np.searchsorted(total, BATCH_RESIDUES,
                                                  side="right")))
        yield rows[start:stop]
        start = stop


def _nonzero_bins(data, code_lut, offsets, lens, k, device):
    """The non-zero diagonal-histogram bins of a batch of sequences:
    (bin, hits) as sorted numpy arrays, where bin = bin_off[s] + diagonal -
    third[s] and bin_off is the exclusive running sum of 2 * third + 1."""
    m = len(lens)
    off_t = torch.from_numpy(offsets).to(device)
    len_t = torch.from_numpy(lens).to(device)
    third = len_t // 3
    bin_off = torch.cumsum(2 * third + 1, 0) - (2 * third + 1)
    seg = torch.repeat_interleave(torch.arange(m, device=device), len_t)
    total = seg.numel()
    start = torch.cumsum(len_t, 0) - len_t
    pos = torch.arange(total, device=device) - start[seg]
    codes = code_lut[data[off_t[seg] + pos].long()]
    codes = torch.cat([codes, codes.new_zeros(k)])
    kmer = torch.zeros(total, dtype=torch.int64, device=device)
    for i in range(k):
        kmer += codes[i:i + total] << (2 * i)
    valid = pos <= len_t[seg] - k
    seg, pos, kmer = seg[valid], pos[valid], kmer[valid]
    del codes, valid

    # entries are in (sequence, position) order: a stable sort by
    # (sequence, k-mer) leaves each run of equal k-mers in position order
    key, order = torch.sort((seg << (2 * k + 1)) | kmer, stable=True)
    seg, pos = seg[order], pos[order]
    del kmer, order
    th = third[seg]
    part = (pos >= th + 1).to(torch.int8) + (pos >= 2 * th + 1).to(torch.int8)
    idx = torch.arange(key.numel(), device=device)
    run_start = torch.ones_like(key, dtype=torch.bool)
    run_start[1:] = key[1:] != key[:-1]
    prev_part = torch.cat([part.new_zeros(1), part[:-1]])
    first = torch.cummax(torch.where(run_start, idx, 0), 0).values
    # the first middle entry of a run: a middle entry at the run's start or
    # right after a front one (within a run the thirds never go back)
    first_mid = torch.cummax(torch.where(
        (part == 1) & (run_start | (prev_part == 0)), idx, -1), 0).values
    del key, run_start, prev_part

    # front -> middle and front -> back
    diag_a = pos - pos[first]
    keep_a = (part >= 1) & (part[first] == 0) & (diag_a >= th)
    # middle -> back
    diag_b = pos - pos[first_mid.clamp(min=0)]
    keep_b = (part == 2) & (first_mid >= first) & (diag_b >= th)
    base = bin_off[seg] - th
    bins = torch.cat([(base + diag_a)[keep_a], (base + diag_b)[keep_b]])
    uniq, hits = torch.unique(bins, return_counts=True)
    return uniq.cpu().numpy(), hits.cpu().numpy()


def _first_split(bins, hits, lens, k):
    """The band test of cycle_check_seq on the non-zero bins of a batch:
    int64[m] split diagonals (0: none). A band holds only non-zero bins,
    so its sum over all of them bounds the sum over those not above the
    centre bin; the exact sum is made only where that bound passes."""
    m = len(lens)
    split = np.zeros(m, dtype=np.int64)
    if not len(bins):
        return split
    third = lens // 3
    width = 2 * third + 1
    bin_off = np.cumsum(width) - width
    s = np.searchsorted(bin_off, bins, side="right") - 1
    d = bins - bin_off[s]
    diaglen = lens[s] - (d + third[s])
    gap = (diaglen * 0.01).astype(np.int64)
    lo = np.searchsorted(bins, bin_off[s] + np.maximum(0, d - gap), "left")
    hi = np.searchsorted(bins, bin_off[s] + np.minimum(d + gap, 2 * third[s]),
                         "right")
    denom = diaglen - k + 1
    run = np.concatenate([[0], np.cumsum(hits)])
    # the diagonal loop runs over range(2 * third): never the last bin
    cand = np.nonzero((d < 2 * third[s])
                      & ((run[hi] - run[lo]) / denom > HIT_RATE_THRESHOLD))[0]
    while len(cand):
        size = hi[cand] - lo[cand]
        n = max(1, int(np.searchsorted(np.cumsum(size), BAND_BUDGET,
                                       side="right")))
        now, size = cand[:n], size[:n]
        rep = np.repeat(np.arange(n), size)
        j = lo[now][rep] + np.arange(len(rep)) - (np.cumsum(size) - size)[rep]
        band = np.bincount(rep, np.where(hits[j] <= hits[now][rep], hits[j], 0),
                           minlength=n)
        ok = now[band / denom[now] > HIT_RATE_THRESHOLD]
        # bins are sorted by (sequence, diagonal): the first passing bin of
        # a sequence is its answer, and its later candidates are dropped
        seqs, at = np.unique(s[ok], return_index=True)
        split[seqs] = (d + third[s])[ok[at]]
        cand = cand[n:]
        cand = cand[split[s[cand]] == 0]
    return split


def cycle_check_splits(db, max_seq_len=200000, k=22, device="cpu"):
    """int64[db.size]: cycle_check_seq of every sequence shorter than
    max_seq_len (0 for the others and for those without a cycle)."""
    device = torch.device(device)
    lens = db.seq_lens().astype(np.int64)
    split = np.zeros(db.size, dtype=np.int64)
    rows = np.nonzero((lens < max_seq_len) & (lens >= k + 1))[0]
    if not len(rows):
        return split
    lut = constants.nucleotide().aa2num.astype(np.int64)
    if lut.max() > 4 or 2 * k + 1 >= KEY_BITS:
        raise ValueError("cycle check: k-mer codes must fit the sort key")
    code_lut = torch.from_numpy(lut).to(device)
    data = torch.from_numpy(np.array(db.data)).to(device)
    for batch in _batches(rows, lens, 1 << (KEY_BITS - (2 * k + 1))):
        bins, hits = _nonzero_bins(
            data, code_lut, np.ascontiguousarray(db.offsets[batch], np.int64),
            lens[batch], k, device)
        split[batch] = _first_split(bins, hits, lens[batch], k)
    return split


def cycle_check_db(db, chop_cycle=False, max_seq_len=200000, k=22,
                   device="cpu"):
    """cyclecheck: returns (cycle DB of [chopped] circular contigs,
    {key: split_diagonal}). The sort runs on `device`."""
    writer = seqdb.DBWriter(seqdb.NUCLEOTIDES)
    info = {}
    split = cycle_check_splits(db, max_seq_len, k, device)
    for i in np.nonzero(split)[0]:
        s = np.asarray(db.get_seq(i))
        key = int(db.keys[i])
        info[key] = int(split[i])
        out = s[:split[i]] if chop_cycle else s
        writer.write(key, out.tobytes())
    return writer.finish(), info
