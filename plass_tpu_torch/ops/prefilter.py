"""Sensitive double-k-mer-match prefilter (`prefilter` command).

Reference: lib/mmseqs/src/prefiltering/ — Prefiltering.{h,cpp},
QueryMatcher.{h,cpp}, IndexTable.h, IndexBuilder.cpp, KmerGenerator.cpp,
UngappedAlignment.cpp. This is the classic MMseqs2 sensitive prefilter:
an inverted index of spaced target k-mers is probed with all k-mers
*similar* to each query k-mer (score >= a sensitivity-derived threshold
under an 8-bit-factor seed matrix, VTML80 by default), candidate
(target, diagonal) pairs are scored by ungapped diagonal alignment with
composition-bias-corrected scores, and the best `max_seqs` targets per
query are emitted as `targetKey score diagonal` prefilter records.

Design notes (TPU-first, not a port): instead of the reference's
per-query inverted-index probing with 515MB precomputed 3-mer extension
tables (ExtendedSubstitutionMatrix), similar k-mers are enumerated once
per *unique* query k-mer with a vectorized branch-and-bound frontier
expansion (exact same output set: all k-mers with score >= threshold,
KmerGenerator.cpp:105-185 enumerates exactly this), and the
query-candidate/target join is a sorted-array join. Diagonal scoring is
batched. Exact/capped score semantics follow UngappedAlignment: scores
are stored capped at (255 - query profile bias) for threshold selection
(the SIMD uint8 saturation bound, UngappedAlignment.cpp:27-35) and
rescored exactly when at the cap (QueryMatcher.cpp:155-166,377-385).

The JAX package's host prefilter (numpy and the native tantan and
ungapped-diagonal kernels), copied: it runs on the host whatever the
device, for sequence and profile queries and targets alike (profiles
through ops/profile_query.py).
"""
import os

import numpy as np

from .. import constants
from ..data import seqdb
from ..utils.log import logger

# Spaced seed patterns, Sequence.h:19-40 (data tables, 1 = informative).
SPACED_PATTERNS = {
    4: [1, 1, 1, 0, 1],
    5: [1, 1, 0, 1, 0, 1, 1],
    6: [1, 1, 0, 1, 0, 1, 0, 0, 1, 1],
    7: [1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1],
    8: [1, 1, 0, 1, 0, 1, 1, 1, 0, 0, 1, 1],
    9: [1, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1],
    10: [1, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 1],
    11: [1, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 1, 1],
}

SCORE_RANGE = 256  # QueryMatcher.h SCORE_RANGE


def kmer_threshold(sensitivity, kmer_size, kmer_score=None, profile=False):
    """Prefiltering::getKmerThreshold (Prefiltering.cpp:987-1022)."""
    if kmer_score is not None:
        return int(kmer_score)
    if profile:
        base = {5: 140.75, 6: 155.75, 7: 171.75}[kmer_size]
        slope = {5: 8.75, 6: 8.75, 7: 9.75}[kmer_size]
    else:
        base = {5: 160.75, 6: 163.2, 7: 186.15}[kmer_size]
        slope = {5: 12.75, 6: 8.917, 7: 11.22}[kmer_size]
    return int(np.float32(base) - np.float32(sensitivity) * np.float32(slope))


def auto_kmer_size(target_residues):
    """IndexTable::computeKmerSize (IndexTable.h:432-434)."""
    return 6 if target_residues < 3350000000 else 7


def spaced_positions(kmer_size, spaced=True):
    """Informative offsets of the (spaced) seed for this k."""
    if not spaced:
        return np.arange(kmer_size)
    pat = np.asarray(SPACED_PATTERNS[kmer_size])
    return np.flatnonzero(pat)


def _pack(kmers):
    """Pack [N, k] residue matrix (0..19) into uint64 keys, base 21
    (Indexer::int2index digit order: kmer[0] is the most significant)."""
    k = kmers.shape[1]
    powers = (21 ** np.arange(k - 1, -1, -1)).astype(np.uint64)
    return (kmers.astype(np.uint64) * powers[None, :]).sum(axis=1)


def extract_kmers(num, positions, x_idx):
    """All spaced k-mers of numeric sequence `num`: returns (starts, packed)
    with X-containing k-mers removed (Sequence::kmerContainsX over the
    informative window only, Sequence.h:103-105)."""
    span = int(positions[-1]) + 1
    L = len(num)
    n = L - span + 1
    if n <= 0:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint64))
    starts = np.arange(n)
    window = num[starts[:, None] + positions[None, :]]
    ok = ~(window == x_idx).any(axis=1)
    return starts[ok], _pack(window[ok])


class KmerIndex:
    """Inverted spaced-k-mer index over the target DB
    (IndexTable.h:341-395 addSequence semantics: per sequence one entry
    per distinct k-mer at its first occurrence position; k-mers whose
    self-score under the seed matrix is below the k-mer threshold are
    excluded, IndexTable.h:141-148)."""

    def __init__(self, tdb, kmer_size, kmer_thr, seed_mat, spaced=True,
                 mask=0, comp_bias=True):
        positions = spaced_positions(kmer_size, spaced)
        x_idx = seed_mat.alphabet_size - 1
        self_score = np.diag(seed_mat.sub).astype(np.int32)
        is_profile = tdb.dbtype == seqdb.HMM_PROFILE
        all_kmers = []
        all_sid = []
        all_pos = []
        masker = None
        if mask and not is_profile:
            from . import tantan
            masker = tantan.TantanMasker(seed_mat)
        # internal target ids follow the DATA-file order: the reference
        # opens the target with LINEAR_ACCCESS (Prefiltering.cpp:164) and
        # IndexBuilder assigns ids sequentially, so score ties in the final
        # hit sort break by data order, not key order
        self.order = np.asarray(seqdb.data_order(tdb), dtype=np.int64)
        # the SequenceLookup used for ungapped diagonal scoring holds the
        # *masked* sequences when masking is on (IndexBuilder.cpp:520-521,
        # maskedLookup), so keep what we indexed
        self.nums = []
        for rank in range(tdb.size):
            i = int(self.order[rank])
            if is_profile:
                # profile targets: every k-mer scoring >= kmerThr under the
                # profile's own column scores goes into the index
                # (IndexBuilder.cpp:105-133 addSimilarKmerCount /
                # IndexTable.h:298-330 addSimilarSequence); the ungapped
                # rescorer reads the CONSENSUS residues
                # (IndexBuilder.cpp:132 numConsensusSequence)
                from .profile_query import (ProfileQuery,
                                            enumerate_profile_kmers)
                pq = ProfileQuery(tdb.get_data(i).tobytes(),
                                  comp_bias=comp_bias)
                self.nums.append(pq.consensus)
                w_starts, w_off, packed, _ = enumerate_profile_kmers(
                    pq, positions, kmer_thr)
                starts = np.repeat(w_starts, np.diff(w_off)).astype(np.int64)
                if not len(packed):
                    continue
                # one entry per distinct kmer at its lowest position
                # (sorted by (kmer, position_j), IndexTable.h:52-63)
                order = np.lexsort((starts, packed))
                packed, starts = packed[order], starts[order]
                first = np.ones(len(packed), dtype=bool)
                first[1:] = packed[1:] != packed[:-1]
                all_kmers.append(packed[first])
                all_sid.append(np.full(int(first.sum()), rank,
                                       dtype=np.int32))
                all_pos.append(starts[first].astype(np.int32))
                continue
            num = seed_mat.aa2num[np.asarray(tdb.get_seq(i))]
            if masker is not None:
                num = masker.mask(num)
            self.nums.append(num)
            starts, packed = extract_kmers(num, positions, x_idx)
            if kmer_thr > 0 and len(packed):
                window = num[starts[:, None] + positions[None, :]]
                keep = self_score[window].sum(axis=1) >= kmer_thr
                starts, packed = starts[keep], packed[keep]
            if not len(packed):
                continue
            # one entry per distinct kmer: first (lowest) position
            order = np.lexsort((starts, packed))
            packed, starts = packed[order], starts[order]
            first = np.ones(len(packed), dtype=bool)
            first[1:] = packed[1:] != packed[:-1]
            all_kmers.append(packed[first])
            all_sid.append(np.full(int(first.sum()), rank, dtype=np.int32))
            all_pos.append(starts[first].astype(np.int32))
        if all_kmers:
            kmers = np.concatenate(all_kmers)
            sid = np.concatenate(all_sid)
            pos = np.concatenate(all_pos)
        else:
            kmers = np.zeros(0, dtype=np.uint64)
            sid = np.zeros(0, dtype=np.int32)
            pos = np.zeros(0, dtype=np.int32)
        order = np.argsort(kmers, kind="stable")  # stable: entries per
        # k-mer stay in target-id order, like sequential index insertion
        self.kmers = kmers[order]
        self.sid = sid[order]
        self.pos = pos[order]
        self.uniq, self.starts = np.unique(self.kmers, return_index=True)
        self.counts = np.diff(np.append(self.starts, len(self.kmers)))
        self.positions = positions
        self.kmer_size = kmer_size


def enumerate_similar(sub20, ukmers, thresholds):
    """All k-mers (over the 20-letter alphabet, X excluded:
    Prefiltering.cpp:218 drops X before building extension tables) with
    score(query_kmer, candidate) >= threshold. Vectorized breadth-first
    branch-and-bound; output set identical to KmerGenerator's exact
    threshold enumeration (KmerGenerator.cpp:105-185).

    ukmers: [U, k] residues of the unique query k-mers.
    thresholds: [U] per-k-mer minimum score.
    Returns (csr_offsets [U+1], cand_packed, cand_score) sorted by source
    k-mer (row) with candidates in arbitrary order.
    """
    U, k = ukmers.shape
    row_scores = sub20[ukmers]              # [U, k, 20]
    row_max = row_scores.max(axis=2)        # [U, k]
    # suffix_max[u, i] = max achievable from positions i..k-1
    suffix_max = np.zeros((U, k + 1), dtype=np.int32)
    suffix_max[:, :k] = row_max[:, ::-1].cumsum(axis=1)[:, ::-1]

    rows = np.arange(U, dtype=np.int64)
    scores = np.zeros(U, dtype=np.int32)
    packed = np.zeros(U, dtype=np.uint64)
    alive = scores + suffix_max[:, 0] >= thresholds
    rows, scores, packed = rows[alive], scores[alive], packed[alive]
    for i in range(k):
        # extend every frontier entry with all 20 residues
        new_scores = scores[:, None] + row_scores[rows, i]   # [F, 20]
        bound = new_scores + suffix_max[rows, i + 1][:, None]
        keep = bound >= thresholds[rows][:, None]
        f_idx, res = np.nonzero(keep)
        rows = rows[f_idx]
        scores = new_scores[f_idx, res]
        packed = packed[f_idx] * np.uint64(21) + res.astype(np.uint64)
        if not len(rows):
            break
    # Reproduce KmerGenerator's emission order: the k-mer is split into
    # chunks (k=6 -> [3,3]; k=7 -> [2,2,3]: setDivideStrategy builds
    # [3,2,2] and reverses, KmerGenerator.cpp:41-86) and candidates are
    # the Cartesian product with each chunk's list sorted by (score desc,
    # chunk value asc — ExtendedSubstitutionMatrix rows are stable-sorted
    # by score over lexicographically ordered k-mers,
    # ExtendedSubstitutionMatrix.cpp:44-57). Order matters downstream:
    # the two-hit filter tests *consecutive* matches.
    chunks = _divide_chunks(k)
    sort_keys = []
    unpacked = _unpack(packed, k)
    for (a, b) in reversed(chunks):
        csc = np.zeros(len(rows), dtype=np.int32)
        cval = np.zeros(len(rows), dtype=np.int64)
        for p in range(a, b):
            csc += sub20[ukmers[rows, p], unpacked[:, p]]
            cval = cval * 21 + unpacked[:, p]
        sort_keys.append(cval)     # chunk value asc (secondary)
        sort_keys.append(-csc)     # chunk score desc (primary)
    sort_keys.append(rows)
    order = np.lexsort(sort_keys)
    rows, scores, packed = rows[order], scores[order], packed[order]
    offsets = np.zeros(U + 1, dtype=np.int64)
    np.add.at(offsets, rows + 1, 1)
    offsets = offsets.cumsum()
    return offsets, packed, scores


def _divide_chunks(k):
    """KmerGenerator::setDivideStrategy chunk spans (after the reversal at
    KmerGenerator.cpp:84-85): k%3==0 -> [3,3,...]; k%3==1 -> [2,2,3,...];
    k%3==2 -> [2,3,...]."""
    if k % 3 == 0:
        sizes = [3] * (k // 3)
    elif k % 3 == 1:
        sizes = [2, 2] + [3] * (k // 3 - 1)
    else:
        sizes = [2] + [3] * (k // 3)
    out = []
    a = 0
    for s in sizes:
        out.append((a, a + s))
        a += s
    return out


def _unpack(packed, k):
    """Inverse of _pack: [N] uint64 -> [N, k] residues."""
    out = np.zeros((len(packed), k), dtype=np.int64)
    v = packed.astype(np.uint64)
    for i in range(k - 1, -1, -1):
        out[:, i] = (v % np.uint64(21)).astype(np.int64)
        v //= np.uint64(21)
    return out


def _l2_cache_size():
    """Util::getL2CacheSize (Util.cpp:373-388; 256KB fallback)."""
    try:
        with open("/sys/devices/system/cpu/cpu0/cache/index2/size") as f:
            txt = f.read().strip()
        if txt.endswith("K"):
            return int(txt[:-1]) * 1024
        if txt.endswith("M"):
            return int(txt[:-1]) * 1024 * 1024
        return int(txt)
    except (OSError, ValueError):
        return 262144


def two_hit_diagonals(tids, diag, n_targets, l2_cache=None):
    """The double-k-mer-match candidate filter
    (CacheFriendlyOperations::findDuplicates,
    CacheFriendlyOperations.cpp:38-220): a (target, diagonal) becomes a
    candidate only when two k-mer matches land on the same target with
    equal diagonal *as unsigned char* (mod 256) consecutively in match
    order. Surviving entries are collapsed per target by consecutive
    equal mod-256 diagonal, keeping the full 16-bit diagonal of the
    first surviving entry of each run.

    The per-target last-diagonal state is a byte array zeroed at the
    start AND cleaned after every bin (CacheFriendlyOperations.cpp:147,
    225-233), so each target starts at state 0: a first match whose
    diagonal is ==0 mod 256 counts as a duplicate immediately (reference
    quirk, commented-out fix at CacheFriendlyOperations.cpp:162). The
    bin decomposition (BINCOUNT from the host L2 cache size,
    QueryMatcher.cpp:392-421) therefore only affects output *order*
    (bin-major), which downstream max-per-target tie-breaking sees.

    tids/diag: per k-mer match, in match order (query position asc,
    candidate k-mer order, index entry order). Returns (tid, diag16)
    candidate arrays in (bin, match-order) order.
    """
    if l2_cache is None:
        l2_cache = _l2_cache_size()
    bincount = 2
    while bincount < 2048 and n_targets // bincount >= l2_cache:
        bincount *= 2

    out_t, out_d = [], []
    bin_of = tids & np.int64(bincount - 1) if tids.dtype != np.int32 \
        else tids & np.int32(bincount - 1)
    for b in range(bincount):
        idx = np.flatnonzero(bin_of == b)
        if not len(idx):
            continue
        t, d = tids[idx], diag[idx]
        d8 = (d & np.uint16(0xFF)).astype(np.uint8)
        order = np.argsort(t, kind="stable")
        ts, ds, d8s = t[order], d[order], d8[order]
        run_first = np.ones(len(ts), dtype=bool)
        run_first[1:] = ts[1:] != ts[:-1]
        prev8 = np.empty(len(ts), dtype=np.uint8)
        prev8[1:] = d8s[:-1]
        prev8[run_first] = 0  # fresh per-target state: the ==0 quirk
        kept = d8s == prev8
        if kept.any():
            kt, kd, kd8 = ts[kept], ds[kept], d8s[kept]
            kpos = idx[order][kept]
            same_t = np.zeros(len(kt), dtype=bool)
            same_t[1:] = kt[1:] == kt[:-1]
            emit = np.ones(len(kt), dtype=bool)
            emit[1:] = ~(same_t[1:] & (kd8[1:] == kd8[:-1]))
            # emit in bin input order (the reference writes the output
            # scanning the bin sequentially)
            pos = kpos[emit]
            reorder = np.argsort(pos, kind="stable")
            out_t.append(kt[emit][reorder])
            out_d.append(kd[emit][reorder])
    if not out_t:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.uint16)
    return (np.concatenate(out_t).astype(np.int32),
            np.concatenate(out_d))


MAX_DB_MATCHES = 2000000  # max(1e6, dbSize)*2, QueryMatcher.cpp:41


def match_candidates(index, kmer_rows, ecnt, cand_qpos, index_to, n_targets,
                     count_mode=False):
    """Expand matched candidate k-mers to (target, diagonal) matches and
    run the segmented two-hit filter.

    Replicates QueryMatcher::match's bounded match buffer
    (QueryMatcher.cpp:199-290): entries are collected per candidate k-mer
    into a 2M-entry buffer; when a k-mer's list would overflow it, the
    buffered positions [indexStart, current_i) are flushed through
    findDuplicates (fresh duplicate state per flush) and *the already
    buffered entries of the flush position itself are dropped*; flushed
    candidate lists are combined with mergeElementsByDiagonal. The final
    flush excludes the last k-mer position entirely (`i < indexTo`,
    QueryMatcher.cpp:43 — reference off-by-one kept for parity).

    kmer_rows: per matched candidate, row into the index CSR.
    ecnt: per candidate, number of index entries. cand_qpos: per
    candidate, query position. index_to: the last k-mer position (L-span).
    """
    ncand = len(kmer_rows)
    cum = np.cumsum(ecnt, dtype=np.int64)
    segments = []  # list of candidate-index arrays
    start = 0
    base = 0
    while True:
        # first candidate c with fill-before + cnt >= CAP, i.e.
        # cum[c] - base >= CAP
        idx = int(np.searchsorted(cum, base + MAX_DB_MATCHES, side="left"))
        if idx >= ncand:
            seg = np.arange(start, ncand)
            # final flush drops the last k-mer position (i < indexTo)
            seg = seg[cand_qpos[seg] != index_to]
            segments.append(seg)
            break
        seg = np.arange(start, idx)
        # entries already buffered for the flush position are discarded
        seg = seg[cand_qpos[seg] != cand_qpos[idx]]
        segments.append(seg)
        start = idx
        base = int(cum[idx]) - int(ecnt[idx])

    merged_t = merged_d = merged_c = None
    for seg in segments:
        if not len(seg):
            continue
        eidx = _expand_ranges(index.starts[kmer_rows[seg]], ecnt[seg])
        tids = index.sid[eidx]
        tpos = index.pos[eidx]
        qpos = np.repeat(cand_qpos[seg], ecnt[seg])
        diag = (qpos - tpos).astype(np.uint16)
        if count_mode:
            st, sd, sc = two_hit_counts(tids, diag, n_targets)
        else:
            st, sd = two_hit_diagonals(tids, diag, n_targets)
            sc = None
        if merged_t is None:
            merged_t, merged_d, merged_c = st, sd, sc
        else:
            merged_t = np.concatenate([merged_t, st])
            merged_d = np.concatenate([merged_d, sd])
            if count_mode:
                merged_c = np.concatenate([merged_c, sc])
                merged_t, merged_d, merged_c = merge_by_score(
                    merged_t, merged_d, merged_c, n_targets)
            else:
                merged_t, merged_d = merge_by_diagonal(merged_t, merged_d,
                                                       n_targets)
    if merged_t is None:
        z = (np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.uint16))
        return z + (np.zeros(0, dtype=np.int32),) if count_mode else z
    if count_mode:
        return merged_t, merged_d, merged_c
    return merged_t, merged_d


def merge_by_score(tids, diag, counts, n_targets, l2_cache=None):
    """CacheFriendlyOperations::mergeElementsByScore
    (CacheFriendlyOperations.cpp:112-143): re-bin, saturating-add counts
    per target, emit one entry per target with its first diagonal."""
    if l2_cache is None:
        l2_cache = _l2_cache_size()
    bincount = 2
    while bincount < 2048 and n_targets // bincount >= l2_cache:
        bincount *= 2
    out_t, out_d, out_c = [], [], []
    bin_of = tids & np.int32(bincount - 1)
    for b in range(bincount):
        idx = np.flatnonzero(bin_of == b)
        if not len(idx):
            continue
        t, d, c = tids[idx], diag[idx], counts[idx]
        order = np.argsort(t, kind="stable")
        ts, ds, cs = t[order], d[order], c[order]
        first = np.ones(len(ts), dtype=bool)
        first[1:] = ts[1:] != ts[:-1]
        group = np.cumsum(first) - 1
        tot = np.zeros(int(group[-1]) + 1, dtype=np.int64)
        np.add.at(tot, group, cs)
        tot = np.minimum(tot, 255).astype(np.int32)
        pos = idx[order][first]
        reorder = np.argsort(pos, kind="stable")
        out_t.append(ts[first][reorder])
        out_d.append(ds[first][reorder])
        out_c.append(tot[reorder])
    return (np.concatenate(out_t), np.concatenate(out_d),
            np.concatenate(out_c))


def merge_by_diagonal(tids, diag, n_targets, l2_cache=None):
    """CacheFriendlyOperations::mergeElementsByDiagonal
    (CacheFriendlyOperations.cpp:60-110): re-bin, then per target keep
    the first entry of each run of equal mod-256 diagonals (the slot is
    pre-seeded with the first entry's diagonal + 1, so the first entry
    always survives)."""
    if l2_cache is None:
        l2_cache = _l2_cache_size()
    bincount = 2
    while bincount < 2048 and n_targets // bincount >= l2_cache:
        bincount *= 2
    out_t, out_d = [], []
    bin_of = tids & np.int32(bincount - 1)
    for b in range(bincount):
        idx = np.flatnonzero(bin_of == b)
        if not len(idx):
            continue
        t, d = tids[idx], diag[idx]
        d8 = (d & np.uint16(0xFF)).astype(np.uint8)
        order = np.argsort(t, kind="stable")
        ts, ds, d8s = t[order], d[order], d8[order]
        same_t = np.zeros(len(ts), dtype=bool)
        same_t[1:] = ts[1:] == ts[:-1]
        emit = np.ones(len(ts), dtype=bool)
        emit[1:] = ~(same_t[1:] & (d8s[1:] == d8s[:-1]))
        pos = idx[order][emit]
        reorder = np.argsort(pos, kind="stable")
        out_t.append(ts[emit][reorder])
        out_d.append(ds[emit][reorder])
    if not out_t:
        return (np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.uint16))
    return np.concatenate(out_t), np.concatenate(out_d)


def two_hit_counts(tids, diag, n_targets, l2_cache=None):
    """computeTotalScore variant of the two-hit filter
    (CacheFriendlyOperations.cpp:175-196, diagonalScoring off): surviving
    entries are counted per target (saturating at 255) and one entry per
    target is emitted carrying (count, first surviving diagonal)."""
    if l2_cache is None:
        l2_cache = _l2_cache_size()
    bincount = 2
    while bincount < 2048 and n_targets // bincount >= l2_cache:
        bincount *= 2
    out_t, out_d, out_c = [], [], []
    bin_of = tids & np.int64(bincount - 1) if tids.dtype != np.int32 \
        else tids & np.int32(bincount - 1)
    for b in range(bincount):
        idx = np.flatnonzero(bin_of == b)
        if not len(idx):
            continue
        t, d = tids[idx], diag[idx]
        d8 = (d & np.uint16(0xFF)).astype(np.uint8)
        order = np.argsort(t, kind="stable")
        ts, ds, d8s = t[order], d[order], d8[order]
        run_first = np.ones(len(ts), dtype=bool)
        run_first[1:] = ts[1:] != ts[:-1]
        prev8 = np.empty(len(ts), dtype=np.uint8)
        prev8[1:] = d8s[:-1]
        prev8[run_first] = 0
        kept = d8s == prev8
        if kept.any():
            kt, kd, kpos = ts[kept], ds[kept], idx[order][kept]
            first = np.ones(len(kt), dtype=bool)
            first[1:] = kt[1:] != kt[:-1]
            counts = np.diff(np.append(np.flatnonzero(first), len(kt)))
            counts = np.minimum(counts, 255).astype(np.int32)
            pos = kpos[first]
            reorder = np.argsort(pos, kind="stable")
            out_t.append(kt[first][reorder])
            out_d.append(kd[first][reorder])
            out_c.append(counts[reorder])
    if not out_t:
        return (np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.uint16),
                np.zeros(0, dtype=np.int32))
    return (np.concatenate(out_t).astype(np.int32), np.concatenate(out_d),
            np.concatenate(out_c))


def diagonal_scores_exact(qprofile, tnum, diags):
    """Exact local ungapped max along each diagonal
    (UngappedAlignment::scalarDiagonalScoring semantics with the
    bias-corrected query profile: running score clamped at 0, max taken).

    qprofile: [L, A] int32 profile (sub2[q[i]] + comp_bias_char[i]).
    tnum: numeric target sequence. diags: int array (qpos - tpos).
    """
    L = qprofile.shape[0]
    tl = len(tnum)
    out = np.zeros(len(diags), dtype=np.int32)
    for n, d in enumerate(diags):
        if d >= 0:
            qs, ts = d, 0
        else:
            qs, ts = 0, -d
        m = min(L - qs, tl - ts)
        if m <= 0:
            continue
        s = qprofile[np.arange(qs, qs + m), tnum[ts:ts + m]]
        # local max of running sum clamped at 0:
        # max over j of (prefix[j] - min(0, min prefix before j))
        pref = np.cumsum(s)
        run_min = np.minimum(np.minimum.accumulate(
            np.concatenate(([0], pref[:-1]))), 0)
        out[n] = max(int((pref - run_min).max()), 0)
    return out


class PrefilterParams:
    def __init__(self, sensitivity=4.0, kmer_size=0, kmer_score=None,
                 max_seqs=300, min_ungapped_score=15, comp_bias_corr=True,
                 spaced_kmer=True, mask=1, exact_kmer_matching=False,
                 add_self_matches=False, seed_mat=None, ungapped_mat=None,
                 diag_score=True, cov_thr=0.0, cov_mode=0):
        self.sensitivity = sensitivity
        self.kmer_size = kmer_size
        self.kmer_score = kmer_score
        self.max_seqs = max_seqs
        self.min_ungapped_score = min_ungapped_score
        self.comp_bias_corr = comp_bias_corr
        self.spaced_kmer = spaced_kmer
        self.mask = mask
        self.exact_kmer_matching = exact_kmer_matching
        self.add_self_matches = add_self_matches
        self.seed_mat = seed_mat
        self.ungapped_mat = ungapped_mat
        self.diag_score = diag_score
        self.cov_thr = cov_thr
        self.cov_mode = cov_mode


def prefilter(qdb, tdb, params=None, same_db=None):
    """Run the prefilter; returns {query_key: [(target_key, score, diag)]}
    with hits sorted by (|score| desc, target id asc)
    (hit_t::compareHitsByScoreAndId, QueryMatcher.h:40-47)."""
    from .protein_align import calc_local_aa_bias

    p = params or PrefilterParams()
    seed = p.seed_mat or constants.vtml80_8()
    ungapped = p.ungapped_mat or constants.blosum62_pref()
    is_profile_query = qdb.dbtype == seqdb.HMM_PROFILE
    is_profile_target = tdb.dbtype == seqdb.HMM_PROFILE
    if is_profile_query and is_profile_target:
        raise ValueError("Query-profiles cannot be searched against a "
                         "target-profile database!")
    k = p.kmer_size or auto_kmer_size(tdb.total_residues())
    kmer_thr = kmer_threshold(p.sensitivity, k, p.kmer_score,
                              profile=is_profile_query or is_profile_target)
    max_seqs = min(int(p.max_seqs), tdb.size)
    if same_db is None:
        same_db = qdb is tdb
    # profile targets: consensus never masked (Prefiltering.cpp:173-175),
    # query k-mers matched exactly (takeOnlyBestKmer, Prefiltering.cpp:177)
    exact_matching = p.exact_kmer_matching or is_profile_target
    logger.info("prefilter: k=%d kmerThr=%d maxSeqs=%d", k, kmer_thr,
                max_seqs)

    index = getattr(p, "prebuilt_index", None)
    if index is None:
        index = KmerIndex(tdb, k, kmer_thr, seed, p.spaced_kmer,
                          0 if is_profile_target else p.mask,
                          comp_bias=p.comp_bias_corr)
    positions = index.positions
    x_idx = seed.alphabet_size - 1
    sub20 = seed.sub[:20, :20].astype(np.int32)
    sub2 = ungapped.sub.astype(np.int32)
    seed_sub8 = seed.sub.astype(np.int8)

    # target numeric cache for diagonal scoring
    # diagonal scoring reads the index's (possibly masked) sequences; the
    # seed and ungapped matrices share one letter order, so the numeric
    # encodings are interchangeable. Internal target ids (= index ranks)
    # follow the target DATA order, like the reference's LINEAR_ACCCESS
    # reader, so score ties sort by data order.
    tnums = index.nums
    tkeys = np.asarray(tdb.keys)[index.order]
    tkey_to_id = {int(kk): i for i, kk in enumerate(tkeys)}
    tkey_to_dbid = {int(kk): int(index.order[i])
                    for i, kk in enumerate(tkeys)}

    out = {}
    for qi in range(qdb.size):
        qkey = int(qdb.keys[qi])
        pq = None
        if is_profile_query:
            from .profile_query import ProfileQuery, enumerate_profile_kmers
            pq = ProfileQuery(qdb.get_data(qi).tobytes(),
                              comp_bias=p.comp_bias_corr)
            qnum_seed = pq.qnum
            qnum_ung = pq.qnum
            L = pq.L
            comp = np.zeros(L, dtype=np.float32)
        else:
            qnum_seed = seed.aa2num[np.asarray(qdb.get_seq(qi))]
            qnum_ung = ungapped.aa2num[np.asarray(qdb.get_seq(qi))]
            L = len(qnum_seed)
            # composition bias under the seed matrix (QueryMatcher.cpp:90-98)
            if p.comp_bias_corr:
                comp = calc_local_aa_bias(seed_sub8, seed.pback, qnum_seed)
            else:
                comp = np.zeros(L, dtype=np.float32)

        hits_t = hits_d = hits_c = None
        if is_profile_query:
            # per-window candidate lists from the sorted profile columns
            # (QueryMatcher with kmerGenerator->setDivideStrategy(profile),
            # QueryMatcher.h:67-69)
            w_starts, w_off, cand_kmer, _ = enumerate_profile_kmers(
                pq, positions, kmer_thr)
            cand_inst = np.repeat(np.arange(len(w_starts)), np.diff(w_off))
            starts = w_starts
            if len(cand_kmer):
                lo = np.searchsorted(index.uniq, cand_kmer)
                lo = np.minimum(lo, len(index.uniq) - 1) \
                    if len(index.uniq) else lo
                if len(index.uniq):
                    found = index.uniq[lo] == cand_kmer
                    lo, cand_inst = lo[found], cand_inst[found]
                    ecnt = index.counts[lo]
                    if int(ecnt.sum()):
                        span = int(positions[-1]) + 1
                        if p.diag_score:
                            hits_t, hits_d = match_candidates(
                                index, lo, ecnt, starts[cand_inst],
                                L - span, tdb.size)
                        else:
                            hits_t, hits_d, hits_c = match_candidates(
                                index, lo, ecnt, starts[cand_inst],
                                L - span, tdb.size, count_mode=True)
        else:
            starts, packed = extract_kmers(qnum_seed, positions, x_idx)
        if not is_profile_query and len(starts):
            # per-instance threshold: kmerThr - round(bias sum), with the
            # reference's float32 sequential accumulation over the spaced
            # positions (QueryMatcher.cpp:214-229: `float += float`)
            comp32 = comp.astype(np.float32)
            bias_sum = np.zeros(len(starts), dtype=np.float32)
            for j in positions:
                bias_sum = (bias_sum + comp32[starts + int(j)]).astype(
                    np.float32)
            bias_r = np.where(bias_sum < 0.0, bias_sum - np.float32(0.5),
                              bias_sum + np.float32(0.5)).astype(np.int16)
            inst_thr = np.maximum(kmer_thr - bias_r.astype(np.int32), 0)

            window = qnum_seed[starts[:, None] + positions[None, :]]
            if exact_matching:
                cand_kmer, cand_inst = _pack(window), np.arange(len(starts))
            else:
                ukm, inv = np.unique(window, axis=0, return_inverse=True)
                # minimum threshold across instances of each unique k-mer
                uthr = np.full(len(ukm), 2**30, dtype=np.int32)
                np.minimum.at(uthr, inv, inst_thr)
                off, cpk, csc = enumerate_similar(sub20, ukm, uthr)
                # expand per instance, filtering by the instance threshold
                cnt = np.diff(off)
                inst_rep = np.repeat(np.arange(len(starts)), cnt[inv])
                gather = _csr_gather(off, inv)
                cand_kmer = cpk[gather]
                keep = csc[gather] >= inst_thr[inst_rep]
                cand_kmer, cand_inst = cand_kmer[keep], inst_rep[keep]
            # join with target index
            lo = np.searchsorted(index.uniq, cand_kmer)
            lo = np.minimum(lo, len(index.uniq) - 1) if len(index.uniq) \
                else lo
            if len(index.uniq):
                found = index.uniq[lo] == cand_kmer
                lo, cand_inst = lo[found], cand_inst[found]
                ecnt = index.counts[lo]
                tot = int(ecnt.sum())
                if tot:
                    span = int(positions[-1]) + 1
                    if p.diag_score:
                        hits_t, hits_d = match_candidates(
                            index, lo, ecnt, starts[cand_inst], L - span,
                            tdb.size)
                    else:
                        hits_t, hits_d, hits_c = match_candidates(
                            index, lo, ecnt, starts[cand_inst], L - span,
                            tdb.size, count_mode=True)

        results = []
        identity_tid = None
        if same_db or p.add_self_matches:
            identity_tid = tkey_to_id.get(qkey)
        if hits_t is not None and len(hits_t) and not p.diag_score:
            # KMER_SCORE mode (diagonal scoring off): the prefilter score
            # is the per-target double-match count
            # (QueryMatcher.cpp:175-186, getResult<KMER_SCORE>)
            hist = np.bincount(np.minimum(hits_c, 255),
                               minlength=SCORE_RANGE)
            cum = 0
            thr = 0
            for sc in range(SCORE_RANGE - 1, 0, -1):
                cum += int(hist[sc])
                if cum >= max_seqs:
                    thr = sc
                    break
            thr = max(p.min_ungapped_score, thr)
            keep = hits_c >= thr
            if identity_tid is not None:
                keep &= hits_t != identity_tid
            ht, hc, dg = hits_t[keep], hits_c[keep], hits_d[keep]
            sdg = np.where(dg.astype(np.int32) < 32768, dg.astype(np.int32),
                           dg.astype(np.int32) - 65536)
            order = np.lexsort((ht, -np.abs(hc)))
            budget = max_seqs - (1 if identity_tid is not None else 0)
            for j in order[:budget]:
                results.append((int(tkeys[ht[j]]), int(hc[j]),
                                int(sdg[j])))
            if identity_tid is not None:
                results.insert(0, (qkey, 255, 0))
            out[qkey] = results
            continue
        if hits_t is not None and len(hits_t):
            # diagonal scoring with the 2-bit-factor matrix + comp/4 bias
            # (UngappedAlignment::createProfile, UngappedAlignment.cpp:322-331)
            if is_profile_query:
                # profile path: per-position alignment PSSM, zero bias
                # correction, X column contributes 0
                # (UngappedAlignment.cpp:295-345)
                bias8 = abs(min(int(pq.aln_profile.min()), 0))
                cap = 255 - bias8
                qprofile = np.zeros((L, sub2.shape[0]), dtype=np.int32)
                qprofile[:, :20] = pq.aln_profile.T.astype(np.int32)
            else:
                comp4 = np.where(comp < 0.0, comp / 4 - 0.5,
                                 comp / 4 + 0.5).astype(np.int8)
                bias8 = abs(int(sub2.min())) + abs(min(int(comp4.min()), 0))
                cap = 255 - bias8
                qprofile = sub2[qnum_ung] + comp4[:, None].astype(np.int32)
            sdiag = np.where(hits_d.astype(np.int32) < 32768,
                             hits_d.astype(np.int32),
                             hits_d.astype(np.int32) - 65536)
            exact = np.zeros(len(hits_t), dtype=np.int32)
            for tid in np.unique(hits_t):
                sel = hits_t == tid
                exact[sel] = diagonal_scores_exact(qprofile, tnums[tid],
                                                   sdiag[sel])
            stored = np.minimum(exact, cap)
            # per target keep the best diagonal
            # (keepMaxScoreElementOnly; ties keep the first entry)
            order = np.lexsort((np.arange(len(hits_t)), -stored, hits_t))
            ht, st, ex, dg = (hits_t[order], stored[order], exact[order],
                              hits_d[order])
            first = np.ones(len(ht), dtype=bool)
            first[1:] = ht[1:] != ht[:-1]
            ht, st, ex, dg = ht[first], st[first], ex[first], dg[first]
            # score threshold keeping <= max_seqs hits
            # (computeScoreThreshold, QueryMatcher.h:199-209)
            hist = np.bincount(np.minimum(st, 255), minlength=SCORE_RANGE)
            cum = 0
            thr = 0
            for sc in range(SCORE_RANGE - 1, 0, -1):
                cum += int(hist[sc])
                if cum >= max_seqs:
                    thr = sc
                    break
            thr = max(p.min_ungapped_score, thr)
            keep = st >= thr
            if identity_tid is not None:
                keep &= ht != identity_tid
            ht, st, ex, dg = ht[keep], st[keep], ex[keep], dg[keep]
            sdg = np.where(dg.astype(np.int32) < 32768, dg.astype(np.int32),
                           dg.astype(np.int32) - 65536)
            if thr >= cap and len(ht):
                # saturated-threshold rescale path (QueryMatcher.cpp:
                # 152-166 rescoreHits + getResult rescaleScore): scores are
                # re-expressed relative to the query self-score
                self_exact = int(diagonal_scores_exact(
                    qprofile, qnum_ung, np.array([0]))[0])
                max_self = max(1, min(self_exact - cap, 65535))
                new_score = np.minimum(ex - cap, 65535).astype(np.float32)
                count8 = ((new_score / np.float32(max_self))
                          * np.float32(255) + np.float32(0.5)).astype(
                              np.int64).astype(np.uint8)
                pref = cap + (count8.astype(np.int64) * max_self) // 255
            else:
                pref = ex
            order = np.lexsort((ht, -np.abs(pref)))
            budget = max_seqs - (1 if identity_tid is not None else 0)
            for j in order[:budget]:
                results.append((int(tkeys[ht[j]]), int(pref[j]),
                                int(sdg[j])))
        if identity_tid is not None:
            # identity raw score: USHRT_MAX in diagonal mode, UCHAR_MAX in
            # k-mer-count mode (QueryMatcher.cpp:343-353)
            results.insert(0, (qkey, 65535 if p.diag_score else 255, 0))
        if p.cov_thr > 0.0 and p.cov_mode in (0, 1, 5):
            # post-hoc length-ratio coverage filter applied when writing
            # hits (Prefiltering.cpp:835-842)
            results = [
                r for r in results
                if _can_be_covered_pref(
                    p.cov_thr, p.cov_mode, float(L),
                    float(tdb.seq_len(tkey_to_dbid[r[0]])))]
        out[qkey] = results
    return out


def _can_be_covered_pref(cov_thr, cov_mode, qlen, tlen):
    """Util::canBeCovered for the prefilter output filter."""
    from .rescore import _can_be_covered
    return _can_be_covered(cov_thr, cov_mode, qlen, tlen)


def _csr_gather(offsets, rows):
    """Indices into the CSR value array for each row in `rows`, expanded
    (concatenated ranges offsets[r]..offsets[r+1])."""
    cnt = np.diff(offsets)[rows]
    return _expand_ranges(offsets[rows], cnt)


def _expand_ranges(starts, counts):
    """Concatenate ranges [starts[i], starts[i]+counts[i]) as one array."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    idx = np.repeat(starts.astype(np.int64) + counts.astype(np.int64),
                    counts.astype(np.int64))
    off = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts, dtype=np.int64), counts.astype(np.int64))
    return idx + off


def prefilter_to_db(hits, qkeys=None):
    """Serialize prefilter hits as a prefilter-result DB
    (QueryMatcher::prefilterHitToBuffer, QueryMatcher.h:114-128)."""
    writer = seqdb.DBWriter(seqdb.PREFILTER_RES)
    keys = qkeys if qkeys is not None else sorted(hits)
    for qkey in keys:
        lines = []
        for (tkey, score, diag) in hits.get(qkey, []):
            lines.append(b"%d\t%d\t%d\n" % (tkey, score, diag))
        writer.write(qkey, b"".join(lines), add_newline=False)
    return writer.finish()


def ungapped_prefilter(qdb, tdb=None, eval_thr=1e-3, cov_thr=0.0, cov_mode=0,
                       min_diag_score=15, max_seqs=300, comp_bias_corr=True,
                       include_identity=False):
    """All-vs-all best ungapped-diagonal search (`ungappedprefilter`,
    lib/mmseqs/src/prefiltering/ungappedprefilter.cpp:23-162).

    Every query is scored against every target with the saturated-uint8
    ungapped diagonal DP (SmithWaterman::ungapped_alignment) run in the
    native batch kernel; hits pass when score > min_diag_score and the
    ALP E-value <= eval_thr (identity hits always pass when same-DB or
    include_identity). Output per query: hits sorted by (score desc,
    target key asc), truncated to max_seqs, formatted as prefilter
    records with diagonal 0.

    Returns {query_key: [(target_key, score, 0), ...]}.
    """
    import ctypes

    from ..native import lib as native_lib
    from .evalue import EvalueComputer
    from .protein_align import ProteinAligner

    same_db = tdb is None
    if tdb is None:
        tdb = qdb
    is_nucl = qdb.dbtype == seqdb.NUCLEOTIDES
    mat = constants.nucleotide() if is_nucl else constants.blosum62()
    evaluer = EvalueComputer.for_matrix(
        "nucleotide_ungapped" if is_nucl else "blosum62_ungapped",
        tdb.total_residues())
    # ssw_init applies the composition-bias correction regardless of the
    # query sequence type (StripedSmithWaterman.cpp:700-706 checks only
    # isProfile), so nucleotide queries get it too when enabled
    aligner = ProteinAligner(mat, comp_bias_corr)
    nat = native_lib()

    n_t = tdb.size
    tnums = [mat.aa2num[np.asarray(tdb.get_seq(i))] for i in range(n_t)]
    tlens = np.array([len(t) for t in tnums], dtype=np.int64)
    toffs = np.zeros(n_t, dtype=np.int64)
    if n_t:
        np.cumsum(tlens[:-1], out=toffs[1:])
    tdata = (np.concatenate(tnums).astype(np.uint8) if n_t
             else np.zeros(0, dtype=np.uint8))
    tkeys = np.asarray(tdb.keys, dtype=np.int64)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    out = {}
    for qid in range(qdb.size):
        qkey = int(qdb.keys[qid])
        qnum = mat.aa2num[np.asarray(qdb.get_seq(qid))]
        aligner.init_query(qnum)
        L = aligner.L
        # [A][L] linear byte profile = striped profile values in scalar order
        qprof = np.ascontiguousarray(
            (aligner.linear + aligner.bias).astype(np.uint8))
        cov_ok = np.array([_can_be_covered_pref(cov_thr, cov_mode, L, tl)
                           for tl in tlens], dtype=bool)
        sel = np.nonzero(cov_ok)[0].astype(np.int64)
        scores = np.zeros(len(sel), dtype=np.int32)
        if len(sel):
            so = np.ascontiguousarray(toffs[sel])
            sl = np.ascontiguousarray(tlens[sel])
            nat.ungapped_all(
                qprof.ctypes.data_as(u8p), L, mat.alphabet_size,
                ctypes.c_uint8(aligner.bias),
                tdata.ctypes.data_as(u8p), so.ctypes.data_as(i64p),
                sl.ctypes.data_as(i64p), len(sel),
                scores.ctypes.data_as(i32p))
        evalues = evaluer.evalue(scores, L) if len(sel) else scores
        keep = (scores > min_diag_score) & (evalues <= eval_thr)
        if same_db or include_identity:
            keep |= tkeys[sel] == qkey
        ks = sel[keep]
        hit_scores = scores[keep]
        hit_keys = tkeys[ks]
        order = np.lexsort((hit_keys, -hit_scores))[:max_seqs]
        out[qkey] = [(int(hit_keys[i]), int(hit_scores[i]), 0)
                     for i in order]
    return out


def index_file_name(base):
    """PrefilteringIndexReader::indexName: <targetDB>.idx."""
    return base + ".idx"


def save_prefilter_index(index, base_out, kmer_thr, mask, spaced,
                         seq_type, max_seq_len=65535, comp_bias=1):
    """indexdb (util/indexdb.cpp:42-155) with a TPU-native payload: the
    inverted k-mer table plus the (masked) numeric target sequences."""
    out = index_file_name(base_out)
    num_off = np.zeros(len(index.nums) + 1, dtype=np.int64)
    for i, nn in enumerate(index.nums):
        num_off[i + 1] = num_off[i] + len(nn)
    flat = np.concatenate(index.nums) if index.nums else \
        np.zeros(0, dtype=np.uint8)
    np.savez(out + ".npz",
             kmers=index.kmers, sid=index.sid, pos=index.pos,
             order=index.order,
             nums=flat.astype(np.uint8), num_off=num_off,
             meta=np.array([index.kmer_size, kmer_thr, int(mask),
                            int(spaced), seq_type, max_seq_len,
                            int(comp_bias)], dtype=np.int64))
    w = seqdb.DBWriter(seqdb.INDEX_DB)
    w.write(0, b"plass_tpu-idx-v1\n", add_newline=False)
    w.finish().save(out)
    return out


def load_prefilter_index(base, kmer_size, kmer_thr, mask, spaced,
                         seq_type=None, comp_bias=None):
    """Load a precomputed index if present and parameter-compatible
    (indexdb.cpp findIncompatibleParameter:16-40); None otherwise. The
    reference's gate also rejects on compBiasCorrection and seqType —
    compare them too when the caller knows them (meta[4]/meta[6])."""
    path = index_file_name(base) + ".npz"
    if not os.path.exists(path):
        return None
    d = np.load(path)
    meta = d["meta"]
    if (int(meta[0]) != kmer_size or int(meta[1]) != kmer_thr
            or int(meta[2]) != int(mask) or int(meta[3]) != int(spaced)):
        return None
    if seq_type is not None and int(meta[4]) != int(seq_type):
        return None
    if comp_bias is not None and len(meta) > 6 \
            and int(meta[6]) != int(comp_bias):
        return None
    idx = KmerIndex.__new__(KmerIndex)
    idx.kmers = d["kmers"]
    idx.sid = d["sid"]
    idx.pos = d["pos"]
    off = d["num_off"]
    flat = d["nums"]
    idx.nums = [flat[off[i]:off[i + 1]] for i in range(len(off) - 1)]
    idx.order = (d["order"] if "order" in d.files
                 else np.arange(len(off) - 1, dtype=np.int64))
    idx.uniq, idx.starts = np.unique(idx.kmers, return_index=True)
    idx.counts = np.diff(np.append(idx.starts, len(idx.kmers)))
    idx.kmer_size = kmer_size
    idx.positions = spaced_positions(kmer_size, spaced)
    return idx
