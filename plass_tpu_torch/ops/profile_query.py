"""Profile-query support for prefilter and align.

Reference: Sequence::mapProfile with mapScores=true (Sequence.cpp:276-363)
turns an HMM-profile record into the k-mer-stage PSSM (profile_score,
sorted per position by rankedDescSort20 together with its residue index)
and the alignment PSSM (profile_for_alignment, /4-scaled int8, aa-major).
The k-mer candidate generator enumerates, per spaced window, every k-mer
whose summed per-position profile score reaches the k-mer threshold,
emitting candidates in the KmerGenerator product order — per position the
sorted-column rank order (KmerGenerator::setDivideStrategy(ScoreMatrix**),
KmerGenerator.cpp:30-39).
"""
import ctypes

import numpy as np

from .. import constants
from ..native import lib

_I16P = ctypes.POINTER(ctypes.c_int16)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_I8P = ctypes.POINTER(ctypes.c_int8)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)


class ProfileQuery:
    """Decoded profile record ready for prefilter/align use."""

    __slots__ = ("qnum", "consensus", "L", "sorted_scores", "sorted_index",
                 "aln_profile")

    def __init__(self, data, comp_bias=True, pca=1.0, pcb=1.5, mat=None):
        from .profiledb import read_profile
        nat = lib()
        if mat is None:
            mat = constants.blosum62()
        rec = read_profile(bytes(data), add_pc=pca > 0.0, pca=pca, pcb=pcb)
        prob = np.ascontiguousarray(rec["prob"], dtype=np.float32)
        L = prob.shape[0]
        self.L = L
        self.qnum = rec["query"].astype(np.uint8)
        self.consensus = rec["consensus"].astype(np.uint8)
        pback = np.ascontiguousarray(mat.pback[:20], dtype=np.float64)
        self.sorted_scores = np.zeros((L, 20), dtype=np.int16)
        self.sorted_index = np.zeros((L, 20), dtype=np.uint32)
        self.aln_profile = np.zeros((20, L), dtype=np.int8)
        nat.pq_map_profile(
            prob.ctypes.data_as(_F32P), pback.ctypes.data_as(_F64P), L,
            1 if comp_bias else 0,
            self.sorted_scores.ctypes.data_as(_I16P),
            self.sorted_index.ctypes.data_as(_U32P),
            self.aln_profile.ctypes.data_as(_I8P))


def enumerate_profile_kmers(pq, positions, threshold):
    """Per-window k-mer candidates above threshold in KmerGenerator order.

    positions: spaced k-mer sample offsets. Returns (win_starts int64[N],
    offsets int64[N+1], packed uint64[C], scores int32[C]) where window i's
    candidates are packed[offsets[i]:offsets[i+1]], packed base-21 like
    ops.prefilter._pack.
    """
    k = len(positions)
    span = int(positions[-1]) + 1
    L = pq.L
    n_win = L - span + 1
    starts = np.arange(max(0, n_win), dtype=np.int64)
    if n_win <= 0:
        return (np.zeros(0, np.int64), np.zeros(1, np.int64),
                np.zeros(0, np.uint64), np.zeros(0, np.int32))

    sscores = pq.sorted_scores.astype(np.int32)   # [L, 20] desc per pos
    sindex = pq.sorted_index.astype(np.uint64)    # [L, 20]
    col_max = sscores[:, 0]                       # max per position

    # per window: columns at starts+positions
    win_cols = starts[:, None] + np.asarray(positions, dtype=np.int64)[None, :]
    wmax = col_max[win_cols]                      # [N, k]
    suffix_max = np.zeros((len(starts), k + 1), dtype=np.int32)
    suffix_max[:, :k] = wmax[:, ::-1].cumsum(axis=1)[:, ::-1]

    rows = np.arange(len(starts), dtype=np.int64)
    scores = np.zeros(len(starts), dtype=np.int32)
    packed = np.zeros(len(starts), dtype=np.uint64)
    # rank path per position (for the emission order)
    rank_keys = [np.zeros(0, dtype=np.int64)] * k
    ranks = np.zeros((len(starts), 0), dtype=np.int8)
    alive = suffix_max[:, 0] >= threshold
    rows, scores, packed = rows[alive], scores[alive], packed[alive]
    ranks = np.zeros((len(rows), 0), dtype=np.int8)
    for i in range(k):
        cols = win_cols[rows, i]
        col_scores = sscores[cols]                # [F, 20] sorted desc
        new_scores = scores[:, None] + col_scores
        bound = new_scores + suffix_max[rows, i + 1][:, None]
        keep = bound >= threshold
        f_idx, rank = np.nonzero(keep)
        rows = rows[f_idx]
        scores = new_scores[f_idx, rank]
        res = sindex[win_cols[rows, i], rank]
        packed = packed[f_idx] * np.uint64(21) + res
        ranks = np.concatenate(
            [ranks[f_idx], rank.astype(np.int8)[:, None]], axis=1)
        if not len(rows):
            break
    # emission order: per-position rank, earlier positions vary slowest
    # (chunk size 1 per position, KmerGenerator.cpp:30-39)
    sort_keys = [ranks[:, i] for i in range(ranks.shape[1] - 1, -1, -1)]
    sort_keys.append(rows)
    order = np.lexsort(sort_keys)
    rows, scores, packed = rows[order], scores[order], packed[order]
    offsets = np.zeros(len(starts) + 1, dtype=np.int64)
    np.add.at(offsets, rows + 1, 1)
    offsets = offsets.cumsum()
    return starts, offsets, packed, scores
