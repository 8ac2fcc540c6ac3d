"""Device k-mer matcher (protein) — the hot path of every assembly
iteration, in torch.

Same semantics as the JAX package's ops/device_kmer.py (monolithic path;
reference: linclust/kmermatcher.cpp):

 A. per sequence, pick the k-mers with the smallest 16-bit XXH64 hashes
    (select_kmers) and flatten them with one whole-sequence hash entry per
    sequence into a table (kmermatcher.cpp:221-347);
 B. sort the table by (k-mer, length desc, id, pos), give every k-mer group
    its first entry as representative and emit (rep, target, diagonal)
    pairs (pairs_from_table, kmermatcher.cpp:406-558), then sort the pairs
    stably by (rep, target, diagonal) (sort_pairs);
 C. per (rep, target), the most frequent diagonal and the entry count
    (best_diagonal_hits, kmermatcher.cpp:870-913).

The segmented scans of B and C run in kernel K1 (ops/seg_scan.py); sorts,
gathers and elementwise work are torch ops.

uint64 k-mer values live in int64. Wherever the JAX package compares them
as unsigned, the port sorts `x ^ INT64_MIN`, which orders signed int64
exactly as the uint64 bits order unsigned; the invalid sentinel 2^64-1 maps
to INT64_MAX and sorts last. Tensors have their exact sizes: no shape
buckets, no hit capacity, and invalid entries are dropped instead of being
carried to the end of every sort.
"""
from dataclasses import dataclass

import torch

from .hashes import seq_hash_torch, xxh64_u64_torch
from .seg_scan import seg_scan

INVALID_HASH = 1 << 20
INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1
# packed sort keys below hold a length, a position or a diagonal in 16 bits
# and a sequence key in 31 bits
MAX_LEN = 1 << 16
MAX_KEY = 1 << 31
# rows of the selection stage handled at once: bounds its [rows, positions]
# temporaries (about a dozen 8-byte arrays) to a few GB
SELECT_CELLS = 1 << 26


@dataclass(frozen=True)
class KmerParams:
    k: int
    alphabet_size: int
    kmers_per_sequence: int
    kmers_per_sequence_scale: float
    ignore_multi_kmer: bool = True
    include_only_extendable: bool = True
    cov_thr: float = 0.0
    ksel: int = 64  # per-row selection capacity


def ksel_capacity(kps, scale, lmax):
    """Per-sequence selection capacity covering kc for every length."""
    return int(kps - 1 + scale * lmax) + 1


# ---------------------------------------------------------------------------
# Stage A: per-sequence k-mer extraction + smallest-hash selection
# ---------------------------------------------------------------------------

def _extract_kmers(seqs, lengths, k, alphabet_size):
    """seqs: uint8[N, L] reduced-alphabet codes (X = alpha-1), L >= k.
    Returns (kmer int64[N, P], valid bool[N, P]) with P = L-k+1."""
    n, lmax = seqs.shape
    p = lmax - k + 1
    x_code = alphabet_size - 1
    contains_x = torch.zeros((n, p), dtype=torch.bool, device=seqs.device)
    kidx = torch.zeros((n, p), dtype=torch.int64, device=seqs.device)
    pw = 1
    for i in range(k):
        w = seqs[:, i:i + p]
        contains_x |= w == x_code
        kidx += w.to(torch.int64) * pw
        pw *= alphabet_size - 1
    pos = torch.arange(p, device=seqs.device)
    in_range = pos[None, :] < (lengths[:, None] - k + 1)
    return kidx, in_range & ~contains_x


# The reference's duplicate-skip loop (kmermatcher.cpp:277-301) processes
# the first entry AFTER a run of equal k-mers without re-checking it — a
# 3-state machine over each row in selection order (TOP=0, SKIP=1, LAND=2):
#   TOP: next equal -> SKIP, else process;  SKIP: last of run -> LAND;
#   LAND: process unconditionally -> TOP.
# Each element is a function on the 3 states, coded f(0) + 3 f(1) + 9 f(2):
# equal-next maps (0,1,2) -> (1,1,0), code 4; otherwise (0,2,0), code 6.
# The state entering element i is the composition of the functions before
# it applied to TOP, so a log-depth doubling scan of compositions over the
# columns replaces the JAX package's lax.scan over every column.
_F_EQ, _F_NE = 4, 6


def _compose_table(device):
    """comp[a * 27 + b] = code of (b after a)."""
    imgs = [(c % 3, c // 3 % 3, c // 9) for c in range(27)]
    lut = [0] * 729
    for a in range(27):
        for b in range(27):
            r = [imgs[b][imgs[a][s]] for s in range(3)]
            lut[a * 27 + b] = r[0] + 3 * r[1] + 9 * r[2]
    return torch.tensor(lut, dtype=torch.int64, device=device)


def _dup_skip_processed(eq_next):
    """bool[N, P]: which entries the duplicate-skip state machine processes."""
    n, p = eq_next.shape
    comp = _compose_table(eq_next.device)
    fn = torch.where(eq_next, _F_EQ, _F_NE).to(torch.int64)
    d = 1
    while d < p:  # inclusive prefix compositions
        fn = torch.cat([fn[:, :d], comp[fn[:, :-d] * 27 + fn[:, d:]]], dim=1)
        d *= 2
    state = torch.zeros_like(fn)
    state[:, 1:] = fn[:, :-1] % 3   # prefix function applied to TOP
    return ((state == 0) & ~eq_next) | (state == 2)


def select_kmers(seqs, lengths, params: KmerParams, hash_shift):
    """Per-sequence smallest-hash selection (kmermatcher.cpp:221-347) for a
    block of rows.

    Returns the selected entries flattened row by row in selection order —
    (row int64[S], kmer int64[S], pos int32[S]) — and the whole-sequence
    hash int64[N] (uint64 bits)."""
    n, _ = seqs.shape
    kmer, valid = _extract_kmers(seqs, lengths, params.k,
                                 params.alphabet_size)
    h16 = (xxh64_u64_torch(kmer, hash_shift) & 0xFFFF).to(torch.int32)
    h16 = torch.where(valid, h16, INVALID_HASH)

    # float32 arithmetic exactly as the reference (kmermatcher.cpp:223)
    kc_f = (torch.tensor(params.kmers_per_sequence - 1, dtype=torch.float32)
            + torch.tensor(params.kmers_per_sequence_scale,
                           dtype=torch.float32) * lengths.to(torch.float32))
    kc = torch.minimum(kc_f.to(torch.int32), valid.sum(dim=1).to(torch.int32))

    # selection order (hash, k-mer as uint64, pos): positions are already
    # ascending along the row, so a stable sort by k-mer and then a stable
    # sort by hash give the total lexicographic order
    mk = torch.where(valid, kmer ^ INT64_MIN, INT64_MAX)
    order = torch.sort(mk, dim=1, stable=True).indices
    order = order.gather(1, torch.sort(h16.gather(1, order), dim=1,
                                       stable=True).indices)
    s_h = h16.gather(1, order)
    s_mk = mk.gather(1, order)

    # threshold = kc-th smallest hash; tooMuch = |{h <= h_kc}| - kc
    h_kc = s_h.gather(1, (kc.long() - 1).clamp(min=0)[:, None])[:, 0]
    h_kc = torch.where(kc > 0, h_kc, -1)
    too_much = (h16 <= h_kc[:, None]).sum(dim=1).to(torch.int32) - kc

    if params.ignore_multi_kmer:
        eq_next = torch.zeros_like(valid)
        eq_next[:, :-1] = s_mk[:, :-1] == s_mk[:, 1:]
        processed = _dup_skip_processed(eq_next)
    else:
        processed = torch.ones_like(valid)

    s_elig = (s_h < INVALID_HASH) & processed
    nonb = s_elig & (s_h < h_kc[:, None])
    bnd = s_elig & (s_h == h_kc[:, None])
    r_all = torch.cumsum((nonb | bnd).to(torch.int32), dim=1)
    r_bnd = torch.cumsum(bnd.to(torch.int32), dim=1)
    tm = too_much[:, None]
    sel = (nonb | (bnd & ((tm == 0) | (r_bnd <= tm)))) & (r_all <= kc[:, None])

    rows, cols = sel.nonzero(as_tuple=True)   # row-major: selection order
    pos = order[rows, cols]
    seq_hash = xxh64_u64_torch(seq_hash_torch(seqs, lengths), hash_shift)
    return rows, kmer[rows, pos], pos.to(torch.int32), seq_hash


def build_table(seqs, lengths, keys, params: KmerParams, hash_shift):
    """Selected k-mers + one whole-sequence hash entry per non-empty
    sequence -> flat table (kmer int64, sid int32, pos int32, len int32),
    valid entries only. Rows are selected in blocks of SELECT_CELLS."""
    n, width = seqs.shape
    block = max(SELECT_CELLS // max(width, 1), 1)
    parts = []
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        rows, kmer, pos, seq_hash = select_kmers(
            seqs[lo:hi], lengths[lo:hi], params, hash_shift)
        rows = rows + lo
        parts.append((kmer, keys[rows], pos, lengths[rows]))
        nonempty = lengths[lo:hi] > 0
        sids = keys[lo:hi][nonempty]
        parts.append((seq_hash[nonempty], sids, torch.zeros_like(sids),
                      lengths[lo:hi][nonempty]))
    return tuple(torch.cat([p[i] for p in parts]) for i in range(4))


# ---------------------------------------------------------------------------
# Stage B: table -> (rep, target, diagonal) pairs
# ---------------------------------------------------------------------------

def sort_table(kmer, sid, pos, slen):
    """Sort the table by (kmer as uint64, len desc, sid, pos). Returns
    (new_group, sid, pos, len) in that order; new_group marks the first
    entry of each k-mer group (new_group[0] is set)."""
    # sort the packed (len desc, sid, pos) key, then stably by k-mer.
    # Entries equal on all of it are identical, so the first sort need
    # not be stable.
    sec = (((MAX_LEN - 1 - slen.to(torch.int64)) << 47)
           | (sid.to(torch.int64) << 16) | pos.to(torch.int64))
    order = torch.argsort(sec)
    ks, o2 = torch.sort(kmer[order] ^ INT64_MIN, stable=True)
    order = order[o2]
    new_group = torch.ones(kmer.numel(), dtype=torch.bool, device=kmer.device)
    new_group[1:] = ks[1:] != ks[:-1]
    return new_group, sid[order], pos[order], slen[order]


def pairs_from_table(kmer, sid, pos, slen, params: KmerParams):
    """Sort the table, assign representatives, emit the kept pairs
    (kmermatcher.cpp:406-558). Returns (rep, tgt, diag) int32 of the kept
    entries, in table order."""
    new_group, sid_s, pos_s, len_s = sort_table(kmer, sid, pos, slen)
    # the first entry of each group is its representative: carry its
    # (id, pos, len) down the group
    rep_id, rep_pos, rep_len = seg_scan("first", new_group, sid_s, pos_s,
                                        len_s)
    # singleton groups are dropped (kmermatcher.cpp:476-478)
    same_next = torch.zeros_like(new_group)
    same_next[:-1] = ~new_group[1:]
    keep = ~new_group | same_next
    diagonal = rep_pos - pos_s
    if params.include_only_extendable:
        keep &= (diagonal < 0) | (diagonal > (rep_len - len_s))
    elif params.cov_thr > 0.0:
        big = torch.maximum(rep_len, len_s).to(torch.float32)
        small = torch.minimum(rep_len, len_s).to(torch.float32)
        keep &= small / big >= params.cov_thr
    return rep_id[keep], sid_s[keep], diagonal[keep]


def sort_pairs(rep, tgt, diag):
    """Stable sort by (rep, tgt, diag): equal pairs keep table order. Two
    stable passes, least significant key first."""
    k2 = (tgt.to(torch.int64) << 18) | (diag.to(torch.int64) + (1 << 17))
    order = torch.sort(k2, stable=True).indices
    order = order[torch.sort(rep[order], stable=True).indices]
    return rep[order], tgt[order], diag[order]


# ---------------------------------------------------------------------------
# Stage C: best diagonal per (rep, target)
# ---------------------------------------------------------------------------

def _next(x, fill):
    """x shifted one towards lower indices; `fill` at the end."""
    out = torch.empty_like(x)
    out[:-1] = x[1:]
    out[-1:] = fill
    return out


def best_diagonal_hits(rep, tgt, diag):
    """Per (rep, target): most frequent diagonal + entry count
    (kmermatcher.cpp:870-913) over sorted, kept pairs, including the
    reference's run-absorb quirk: the run scan checks only the TARGET id,
    so a hit absorbs the following rep's entries when the same target sits
    at the boundary.

    Returns (rep, tgt, score, diag) int32 of the hits — one per (rep, tgt)
    segment start, self pairs excluded — in pair order."""
    t = rep.numel()
    dev = rep.device
    idx = torch.arange(t, dtype=torch.int32, device=dev)
    rev = torch.zeros(t, dtype=torch.int32, device=dev)  # protein: forward
    tgt_change = torch.ones(t, dtype=torch.bool, device=dev)
    tgt_change[1:] = tgt[1:] != tgt[:-1]
    pair_change = tgt_change.clone()
    pair_change[1:] |= rep[1:] != rep[:-1]
    run_change = tgt_change.clone()
    run_change[1:] |= diag[1:] != diag[:-1]
    # segment-end flags: the reverse scans' segment starts
    run_last = _next(run_change, True)
    tgt_last = _next(tgt_change, True)

    (run_first,) = seg_scan("cummax", run_change,
                            torch.where(run_change, idx, -1))
    run_end, rev_end = seg_scan("first", run_last, idx, rev, reverse=True)
    (m,) = seg_scan("cummax", tgt_last,
                    torch.where(tgt_last, (t - 1) - idx, -1), reverse=True)
    tgt_end = (t - 1) - m

    # per-entry key: (run-local count, position<<1|rev) — position encodes
    # the reference's ">= updates, latest wins" tie-break; diag rides along
    c = idx - run_first + 1
    pk = (idx << 1) | rev
    sfx_c, sfx_pk, sfx_diag = seg_scan("sfx2", tgt_last, c, pk, diag,
                                       reverse=True)

    # later-runs candidate: the suffix max evaluated at the start of the
    # NEXT run in the same target segment
    pick = _next(run_change, False) & ~tgt_last
    a_c = torch.where(pick, _next(sfx_c, -1), -1)
    a_pk = torch.where(pick, _next(sfx_pk, -1), -1)
    a_diag = _next(sfx_diag, -1)
    b_c, b_pk, b_diag = seg_scan("sfx2", tgt_last, a_c, a_pk, a_diag,
                                 reverse=True)

    # own-run candidate, clipped to start at this entry
    ca_c = run_end - idx + 1
    ca_pk = (run_end << 1) | rev_end
    b_wins = (b_c > ca_c) | ((b_c == ca_c) & (b_pk > ca_pk))
    best_diag = torch.where(b_wins, b_diag, diag)
    best_rev = torch.where(b_wins, b_pk & 1, rev_end) != 0

    top_score = tgt_end - idx + 1
    score = torch.where(best_rev, -top_score, top_score)
    hit = pair_change & (rep != tgt)
    return rep[hit], tgt[hit], score[hit], best_diag[hit]


def kmermatch_device(seqs, lengths, keys, hash_shift, params: KmerParams):
    """Full device k-mer matcher on one device.

    seqs uint8[N, L] (L >= k), lengths int32[N] (< 2^16), keys int32[N]
    (ascending, < 2^31). Returns (rep, tgt, score, diag) int32[H] — hits
    grouped by ascending rep key — and the number of table entries."""
    kmer, sid, pos, slen = build_table(seqs, lengths, keys, params,
                                       hash_shift)
    rep, tgt, diag = sort_pairs(*pairs_from_table(kmer, sid, pos, slen,
                                                  params))
    if rep.numel() == 0:
        return rep, tgt, diag.clone(), diag, kmer.numel()
    return (*best_diagonal_hits(rep, tgt, diag), kmer.numel())
