"""Device k-mer matcher (protein and nucleotide) — the hot path of every
assembly iteration, in torch.

Same semantics as the JAX package's ops/device_kmer.py (reference:
linclust/kmermatcher.cpp):

 A. per sequence, pick the k-mers with the smallest 16-bit XXH64 hashes
    (select_kmers) and flatten them with one whole-sequence hash entry per
    sequence into a table (kmermatcher.cpp:221-347);
 B. sort the table by (k-mer, length desc, id, pos), give every k-mer group
    its first entry as representative and emit (rep, target, diagonal,
    reverse) pairs (pairs_from_table, kmermatcher.cpp:406-558), then sort
    the pairs stably by (rep, target, diagonal) (sort_pairs);
 C. per (rep, target), the most frequent diagonal and the entry count
    (best_diagonal_hits, kmermatcher.cpp:870-913); the score's sign marks
    a reverse-strand hit.

Nucleotide k-mers are 2-bit packed and canonical: the smaller of the
k-mer and its reverse complement, with bit 63 set when the forward strand
was picked (kmermatcher.cpp:221-263). Palindromes are dropped. Both strands
of a k-mer form one group (bit 63 is masked off for grouping), and a pair
is reverse when its representative and target were picked on different
strands.

The segmented scans of B and C run in kernel K1 (ops/seg_scan.py); sorts,
gathers and elementwise work are torch ops.

Memory-bounded split (kmermatcher.cpp:594-779): every table entry carries a
16-bit range key, the low 16 bits of the hash that selected it (a k-mer
group shares one key, both strands included, so no group straddles two
ranges). With a budget, the key space is cut by the exact histogram into
ranges of at most `budget` entries; B runs per range on the resident
table, and the kept pairs of all ranges are merged through C in buckets of
whole representatives, so that neither the table's sort nor the merge
ever works on more than about `budget` elements at once.

uint64 k-mer values live in int64. Wherever the JAX package compares them
as unsigned, the port sorts `x ^ INT64_MIN`, which orders signed int64
exactly as the uint64 bits order unsigned; the invalid sentinel 2^64-1 maps
to INT64_MAX and sorts last. Tensors have their exact sizes: no shape
buckets, no hit capacity, and invalid entries are dropped instead of being
carried to the end of every sort.
"""
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.trace import span
from .hashes import seq_hash_torch, xxh64_u64_torch
from .seg_scan import seg_scan

INVALID_HASH = 1 << 20
INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1
# packed sort keys below hold a length, a position or a diagonal in 18 bits
# (the nucleotide workflow's --max-seq-len is 200,000) and a sequence key in
# 31 bits
MAX_LEN = 1 << 18
MAX_KEY = 1 << 31
# rows of the selection stage handled at once: bounds its [rows, positions]
# temporaries (about a dozen 8-byte arrays) to a few GB
SELECT_CELLS = 1 << 26
# bins of the split path's range keys
RANGE_BINS = 1 << 16


@dataclass(frozen=True)
class KmerParams:
    k: int
    alphabet_size: int
    kmers_per_sequence: int
    kmers_per_sequence_scale: float
    is_nucl: bool = False
    ignore_multi_kmer: bool = True
    include_only_extendable: bool = True
    cov_thr: float = 0.0
    cov_mode: int = 0
    ksel: int = 64  # per-row selection capacity


def ksel_capacity(kps, scale, lmax):
    """Per-sequence selection capacity covering kc for every length."""
    return int(kps - 1 + scale * lmax) + 1


# ---------------------------------------------------------------------------
# Stage A: per-sequence k-mer extraction + smallest-hash selection
# ---------------------------------------------------------------------------

def _extract_kmers(seqs, lengths, k, alphabet_size, is_nucl):
    """seqs: uint8[N, L] alphabet codes (X = alpha-1), L >= k. Returns
    (stored k-mer int64[N, P], stored pos int64[N, P], canonical k-mer
    int64[N, P], valid bool[N, P]) with P = L-k+1. The hash is taken on
    the canonical k-mer; the table stores the stored k-mer and position.
    Protein k-mers are base-(alpha-1) numbers stored as they are."""
    n, lmax = seqs.shape
    p = lmax - k + 1
    x_code = alphabet_size - 1
    contains_x = torch.zeros((n, p), dtype=torch.bool, device=seqs.device)
    kidx = torch.zeros((n, p), dtype=torch.int64, device=seqs.device)
    pw = 1
    for i in range(k):
        w = seqs[:, i:i + p]
        contains_x |= w == x_code
        if is_nucl:
            kidx = (kidx << 2) | w.to(torch.int64)
        else:
            kidx += w.to(torch.int64) * pw
            pw *= alphabet_size - 1
    pos = torch.arange(p, device=seqs.device).expand(n, p)
    valid = (pos < (lengths[:, None] - k + 1)) & ~contains_x
    if not is_nucl:
        return kidx, pos, kidx, valid
    rev = _revcomp_packed(kidx, k)
    valid &= rev != kidx                 # palindromes are dropped
    pick_rev = rev < kidx                # both < 2^(2k): signed order is fine
    canon = torch.where(pick_rev, rev, kidx)
    store_pos = torch.where(pick_rev, lengths[:, None].long() - pos - k, pos)
    store_kmer = torch.where(pick_rev, canon, canon | INT64_MIN)
    return store_kmer, store_pos, canon, valid


def _revcomp_packed(kmer, k):
    """Reverse complement of 2-bit packed k-mers (code ^ 2 complements
    A/T and C/G in the nucleotide alphabet ACTG)."""
    out = torch.zeros_like(kmer)
    v = kmer
    for _ in range(k):
        out = (out << 2) | ((v ^ 2) & 3)
        v = v >> 2
    return out


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
    (row int64[S], stored k-mer int64[S], stored pos int32[S]) —, the
    whole-sequence hash int64[N] (uint64 bits) and the selected entries'
    16-bit range keys int32[S] (the selection hash)."""
    n, _ = seqs.shape
    store_kmer, store_pos, canon, valid = _extract_kmers(
        seqs, lengths, params.k, params.alphabet_size, params.is_nucl)
    h16 = (xxh64_u64_torch(canon, hash_shift) & 0xFFFF).to(torch.int32)
    h16 = torch.where(valid, h16, INVALID_HASH)

    # float32 arithmetic exactly as the reference (kmermatcher.cpp:223)
    kc_f = (torch.tensor(params.kmers_per_sequence - 1, dtype=torch.float32)
            + torch.tensor(params.kmers_per_sequence_scale,
                           dtype=torch.float32) * lengths.to(torch.float32))
    kc = torch.minimum(kc_f.to(torch.int32), valid.sum(dim=1).to(torch.int32))

    # selection order (hash, k-mer as uint64, stored pos, column): stable
    # sorts from the least significant key up, starting from the column
    # order. The k-mer key has bit 63 forced on (kmermatcher.cpp:277-301
    # compares the strand-masked k-mer): for nucleotides that leaves the
    # canonical k-mer; protein stored positions are the columns already.
    if params.is_nucl:
        mk = torch.where(valid, canon, INT64_MAX)
        order = torch.sort(store_pos, dim=1, stable=True).indices
        order = order.gather(1, torch.sort(mk.gather(1, order), dim=1,
                                           stable=True).indices)
    else:
        mk = torch.where(valid, store_kmer ^ INT64_MIN, INT64_MAX)
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
    col = order[rows, cols]
    seq_hash = xxh64_u64_torch(seq_hash_torch(seqs, lengths), hash_shift)
    return (rows, store_kmer[rows, col], store_pos[rows, col].to(torch.int32),
            seq_hash, h16[rows, col])


def gather_rows(rows, offsets, lengths, code_lut, idx, width, x_code):
    """uint8[len(idx), width]: the alphabet codes of rows `idx`, read from
    the flat bytes through code_lut, X from each row's length on."""
    j = torch.arange(width, device=rows.device)
    pos = (offsets[idx][:, None] + j).clamp(max=rows.numel() - 1)
    codes = code_lut[rows[pos].int()]
    return codes.masked_fill_(j >= lengths[idx][:, None], x_code)


def build_table(rows, offsets, lengths, code_lut, keys, params: KmerParams,
                hash_shift):
    """Selected k-mers + one whole-sequence hash entry per non-empty
    sequence -> flat table (kmer int64, sid int32, pos int32, len int32,
    range key int32), valid entries only. A selected k-mer's range key is
    its selection hash, a whole-sequence entry's the low 16 bits of its
    hash value (the JAX package's select_table_h16). The sequences come as
    the database holds them:
    rows uint8[T] back to back, row r the lengths[r] bytes from
    rows[offsets[r]], a residue's code code_lut[byte]. Rows are selected
    longest first, in blocks of at most SELECT_CELLS cells; each block is
    gathered on the device to [rows, w] codes, only as wide as its longest
    row (at least k): the reads a nucleotide DB keeps beside its long
    contigs are never padded to the contigs' width, on either side. Entry
    order does not matter: sort_table orders the table totally."""
    n = lengths.numel()
    lens_h = lengths.cpu()
    order = torch.argsort(lens_h, descending=True, stable=True)
    lens_h = lens_h[order]
    parts = []
    lo = 0
    while lo < n:
        w = max(int(lens_h[lo]), params.k)
        hi = min(lo + max(SELECT_CELLS // w, 1), n)
        idx = order[lo:hi].to(rows.device)
        blk_len = lengths[idx]
        sel_rows, kmer, pos, seq_hash, h16 = select_kmers(
            gather_rows(rows, offsets, lengths, code_lut, idx, w,
                        params.alphabet_size - 1),
            blk_len, params, hash_shift)
        sel_rows = idx[sel_rows]
        parts.append([kmer, keys[sel_rows], pos, lengths[sel_rows], h16])
        nonempty = blk_len > 0
        sids = keys[idx][nonempty]
        seq_hash = seq_hash[nonempty]
        parts.append([seq_hash, sids, torch.zeros_like(sids),
                      blk_len[nonempty], (seq_hash & 0xFFFF).to(torch.int32)])
        lo = hi
    if not parts:
        empty = torch.zeros(0, dtype=torch.int32, device=rows.device)
        return empty.long(), empty, empty, empty, empty
    return tuple(_join(parts))


def _join(parts):
    """The column-wise concatenation of blocks (lists of columns), one
    column at a time, each block's copy freed as it is joined: the columns
    are never held twice."""
    out = []
    for i in range(len(parts[0])):
        out.append(torch.cat([p[i] for p in parts]))
        for p in parts:
            p[i] = None
    return out


# ---------------------------------------------------------------------------
# Stage B: table -> (rep, target, diagonal, reverse) pairs
# ---------------------------------------------------------------------------

def sort_table(kmer, sid, pos, slen, is_nucl):
    """Sort the table by (k-mer as uint64, len desc, sid, pos, fwd), where
    fwd is bit 63 of the stored k-mer and, for nucleotides, the k-mer key
    has bit 63 forced on (kmermatcher.cpp:406-436): both strands of a
    k-mer form one group. Returns (new_group, sid, pos, len, fwd) in that
    order; new_group marks the first entry of each k-mer group
    (new_group[0] is set)."""
    # three passes from the least significant key up: (sid, pos, fwd)
    # packed in 50 bits, then length descending and the k-mer, both stable.
    # Entries equal on (sid, pos, fwd) and on the k-mer are identical, so
    # the first sort need not be stable.
    fwd = (kmer < 0).to(torch.int32)
    order = torch.argsort((sid.to(torch.int64) << 19)
                          | (pos.to(torch.int64) << 1) | fwd)
    order = order[torch.sort(-slen[order], stable=True).indices]
    key = (kmer & INT64_MAX) if is_nucl else (kmer ^ INT64_MIN)
    ks, o2 = torch.sort(key[order], stable=True)
    order = order[o2]
    new_group = torch.ones(kmer.numel(), dtype=torch.bool, device=kmer.device)
    new_group[1:] = ks[1:] != ks[:-1]
    return new_group, sid[order], pos[order], slen[order], fwd[order]


def pairs_from_table(kmer, sid, pos, slen, params: KmerParams):
    """Sort the table, assign representatives, emit the kept pairs
    (kmermatcher.cpp:406-558). Returns (rep, tgt, diag, rev) int32 of the
    kept entries, in table order; rev is 1 where the representative and
    the target were picked on different strands (0 for protein)."""
    new_group, sid_s, pos_s, len_s, fwd_s = sort_table(kmer, sid, pos, slen,
                                                       params.is_nucl)
    # the first entry of each group is its representative: carry its
    # (id, pos<<1 | fwd, len) down the group
    rep_id, rep_pf, rep_len = seg_scan("first", new_group, sid_s,
                                       (pos_s << 1) | fwd_s, len_s)
    rep_pos = rep_pf >> 1
    # singleton groups are dropped (kmermatcher.cpp:476-478)
    same_next = torch.zeros_like(new_group)
    same_next[:-1] = ~new_group[1:]
    keep = ~new_group | same_next
    if params.is_nucl:
        # strand-aware diagonal: positions on the target's strand
        rev = (rep_pf & 1) ^ fwd_s
        tgt_fwd = fwd_s != 0
        q_pos = torch.where(tgt_fwd, rep_pos, rep_len - 1 - rep_pos)
        t_pos = torch.where(tgt_fwd, pos_s, len_s - 1 - pos_s)
        diagonal = q_pos - t_pos
    else:
        rev = torch.zeros_like(fwd_s)
        diagonal = rep_pos - pos_s
    if params.include_only_extendable:
        keep &= (diagonal < 0) | (diagonal > (rep_len - len_s))
    elif params.cov_thr > 0.0 and params.cov_mode in (0, 2):
        # Util::canBeCovered: bidirectional (0) and query (2) coverage test
        # the lengths; target coverage (1) and the modes above 2 keep all
        big = torch.maximum(rep_len, len_s).to(torch.float32)
        small = torch.minimum(rep_len, len_s).to(torch.float32)
        if params.cov_mode == 0:
            keep &= small / big >= params.cov_thr
        else:
            keep &= big * params.cov_thr <= small
    keep = keep.nonzero()[:, 0]     # one host sync for the four columns
    return rep_id[keep], sid_s[keep], diagonal[keep], rev[keep]


def sort_pairs(rep, tgt, diag, rev):
    """Stable sort by (rep, tgt, diag): equal pairs keep table order, which
    feeds best_diagonal_hits' tie-break. Two stable passes, least
    significant key first; |diag| < MAX_LEN."""
    k2 = (tgt.to(torch.int64) << 19) | (diag.to(torch.int64) + MAX_LEN)
    order = torch.sort(k2, stable=True).indices
    order = order[torch.sort(rep[order], stable=True).indices]
    return rep[order], tgt[order], diag[order], rev[order]


# ---------------------------------------------------------------------------
# Stage C: best diagonal per (rep, target)
# ---------------------------------------------------------------------------

def _next(x, fill):
    """x shifted one towards lower indices; `fill` at the end."""
    out = torch.empty_like(x)
    out[:-1] = x[1:]
    out[-1:] = fill
    return out


def best_diagonal_hits(rep, tgt, diag, rev, n_own=None):
    """Per (rep, target): most frequent diagonal + entry count
    (kmermatcher.cpp:870-913) over sorted, kept pairs, including the
    reference's run-absorb quirk: the run scan checks only the TARGET id,
    so a hit absorbs the following rep's entries when the same target sits
    at the boundary.

    Returns (rep, tgt, score, diag) int32 of the hits — one per (rep, tgt)
    segment start, self pairs excluded — in pair order; a negative score
    marks a reverse-strand hit. With n_own, only hits starting before that
    index are returned: the pairs after it only extend the last target
    segment (a hit depends on its own position and those after it within
    its target segment, never on those before)."""
    t = rep.numel()
    dev = rep.device
    idx = torch.arange(t, dtype=torch.int32, device=dev)
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
    if n_own is not None:
        hit[n_own:] = False
    hit = hit.nonzero()[:, 0]       # one host sync for the four columns
    return rep[hit], tgt[hit], score[hit], best_diag[hit]


def _hits(rep, tgt, diag, rev, n_own=None):
    """best_diagonal_hits of sorted pairs, also when there are none."""
    if rep.numel() == 0:
        return rep, tgt, diag.clone(), diag
    return best_diagonal_hits(rep, tgt, diag, rev, n_own)


# ---------------------------------------------------------------------------
# Memory-bounded split: hash ranges, per-range pairs, bucketed merge
# ---------------------------------------------------------------------------

def cut_bins(hist, budget):
    """Greedy cut of consecutive bins (numpy int64 counts) into ranges of at
    most `budget` entries, as the JAX package's backend.py:196-205 cuts the
    range-key histogram: a range takes bins while it is empty or stays
    within the budget, so a bin over the budget is a range of its own.
    Returns inclusive (lo, hi) bin pairs covering every bin."""
    cs = np.concatenate([[0], np.cumsum(hist, dtype=np.int64)])
    n = len(hist)
    ranges = []
    lo = 0
    while lo < n:
        # the range ends before the first bin h with acc + hist[h] > budget
        # and acc > 0, where acc = cs[h] - cs[lo]
        over = int(np.searchsorted(cs, cs[lo] + budget, side="right")) - 1
        nonempty = int(np.searchsorted(cs, cs[lo], side="right"))
        hi = min(max(over, nonempty), n)
        ranges.append((lo, hi - 1))
        lo = hi
    return ranges


def table_ranges(rkey, budget):
    """The hash ranges of a table of range keys rkey int32[T] for `budget`
    entries per range: the exact 65,536-bin histogram, cut by cut_bins."""
    hist = torch.bincount(rkey, minlength=RANGE_BINS).cpu().numpy()
    return cut_bins(hist, budget)


def pairs_by_range(kmer, sid, pos, slen, rkey, ranges, params: KmerParams):
    """Stage B on each hash range of the resident table: the range's
    entries are taken by a mask of their keys (one read of the key column
    per range; no sorted copy of the table), then pairs_from_table. Returns
    the kept pairs of each range, in range order, as (rep, tgt, diag << 1 |
    rev) int32."""
    parts = []
    for lo, hi in ranges:
        idx = ((rkey >= lo) & (rkey <= hi)).nonzero()[:, 0]
        rep, tgt, diag, rev = pairs_from_table(kmer[idx], sid[idx], pos[idx],
                                               slen[idx], params)
        del idx
        parts.append([rep, tgt, (diag << 1) | rev])
    return parts


def _bucket(stream, klo, khi):
    """The pairs of `stream` (rep, tgt, diag << 1 | rev) whose
    representative key lies in [klo, khi], in stream order, sorted by
    sort_pairs."""
    idx = ((stream[0] >= klo) & (stream[0] <= khi)).nonzero()[:, 0]
    rep, tgt, dr = (x[idx] for x in stream)
    return sort_pairs(rep, tgt, dr >> 1, dr & 1)


def merge_parts(parts, keys, budget):
    """Stage C over the kept pairs of every hash range, equal to running it
    on all of them at once. Stage C needs the pairs sorted by (rep, tgt,
    diag); they are sorted and scanned in buckets of whole representatives
    of at most `budget` pairs (a representative with more pairs is a bucket
    of its own), cut greedily over the exact per-representative counts.
    A bucket's last target segment may go on into the next buckets (the
    run-absorb quirk: the same target at a representative boundary), so
    those buckets' leading pairs with that target are scanned with it; the
    hits starting in them are left to their own bucket. parts are lists
    [rep, tgt, diag << 1 | rev] (pairs_by_range), joined here and freed;
    keys int32[N] are the DB's keys, ascending.

    Pairs equal on (rep, tgt, diag) keep their order within a range and
    come in range order across ranges: the monolithic path orders them by
    the k-mer value instead, so the two agree wherever such a run does not
    mix strands across ranges (a pair's strand decides the hit's sign when
    it ends a run of the winning diagonal)."""
    hist = torch.zeros(keys.numel(), dtype=torch.int64, device=keys.device)
    for part in parts:
        hist += torch.bincount(torch.searchsorted(keys, part[0]),
                               minlength=keys.numel())
    if int(hist.sum()) == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=keys.device)
        return empty, empty, empty, empty
    keys_h = keys.cpu().numpy()
    bounds = [(int(keys_h[lo]), int(keys_h[hi]))
              for lo, hi in cut_bins(hist.cpu().numpy(), budget)]
    del hist
    stream = _join(parts)
    cache = {}

    def bucket(j):
        if j not in cache:
            cache[j] = _bucket(stream, *bounds[j])
        return cache[j]

    out = []
    for i in range(len(bounds)):
        cur = bucket(i)
        segs = [cur]
        last = cur[1][-1]
        for j in range(i + 1, len(bounds)):
            nxt = bucket(j)
            n_lead = 0
            if bool(nxt[1][0] == last):
                other = (nxt[1] != last).nonzero()
                n_lead = int(other[0, 0]) if other.numel() else nxt[1].numel()
            if n_lead:
                segs.append(tuple(c[:n_lead] for c in nxt))
            if n_lead < nxt[1].numel():
                break
        cols = [torch.cat(c) for c in zip(*segs)] if len(segs) > 1 else cur
        out.append(_hits(*cols, n_own=cur[0].numel()))
        del cache[i], segs, cols, cur
    return tuple(torch.cat(c) for c in zip(*out))


class Local:
    """kmermatch_device's route on one device: every table entry and pair
    stays where it is made, and the pairs are sorted."""

    @staticmethod
    def table(kmer, sid, pos, slen, rkey):
        return kmer, sid, pos, slen

    @staticmethod
    def pairs(rep, tgt, diag, rev):
        return sort_pairs(rep, tgt, diag, rev)


def _no_pairs(device):
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    return empty, empty, empty, empty


def kmermatch_device(rows, offsets, lengths, code_lut, keys, hash_shift,
                     params: KmerParams, budget=None, route=Local):
    """Full device k-mer matcher on one device, or one rank's part of it.

    rows uint8[T], offsets int64[N], lengths int32[N] (< MAX_LEN), code_lut
    uint8[256] (the flat sequences of build_table), keys int32[N]
    (ascending, < MAX_KEY). budget: None for the monolithic path, else the
    split path's entries per hash range (and pairs per merge bucket); a
    table of at most `budget` entries runs as one range, monolithic.
    route: where the table's entries and the pairs go between the stages
    (Local: nowhere). Its table(kmer, sid, pos, slen, rkey) returns the
    entries to build pairs from, its pairs(rep, tgt, diag, rev) the pairs
    to take hits from, sorted (sort_pairs); the sharded matcher's route
    (parallel/mesh.py) sends each to the rank that owns it. The split path
    takes none.
    Returns (rep, tgt, score, diag) int32[H] — hits grouped by ascending
    rep key —, the number of table entries and the hash ranges (inclusive
    (lo, hi) range-key pairs)."""
    with span("kmermatch.table"):
        kmer, sid, pos, slen, rkey = build_table(
            rows, offsets, lengths, code_lut, keys, params, hash_shift)
        n = kmer.numel()
        ranges = [(0, RANGE_BINS - 1)]
        if budget is not None and n > budget:
            ranges = table_ranges(rkey, budget)
    if len(ranges) == 1:
        kmer, sid, pos, slen = route.table(kmer, sid, pos, slen, rkey)
        del rkey
        with span("kmermatch.pairs"):
            pairs = (pairs_from_table(kmer, sid, pos, slen, params)
                     if kmer.numel() else _no_pairs(kmer.device))
            del kmer, sid, pos, slen
            pairs = route.pairs(*pairs)
        with span("kmermatch.hits"):
            return (*_hits(*pairs), n, ranges)
    with span("kmermatch.pairs"):
        parts = pairs_by_range(kmer, sid, pos, slen, rkey, ranges, params)
        del kmer, sid, pos, slen, rkey
        return (*merge_parts(parts, keys, budget), n, ranges)
