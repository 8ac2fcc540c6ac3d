"""Plain PyTorch reference of the device step: the k-mer matcher's hits and
the END_TO_END rescore's records, worked out from the DB's own arrays.

It imports nothing of the program. Its tables (alphabets, matrices,
E-value parameters) are data in `perfbench/data/tables.json`. The
semantics are those of MMseqs2's kmermatcher.cpp (selection, table,
representatives, best diagonal) and rescorediagonal.cpp (ungapped
END_TO_END scoring, E-value, filters), written as whole-array torch:
no kernel, no segmented-scan primitive, no cache.

`reference_step(db, cfg, device)` returns
  hits  (rep, tgt, score, diag) int64 host arrays, grouped by ascending
        representative, one row per (representative, target) hit; a
        negative score marks a reverse-strand hit
  recs  {"qk": int64[K], "rec": structured[K]} of the kept records, a
        self row first in each representative's group
`eval_dtype` selects the precision of the E-value's arithmetic (the
control computes it in float32).
"""
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

TABLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "tables.json")
INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1
INVALID_HASH = 1 << 20
STAR = ord("*")
FOLD = ~0x20 & 0xFF
# cells of a selection block and of a rescore chunk
BLOCK_CELLS = 1 << 25

RECORD = np.dtype([
    ("dbKey", np.uint32), ("score", np.int32), ("qcov", np.float32),
    ("dbcov", np.float32), ("seqId", np.float32), ("eval", np.float64),
    ("alnLength", np.int32), ("qStartPos", np.int32), ("qEndPos", np.int32),
    ("qLen", np.int32), ("dbStartPos", np.int32), ("dbEndPos", np.int32),
    ("dbLen", np.int32),
])


def tables():
    with open(TABLES) as fh:
        return json.load(fh)


@dataclass
class Step:
    """The device step's parameters, from a configuration file."""
    k: int
    nucleotide: bool
    kmers_per_sequence: int
    kmers_per_sequence_scale: float
    hash_shift: int
    ignore_multi_kmer: bool
    include_only_extendable: bool
    seq_id_thr: float
    eval_thr: float
    cov_thr: float
    cov_mode: int
    seq_id_mode: int
    aln_len_thr: int

    @classmethod
    def from_config(cls, cfg):
        return cls(k=cfg["k"], nucleotide=cfg["dbtype"] == "nucleotide",
                   kmers_per_sequence=cfg["kmers_per_sequence"],
                   kmers_per_sequence_scale=cfg["kmers_per_sequence_scale"],
                   hash_shift=cfg["hash_shift"],
                   ignore_multi_kmer=cfg["ignore_multi_kmer"],
                   include_only_extendable=cfg["include_only_extendable"],
                   seq_id_thr=cfg["min_seq_id"], eval_thr=cfg["eval_thr"],
                   cov_thr=cfg["cov_thr"], cov_mode=cfg["cov_mode"],
                   seq_id_mode=cfg["seq_id_mode"],
                   aln_len_thr=cfg["min_aln_len"])


# ---------------------------------------------------------------------------
# hashes (uint64 arithmetic in int64 lanes: products and sums wrap alike)
# ---------------------------------------------------------------------------

def _u(x):
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


PRIME64 = [_u(p) for p in (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                           0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                           0x27D4EB2F165667C5)]


def _srl(x, s):
    return (x >> s) & ((1 << (64 - s)) - 1)


def _rotl(x, r):
    return (x << r) | _srl(x, 64 - r)


def xxh64_u64(v, seed):
    """XXH64 of each 8-byte little-endian value, by the xxHash
    specification for an input of 8 bytes."""
    p1, p2, p3, p4, p5 = PRIME64
    acc = torch.full_like(v, _u(seed + PRIME64[4] + 8))
    acc = acc ^ (_rotl(v * p2, 31) * p1)
    acc = _rotl(acc, 27) * p1 + p4
    acc = acc ^ _srl(acc, 33)
    acc = acc * p2
    acc = acc ^ _srl(acc, 29)
    acc = acc * p3
    return acc ^ _srl(acc, 32)


# ---------------------------------------------------------------------------
# the matcher
# ---------------------------------------------------------------------------

def _codes(data, offsets, lens, rows, width, lut, x_code):
    """int64[len(rows), width] alphabet codes of `rows`, X past each end."""
    j = torch.arange(width, device=data.device)
    pos = (offsets[rows][:, None] + j).clamp(max=data.numel() - 1)
    c = lut[data[pos].long()]
    return torch.where(j < lens[rows][:, None], c, x_code)


# the duplicate skip of kmermatcher.cpp:277-301 over a row in selection
# order is a machine of three states (0 top, 1 skip, 2 land); an element
# maps the states by f(0) + 3 f(1) + 9 f(2): a k-mer equal to the next maps
# (0, 1, 2) to (1, 1, 0), any other to (0, 2, 0)
_EQ, _NE = 1 + 3 * 1 + 9 * 0, 0 + 3 * 2 + 9 * 0


def _after(a, b):
    """Code of state map b applied after a, elementwise."""
    out = torch.zeros_like(a)
    for s in range(3):
        fa = a // (3 ** s) % 3
        fb = b // (3 ** fa) % 3
        out += fb * 3 ** s
    return out


def _processed(eq_next):
    """Which entries the duplicate skip processes: state before element i
    is the composition of the maps before it applied to state 0 (a prefix
    scan of compositions, by doubling)."""
    f = torch.where(eq_next, _EQ, _NE).long()
    n = f.shape[1]
    d = 1
    while d < n:
        f = torch.cat([f[:, :d], _after(f[:, :-d], f[:, d:])], 1)
        d *= 2
    state = torch.zeros_like(f)
    state[:, 1:] = f[:, :-1] % 3
    return ((state == 0) & ~eq_next) | (state == 2)


def _select(codes, lens, p: Step, alpha):
    """Selected entries of a block: (row, stored k-mer, position)."""
    n, w = codes.shape
    k = p.k
    npos = w - k + 1
    x_code = alpha - 1
    has_x = torch.zeros((n, npos), dtype=torch.bool, device=codes.device)
    kmer = torch.zeros((n, npos), dtype=torch.int64, device=codes.device)
    for i in range(k):
        c = codes[:, i:i + npos]
        has_x |= c == x_code
        if p.nucleotide:
            kmer = kmer * 4 + c
        else:
            kmer = kmer + c * (alpha - 1) ** i
    pos = torch.arange(npos, device=codes.device).expand(n, npos)
    valid = (pos < (lens[:, None] - k + 1)) & ~has_x
    if p.nucleotide:
        rc = torch.zeros_like(kmer)
        v = kmer
        for _ in range(k):
            rc = (rc << 2) | ((v & 3) ^ 2)   # codes A0 C1 T2 G3
            v = v >> 2
        valid &= rc != kmer
        use_rc = rc < kmer
        canon = torch.where(use_rc, rc, kmer)
        spos = torch.where(use_rc, lens[:, None] - pos - k, pos)
        stored = torch.where(use_rc, canon, canon | INT64_MIN)
        mk = torch.where(valid, canon, INT64_MAX)
    else:
        canon, spos, stored = kmer, pos, kmer
        mk = torch.where(valid, kmer, INT64_MAX)
    h = (xxh64_u64(canon, p.hash_shift) & 0xFFFF)
    h = torch.where(valid, h, INVALID_HASH)
    kc = (torch.tensor(p.kmers_per_sequence - 1, dtype=torch.float32)
          + torch.tensor(p.kmers_per_sequence_scale, dtype=torch.float32)
          * lens.to(torch.float32)).to(torch.int64)
    kc = torch.minimum(kc, valid.sum(1))
    # selection order: hash, then k-mer, then stored position, then column
    order = torch.argsort(spos, dim=1, stable=True)
    for key in (mk, h):
        order = order.gather(1, torch.argsort(key.gather(1, order), dim=1,
                                              stable=True))
    sh, smk = h.gather(1, order), mk.gather(1, order)
    hk = sh.gather(1, (kc - 1).clamp(min=0)[:, None])[:, 0]
    hk = torch.where(kc > 0, hk, -1)
    too_much = (h <= hk[:, None]).sum(1) - kc
    if p.ignore_multi_kmer:
        eq = torch.zeros_like(valid)
        eq[:, :-1] = smk[:, :-1] == smk[:, 1:]
        proc = _processed(eq)
    else:
        proc = torch.ones_like(valid)
    elig = (sh < INVALID_HASH) & proc
    below = elig & (sh < hk[:, None])
    at = elig & (sh == hk[:, None])
    r_all = torch.cumsum((below | at).long(), 1)
    r_at = torch.cumsum(at.long(), 1)
    tm = too_much[:, None]
    sel = (below | (at & ((tm == 0) | (r_at <= tm)))) & (r_all <= kc[:, None])
    rows, cols = sel.nonzero(as_tuple=True)
    col = order[rows, cols]
    return rows, stored[rows, col], spos[rows, col]


def _seq_hash(codes, lens):
    """Util::hash, h = h * 31 + c over each row's codes, mod 2^64."""
    n, w = codes.shape
    pw = [1]
    for _ in range(w - 1):
        pw.append(pw[-1] * 31 % (1 << 64))
    pw = torch.tensor([_u(x) for x in pw], device=codes.device)
    e = lens[:, None] - 1 - torch.arange(w, device=codes.device)
    terms = codes * pw[e.clamp(min=0)]
    return torch.where(e >= 0, terms, 0).sum(1)


def table(data, offsets, lens, keys, p: Step, kmer_lut, alpha):
    """The k-mer table: (k-mer int64, key, position, length) of every
    selected k-mer and one whole-sequence hash entry per non-empty row,
    rows taken longest first in blocks of BLOCK_CELLS."""
    dev = data.device
    order = torch.argsort(lens.cpu(), descending=True, stable=True)
    lens_sorted = lens.cpu()[order]
    cols = [[], [], [], []]
    lo, n = 0, lens.numel()
    while lo < n:
        w = max(int(lens_sorted[lo]), p.k)
        hi = min(lo + max(BLOCK_CELLS // w, 1), n)
        rows = order[lo:hi].to(dev)
        codes = _codes(data, offsets, lens, rows, w, kmer_lut, alpha - 1)
        ln = lens[rows]
        r, km, ps = _select(codes, ln, p, alpha)
        sh = xxh64_u64(_seq_hash(codes, ln), p.hash_shift)
        ne = ln > 0
        for c, v, u in zip(cols, (km, keys[rows][r], ps, ln[r]),
                           (sh[ne], keys[rows][ne],
                            torch.zeros_like(sh[ne]), ln[ne])):
            c += [v, u]
        lo = hi
    return [torch.cat(c) for c in cols]


def pairs(kmer, sid, pos, slen, p: Step):
    """(rep, tgt, diag, rev) of the kept table entries, sorted by (rep,
    tgt, diag) stably (kmermatcher.cpp:406-558)."""
    fwd = (kmer < 0).long()
    # sort by (k-mer, length descending, key, position, strand): least
    # significant keys first
    order = torch.argsort((sid << 19) | (pos << 1) | fwd)
    order = order[torch.argsort(-slen[order], stable=True)]
    key = (kmer & INT64_MAX) if p.nucleotide else (kmer ^ INT64_MIN)
    ks = key[order]
    o2 = torch.argsort(ks, stable=True)
    order, ks = order[o2], ks[o2]
    sid, pos, slen, fwd = sid[order], pos[order], slen[order], fwd[order]
    t = ks.numel()
    idx = torch.arange(t, device=ks.device)
    start = torch.ones(t, dtype=torch.bool, device=ks.device)
    start[1:] = ks[1:] != ks[:-1]
    head = torch.where(start, idx, 0).cummax(0).values
    r_sid, r_pos, r_len, r_fwd = sid[head], pos[head], slen[head], fwd[head]
    last = torch.ones_like(start)
    last[:-1] = start[1:]
    keep = ~(start & last)                    # groups of one are dropped
    if p.nucleotide:
        rev = r_fwd ^ fwd
        t_fwd = fwd != 0
        qp = torch.where(t_fwd, r_pos, r_len - 1 - r_pos)
        tp = torch.where(t_fwd, pos, slen - 1 - pos)
        diag = qp - tp
    else:
        rev = torch.zeros_like(fwd)
        diag = r_pos - pos
    if p.include_only_extendable:
        keep &= (diag < 0) | (diag > r_len - slen)
    sel = keep.nonzero()[:, 0]
    rep, tgt, diag, rev = r_sid[sel], sid[sel], diag[sel], rev[sel]
    o = torch.argsort((tgt << 19) | (diag + (1 << 18)), stable=True)
    o = o[torch.argsort(rep[o], stable=True)]
    return rep[o], tgt[o], diag[o], rev[o]


def best_diagonals(rep, tgt, diag, rev):
    """One hit per (rep, tgt) start (kmermatcher.cpp:870-913): its score is
    the count of entries from it to the end of its run of equal targets
    (the run ignores the representative, so it may reach into the next
    representative's entries), its diagonal that of the longest run of one
    diagonal among those entries, the run it starts in counted from it,
    ties to the later run; the sign is negative where that run's last
    entry is reverse. Self pairs give no hit."""
    n = rep.numel()
    dev = rep.device
    if n == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z, z, z
    idx = torch.arange(n, device=dev)
    t_new = torch.ones(n, dtype=torch.bool, device=dev)
    t_new[1:] = tgt[1:] != tgt[:-1]
    r_new = t_new.clone()
    r_new[1:] |= diag[1:] != diag[:-1]
    tseg = torch.cumsum(t_new.long(), 0) - 1
    run = torch.cumsum(r_new.long(), 0) - 1
    n_seg, n_run = int(tseg[-1]) + 1, int(run[-1]) + 1
    seg_end = torch.zeros(n_seg, dtype=torch.int64, device=dev).scatter_reduce(
        0, tseg, idx, "amax")
    run_end = torch.zeros(n_run, dtype=torch.int64, device=dev).scatter_reduce(
        0, run, idx, "amax")
    run_start = torch.full((n_run,), n, dtype=torch.int64,
                           device=dev).scatter_reduce(0, run, idx, "amin")
    run_seg = tseg[run_start]
    run_len = run_end - run_start + 1
    # rank the runs by (length, last index); the best run at or after each
    # run within its target segment is a reverse running maximum of
    # (segment counted from the end, rank)
    rank_order = torch.argsort(run_len * n + run_end)
    rank = torch.empty_like(rank_order)
    rank[rank_order] = torch.arange(n_run, device=dev)
    key = ((n_seg - 1 - run_seg) << 31) | rank
    best = key.flip(0).cummax(0).values.flip(0)
    best_run = rank_order[best & ((1 << 31) - 1)]

    new_pair = t_new.clone()
    new_pair[1:] |= rep[1:] != rep[:-1]
    h = (new_pair & (rep != tgt)).nonzero()[:, 0]
    r0 = run[h]
    own_c = run_end[r0] - h + 1
    nxt = (r0 + 1).clamp(max=n_run - 1)
    has_later = (r0 + 1 < n_run) & (run_seg[nxt] == tseg[h])
    b = best_run[nxt]
    b_wins = has_later & (run_len[b] >= own_c)
    win = torch.where(b_wins, b, r0)
    d = torch.where(b_wins, diag[run_start[b]], diag[h])
    sign = torch.where(rev[run_end[win]] != 0, -1, 1)
    score = sign * (seg_end[tseg[h]] - h + 1)
    return rep[h], tgt[h], score, d


# ---------------------------------------------------------------------------
# the rescore
# ---------------------------------------------------------------------------

def _windows(data, offsets, lens, qrow, trow, diag, qrev, score_lut, sub,
             comp, code2char):
    """END_TO_END along each hit's diagonal (DistanceCalculator.h:115-220):
    (score, first, last, idents) over the overlap window, '*' skipped at
    either end, a reverse hit's query read back to front and complemented.
    Whole windows, in chunks of at most BLOCK_CELLS residues."""
    dev = data.device
    h = qrow.numel()
    qlen, tlen = lens[qrow], lens[trow]
    dist = diag.abs()
    fwd = diag >= 0
    ov = torch.where(fwd, torch.minimum(tlen, qlen - dist),
                     torch.minimum(tlen - dist, qlen))
    ov = torch.where(torch.where(fwd, dist < qlen, dist < tlen), ov, 0)
    ov = ov.clamp(min=0)
    qoff = torch.where(fwd, dist, 0)
    toff = torch.where(fwd, 0, dist)
    score = torch.zeros(h, dtype=torch.int64, device=dev)
    idents = torch.zeros(h, dtype=torch.int64, device=dev)
    first = torch.full((h,), -1, dtype=torch.int64, device=dev)
    last = torch.full((h,), -1, dtype=torch.int64, device=dev)
    cs = np.concatenate([[0], np.cumsum(ov.cpu().numpy())])
    alpha = int(round(sub.numel() ** 0.5))
    lo = 0
    while lo < h:
        hi = int(np.searchsorted(cs, cs[lo] + BLOCK_CELLS, side="right")) - 1
        hi = min(max(hi, lo + 1), h)
        o = ov[lo:hi]
        hid = torch.repeat_interleave(torch.arange(hi - lo, device=dev), o)
        start = torch.cumsum(o, 0) - o
        j = torch.arange(hid.numel(), device=dev) - start[hid]
        g = hid + lo
        qp = qoff[g] + j
        rv = qrev[g]
        qp = torch.where(rv, qlen[g] - 1 - qp, qp)
        qch = data[offsets[qrow[g]] + qp].long()
        tch = data[offsets[trow[g]] + toff[g] + j].long()
        qc, tc = score_lut[qch], score_lut[tch]
        qc = torch.where(rv, comp[qc], qc)
        qch = torch.where(rv, code2char[qc], qch)
        star = (qch == STAR) | (tch == STAR)
        nh = hi - lo
        zero = torch.zeros(nh, dtype=torch.int64, device=dev)
        f = torch.zeros(nh, dtype=torch.int64, device=dev)
        f.index_put_((hid[j == 0],), star[j == 0].long())
        la = (o - 1).clamp(min=0)
        at_end = (j == o[hid] - 1) & (j > 0)
        strip = zero.clone()
        strip.index_put_((hid[at_end],), star[at_end].long())
        la = la - strip
        inside = (j >= f[hid]) & (j <= la[hid])
        s = sub[qc * alpha + tc]
        sc = zero.clone().index_add_(0, hid, torch.where(inside, s, 0))
        ids = zero.clone().index_add_(
            0, hid, (inside & ((qch & FOLD) == (tch & FOLD))).long())
        has = o > 0
        score[lo:hi] = torch.where(has, sc.clamp(min=0), 0)
        idents[lo:hi] = torch.where(has, ids, 0)
        first[lo:hi] = torch.where(has, f, -1)
        last[lo:hi] = torch.where(has, la, -1)
        lo = hi
    return score, first, last, idents, ov


def evalue(y, qlen, ev, db_res, dtype):
    """The ALP finite-size E-value (sls_pvalues.cpp:366-490,
    EvalueComputation.h:18-45), K exp(-lambda y) times the area, in
    `dtype`. ev = [lambda K aJ bJ aI bI alphaJ betaJ alphaI betaI sigma
    tau]."""
    lam, K, a_J, b_J, a_I, b_I, al_J, be_J, al_I, be_I, sigma, tau = ev
    cut = 2.0  # sls_pvalues.cpp:46
    vi_thr = max(cut * al_I / lam, 0.0)
    vj_thr = max(cut * al_J / lam, 0.0)
    c_thr = max(cut * sigma / lam, 0.0)
    y = y.to(dtype)
    n = qlen.to(dtype)
    sqrt_half = 0.70710678118654752440
    inv_sqrt_2pi = 0.39894228040143267794
    epa = K * torch.exp(-lam * y)

    def part(len_minus, alpha_, beta_, thr):
        v = torch.clamp(alpha_ * y + beta_, min=thr)
        sv = torch.sqrt(v)
        f = torch.where(sv == 0, torch.full_like(sv, 1e100 if dtype ==
                                                 torch.float64 else 3e38),
                        len_minus / torch.where(sv == 0, 1.0, sv))
        P = 0.5 * torch.special.erfc(-sqrt_half * f)
        E = -inv_sqrt_2pi * torch.exp(-0.5 * f * f)
        return len_minus * P - sv * E, P

    p1, P_m = part(db_res - (a_I * y + b_I), al_I, be_I, vi_thr)
    p2, P_n = part(n - (a_J * y + b_J), al_J, be_J, vj_thr)
    c_y = torch.clamp(sigma * y + tau, min=c_thr)
    return (epa * (p1 * p2 + c_y * P_m * P_n)).to(torch.float64)


def rescore(db_arrays, hits, p: Step, eval_dtype=torch.float64):
    """Records of every row, self rows included, and which are kept
    (rescorediagonal.cpp, END_TO_END, as `plass assemble` and `penguin
    nuclassemble` call it)."""
    data, offsets, lens, keys, t = db_arrays
    dev = data.device
    rep, tgt, sc, dg = hits
    n = keys.numel()
    # a self row (key, key, 0, 0) first in each representative's group
    grp = torch.searchsorted(keys, rep)
    counts = torch.bincount(grp, minlength=n)
    gstart = torch.cumsum(counts + 1, 0) - (counts + 1)
    m = n + rep.numel()
    qk = torch.empty(m, dtype=torch.int64, device=dev)
    tk = torch.empty_like(qk)
    pref = torch.zeros_like(qk)
    d = torch.zeros_like(qk)
    is_self = torch.zeros(m, dtype=torch.bool, device=dev)
    is_self[gstart] = True
    qk[gstart] = keys
    tk[gstart] = keys
    slot = (~is_self).nonzero()[:, 0]
    qk[slot], tk[slot], pref[slot], d[slot] = rep, tgt, sc, dg
    lut = torch.full((int(keys.max()) + 1,), -1, dtype=torch.int64,
                     device=dev)
    lut[keys] = torch.arange(n, device=dev)
    qrow, trow = lut[qk], lut[tk]
    qrev = (pref < 0) & p.nucleotide
    score, first, last, idents, ov = _windows(
        data, offsets, lens, qrow, trow, d, qrev, t["score_lut"], t["sub"],
        t["comp"], t["code2char"])
    qlen, tlen = lens[qrow], lens[trow]
    dist = d.abs()
    ev = evalue(score, qlen, t["evalue"], float(lens.sum()), eval_dtype)
    f64 = torch.float64
    bit = ((t["evalue"][0] * score.to(f64) - np.log(t["evalue"][1]))
           / np.log(2.0) + 0.5).trunc().long()
    aln = last - first + 1
    pos_d = d >= 0
    qs = torch.where(pos_d, first + dist, first)
    qe = torch.where(pos_d, last + dist, last)
    ts = torch.where(pos_d, first, first + dist)
    te = torch.where(pos_d, last, last + dist)
    if p.seq_id_mode == 1:
        denom = torch.minimum(qlen, tlen).to(f64)
    elif p.seq_id_mode == 2:
        denom = torch.maximum(qlen, tlen).to(f64)
    else:
        denom = aln.to(f64)
    ident = qrow == trow
    seq_id = idents.to(f64) / denom
    seq_id = torch.where((ev <= p.eval_thr) | ident, seq_id, 0.0)
    qcov = (torch.minimum(qlen, torch.maximum(qs, qe))
            - torch.minimum(qs, qe) + 1).to(f64) / qlen.to(f64)
    tcov = (torch.minimum(tlen, torch.maximum(ts, te))
            - torch.minimum(ts, te) + 1).to(f64) / tlen.to(f64)
    qs = torch.where(qrev, qlen - qs - 1, qs)
    qe = torch.where(qrev, qlen - qe - 1, qe)
    if p.cov_mode == 0:
        has_cov = (qcov >= p.cov_thr) & (tcov >= p.cov_thr)
    elif p.cov_mode == 1:
        has_cov = tcov >= p.cov_thr
    elif p.cov_mode == 2:
        has_cov = qcov >= p.cov_thr
    else:
        has_cov = torch.ones_like(ident)
    eps = float(np.finfo(np.float32).eps)
    keep = (ov > 0) & (ident | ((aln >= p.aln_len_thr) & has_cov
                                & (seq_id >= p.seq_id_thr - eps)
                                & (ev <= p.eval_thr)))
    if p.cov_thr > 0 and p.cov_mode in (0, 2):
        small = torch.minimum(qlen, tlen).to(f64)
        big = torch.maximum(qlen, tlen).to(f64)
        keep &= (small / big >= p.cov_thr) if p.cov_mode == 0 \
            else (big * p.cov_thr <= small)
    kept = keep.nonzero()[:, 0]
    rec = np.zeros(kept.numel(), dtype=RECORD)
    for name, v in (("dbKey", tk), ("score", bit), ("qcov", qcov),
                    ("dbcov", tcov), ("seqId", seq_id), ("eval", ev),
                    ("alnLength", aln), ("qStartPos", qs), ("qEndPos", qe),
                    ("qLen", qlen), ("dbStartPos", ts), ("dbEndPos", te),
                    ("dbLen", tlen)):
        x = v[kept]
        if rec.dtype[name] == np.float32:
            x = x.to(torch.float32)
        rec[name] = x.cpu().numpy()
    return {"qk": qk[kept].cpu().numpy(), "rec": rec}


def device_tables(nucleotide, device):
    """The reference's tables on `device`: k-mer and score alphabets, the
    score matrix, complement, chars of codes, E-value parameters."""
    t = tables()
    if nucleotide:
        km = sc = t["nucleotide"]
        ev = t["evalue"]["nucleotide_ungapped"]
    else:
        km, sc = t["reduced13"], t["blosum62"]
        ev = t["evalue"]["blosum62_ungapped"]
    alpha = len(sc["sub"])

    def tens(x):
        return torch.tensor(x, dtype=torch.int64, device=device)

    return {"kmer_lut": tens(km["aa2num"]), "kmer_alpha": len(km["letters"]),
            "score_lut": tens(sc["aa2num"]),
            "sub": tens(sc["sub"]).reshape(-1),
            "comp": tens(sc.get("reverse", list(range(alpha)))),
            "code2char": tens([ord(ch) for ch in sc["letters"]]),
            "evalue": ev}


def reference_step(db, cfg, device, eval_dtype=torch.float64):
    """(hits, recs) of the device step on the DB `db` (generate.Db)."""
    p = Step.from_config(cfg)
    device = torch.device(device)
    t = device_tables(p.nucleotide, device)
    data = torch.from_numpy(np.asarray(db.data)).to(device)
    offsets = torch.from_numpy(np.asarray(db.offsets, np.int64)).to(device)
    lens = torch.from_numpy(np.asarray(db.lengths, np.int64) - 2).to(device)
    keys = torch.from_numpy(np.asarray(db.keys, np.int64)).to(device)
    kmer, sid, pos, slen = table(data, offsets, lens, keys, p, t["kmer_lut"],
                                 t["kmer_alpha"])
    pr = pairs(kmer, sid, pos, slen, p)
    del kmer, sid, pos, slen
    hits = best_diagonals(*pr)
    del pr
    recs = rescore((data, offsets, lens, keys, t), hits, p, eval_dtype)
    return tuple(x.cpu().numpy() for x in hits), recs
