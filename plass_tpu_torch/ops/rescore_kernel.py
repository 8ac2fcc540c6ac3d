"""END_TO_END ungapped diagonal rescore of device-resident hits (kernel K2).

`rescore_e2e(rows, offsets, lengths, code_lut, qrow, trow, diag, sub)`
scores each hit (qrow[h], trow[h], diag[h]) along its diagonal (reference:
DistanceCalculator.h:115-220; the JAX package's
ops/pallas_rescore.py:_kernel_gathered_body), reading the sequence
database's own flat bytes — there is no padded [N, W] copy of the rows:

  rows     uint8[T]    every sequence back to back, as SeqDB.data holds
                       them (record terminators included, never scored)
  offsets  int64[N]    row r starts at rows[offsets[r]]
  lengths  int32[N]    row r is lengths[r] residues long
  code_lut uint8[256]  byte -> substitution-alphabet code (values < A);
                       a residue's char is the byte itself ('*' detection,
                       case-folded identity)
  qrow, trow, diag     int32[H]
  sub      int32[A, A] substitution matrix (A <= 32)

Nucleotide hits add the reverse strand (the JAX package's has_rev path,
rescorediagonal.cpp:173-179):

  qrev      bool[H]   the hit's query is read reverse-complemented: index
                      qlen-1-(qoff+j) instead of qoff+j, code comp[q]
  comp      int32[A]  complement permutation of the codes
  code2char uint8[A]  canonical char of a code: a reverse hit's query char
                      is code2char[comp[q]], not the raw byte
  uniform   (match, mismatch) when sub is the uniform matrix
            (q == t and q != X ? match : mismatch; uniform_pattern):
            selects the kernel variant that compares instead of looking
            the score up (the TPU kernel's `fast` path)

Returns (score, first, last, idents) int32[H], relative to the overlap
window; a hit with no overlap gives (0, -1, -1, 0). The overlap length and
|diag| are host-derivable from the lengths and are not returned.

`rescore_hamming(rows, offsets, lengths, code_lut, qrow, trow, diag[,
qrev, comp, code2char])` is the HAMMING rescore of --rescore-mode 0 (the
JAX package's device_rescore.rescore_pairs, mode 0) on the same operands:
the count of identical raw chars over the overlap window (no case
folding; a reverse hit's query chars from code2char as above) as score
and idents, first = last = -1. It takes no matrix.

`rescore_align(...)`, on rescore_e2e's operands, is the ALIGNMENT
rescore of --rescore-mode 2 (kernel B12; the JAX package computes it on
the host only, ops/rescore.py:ungapped_best with ungapped_by_diagonal,
mode 2): the best local ungapped segment of each window, scored through
the matrix on every residue ('*' included). With c[p] the running sum of
the window's scores and c[-1] = 0, score = max over p of c[p] - min
c[-1..p], the minimum at its latest index on ties; last = the first p
that reaches the maximum, first = that p's minimum index + 1, and idents
counts the case-folded equal chars over [first, last]. A window with no
positive score gives (0, 0, 0, 0), one with no overlap (0, -1, -1, 0).
As the host, a hit whose rows have qlen + tlen > WRAP also scores the
other diagonals WRAP apart that share its low 16 bits (wrap_candidates,
in the host's order) and keeps the first strictly greater score; a fifth
output, int32[H], is the winning diagonal (the hit's own where none
scores above 0, with that diagonal's outputs).

On a CUDA tensor each call launches the CUDA kernel (csrc/rescore.cu) or
raises; on a CPU tensor it runs `rescore_e2e_plain`,
`rescore_hamming_plain` or `rescore_align_plain`, the oracles of the
kernel's variants.
"""
import bisect

import numpy as np
import torch

from ..kernels import build

STAR = ord("*")
FOLD = ~0x20 & 0xFF

# launches of the CUDA kernel in this process, one per call on a CUDA
# tensor, by variant: END_TO_END forward-only with the matrix (protein),
# with reverse hits, and with reverse hits and the uniform matrix
# (nucleotide); HAMMING forward-only and with reverse hits; ALIGNMENT
# forward-only and with reverse hits (either matrix form)
LAUNCHES = 0
LAUNCHES_REV = 0
LAUNCHES_REV_UNIFORM = 0
LAUNCHES_HAMMING = 0
LAUNCHES_HAMMING_REV = 0
LAUNCHES_ALIGN = 0
LAUNCHES_ALIGN_REV = 0


def uniform_pattern(sub):
    """(match, mismatch) when the numpy matrix `sub` is uniform — every
    diagonal entry but X's is `match`, every other entry `mismatch`, and
    the two differ (the JAX package's backend._fast_sub_pattern) — else
    None. The nucleotide matrix is 2/-3."""
    sub = np.asarray(sub, dtype=np.int64)
    alpha = sub.shape[0]
    m, x = int(sub[0, 0]), int(sub[0, -1])
    want = np.full((alpha, alpha), x, dtype=np.int64)
    want[np.arange(alpha - 1), np.arange(alpha - 1)] = m
    if m == x or not np.array_equal(sub, want):
        return None
    return m, x


def _overlap(lengths, qrow, trow, diag):
    qlen = lengths[qrow]
    tlen = lengths[trow]
    dist = diag.abs()
    fwd = diag >= 0
    pos_ok = torch.where(fwd, dist < qlen, dist < tlen)
    ov = torch.where(fwd, torch.minimum(tlen, qlen - dist),
                     torch.minimum(tlen - dist, qlen))
    ov = torch.where(pos_ok, ov, 0)
    qoff = torch.where(fwd, dist, 0)
    toff = torch.where(fwd, 0, dist)
    return ov, qoff, toff, qlen


def _windows(rows, offsets, lengths, code_lut, qrow, trow, diag, qrev,
             comp, code2char, budget):
    """The hits' overlap windows as [hits, width] gathers from the flat
    rows, in chunks of at most `budget` window cells, the hits taken in
    the order of their window length so that each chunk is padded to its
    own widest window: yields (at, ov, j, qch, tch, qc, tc) per chunk, `at`
    the chunk's hit indices, with the query's and the target's chars and
    codes, a reverse hit's query read back to front and complemented, its
    chars from code2char."""
    h = qrow.numel()
    dev = rows.device
    top = max(rows.numel() - 1, 0)
    lut = code_lut.long()
    ov_all = _overlap(lengths, qrow.long(), trow.long(), diag)[0]
    order = torch.argsort(ov_all, stable=True)
    widths = ov_all[order].clamp(min=1).tolist()
    lo = 0
    while lo < h:
        # the most hits from lo whose count times the widest of them (the
        # last, the widths being sorted) fits the budget; at least one
        hi = lo + max(bisect.bisect_right(
            range(lo + 1, h + 1), budget,
            key=lambda n: (n - lo) * widths[n - 1]), 1)
        width = widths[hi - 1]
        at = order[lo:hi]
        lo = hi
        j = torch.arange(width, device=dev)
        q = qrow[at].long()
        t = trow[at].long()
        ov, qoff, toff, qlen = _overlap(lengths, q, t, diag[at])
        qpos = qoff[:, None] + j
        if qrev is not None:
            rv = qrev[at][:, None]
            qpos = torch.where(rv, qlen[:, None] - 1 - qpos, qpos)
        # cells past the window are masked by the callers; their index
        # only has to stay inside the array
        qch = rows[(offsets[q][:, None] + qpos).clamp(0, top)]
        tch = rows[(offsets[t][:, None] + toff[:, None] + j).clamp(0, top)]
        qc = lut[qch.long()]
        tc = lut[tch.long()]
        if qrev is not None:
            qc = torch.where(rv, comp.long()[qc], qc)
            qch = torch.where(rv, code2char[qc], qch)
        yield at, ov, j, qch, tch, qc, tc


def rescore_e2e_plain(rows, offsets, lengths, code_lut, qrow, trow, diag,
                      sub, qrev=None, comp=None, code2char=None, uniform=None,
                      budget=1 << 24):
    """Plain PyTorch version: the JAX package's device_rescore.rescore_pairs
    (mode 3; has_rev when qrev is given) as [hits, window] gathers from the
    flat rows, in chunks of at most `budget` window cells. It scores through
    `sub` for both matrix variants (`uniform` only picks the kernel's
    variant)."""
    _check(rows, offsets, lengths, code_lut, qrow, trow, diag, sub, qrev,
           comp, code2char, uniform)
    h = qrow.numel()
    outs = [torch.empty(h, dtype=torch.int32, device=rows.device)
            for _ in range(4)]
    if h == 0:
        return tuple(outs)
    alpha = sub.shape[0]
    sub_flat = sub.reshape(-1).to(torch.int64)
    for at, ov, j, qch, tch, qc, tc in _windows(
            rows, offsets, lengths, code_lut, qrow, trow, diag, qrev, comp,
            code2char, budget):
        width = j.numel()
        s = sub_flat[qc * alpha + tc]
        first = ((qch[:, 0] == STAR) | (tch[:, 0] == STAR)).int()
        last_idx = (ov - 1).clamp(min=0)
        cl = last_idx.clamp(max=width - 1)[:, None]
        star_last = (qch.gather(1, cl) == STAR) | (tch.gather(1, cl) == STAR)
        last = last_idx - ((last_idx > 0) & star_last[:, 0]).int()
        first = torch.where(ov > 0, first, -1)
        last = torch.where(ov > 0, last, -1)
        in_range = ((j < ov[:, None]) & (j >= first[:, None])
                    & (j <= last[:, None]))
        score = torch.where(in_range, s, 0).sum(dim=1).clamp(min=0)
        idents = (((qch & FOLD) == (tch & FOLD)) & in_range).sum(dim=1)
        for out, val in zip(outs, (score, first, last, idents)):
            out[at] = val.to(out.dtype)
    return tuple(outs)


def rescore_hamming_plain(rows, offsets, lengths, code_lut, qrow, trow, diag,
                          qrev=None, comp=None, code2char=None,
                          budget=1 << 24):
    """Plain PyTorch version of the HAMMING rescore: the JAX package's
    device_rescore.rescore_pairs, mode 0, on the flat rows."""
    _check(rows, offsets, lengths, code_lut, qrow, trow, diag, None, qrev,
           comp, code2char)
    h = qrow.numel()
    dev = rows.device
    idents = torch.empty(h, dtype=torch.int32, device=dev)
    for at, ov, j, qch, tch, _, _ in _windows(
            rows, offsets, lengths, code_lut, qrow, trow, diag, qrev, comp,
            code2char, budget):
        idents[at] = ((qch == tch) & (j < ov[:, None])).sum(dim=1).to(
            idents.dtype)
    ends = torch.full((h,), -1, dtype=torch.int32, device=dev)
    return idents, ends, ends.clone(), idents.clone()


# the host's hits keep a diagonal's low 16 bits: its ungapped_best scores
# every diagonal that many apart from the hit's (plass_tpu's
# ops/rescore.py:155-176)
WRAP = 1 << 16


def _align_windows(rows, offsets, lengths, code_lut, qrow, trow, diag, sub,
                   qrev, comp, code2char, budget):
    """(score, first, last, idents) of each hit's own diagonal: the host
    loop as a cumulative sum and a running minimum at its latest index."""
    h = qrow.numel()
    outs = [torch.empty(h, dtype=torch.int32, device=rows.device)
            for _ in range(4)]
    if h == 0:
        return outs
    alpha = sub.shape[0]
    sub_flat = sub.reshape(-1).to(torch.int64)
    for at, ov, j, qch, tch, qc, tc in _windows(
            rows, offsets, lengths, code_lut, qrow, trow, diag, qrev, comp,
            code2char, budget):
        width = j.numel()
        inside = j < ov[:, None]
        c = torch.where(inside, sub_flat[qc * alpha + tc], 0).cumsum(1)
        # the running minimum of c[0..p] at its latest index: the minimum
        # of c * width + (width - 1 - j) orders by c, then by later j
        key = torch.cummin(c * width + (width - 1 - j), dim=1).values
        run_min = torch.div(key, width, rounding_mode="floor")
        run_at = width - 1 - (key - run_min * width)
        # c[-1] = 0 at index -1 takes part; a tie at 0 goes to the later j
        min_at = torch.where(run_min <= 0, run_at, -1)
        run = torch.where(inside, c - run_min.clamp(max=0), -1)
        best = run.max(dim=1).values.clamp(min=0)
        end = torch.where(run == best[:, None], j, width).min(dim=1).values
        start = min_at.gather(1, end.clamp(max=width - 1)[:, None])[:, 0] + 1
        found = best > 0
        start = torch.where(found, start, torch.where(ov > 0, 0, -1))
        end = torch.where(found, end, torch.where(ov > 0, 0, -1))
        in_seg = found[:, None] & (j >= start[:, None]) & (j <= end[:, None])
        idents = (((qch & FOLD) == (tch & FOLD)) & in_seg).sum(dim=1)
        for out, val in zip(outs, (best, start, end, idents)):
            out[at] = val.to(out.dtype)
    return outs


def wrap_candidates(qlen, tlen, diag):
    """The diagonals the host's ungapped_best scores for a hit, in its
    order, those that overlap the rows only: -k * WRAP + u16 for k = 1, 2,
    ..., then k * WRAP + u16 for k = 0, 1, ..., u16 the diagonal's low 16
    bits. The hit's own diagonal is one of them; it is the only one unless
    qlen + tlen > WRAP."""
    u16 = int(diag) & (WRAP - 1)
    neg = [-k * WRAP + u16 for k in range(1, 2 + tlen // (WRAP // 2))]
    pos = [k * WRAP + u16 for k in range(0, 1 + qlen // WRAP)]
    return [c for c in neg if -c < tlen] + [c for c in pos if c < qlen]


def rescore_align_plain(rows, offsets, lengths, code_lut, qrow, trow, diag,
                        sub, qrev=None, comp=None, code2char=None,
                        uniform=None, budget=1 << 24):
    """Plain PyTorch version of the ALIGNMENT rescore (the JAX package's
    ops/rescore.py:ungapped_best, mode 2, per hit) as [hits, window]
    gathers from the flat rows, in chunks of at most `budget` window cells.
    It scores through `sub` for both matrix variants (`uniform` only picks
    the kernel's variant). A hit with qlen + tlen > WRAP also scores its
    other wrap_candidates and keeps the first strictly greater score;
    returns (score, first, last, idents, diag) with the winning diagonal,
    the hit's own where no candidate scores above 0."""
    _check(rows, offsets, lengths, code_lut, qrow, trow, diag, sub, qrev,
           comp, code2char, uniform)
    outs = _align_windows(rows, offsets, lengths, code_lut, qrow, trow, diag,
                          sub, qrev, comp, code2char, budget)
    outs.append(diag.clone())
    qlen = lengths[qrow.long()].long()
    tlen = lengths[trow.long()].long()
    wide = torch.nonzero(qlen + tlen > WRAP)[:, 0].cpu().numpy()
    if not len(wide):
        return tuple(outs)
    ql, tl, dg = (x[wide].cpu().numpy() for x in (qlen, tlen, diag))
    cands = [wrap_candidates(int(a), int(b), int(d))
             for a, b, d in zip(ql, tl, dg)]
    hit = np.repeat(wide, [len(c) for c in cands])
    cand = np.concatenate(cands).astype(np.int32)
    dev = rows.device
    at = torch.from_numpy(hit).to(dev)
    got = _align_windows(rows, offsets, lengths, code_lut, qrow[at],
                         trow[at], torch.from_numpy(cand).to(dev), sub,
                         None if qrev is None else qrev[at], comp, code2char,
                         budget)
    score = got[0].cpu().numpy()
    # per hit, the first candidate with the greatest score, if above 0
    win, lo = [], 0
    for c in cands:
        top = lo + int(np.argmax(score[lo:lo + len(c)]))
        if score[top] > 0:
            win.append(top)
        lo += len(c)
    win = np.array(win, dtype=np.int64)
    keep = torch.from_numpy(hit[win]).to(dev)
    sel = torch.from_numpy(win).to(dev)
    for out, val in zip(outs, got):
        out[keep] = val[sel]
    outs[4][keep] = torch.from_numpy(cand[win]).to(dev)
    return tuple(outs)


def _check(rows, offsets, lengths, code_lut, qrow, trow, diag, sub,
           qrev=None, comp=None, code2char=None, uniform=None):
    if rows.dtype != torch.uint8 or rows.dim() != 1:
        raise TypeError("rows must be uint8[T], the flat sequence bytes")
    if offsets.dtype != torch.int64 or offsets.dim() != 1:
        raise TypeError("offsets must be int64[N]")
    if lengths.dtype != torch.int32 or lengths.shape != offsets.shape:
        raise TypeError("lengths must be int32[N] like offsets")
    if code_lut.dtype != torch.uint8 or code_lut.shape != (256,):
        raise TypeError("code_lut must be uint8[256]")
    for name, x in (("qrow", qrow), ("trow", trow), ("diag", diag)):
        if x.dtype != torch.int32 or x.dim() != 1 or x.shape != qrow.shape:
            raise TypeError(f"{name} must be int32[H] like qrow")
    tensors = [rows, offsets, lengths, code_lut, qrow, trow, diag]
    if sub is not None:   # HAMMING takes no matrix
        if (sub.dtype != torch.int32 or sub.dim() != 2
                or sub.shape[0] != sub.shape[1]
                or not 1 <= sub.shape[0] <= 32):
            raise TypeError("sub must be int32[A, A] with A <= 32")
        tensors.append(sub)
    rev_ops = (qrev, comp, code2char)
    if any(x is None for x in rev_ops) != all(x is None for x in rev_ops):
        raise ValueError("qrev, comp and code2char come together")
    if qrev is not None:
        alpha = sub.shape[0] if sub is not None else comp.numel()
        if not 1 <= alpha <= 32:
            raise TypeError("the alphabet must have 1 to 32 codes")
        if qrev.dtype != torch.bool or qrev.shape != qrow.shape:
            raise TypeError("qrev must be bool[H] like qrow")
        if comp.dtype != torch.int32 or comp.shape != (alpha,):
            raise TypeError("comp must be int32[A]")
        if code2char.dtype != torch.uint8 or code2char.shape != (alpha,):
            raise TypeError("code2char must be uint8[A]")
        tensors += [qrev, comp, code2char]
    elif uniform is not None:
        raise ValueError("the uniform-matrix variant takes reverse hits")
    if any(x.device != rows.device for x in tensors):
        raise ValueError("all operands must be on one device")
    return tensors


def _launch(name, rows, offsets, lengths, code_lut, qrow, trow, diag,
            tensors, middle, n_out=4):
    """Launch the entry `name` of the rescore library on the flat rows and
    hits, with `middle` (the variant's operands between diag and h, as
    ctypes takes them): returns the n_out outputs."""
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if rows.data_ptr() % 4:
        raise ValueError(f"{name}: rows must be 4-byte aligned")
    h = qrow.numel()
    dev = rows.device
    outs = [torch.empty(h, dtype=torch.int32, device=dev)
            for _ in range(n_out)]
    # the kernel's queue of long-window hits: a count, then up to h indices
    queue = torch.empty(h + 1, dtype=torch.int32, device=dev)
    lib = build.load("rescore")
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(
            build.ptr(rows), rows.numel(), build.ptr(offsets),
            build.ptr(lengths), build.ptr(code_lut), build.ptr(qrow),
            build.ptr(trow), build.ptr(diag), *middle, h,
            *[build.ptr(o) for o in outs], build.ptr(queue),
            build.stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {rc})")
    return tuple(outs)


def _rev_middle(qrev, sub, comp, code2char, uniform):
    """rescore_e2e_rev's and rescore_align's operands between diag and h."""
    match, mismatch = uniform if uniform is not None else (0, 0)
    return (build.ptr(qrev), build.ptr(sub), build.ptr(comp),
            build.ptr(code2char), sub.shape[0], int(uniform is not None),
            match, mismatch)


def rescore_e2e(rows, offsets, lengths, code_lut, qrow, trow, diag, sub,
                qrev=None, comp=None, code2char=None, uniform=None):
    """END_TO_END rescore; see the module docstring."""
    if rows.device.type == "cpu":
        return rescore_e2e_plain(rows, offsets, lengths, code_lut, qrow, trow,
                                 diag, sub, qrev, comp, code2char, uniform)
    if rows.device.type != "cuda":
        raise ValueError(f"rescore_e2e: unsupported device {rows.device}")
    tensors = _check(rows, offsets, lengths, code_lut, qrow, trow, diag, sub,
                     qrev, comp, code2char, uniform)
    global LAUNCHES, LAUNCHES_REV, LAUNCHES_REV_UNIFORM
    if qrev is None:
        outs = _launch("rescore_e2e", rows, offsets, lengths, code_lut, qrow,
                       trow, diag, tensors,
                       (build.ptr(sub), sub.shape[0]))
    else:
        outs = _launch("rescore_e2e_rev", rows, offsets, lengths, code_lut,
                       qrow, trow, diag, tensors, _rev_middle(
                           qrev, sub, comp, code2char, uniform))
    if qrow.numel() == 0:
        return outs
    if qrev is None:
        LAUNCHES += 1
    elif uniform is None:
        LAUNCHES_REV += 1
    else:
        LAUNCHES_REV_UNIFORM += 1
    return outs


def rescore_hamming(rows, offsets, lengths, code_lut, qrow, trow, diag,
                    qrev=None, comp=None, code2char=None):
    """HAMMING rescore; see the module docstring."""
    if rows.device.type == "cpu":
        return rescore_hamming_plain(rows, offsets, lengths, code_lut, qrow,
                                     trow, diag, qrev, comp, code2char)
    if rows.device.type != "cuda":
        raise ValueError(f"rescore_hamming: unsupported device {rows.device}")
    tensors = _check(rows, offsets, lengths, code_lut, qrow, trow, diag,
                     None, qrev, comp, code2char)
    global LAUNCHES_HAMMING, LAUNCHES_HAMMING_REV
    # the alphabet bounds the codes the kernel's tables take (comp's size
    # on reverse hits; forward hits read no code)
    alpha = comp.numel() if comp is not None else 32
    outs = _launch("rescore_hamming", rows, offsets, lengths, code_lut, qrow,
                   trow, diag, tensors, (build.ptr(qrev), build.ptr(comp),
                                         build.ptr(code2char), alpha))
    if qrow.numel() == 0:
        return outs
    if qrev is None:
        LAUNCHES_HAMMING += 1
    else:
        LAUNCHES_HAMMING_REV += 1
    return outs


def rescore_align(rows, offsets, lengths, code_lut, qrow, trow, diag, sub,
                  qrev=None, comp=None, code2char=None, uniform=None):
    """ALIGNMENT rescore (B12); see the module docstring."""
    if rows.device.type == "cpu":
        return rescore_align_plain(rows, offsets, lengths, code_lut, qrow,
                                   trow, diag, sub, qrev, comp, code2char,
                                   uniform)
    if rows.device.type != "cuda":
        raise ValueError(f"rescore_align: unsupported device {rows.device}")
    tensors = _check(rows, offsets, lengths, code_lut, qrow, trow, diag, sub,
                     qrev, comp, code2char, uniform)
    global LAUNCHES_ALIGN, LAUNCHES_ALIGN_REV
    outs = _launch("rescore_align", rows, offsets, lengths, code_lut, qrow,
                   trow, diag, tensors, _rev_middle(
                       qrev, sub, comp, code2char, uniform), n_out=5)
    if qrow.numel() == 0:
        return outs
    if qrev is None:
        LAUNCHES_ALIGN += 1
    else:
        LAUNCHES_ALIGN_REV += 1
    return outs
