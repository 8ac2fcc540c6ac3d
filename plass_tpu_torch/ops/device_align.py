"""Batched score-only Smith-Waterman of the amino-acid aligner (kernel B9).

The reference's align stage scores every (query, target) candidate with
striped SIMD SW (StripedSmithWaterman.cpp:71-231) before most of them fail
the E-value test. `sw_score` computes the exact same local affine-gap
maxima for every pair in one call (the JAX package's
ops/device_align.py:sw_score_batch), so the E-value rejection it allows is
bit-equivalent to rejecting after a full ssw call; positions and
backtraces of the survivors stay with the host aligner.

  qcodes   uint8[TQ]   the queries' codes back to back (codes < A)
  qoffsets int64[NQ]   query n starts at qcodes[qoffsets[n]]
  qlens    int32[NQ]
  bias     int8[TQ]    the queries' rounded composition bias, per residue
  rows     uint8[T]    the target DB's own bytes (SeqDB.data, flat_rows)
  offsets  int64[N], lengths int32[N], code_lut uint8[256] as K2 reads them
  qidx, tidx int32[B]  the pairs: query index, target row
  order    int32[B]    the order the kernel takes the pairs in (schedule)
  plan     int64[7 + classes] on the host: which pairs take which path
  strip_cols int       the wrap scratch's columns (schedule)
  sub      int32[A, A] (A <= 32); gap_open >= gap_extend

`schedule` makes order, plan and strip_cols from the pairs' lengths and
the queries' bias range. The kernel (csrc/sw_score.cu) sends a pair whose
query is longer than plan[0] (STRIP_ROWS, one warp's strip), or spans two
strips and has many cells, to warps of a block that sweep its strips as a
wavefront; the rest go to groups of lanes sized to the query (CLASS_ROWS),
several pairs a warp.

Returns int32[B]: -1 for a pair whose query is longer than plan[0] and
whose target is longer than strip_cols, -2 for a pair whose query's bias
leaves the plan's range, else its score. Nothing is padded. On a CUDA
tensor the call launches the CUDA kernel or raises; on a CPU tensor it
runs `sw_score_plain`, a loop over target columns on [B, LQ] tensors.
"""
import ctypes

import numpy as np
import torch

from ..kernels import build

NEG = -(1 << 30)
# a pair of at least this many cells, and at least tail_share-th of the
# call's, takes the block path if its query spans two strips of a block
BLOCK_CELLS = 1 << 18
TAIL_SHARE = 512
# a call whose pairs fill about this many warps (an H100 holds 2,112 at 16
# an SM) gives its block-path pairs the fewest warps their strips fill,
# several pairs a block, rather than a block each
FULL_WARPS = 2048
BLOCK_WARPS = 8   # a block's warps (csrc/sw_score.cu, kWarps)

# calls of the CUDA kernel in this process, the pairs they scored and
# those of them that took the block path
LAUNCHES = 0
PAIRS = 0
BLOCK_PAIRS = 0


def _class_rows(max_r=16, r_step=2):
    """The rows each warp-path class of csrc/sw_score.cu holds (its kMaxR,
    kRStep, kMinLanes = 1): one lane of 1 row and of r_step .. max_r rows,
    then 2 .. 32 lanes of max_r / 2 + r_step .. max_r rows each; the last
    is a warp's strip, 32 * max_r."""
    upper = range(max_r // 2 + r_step, max_r + 1, r_step)
    return tuple([1, *range(r_step, max_r + 1, r_step)]
                 + [g * r for g in (2, 4, 8, 16, 32) for r in upper])


CLASS_ROWS = _class_rows()
# the longest query of one warp's strip: longer ones take the block path,
# and wrap through the scratch past a block's strips
STRIP_ROWS = CLASS_ROWS[-1]


def _check(qcodes, qoffsets, qlens, bias, rows, offsets, lengths, code_lut,
           qidx, tidx, order, plan, strip_cols, sub, gap_open, gap_extend):
    for name, x, dtype in (("qcodes", qcodes, torch.uint8),
                           ("bias", bias, torch.int8),
                           ("rows", rows, torch.uint8)):
        if x.dtype != dtype or x.dim() != 1:
            raise TypeError(f"{name} must be {dtype}[n]")
    if bias.shape != qcodes.shape:
        raise TypeError("bias must hold one value per query residue")
    for name, off, lens in (("query", qoffsets, qlens),
                            ("target", offsets, lengths)):
        if off.dtype != torch.int64 or lens.dtype != torch.int32 \
                or off.dim() != 1 or lens.shape != off.shape:
            raise TypeError(f"{name} offsets must be int64[n] and lengths "
                            f"int32[n] like them")
    if code_lut.dtype != torch.uint8 or code_lut.shape != (256,):
        raise TypeError("code_lut must be uint8[256]")
    if any(x.dtype != torch.int32 or x.shape != qidx.shape
           for x in (qidx, tidx, order)) or qidx.dim() != 1:
        raise TypeError("qidx, tidx and order must be int32[B]")
    if strip_cols < 0:
        raise ValueError("strip_cols must be >= 0")
    plan = [int(x) for x in plan]
    if len(plan) < 8 or min(plan[3:]) < 0 or sum(plan[4:]) != qidx.numel():
        raise ValueError("plan must be schedule()'s for these pairs")
    if (sub.dtype != torch.int32 or sub.dim() != 2
            or sub.shape[0] != sub.shape[1] or not 1 <= sub.shape[0] <= 32):
        raise TypeError("sub must be int32[A, A] with A <= 32")
    if not 0 <= gap_extend <= gap_open:
        raise ValueError("the column scan needs gap_open >= gap_extend >= 0")
    tensors = [qcodes, qoffsets, qlens, bias, rows, offsets, lengths,
               code_lut, qidx, tidx, order, sub]
    if any(x.device != rows.device for x in tensors):
        raise ValueError("all operands must be on one device")
    return tensors


def sw_score_plain(qcodes, qoffsets, qlens, bias, rows, offsets, lengths,
                   code_lut, qidx, tidx, order, plan, strip_cols, sub,
                   gap_open, gap_extend, budget=1 << 22):
    """Plain PyTorch version: the JAX package's sw_score_batch (a scan over
    target columns of [B, LQ] H and E, F closed as a prefix max of
    H0 + i * gape), on pairs gathered from the flat operands, in chunks of
    at most `budget` query cells; order and the plan's paths only arrange
    the kernel's work."""
    _check(qcodes, qoffsets, qlens, bias, rows, offsets, lengths, code_lut,
           qidx, tidx, order, plan, strip_cols, sub, gap_open, gap_extend)
    dev = rows.device
    n = qidx.numel()
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    alpha = sub.shape[0]
    sub_flat = sub.reshape(-1).long()
    lut = code_lut.long().clamp(max=alpha - 1)
    ql_all = qlens[qidx.long()].long()
    tl_all = lengths[tidx.long()].long()
    lq = max(int(ql_all.max()), 1)
    chunk = max(budget // lq, 1)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        ql, tl = ql_all[lo:hi], tl_all[lo:hi]
        b = hi - lo
        width = max(int(ql.max()), 1)
        lt = int(tl.max())
        ii = torch.arange(width, device=dev)
        imask = ii[None, :] < ql[:, None]
        qpos = (qoffsets[qidx[lo:hi].long()][:, None] + ii).clamp(
            max=max(qcodes.numel() - 1, 0))
        q = torch.where(imask, qcodes[qpos].long(), 0) if qcodes.numel() \
            else torch.zeros((b, width), dtype=torch.long, device=dev)
        bq = torch.where(imask, bias[qpos].long(), 0) if bias.numel() \
            else torch.zeros((b, width), dtype=torch.long, device=dev)
        jj = torch.arange(max(lt, 1), device=dev)
        tpos = (offsets[tidx[lo:hi].long()][:, None] + jj).clamp(
            max=max(rows.numel() - 1, 0))
        t = lut[rows[tpos].long()]
        igape = ii * gap_extend
        h = torch.zeros((b, width), dtype=torch.long, device=dev)
        e = torch.full((b, width), NEG, dtype=torch.long, device=dev)
        best = torch.zeros(b, dtype=torch.long, device=dev)
        neg_col = torch.full((b, 1), NEG, dtype=torch.long, device=dev)
        zero_col = torch.zeros((b, 1), dtype=torch.long, device=dev)
        for j in range(lt):
            s = sub_flat[q * alpha + t[:, j:j + 1]] + bq
            e2 = torch.maximum(h - gap_open, e - gap_extend)
            hdiag = torch.cat([zero_col, h[:, :-1]], dim=1)
            h0 = torch.clamp(torch.maximum(hdiag + s, e2), min=0)
            h0 = torch.where(imask, h0, 0)
            pm = torch.cummax(h0 + igape, dim=1).values
            pm = torch.cat([neg_col, pm[:, :-1]], dim=1)
            f = pm - (ii - 1) * gap_extend - gap_open
            h1 = torch.where(imask, torch.maximum(h0, f), 0)
            ok = (j < tl)[:, None]
            h = torch.where(ok, h1, h)
            e = torch.where(ok, e2, e)
            best = torch.maximum(best, torch.where(ok, h, 0).amax(dim=1))
        out[lo:hi] = best.to(torch.int32)
    # the kernel's -2 for a query with a bias outside the plan's range
    lo, hi = int(plan[1]), int(plan[2])
    oob = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                     ((bias < lo) | (bias > hi)).long().cumsum(0)])
    qi = qidx.long()
    start = qoffsets[qi]
    n_oob = oob[start + qlens[qi].long()] - oob[start]
    out[(n_oob > 0) & (ql_all > 0) & (tl_all > 0)] = -2
    out[(ql_all > int(plan[0])) & (tl_all > strip_cols)] = -1
    return out


def schedule(qlens, tlens, bias_range=(0, 0), classes=CLASS_ROWS,
             tail_share=TAIL_SHARE,
             full_warps=FULL_WARPS, block_warps=BLOCK_WARPS):
    """(order, plan, strip_cols) for pairs of these query and target
    lengths (numpy, one each a pair) whose queries' bias lies in
    bias_range (least, most), for a kernel of these warp-path classes
    (rows each holds) and warps a block.

    A pair takes the block path when its query is longer than a warp's
    strip (classes[-1]), or when it spans two strips of a block (more than
    half of that) and has at least the larger of BLOCK_CELLS and the
    tail_share-th part of the call's cells (tail_share 0: no such pair),
    so that a pair takes a block only where alone on a warp it
    would outlast the rest of the call. When the pairs fill full_warps
    warps, throughput counts: a block-path pair takes the fewest warps its
    strips of the most rows fill (a block of 1, 2 or 4 pairs), and the
    kernel gives its lanes the fewest rows that keep its strips in them;
    else each pair takes a whole block, longest first, and the kernel
    picks its rows so that its strips fill the block. The rest take
    the least warp-path class that holds their query, from the highest
    class down, each by longest target, so that the pairs that share a
    warp sweep about as many columns.

    plan is [classes[-1], the bias range, 1 when the call fills the card
    (else 0), the block-path pairs of 1, 2 and 4 a block, the pairs of
    each warp-path class];
    strip_cols the wrap scratch's columns, the longest target of a query
    longer than classes[-1] (0 when there is none)."""
    qlens = np.asarray(qlens, dtype=np.int64)
    tlens = np.asarray(tlens, dtype=np.int64)
    strip_rows = classes[-1]
    cells = qlens * tlens
    block_cells = max(BLOCK_CELLS, int(cells.sum()) // tail_share) \
        if tail_share else np.inf
    block = (qlens > strip_rows) | ((cells >= block_cells)
                                    & (qlens > strip_rows // 2))
    cls = np.searchsorted(np.asarray(classes), np.maximum(qlens, 1))
    counts = np.bincount(cls[~block], minlength=len(classes))[:len(classes)]
    # a pair of the class of c rows takes about c / strip_rows of a warp,
    # a block-path pair a warp a strip
    strips = -(-qlens // strip_rows)
    warps = float((counts * np.maximum(np.asarray(classes) / strip_rows,
                                       1 / 32)).sum()) \
        + float(strips[block].sum())
    full = warps >= full_warps
    # block class b: 2^b pairs a block of block_warps >> b warps each, the
    # fewest warps whose strips hold the query (a query that wraps: b = 0)
    ws = np.minimum(block_warps, 1 << np.ceil(np.log2(np.maximum(strips, 1)))
                    .astype(np.int64))
    bcls = np.where(block & full,
                    np.minimum(2, np.log2(block_warps // ws).astype(np.int64)),
                    0)
    order = np.lexsort((-cells, np.where(block & (not full), -cells, -tlens),
                        np.where(block, bcls, -cls), ~block)).astype(np.int32)
    plan = np.array([strip_rows, *bias_range, int(full),
                     *np.bincount(bcls[block], minlength=3)[:3].tolist(),
                     *counts.tolist()], dtype=np.int64)
    long_q = qlens > strip_rows
    return order, plan, int(tlens[long_q].max()) if long_q.any() else 0


def sw_score(qcodes, qoffsets, qlens, bias, rows, offsets, lengths, code_lut,
             qidx, tidx, order, plan, strip_cols, sub, gap_open, gap_extend):
    """Best local SW score per pair; see the module docstring."""
    if rows.device.type == "cpu":
        return sw_score_plain(qcodes, qoffsets, qlens, bias, rows, offsets,
                              lengths, code_lut, qidx, tidx, order, plan,
                              strip_cols, sub, gap_open, gap_extend)
    if rows.device.type != "cuda":
        raise ValueError(f"sw_score: unsupported device {rows.device}")
    tensors = _check(qcodes, qoffsets, qlens, bias, rows, offsets, lengths,
                     code_lut, qidx, tidx, order, plan, strip_cols, sub,
                     gap_open, gap_extend)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("sw_score: tensors must be contiguous")
    global LAUNCHES, PAIRS, BLOCK_PAIRS
    n = qidx.numel()
    dev = rows.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = build.load("sw_score")
    plan = [int(x) for x in plan]
    if len(plan) != lib.sw_score_plan_size() \
            or plan[0] != lib.sw_score_strip_rows():
        raise RuntimeError("sw_score: the plan is not for this kernel's "
                           "classes (schedule(**kernel_shape()))")
    alpha = sub.shape[0]
    with torch.cuda.device(dev):
        blocks = lib.sw_score_resident_blocks(alpha, plan[2] - plan[1] + 1)
        if blocks <= 0:
            raise RuntimeError(f"sw_score: no block resident (CUDA error "
                               f"{-blocks})")
        strips = torch.empty(2 * blocks * strip_cols or 1, dtype=torch.int32,
                             device=dev)
        counters = torch.empty(lib.sw_score_counters(), dtype=torch.int32,
                               device=dev)
        host_plan = (ctypes.c_int64 * len(plan))(*plan)
        rc = lib.sw_score(
            *[build.ptr(x) for x in (qcodes, qoffsets, qlens, bias, rows,
                                     offsets, lengths, code_lut, qidx, tidx,
                                     order)],
            ctypes.cast(host_plan, ctypes.c_void_p), n, build.ptr(sub),
            alpha, int(gap_open), int(gap_extend), build.ptr(out),
            build.ptr(counters), build.ptr(strips), strip_cols,
            build.stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"sw_score kernel launch failed (code {rc})")
    LAUNCHES += 1
    PAIRS += n
    BLOCK_PAIRS += sum(plan[4:7])
    return out


def kernel_shape(lib=None):
    """schedule()'s classes and block_warps for the built kernel (lib, or
    the package's), to schedule for a kernel built with other constants."""
    lib = lib or build.load("sw_score")
    return dict(classes=tuple(lib.sw_score_class_rows(c)
                              for c in range(lib.sw_score_classes())),
                block_warps=lib.sw_score_block_warps())


def pair_operands(db, tdb, pairs, bias_fn, device):
    """sw_score's operands on `device` for (qkey, tkey) pairs of query DB
    `db` and target DB `tdb`, all but the gaps: the distinct queries' codes
    and bias from bias_fn(qid) -> (qnum uint8[L], comp int8[L]) back to
    back, the target DB's flat rows, the pairs' indices, their schedule
    (order and the host plan, from the host's lengths) and blosum62."""
    from .. import constants
    from .backend import flat_rows

    qkeys = sorted({q for q, _ in pairs})
    qpos = {k: i for i, k in enumerate(qkeys)}
    parts = [bias_fn(db.key_to_id(k)) for k in qkeys]
    qlens = np.array([len(qn) for qn, _ in parts], dtype=np.int32)
    qoff = np.concatenate([[0], np.cumsum(qlens, dtype=np.int64)[:-1]])
    qcodes = np.concatenate([qn for qn, _ in parts]).astype(np.uint8)
    bias = np.concatenate([c for _, c in parts]).astype(np.int8)
    tlut = tdb.id_lookup_array()
    qidx = np.array([qpos[q] for q, _ in pairs], dtype=np.int32)
    tidx = tlut[np.array([t for _, t in pairs], dtype=np.int64)] \
        .astype(np.int32)
    order, plan, strip_cols = schedule(
        qlens[qidx], tdb.seq_lens()[tidx],
        (int(bias.min()), int(bias.max())) if len(bias) else (0, 0))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (dev(qcodes), dev(qoff.astype(np.int64)), dev(qlens), dev(bias),
            *flat_rows(tdb, device, "score"), dev(qidx), dev(tidx),
            dev(order), plan, strip_cols,
            dev(constants.blosum62().sub.astype(np.int32)))


def batch_pair_scores(db, tdb, pairs, bias_fn, gap_open, gap_extend, device):
    """Host glue: score all (qkey, tkey) pairs on `device` in one call
    (operands as pair_operands builds them). Returns {(qkey, tkey):
    score}."""
    scores = sw_score(*pair_operands(db, tdb, pairs, bias_fn, device),
                      gap_open, gap_extend).cpu().numpy()
    if (scores < 0).any():
        raise RuntimeError("sw_score: a pair outgrew its wrap scratch or "
                           "its plan")
    return {pair: int(s) for pair, s in zip(pairs, scores)}
