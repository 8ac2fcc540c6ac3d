"""Batched score-only Smith-Waterman of the amino-acid aligner (kernel B9).

The reference's align stage scores every (query, target) candidate with
striped SIMD SW (StripedSmithWaterman.cpp:71-231) before most of them fail
the E-value test. `sw_score` computes the exact same local affine-gap
maxima for every pair in one launch (the JAX package's
ops/device_align.py:sw_score_batch), so the E-value rejection it allows is
bit-equivalent to rejecting after a full ssw call; positions and
backtraces of the survivors stay with the host aligner.

  qcodes   uint8[TQ]   the queries' codes back to back
  qoffsets int64[NQ]   query n starts at qcodes[qoffsets[n]]
  qlens    int32[NQ]
  bias     int8[TQ]    the queries' rounded composition bias, per residue
  rows     uint8[T]    the target DB's own bytes (SeqDB.data, flat_rows)
  offsets  int64[N], lengths int32[N], code_lut uint8[256] as K2 reads them
  qidx, tidx int32[B]  the pairs: query index, target row
  order    int32[B]    the order the kernel takes the pairs in (schedule)
  strip_cols int       the strip scratch's columns (schedule)
  sub      int32[A, A] (A <= 32); gap_open >= gap_extend

Returns int32[B]: -1 for a pair whose query is longer than STRIP_ROWS and
whose target is longer than strip_cols, else its score. Nothing is padded.
On a CUDA tensor the call launches the CUDA kernel (csrc/sw_score.cu) or
raises; on a CPU tensor it runs `sw_score_plain`, a loop over target
columns on [B, LQ] tensors.
"""
import numpy as np
import torch

from ..kernels import build

NEG = -(1 << 30)
# the longest query the kernel holds in one strip (csrc/sw_score.cu,
# 32 * kMaxR); longer ones pass two ints per target column between strips
STRIP_ROWS = 512

# launches of the CUDA kernel in this process, and the pairs they scored
LAUNCHES = 0
PAIRS = 0


def _check(qcodes, qoffsets, qlens, bias, rows, offsets, lengths, code_lut,
           qidx, tidx, order, strip_cols, sub, gap_open, gap_extend):
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
                   code_lut, qidx, tidx, order, strip_cols, sub, gap_open,
                   gap_extend, budget=1 << 22):
    """Plain PyTorch version: the JAX package's sw_score_batch (a scan over
    target columns of [B, LQ] H and E, F closed as a prefix max of
    H0 + i * gape), on pairs gathered from the flat operands, in chunks of
    at most `budget` query cells; order only orders the kernel's work."""
    _check(qcodes, qoffsets, qlens, bias, rows, offsets, lengths, code_lut,
           qidx, tidx, order, strip_cols, sub, gap_open, gap_extend)
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
    out[(ql_all > STRIP_ROWS) & (tl_all > strip_cols)] = -1
    return out


def schedule(qlens, tlens):
    """(order, strip_cols) for pairs of these query and target lengths
    (numpy, one each a pair): the pairs longest first, so that none starts
    last, and the strip scratch's columns, the longest target of a pair
    whose query is longer than STRIP_ROWS (0 when there is none)."""
    cells = qlens.astype(np.int64) * tlens
    order = np.argsort(-cells, kind="stable").astype(np.int32)
    long_q = qlens > STRIP_ROWS
    return order, int(tlens[long_q].max()) if long_q.any() else 0


def sw_score(qcodes, qoffsets, qlens, bias, rows, offsets, lengths, code_lut,
             qidx, tidx, order, strip_cols, sub, gap_open, gap_extend):
    """Best local SW score per pair; see the module docstring."""
    if rows.device.type == "cpu":
        return sw_score_plain(qcodes, qoffsets, qlens, bias, rows, offsets,
                              lengths, code_lut, qidx, tidx, order,
                              strip_cols, sub, gap_open, gap_extend)
    if rows.device.type != "cuda":
        raise ValueError(f"sw_score: unsupported device {rows.device}")
    tensors = _check(qcodes, qoffsets, qlens, bias, rows, offsets, lengths,
                     code_lut, qidx, tidx, order, strip_cols, sub, gap_open,
                     gap_extend)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("sw_score: tensors must be contiguous")
    global LAUNCHES, PAIRS
    n = qidx.numel()
    dev = rows.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = build.load("sw_score")
    if lib.sw_score_strip_rows() != STRIP_ROWS:
        raise RuntimeError("sw_score: STRIP_ROWS differs from the kernel's")
    strips = torch.empty(2 * lib.sw_score_warps(n) * strip_cols or 1,
                         dtype=torch.int32, device=dev)
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sw_score(
            *[build.ptr(x) for x in (qcodes, qoffsets, qlens, bias, rows,
                                     offsets, lengths, code_lut, qidx, tidx,
                                     order)],
            n, build.ptr(sub), sub.shape[0], int(gap_open), int(gap_extend),
            build.ptr(out), build.ptr(counter), build.ptr(strips),
            strip_cols, build.stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"sw_score kernel launch failed (CUDA error {rc})")
    LAUNCHES += 1
    PAIRS += n
    return out


def pair_operands(db, tdb, pairs, bias_fn, device):
    """sw_score's operands on `device` for (qkey, tkey) pairs of query DB
    `db` and target DB `tdb`, all but the gaps: the distinct queries' codes
    and bias from bias_fn(qid) -> (qnum uint8[L], comp int8[L]) back to
    back, the target DB's flat rows, the pairs' indices, their schedule
    (from the host's lengths) and blosum62."""
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
    order, strip_cols = schedule(qlens[qidx], tdb.seq_lens()[tidx])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (dev(qcodes), dev(qoff.astype(np.int64)), dev(qlens), dev(bias),
            *flat_rows(tdb, device, "score"), dev(qidx), dev(tidx),
            dev(order), strip_cols,
            dev(constants.blosum62().sub.astype(np.int32)))


def batch_pair_scores(db, tdb, pairs, bias_fn, gap_open, gap_extend, device):
    """Host glue: score all (qkey, tkey) pairs on `device` in one call
    (operands as pair_operands builds them). Returns {(qkey, tkey):
    score}."""
    scores = sw_score(*pair_operands(db, tdb, pairs, bias_fn, device),
                      gap_open, gap_extend).cpu().numpy()
    if (scores < 0).any():
        raise RuntimeError("sw_score: a pair outgrew its strip scratch")
    return {pair: int(s) for pair, s in zip(pairs, scores)}
