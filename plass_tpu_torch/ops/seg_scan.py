"""Segmented inclusive scans of the device k-mer matcher (kernel K1).

`seg_scan(kind, flag, *vals, reverse=False)` scans the int32 columns `vals`
in segments that start where the bool `flag` is set, with one of three
combine functions op(earlier, later) (the JAX package's
ops/pallas_scan.py:_combine):

  "first"  every element takes the values of its segment's first element
           (the first element of the scan must carry a flag)
  "cummax" segmented running max
  "sfx2"   vals (c, pk[, payload]): the lexicographic max of (c, pk),
           carrying the payload; the earlier operand wins ties

With reverse=True the scan runs from the last index to the first: a flag
then marks the first element of a segment in that order, i.e. a segment's
LAST index, and "earlier" means the higher index. This is the JAX
package's flip / scan / flip without the copies.

On a CUDA tensor the call launches the CUDA kernel (csrc/seg_scan.cu: one
single-pass launch per call, after the reset of its tile descriptors) or
raises; on a CPU tensor it runs `seg_scan_plain`.
"""
import torch

from ..kernels import build

KINDS = {"first": 0, "cummax": 1, "sfx2": 2}

# launches of the CUDA kernel in this process (one per seg_scan call on a
# CUDA tensor)
LAUNCHES = 0


def _combine(kind, af, avs, bf, bvs):
    """op(earlier a, later b) on (flag, vals) tensors -> (flag, vals)."""
    f = af | bf
    if kind == "first":
        return f, [torch.where(bf, bv, av) for av, bv in zip(avs, bvs)]
    if kind == "cummax":
        return f, [torch.where(bf, bv, torch.maximum(av, bv))
                   for av, bv in zip(avs, bvs)]
    ac, apk, bc, bpk = avs[0], avs[1], bvs[0], bvs[1]
    a_wins = ~bf & ((ac > bc) | ((ac == bc) & (apk >= bpk)))
    return f, [torch.where(a_wins, av, bv) for av, bv in zip(avs, bvs)]


def seg_scan_plain(kind, flag, *vals, reverse=False):
    """Plain PyTorch version: a Hillis-Steele doubling scan (log2(n)
    rounds of torch.where over the whole column). Returns the scanned
    vals as a tuple."""
    _check(kind, flag, vals)
    f = flag
    vs = list(vals)
    n = f.numel()
    d = 1
    while d < n:
        if reverse:   # element i combines i + d (earlier) with itself
            a, b = slice(d, None), slice(None, n - d)
        else:         # element i combines i - d (earlier) with itself
            a, b = slice(None, n - d), slice(d, None)
        nf, nvs = _combine(kind, f[a], [v[a] for v in vs],
                           f[b], [v[b] for v in vs])
        if reverse:
            f = torch.cat([nf, f[n - d:]])
            vs = [torch.cat([nv, v[n - d:]]) for nv, v in zip(nvs, vs)]
        else:
            f = torch.cat([f[:d], nf])
            vs = [torch.cat([v[:d], nv]) for nv, v in zip(nvs, vs)]
        d *= 2
    return tuple(v.clone() if v is u else v for v, u in zip(vs, vals))


def _check(kind, flag, vals):
    if kind not in KINDS:
        raise ValueError(f"unknown scan kind {kind!r}")
    if not 1 <= len(vals) <= 3 or (kind == "sfx2" and len(vals) < 2):
        raise ValueError(f"{kind}: unsupported number of columns {len(vals)}")
    if flag.dtype != torch.bool or flag.dim() != 1:
        raise TypeError("flag must be a 1-D bool tensor")
    for v in vals:
        if v.dtype != torch.int32 or v.shape != flag.shape:
            raise TypeError("vals must be int32 tensors shaped like flag")
        if v.device != flag.device:
            raise ValueError("flag and vals must be on one device")


def seg_scan(kind, flag, *vals, reverse=False):
    """Segmented inclusive scan; see the module docstring."""
    if flag.device.type == "cpu":
        return seg_scan_plain(kind, flag, *vals, reverse=reverse)
    if flag.device.type != "cuda":
        raise ValueError(f"seg_scan: unsupported device {flag.device}")
    _check(kind, flag, vals)
    if not flag.is_contiguous() or not all(v.is_contiguous() for v in vals):
        raise ValueError("seg_scan: tensors must be contiguous")
    global LAUNCHES
    n = flag.numel()
    nv = len(vals)
    outs = [torch.empty_like(v) for v in vals]
    if n == 0:
        return tuple(outs)
    lib = build.load("seg_scan")
    # the tile descriptors of the single-pass scan: a tile counter, a status
    # word and two value slots per tile; the kernel's entry point resets
    # the counter and the status words on the stream
    scratch = torch.empty(lib.seg_scan_scratch_ints(n), dtype=torch.int32,
                          device=flag.device)
    ins = [build.ptr(v) for v in vals] + [None] * (3 - nv)
    ops = [build.ptr(o) for o in outs] + [None] * (3 - nv)
    with torch.cuda.device(flag.device):
        rc = lib.seg_scan(
            KINDS[kind], nv, int(reverse), build.ptr(flag), *ins, *ops, n,
            build.ptr(scratch), build.stream_of(flag.device))
    if rc != 0:
        raise RuntimeError(f"seg_scan kernel launch failed (CUDA error {rc})")
    LAUNCHES += 1
    return tuple(outs)
