"""PyTorch port, kernel K1: seg_scan_plain (the CPU path of seg_scan)
against the JAX package's Pallas segmented scan in interpret mode (blocks
shrunk to 1K so the carry crosses many grid steps) and against
jax.lax.associative_scan — every kind, forward and reverse, exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plass_tpu.ops import pallas_scan as ps
from plass_tpu_torch.ops.seg_scan import seg_scan, seg_scan_plain

N = 1024 * 4 + 700   # padding + 4 block boundaries


def _inputs(kind, nvals, reverse, density):
    rng = np.random.default_rng(nvals * 10 + int(reverse) + int(density * 1e3))
    flag = rng.random(N) < density
    flag[-1 if reverse else 0] = True   # the scan's first element
    if kind == "sfx2":   # few distinct counts, so ties are frequent
        cols = [rng.integers(-1, 40, N), rng.integers(-1, 2**24, N)]
        cols += [rng.integers(-2**31, 2**31, N)] * (nvals - 2)
    else:
        cols = [rng.integers(-2**31, 2**31, N) for _ in range(nvals)]
    return flag, [c.astype(np.int32) for c in cols]


def _assoc_ref(kind, flag, cols):
    def op(a, b):
        af, avs = a[0], a[1:]
        bf, bvs = b[0], b[1:]
        if kind == "first":
            out = [jnp.where(bf, bv, av) for av, bv in zip(avs, bvs)]
        elif kind == "cummax":
            out = [jnp.where(bf, bv, jnp.maximum(av, bv))
                   for av, bv in zip(avs, bvs)]
        else:
            a_wins = ~bf & ((avs[0] > bvs[0])
                            | ((avs[0] == bvs[0]) & (avs[1] >= bvs[1])))
            out = [jnp.where(a_wins, av, bv) for av, bv in zip(avs, bvs)]
        return (af | bf, *out)
    res = jax.lax.associative_scan(
        op, (jnp.asarray(flag), *[jnp.asarray(c) for c in cols]))
    return [np.asarray(r) for r in res[1:]]


def _flip(x):
    return x[::-1].copy()


CASES = [(k, nv) for k in ("first", "cummax") for nv in (1, 2, 3)] + \
    [("sfx2", 2), ("sfx2", 3)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind,nvals", CASES)
def test_seg_scan_plain_matches_pallas_and_assoc(kind, nvals, reverse):
    flag, cols = _inputs(kind, nvals, reverse, 0.02)
    got = seg_scan_plain(kind, torch.from_numpy(flag),
                         *[torch.from_numpy(c) for c in cols],
                         reverse=reverse)
    # the JAX package runs a suffix scan as flip / forward scan / flip
    f_in = _flip(flag) if reverse else flag
    c_in = [_flip(c) for c in cols] if reverse else cols
    ref = _assoc_ref(kind, f_in, c_in)
    old_blk, old_r = ps.BLK, ps._R
    ps.BLK = 1024
    ps._R = ps.BLK // ps._C
    try:
        pal = ps.seg_scan_pallas(kind, jnp.asarray(f_in),
                                 *[jnp.asarray(c) for c in c_in],
                                 interpret=True)[1:]
    finally:
        ps.BLK, ps._R = old_blk, old_r
    for g, r, p in zip(got, ref, pal):
        g = g.numpy()
        if reverse:
            r, p = _flip(r), _flip(np.asarray(p))
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, np.asarray(p))


@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_seg_scan_dense_and_empty_segments(density):
    """All-flags, half-flags and a single segment; cpu dispatch goes to
    the plain version; n = 0 and n = 1 are fine."""
    for kind, nvals in CASES:
        flag, cols = _inputs(kind, nvals, False, density)
        tf = torch.from_numpy(flag)
        tc = [torch.from_numpy(c) for c in cols]
        ref = _assoc_ref(kind, flag, cols)
        for g, r in zip(seg_scan(kind, tf, *tc), ref):
            np.testing.assert_array_equal(g.numpy(), r)
        for n in (0, 1):
            out = seg_scan(kind, tf[:n], *[c[:n] for c in tc])
            for o, c in zip(out, tc):
                np.testing.assert_array_equal(o.numpy(), c[:n].numpy())


def test_seg_scan_rejects_bad_operands():
    f = torch.ones(8, dtype=torch.bool)
    v = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        seg_scan("sum", f, v)
    with pytest.raises(ValueError):
        seg_scan("sfx2", f, v)
    with pytest.raises(TypeError):
        seg_scan("first", f, v.long())
    with pytest.raises(TypeError):
        seg_scan("first", f.int(), v)
