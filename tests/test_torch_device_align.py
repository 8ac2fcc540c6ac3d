"""PyTorch port: the amino-acid aligner and its device Smith-Waterman
(kernel B9, plain version on the CPU) against the JAX package on CPU jax:
scores exact, result dicts equal."""
import numpy as np
import pytest
import torch

from plass_tpu import constants as ref_constants
from plass_tpu.data import seqdb
from plass_tpu.ops import device_align as ref_device_align
from plass_tpu.ops import protein_align as ref_align
from plass_tpu.ops.kmermatch import kmermatcher
from plass_tpu_torch.data.seqdb import SeqDB as PortSeqDB
from plass_tpu_torch.ops import device_align, protein_align
from plass_tpu_torch.ops.backend import flat_rows
from plass_tpu_torch.ops.evalue import EvalueComputer

from test_torch_kmer import _synthetic_db

CPU = torch.device("cpu")
LETTERS = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX", dtype=np.uint8)


def _port(db):
    return PortSeqDB(db.data, db.keys, db.offsets, db.lengths, db.dbtype)


def _sw_inputs(seed, bias_on):
    """Seeded queries and targets of lengths 0, 1, odd and around the
    kernel's lane edge (32), half the targets mutated copies of a query;
    every (query, target) pair. (The kernel's register and strip edges are
    held on the card, chip_smoke.py's sw-main.)"""
    rng = np.random.default_rng(seed)
    mat = ref_constants.blosum62()
    qlens = [0, 1, 2, 31, 32, 33, 63, 97, 140]
    tlens = [0, 1, 7, 33, 90, 151]
    queries = [LETTERS[rng.integers(0, 20, n)] for n in qlens]
    targets = []
    for i, n in enumerate(tlens):
        t = LETTERS[rng.integers(0, 21, n)]
        if i % 2 and n:
            src = queries[(3 * i) % len(queries)]
            m = min(n, len(src))
            t[:m] = src[:m]
            mut = rng.random(n) < 0.1
            t[mut] = LETTERS[rng.integers(0, 20, int(mut.sum()))]
        targets.append(t)
    qnums = [mat.aa2num[q] for q in queries]
    if bias_on:
        comps = [np.where(b < 0, b - 0.5, b + 0.5).astype(np.int8)
                 for b in (ref_align.calc_local_aa_bias(
                     mat.sub.astype(np.int8), mat.pback, qn) for qn in qnums)]
    else:
        comps = [np.zeros(len(qn), dtype=np.int8) for qn in qnums]
    tdb = seqdb.SeqDB.from_records([t.tobytes() for t in targets],
                                   dbtype=seqdb.AMINO_ACIDS)
    pairs = [(a, b) for a in range(len(queries)) for b in range(len(targets))]
    return mat, qnums, comps, tdb, pairs


def _port_sw(mat, qnums, comps, tdb, pairs, gapo, gape, strip_cols=None,
             plan=None):
    qlens = np.array([len(q) for q in qnums], dtype=np.int32)
    qoff = np.concatenate([[0], np.cumsum(qlens)[:-1]]).astype(np.int64)
    qidx = np.array([a for a, _ in pairs], dtype=np.int32)
    tidx = np.array([b for _, b in pairs], dtype=np.int32)
    bias = np.concatenate(comps).astype(np.int8)
    order, own_plan, cols = device_align.schedule(
        qlens[qidx], tdb.seq_lens()[tidx],
        (int(bias.min()), int(bias.max())) if len(bias) else (0, 0))
    strip_cols = cols if strip_cols is None else strip_cols
    plan = own_plan if plan is None else plan
    t = torch.from_numpy
    return device_align.sw_score(
        t(np.concatenate(qnums).astype(np.uint8)), t(qoff), t(qlens),
        t(bias), *flat_rows(_port(tdb), CPU, "score"), t(qidx), t(tidx),
        t(order),
        plan, strip_cols, t(mat.sub.astype(np.int32)), gapo, gape).numpy()


@pytest.mark.parametrize("bias_on", [True, False])
@pytest.mark.parametrize("gaps", [(11, 1), (5, 2)])
def test_plain_sw_equals_jax_and_native(gaps, bias_on):
    """The plain B9 equals sw_score_batch (XLA on CPU jax) and the native
    striped ssw's score of the port's ProteinAligner, pair for pair."""
    import jax.numpy as jnp

    gapo, gape = gaps
    mat, qnums, comps, tdb, pairs = _sw_inputs(5 + gapo, bias_on)
    got = _port_sw(mat, qnums, comps, tdb, pairs, gapo, gape)

    lq = max(len(q) for q in qnums)
    qc = np.full((len(qnums), lq), 20, dtype=np.uint8)
    qb = np.zeros((len(qnums), lq), dtype=np.int32)
    for i, (qn, c) in enumerate(zip(qnums, comps)):
        qc[i, :len(qn)] = qn
        qb[i, :len(qn)] = c
    tl = tdb.seq_lens().astype(np.int32)
    tc = np.full((tdb.size, max(int(tl.max()), 1)), 20, dtype=np.uint8)
    for i in range(tdb.size):
        tc[i, :tl[i]] = mat.aa2num[np.asarray(tdb.get_seq(i))]
    want = np.asarray(ref_device_align.sw_score_batch(
        jnp.asarray(qc), jnp.asarray(qb),
        jnp.asarray(np.array([len(q) for q in qnums], dtype=np.int32)),
        jnp.asarray(tc), jnp.asarray(tl),
        jnp.asarray(np.array([a for a, _ in pairs], dtype=np.int32)),
        jnp.asarray(np.array([b for _, b in pairs], dtype=np.int32)),
        jnp.asarray(mat.sub.astype(np.int32).reshape(-1)), 21, gapo, gape))
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > len(pairs) // 2 and got.max() > 100

    aligner = protein_align.ProteinAligner(aa_bias_correction=bias_on)
    ev = EvalueComputer.for_matrix("blosum62_11_1", tdb.total_residues())
    native = []
    for a, b in pairs:
        if not len(qnums[a]) or not tl[b]:
            native.append(0)
            continue
        aligner.init_query(qnums[a])
        tnum = mat.aa2num[np.asarray(tdb.get_seq(b))]
        native.append(aligner.ssw_align(tnum, gapo, gape, 0, 1e-3, ev, 0,
                                        0.0, len(qnums[a]) // 2)["score1"])
    np.testing.assert_array_equal(got, np.array(native))


def test_schedule_orders_longest_first_and_sizes_the_strips():
    """schedule() puts the block path's pairs first, most cells first, then
    the warp-path classes from the highest down, each by longest target;
    the wrap scratch gets the longest target of a query past STRIP_ROWS; a
    pair that outgrows the scratch scores -1, one it fits scores as
    usual."""
    order, plan, cols = device_align.schedule(np.array([600, 10, 513, 512]),
                                              np.array([5, 40, 30, 900]))
    assert order.tolist() == [3, 2, 0, 1] and cols == 30
    assert plan[:7].tolist() == [512, 0, 0, 0, 3, 0, 0] and plan[7:].tolist() == [
        int(r == 10) for r in device_align.CLASS_ROWS]
    assert device_align.schedule(np.array([512, 3]), np.array([9, 9]))[2] == 0

    rng = np.random.default_rng(8)
    mat = ref_constants.blosum62()
    q = mat.aa2num[LETTERS[rng.integers(0, 20, device_align.STRIP_ROWS + 9)]]
    t = LETTERS[rng.integers(0, 20, 40)]
    t[:30] = mat.num2aa[q[:30]]
    tdb = seqdb.SeqDB.from_records([t.tobytes(), t[:3].tobytes()],
                                   dbtype=seqdb.AMINO_ACIDS)
    args = (mat, [q], [np.zeros(len(q), dtype=np.int8)], tdb,
            [(0, 0), (0, 1)], 11, 1)
    full = _port_sw(*args)
    assert (full >= 0).all()
    np.testing.assert_array_equal(_port_sw(*args, strip_cols=3),
                                  [-1, full[1]])
    np.testing.assert_array_equal(_port_sw(*args, strip_cols=0), [-1, -1])
    # a query whose bias leaves the plan's range scores -2 (as the kernel)
    plan = device_align.schedule(np.array([len(q)] * 2), np.array([40, 3]),
                                 (1, 2))[1]
    np.testing.assert_array_equal(_port_sw(*args, plan=plan), [-2, -2])


def test_schedule_partitions_the_paths_and_classes(monkeypatch):
    """The block path takes a query past a warp's strip, or a pair of at
    least BLOCK_CELLS cells (and a TAIL_SHARE-th of the call's) whose query
    spans two strips; every other pair
    takes the least warp-path class that holds its query; the plan counts
    both and the order lists them path by path, each class by longest
    target."""
    rows = device_align.CLASS_ROWS
    s = device_align.STRIP_ROWS
    assert len(rows) == 29 and s == 512
    assert list(rows) == sorted(set(rows)) and rows[:9] == (
        1, 2, 4, 6, 8, 10, 12, 14, 16) and rows[-4:] == (320, 384, 448, 512)
    qlens = np.array([0, 1, 2, 3, 16, 17, s - 1, s, s + 1, 2 * s + 1, 100,
                      300, 5000, 1])
    tlens = np.array([9, 6000, 5, 7, 1, 33, 10, 2, 0, 4, 2621, 874, 6000,
                      7])
    # BLOCK_CELLS (262,144) is the threshold: the call's cells over
    # TAIL_SHARE are fewer
    order, plan, cols = device_align.schedule(qlens, tlens)
    assert plan[0] == s and len(plan) == 7 + len(rows)
    # 300 x 874 = 262,200 cells and the queries past the strip take the
    # block path, most cells first; 100 x 2,621 = 262,100 does not
    assert plan[3:7].tolist() == [0, 4, 0, 0]
    assert order[:4].tolist() == [12, 11, 9, 8]
    want = {rows.index(1): [1, 0, 13], rows.index(2): [2],
            rows.index(4): [3], rows.index(16): [4], rows.index(20): [5],
            rows.index(112): [10], rows.index(512): [6, 7]}
    assert plan[7:].tolist() == [len(want.get(c, []))
                                 for c in range(len(rows))]
    assert order[4:].tolist() == [i for c in sorted(want, reverse=True)
                                  for i in want[c]]
    assert cols == 6000
    # the cells rule takes only queries of two strips (511 x 10 at 5,000
    # cells, not 100 x 2,621); tail_share=0 drops it
    assert device_align.schedule(qlens, tlens, tail_share=0)[1][4] == 3
    monkeypatch.setattr(device_align, "BLOCK_CELLS", 5_000)
    assert device_align.schedule(qlens, tlens, tail_share=10**9)[1][4] == 5
    monkeypatch.undo()
    # a call of 4,000 pairs of 280,000 cells: none outlasts the rest,
    # unless each may take a block
    q, t = np.full(4000, 400), np.full(4000, 700)
    assert device_align.schedule(q, t)[1][3:7].tolist() == [1, 0, 0, 0]
    assert device_align.schedule(q, t, tail_share=10**9)[1][3:7].tolist() \
        == [1, 0, 0, 4000]
    # with the warps full, a block-path pair takes the fewest warps its
    # strips of 512 rows fill: 4 pairs a block up to two strips, 2 up to
    # four, else the whole block (and the wrap)
    o, p, _ = device_align.schedule(np.array([600, 1100, 2100, 5000, 600]),
                                    np.array([9, 8, 7, 6, 10]),
                                    full_warps=0)
    assert p[3:7].tolist() == [1, 2, 1, 2]
    assert o.tolist() == [2, 3, 1, 4, 0]
    o, p, c = device_align.schedule(np.array([4, 4]), np.array([3, 2]),
                                    (-3, 5))
    assert o.tolist() == [0, 1] and p[1:7].tolist() == [-3, 5, 0, 0, 0, 0] \
        and p[7 + 2] == 2 and c == 0
    # the plan must be the pairs'
    with pytest.raises(ValueError, match="plan"):
        _port_sw(*_sw_inputs(1, False), 11, 1, plan=plan)


@pytest.mark.parametrize("gaps", [(11, 1), (5, 2)])
def test_plain_sw_equals_jax_and_native_around_the_paths(gaps):
    """The plain B9 equals sw_score_batch and the native ssw at the block
    path's edges: queries of STRIP_ROWS and one either side, twice it plus
    one, against targets of 0, 1, 33 and 90 residues, and a 1-residue
    query against 700."""
    import jax.numpy as jnp

    gapo, gape = gaps
    rng = np.random.default_rng(11 + gapo)
    mat = ref_constants.blosum62()
    s = device_align.STRIP_ROWS
    qlens = [s - 1, s, s + 1, 2 * s + 1, 1]
    queries = [LETTERS[rng.integers(0, 20, n)] for n in qlens]
    targets = []
    for i, n in enumerate([0, 1, 33, 90, 700]):
        t = LETTERS[rng.integers(0, 21, n)]
        src = queries[i % 4][s - 60:]
        m = min(n, len(src))
        t[:m] = src[:m]
        mut = rng.random(n) < 0.1
        t[mut] = LETTERS[rng.integers(0, 20, int(mut.sum()))]
        targets.append(t)
    qnums = [mat.aa2num[q] for q in queries]
    comps = [np.where(b < 0, b - 0.5, b + 0.5).astype(np.int8)
             for b in (ref_align.calc_local_aa_bias(
                 mat.sub.astype(np.int8), mat.pback, qn) for qn in qnums)]
    tdb = seqdb.SeqDB.from_records([t.tobytes() for t in targets],
                                   dbtype=seqdb.AMINO_ACIDS)
    pairs = [(a, b) for a in range(4) for b in range(4)] + [(4, 4)]
    got = _port_sw(mat, qnums, comps, tdb, pairs, gapo, gape)

    lq = max(qlens)
    qc = np.full((len(qnums), lq), 20, dtype=np.uint8)
    qb = np.zeros((len(qnums), lq), dtype=np.int32)
    for i, (qn, c) in enumerate(zip(qnums, comps)):
        qc[i, :len(qn)] = qn
        qb[i, :len(qn)] = c
    tl = tdb.seq_lens().astype(np.int32)
    tc = np.full((tdb.size, int(tl.max())), 20, dtype=np.uint8)
    for i in range(tdb.size):
        tc[i, :tl[i]] = mat.aa2num[np.asarray(tdb.get_seq(i))]
    want = np.asarray(ref_device_align.sw_score_batch(
        jnp.asarray(qc), jnp.asarray(qb), jnp.asarray(np.array(qlens,
                                                               np.int32)),
        jnp.asarray(tc), jnp.asarray(tl),
        jnp.asarray(np.array([a for a, _ in pairs], dtype=np.int32)),
        jnp.asarray(np.array([b for _, b in pairs], dtype=np.int32)),
        jnp.asarray(mat.sub.astype(np.int32).reshape(-1)), 21, gapo, gape))
    np.testing.assert_array_equal(got, want)
    assert got.max() > 100

    aligner = protein_align.ProteinAligner()
    ev = EvalueComputer.for_matrix("blosum62_11_1", tdb.total_residues())
    native = []
    for a, b in pairs:
        if not tl[b]:
            native.append(0)
            continue
        aligner.init_query(qnums[a])
        tnum = mat.aa2num[np.asarray(tdb.get_seq(b))]
        native.append(aligner.ssw_align(tnum, gapo, gape, 0, 1e-3, ev, 0,
                                        0.0, len(qnums[a]) // 2)["score1"])
    np.testing.assert_array_equal(got, np.array(native))


def test_local_aa_bias_equals_jax():
    """The vectorised composition bias equals the JAX package's loop."""
    mat = ref_constants.blosum62()
    rng = np.random.default_rng(2)
    for n in (0, 1, 5, 39, 40, 41, 300):
        qnum = rng.integers(0, 21, n).astype(np.uint8)
        np.testing.assert_array_equal(
            protein_align.calc_local_aa_bias(mat.sub.astype(np.int8),
                                             mat.pback, qnum),
            ref_align.calc_local_aa_bias(mat.sub.astype(np.int8), mat.pback,
                                         qnum))


def _aligned_hits(db, seed=3):
    """Host-matcher hits of `db` plus seeded unrelated candidates, so that
    some pairs fail the E-value test."""
    hits = kmermatcher(db, 14, kmers_per_sequence=21, hash_shift=67,
                       cov_thr=0.5)
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in db.keys]
    for q in keys[::3]:
        for t in rng.choice(keys, 3, replace=False):
            hits.setdefault(q, [(q, 0, 0)]).append((int(t), 1, 0))
    return hits


@pytest.mark.parametrize("prefilter", [True, False])
def test_align_protein_equals_jax(prefilter):
    """align_protein of the port, with the plain B9 prefilter and without,
    equals the JAX package's, result dict for result dict."""
    db = _synthetic_db(n=400)
    hits = _aligned_hits(db)
    kw = dict(seq_id_thr=0.5, cov_thr=0.5, cov_mode=0, eval_thr=1e-3)
    want = ref_align.align_protein(db, hits, device_prefilter=False, **kw)
    got = protein_align.align_protein(_port(db), hits,
                                      device_prefilter=prefilter,
                                      device="cpu", **kw)
    assert got == want
    n_pairs = sum(len(v) for v in hits.values())
    n_aln = sum(len(v) for v in got.values())
    assert n_pairs > n_aln + 300 and n_aln > len(got)   # rejections too
    db_bytes = protein_align.protein_align_results_to_db(got)
    ref_bytes = ref_align.protein_align_results_to_db(want)
    assert db_bytes.data.tobytes() == ref_bytes.data.tobytes()


def test_align_protein_realign_and_backtrace_equal_jax():
    """--realign and -a (backtraces) through the port's aligner."""
    db = _synthetic_db(seed=4, n=200)
    hits = _aligned_hits(db, seed=5)
    for kw in (dict(realign=True), dict(add_backtrace=True),
               dict(realign=True, add_backtrace=True, cov_thr=0.3)):
        want = ref_align.align_protein(db, hits, device_prefilter=False,
                                       **kw)
        got = protein_align.align_protein(_port(db), hits, device="cpu",
                                          **kw)
        assert got == want, kw


def test_profile_queries_and_cuda_without_a_card_raise():
    db = _port(_synthetic_db(n=20))
    prof = PortSeqDB(db.data, db.keys, db.offsets, db.lengths,
                     seqdb.HMM_PROFILE)
    with pytest.raises(NotImplementedError, match="ROADMAP item 23"):
        protein_align.align_protein(prof, {}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            protein_align.align_protein(db, {}, device="cuda")
