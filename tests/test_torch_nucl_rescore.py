"""PyTorch port, kernel K2 on nucleotide hits: rescore_e2e_plain with
reverse-strand hits (the CPU path of rescore_e2e, the oracle of its
reverse and uniform-matrix variants), on the database's flat rows, against the JAX package's XLA
formulation device_rescore.rescore_pairs(has_rev=True) and its Pallas
kernel in interpret mode, with the generic and the uniform (`fast`)
matrix path; the Pallas kernel's streamed (K3) and per-hit (K4) variants
against the same plain version; rescore_diagonal_torch's records against
rescore_diagonal_jax. Exact."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plass_tpu import constants
from plass_tpu.data import seqdb
from plass_tpu.data.createdb import merge_reads
from plass_tpu.ops.backend import (_fast_sub_pattern, _score_tables,
                                   db_to_padded, kmermatcher_jax,
                                   rescore_diagonal_jax)
from plass_tpu.ops.device_rescore import rescore_pairs
from plass_tpu.ops.evalue import EvalueComputer
from plass_tpu.ops import pallas_rescore
from plass_tpu.ops.pallas_rescore import rescore_pairs_pallas
from plass_tpu.ops.rescore import RescoreParams
from plass_tpu_torch.data import seqdb as port_seqdb
from plass_tpu_torch.data.createdb import merge_reads as port_merge_reads
from plass_tpu_torch.ops import backend as port_backend
from plass_tpu_torch.ops.backend import (kmermatcher_torch,
                                         rescore_diagonal_torch)
from plass_tpu_torch.ops.rescore import RescoreParams as PortRescoreParams
from plass_tpu_torch.ops.rescore_kernel import (rescore_e2e,
                                                rescore_e2e_plain,
                                                rescore_hamming,
                                                uniform_pattern)
from test_torch_nucl_kmer import ACGT, RC, sample_reads
from test_torch_rescore import flat_rows, port_args

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
KW = dict(kmers_per_sequence=60, kmers_per_sequence_scale=0.1, hash_shift=67,
          ignore_multi_kmer=True, include_only_extendable=False)
NUCL = constants.nucleotide()


def _mini_reads():
    jdb, _ = merge_reads(READS)
    pdb, _ = port_merge_reads(READS)
    return jdb, pdb


def _synthetic(seed=17, n=500):
    """Reads of one random genome from both strands, with N bases and some
    reads in lower case."""
    rng = np.random.default_rng(seed)
    genome = ACGT[rng.integers(0, 4, 4000)]
    recs = sample_reads(genome, n, rng, sub_rate=0.01)
    recs = [r.lower() if i % 7 == 0 else r for i, r in enumerate(recs)]
    keys = np.sort(rng.choice(3 * n, n, replace=False))
    return (seqdb.SeqDB.from_records(recs, keys=keys,
                                     dbtype=seqdb.NUCLEOTIDES),
            port_seqdb.SeqDB.from_records(recs, keys=keys,
                                          dbtype=port_seqdb.NUCLEOTIDES))


def _db_hits(dbs):
    """(codes, chars, lengths, qrow, trow, diag, qrev) of the JAX matcher's
    hits on the DB, self rows included; qrev from the score's sign; and
    the DB's own (rows, offsets)."""
    jdb, _ = dbs
    qk, tk, score, dg = kmermatcher_jax(jdb, 22, return_arrays=True, **KW)
    codes, lengths, _ = db_to_padded(jdb, "score")
    chars, _, _ = db_to_padded(jdb, "char")
    n = jdb.size
    lut = jdb.id_lookup_array()
    i32 = lambda x: np.asarray(x, dtype=np.int32)
    return (codes[:n], chars[:n], lengths[:n], i32(lut[qk]), i32(lut[tk]),
            i32(dg), np.asarray(score) < 0, (np.asarray(jdb.data),
                                             jdb.offsets))


def _edge_cases():
    """Reverse and forward hits at both row ends, no overlap (ov <= 0),
    N bases (a mismatch even against N), lower case, '*' at either end of
    a window, rows longer than 1,024."""
    rng = np.random.default_rng(3)
    lens = [40, 40, 1100, 1500, 1, 2, 64, 300]
    width = max(lens)
    chars = np.zeros((len(lens), width), dtype=np.uint8)
    letters = np.frombuffer(b"ACGTN", dtype=np.uint8)
    for i, n in enumerate(lens):
        chars[i, :n] = letters[rng.integers(0, 5, n)]
    chars[0, 0] = chars[1, 39] = chars[2, 1099] = ord("*")
    chars[3, :200] = chars[2, 300:500]       # a forward match at diag -300
    chars[7, :300] = RC[chars[2, 400:700][::-1]]   # a reverse one at -400
    chars[6, :32] += 32                      # lower case: identity is folded
    codes = NUCL.aa2num[chars].astype(np.uint8)
    codes[chars == 0] = 4
    q, t, d, r = [], [], [], []
    for a in range(len(lens)):
        for b in range(len(lens)):
            for dg in (0, 1, -1, 39, -39, 40, -300, -400, 1099, -1099,
                       1100, -1499, 1500):
                for rv in (False, True):
                    q.append(a)
                    t.append(b)
                    d.append(dg)
                    r.append(rv)
    i32 = lambda x: np.asarray(x, dtype=np.int32)
    return (codes, chars, i32(lens), i32(q), i32(t), i32(d), np.asarray(r),
            flat_rows(chars, lens))


def _unaligned_windows():
    """70 reads, one of each length 1-70, whose starts take every residue
    mod 16, beside one contig of 20,500 nt; '*' at row starts and ends, so
    at both window ends of forward and reverse hits; windows of 1-70 and of
    over 20,000 nt, hits with no overlap (ov <= 0), every hit on both
    strands."""
    rng = np.random.default_rng(41)
    lens = [int(x) for x in rng.permutation(np.arange(1, 71))] + [20500]
    big = len(lens) - 1
    whole = lens.index(70)
    letters = np.frombuffer(b"ACGTN", dtype=np.uint8)
    chars = np.zeros((len(lens), max(lens)), dtype=np.uint8)
    for i, n in enumerate(lens):
        chars[i, :n] = letters[rng.integers(0, 5, n)]
        if i % 3 == 0:
            chars[i, 0] = ord("*")
        if i % 4 == 0:
            chars[i, n - 1] = ord("*")
    chars[big, 5000:5070] = chars[whole, :70]            # a forward match
    chars[big, 9000:9070] = RC[chars[whole, :70][::-1]]  # a reverse one
    codes = NUCL.aa2num[chars].astype(np.uint8)
    codes[chars == 0] = 4
    q = rng.integers(0, big + 1, 500)
    t = rng.integers(0, big + 1, 500)
    d = rng.integers(-75, 76, 500)
    long_q = q == big
    d[long_q] = rng.integers(-75, 20500, int(long_q.sum()))
    long_t = (t == big) & ~long_q
    d[long_t] = -rng.integers(0, 20500, int(long_t.sum()))
    # the long row as target of every read: windows of 1-70, far into it;
    # the long row against itself: windows of over 20,000
    q = np.concatenate([q, np.arange(big), [whole, big, big]])
    t = np.concatenate([t, np.full(big + 1, big), [big, big]])
    d = np.concatenate([d, -rng.integers(0, 20000, big), [-9000, 300, -7]])
    d[500 + whole] = -5000
    q, t, d = (np.concatenate([x, x]) for x in (q, t, d))
    r = np.arange(len(q)) >= len(q) // 2
    i32 = lambda x: np.asarray(x, dtype=np.int32)
    rows, offsets = flat_rows(chars, lens, shift=5)
    assert len(set(int(o) % 16 for o in offsets)) == 16
    return (codes, chars, i32(lens), i32(q), i32(t), i32(d), r,
            (rows, offsets))


def _pow2(codes, chars):
    w = 1 << (codes.shape[1] - 1).bit_length()
    pad = ((0, 0), (0, w - codes.shape[1]))
    return np.pad(codes, pad, constant_values=4), np.pad(chars, pad), w


INPUTS = {"mini_reads": lambda: _db_hits(_mini_reads()),
          "synthetic": lambda: _db_hits(_synthetic()),
          "edge_cases": _edge_cases,
          "unaligned_windows": _unaligned_windows}


def _port_rev_kw(uniform):
    return dict(comp=torch.from_numpy(NUCL.reverse.astype(np.int32)),
                code2char=torch.from_numpy(NUCL.num2aa.astype(np.uint8)),
                uniform=uniform)


def test_uniform_pattern_matches_jax_fast_pattern():
    db = seqdb.SeqDB.from_records([b"ACGT"], dbtype=seqdb.NUCLEOTIDES)
    fast = _fast_sub_pattern(db)
    assert uniform_pattern(NUCL.sub) == (fast[0], fast[1]) == (2, -3)
    assert uniform_pattern(constants.blosum62().sub) is None
    # X scores a mismatch against itself: the fast path's q != X
    assert NUCL.sub[4, 4] == -3


@pytest.mark.parametrize("which", list(INPUTS))
def test_rescore_rev_plain_matches_xla_and_pallas(which):
    codes, chars, lengths, q, t, d, rv, (rows, offsets) = INPUTS[which]()
    assert rv.sum() >= 5 and (~rv).sum() >= 5
    sub = NUCL.sub.astype(np.int32)
    args = port_args(rows, offsets, lengths, q, t, d, NUCL)
    got = rescore_e2e(*args, qrev=torch.from_numpy(rv),
                      **_port_rev_kw(uniform_pattern(sub)))
    got = [x.numpy() for x in got]
    generic = rescore_e2e_plain(*args, qrev=torch.from_numpy(rv),
                                **_port_rev_kw(None))
    for g, x in zip(got, generic):
        np.testing.assert_array_equal(g, x.numpy())

    jdb = seqdb.SeqDB.from_records([b"A"], dbtype=seqdb.NUCLEOTIDES)
    sub_flat, comp, c2c, alpha = _score_tables(jdb)
    xla = rescore_pairs(jnp.asarray(codes), jnp.asarray(chars),
                        jnp.asarray(lengths), jnp.asarray(q), jnp.asarray(t),
                        jnp.asarray(d), jnp.asarray(rv), jnp.asarray(sub_flat),
                        jnp.asarray(comp), jnp.asarray(c2c), alpha, mode=3,
                        has_rev=True)
    ov = np.asarray(xla[3])
    pc, pch, w = _pow2(codes, chars)
    names = ("score", "first", "last", "idents")
    for fast in (None, _fast_sub_pattern(jdb)):
        pal = rescore_pairs_pallas(
            jnp.asarray(pc), jnp.asarray(pch), jnp.asarray(lengths),
            jnp.asarray(q), jnp.asarray(t), jnp.asarray(d),
            jnp.asarray(sub), alpha, width=w, interpret=True,
            qrev=jnp.asarray(rv.astype(np.int32)), comp_perm=jnp.asarray(comp),
            code2char=jnp.asarray(c2c), fast=fast)
        for name, g, p in zip(names, got, (pal[0], pal[1], pal[2], pal[5])):
            np.testing.assert_array_equal(g, np.asarray(p),
                                          err_msg=f"{name} fast={fast}")
    for name, g, x in zip(names, got, (xla[0], xla[1], xla[2], xla[5])):
        # the XLA formulation leaves first/last of ov <= 0 hits unset
        m = ov > 0 if name in ("first", "last") else slice(None)
        np.testing.assert_array_equal(g[m], np.asarray(x)[m], err_msg=name)
    if which == "unaligned_windows":
        assert set(range(1, 71)) <= set(ov[rv].tolist()) and ov.max() > 20000
        assert (got[1][rv] == 1).sum() > 0 and (got[2] < ov - 1)[rv].any()
    if which in ("edge_cases", "unaligned_windows"):
        assert (ov <= 0).sum() > 10 and (got[1] == -1).sum() == (ov <= 0).sum()
        assert (got[1] == 1).sum() > 0 and (got[2] < ov - 1)[ov > 1].any()
        high = 100 if which == "edge_cases" else 50   # N never matches
        assert (got[0][rv] > high).any() and (got[0][~rv] > high).any()


def _protein_edge_hits():
    """~200 protein hits with '*' ends and no-overlap cases."""
    rng = np.random.default_rng(8)
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    lens = [60, 90, 200, 30]
    chars = np.zeros((4, 200), dtype=np.uint8)
    for i, n in enumerate(lens):
        chars[i, :n] = letters[rng.integers(0, 20, n)]
    chars[1, :60] = chars[0, :60]
    chars[0, 0] = chars[2, 199] = ord("*")
    codes = constants.blosum62().aa2num[chars].astype(np.uint8)
    codes[chars == 0] = 20
    q, t, d = (rng.integers(0, 4, 200), rng.integers(0, 4, 200),
               rng.integers(-200, 200, 200))
    i32 = lambda x: np.asarray(x, dtype=np.int32)
    return (codes, chars, i32(lens), i32(q), i32(t), i32(d),
            constants.blosum62().sub.astype(np.int32))


@pytest.mark.parametrize("env", [("PLASS_PALLAS_GATHER", "0"),
                                 ("PLASS_PALLAS_BLOCK", "1")])
def test_streamed_and_per_hit_pallas_variants_equal_plain(monkeypatch, env):
    """K3 (rows streamed per hit, PLASS_PALLAS_GATHER=0) and K4 (one hit
    per grid step, PLASS_PALLAS_BLOCK=1) compute what the port's K2
    computes: interpret mode equals rescore_e2e_plain on ~200 protein hits
    and ~200 nucleotide hits with reverse ones."""
    edge = _edge_cases()
    sel = np.random.default_rng(1).choice(len(edge[3]), 200, replace=False)
    nucl = (*edge[:3], *(a[sel] for a in edge[3:6]),
            NUCL.sub.astype(np.int32))
    rv = edge[6][sel]
    assert rv.sum() > 50
    cases = ((_protein_edge_hits(), 20, {}, {}, constants.blosum62()),
             (nucl, 4,
              dict(qrev=jnp.asarray(rv.astype(np.int32)),
                   comp_perm=jnp.asarray(NUCL.reverse.astype(np.int32)),
                   code2char=jnp.asarray(NUCL.num2aa.astype(np.uint8))),
              dict(qrev=torch.from_numpy(rv), **_port_rev_kw(None)), NUCL))
    monkeypatch.setenv(*env)
    # the variant is chosen when the kernel traces; count its traces
    kernel = {"PLASS_PALLAS_GATHER": "_kernel_blocked",
              "PLASS_PALLAS_BLOCK": "_kernel"}[env[0]]
    body = getattr(pallas_rescore, kernel)
    traced = []
    monkeypatch.setattr(pallas_rescore, kernel,
                        lambda *a, **k: traced.append(1) or body(*a, **k))
    jax.clear_caches()
    try:
        for (codes, chars, lengths, q, t, d, sub), x_code, kw, pkw, mat in cases:
            w = 1 << (codes.shape[1] - 1).bit_length()
            pad = ((0, 0), (0, w - codes.shape[1]))
            pal = rescore_pairs_pallas(
                jnp.asarray(np.pad(codes, pad, constant_values=x_code)),
                jnp.asarray(np.pad(chars, pad)), jnp.asarray(lengths),
                jnp.asarray(q), jnp.asarray(t), jnp.asarray(d),
                jnp.asarray(sub), sub.shape[0], width=w, interpret=True,
                **kw)
            want = rescore_e2e_plain(
                *port_args(*flat_rows(chars, lengths), lengths, q, t, d, mat),
                **pkw)
            for name, p, g in zip(("score", "first", "last", "idents"),
                                  (pal[0], pal[1], pal[2], pal[5]), want):
                np.testing.assert_array_equal(np.asarray(p), g.numpy(),
                                              err_msg=f"{env} {name}")
        assert traced
    finally:
        monkeypatch.undo()
        jax.clear_caches()


def _self_row_edges():
    """Reads with N bases (one in ten with an N run) and lower case, and
    rows whose self rows are edges: no base, a lone N, NN, N at both ends."""
    rng = np.random.default_rng(29)
    genome = ACGT[rng.integers(0, 4, 3000)]
    recs = sample_reads(genome, 300, rng, sub_rate=0.01)
    for i in range(0, len(recs), 10):
        recs[i] = recs[i][:20] + b"NNNN" + recs[i][24:]
    recs = [r.lower() if i % 6 == 0 else r for i, r in enumerate(recs)]
    body = ACGT[rng.integers(0, 4, 70)].tobytes()
    for j, rec in enumerate([b"", b"N", b"NN", b"N" + body + b"N",
                             body[:40].lower() + b"N", b""]):
        recs.insert(23 * j + 5, rec)
    keys = np.sort(rng.choice(3 * len(recs), len(recs), replace=False))
    return (seqdb.SeqDB.from_records(recs, keys=keys,
                                     dbtype=seqdb.NUCLEOTIDES),
            port_seqdb.SeqDB.from_records(recs, keys=keys,
                                          dbtype=port_seqdb.NUCLEOTIDES))


DBS = {"mini_reads": _mini_reads, "synthetic": _synthetic,
       "self_row_edges": _self_row_edges}


@pytest.mark.parametrize("flat", [True, False])
@pytest.mark.parametrize("which", list(DBS))
def test_nucl_rescore_records_match_jax(which, flat):
    """rescore_diagonal_torch on the port's hits against
    rescore_diagonal_jax on the JAX package's hits: the same records, in
    the flat format the extender reads and per query. The self rows, one
    a sequence, are scored in K2's launch with the forward and reverse
    hits (SELF_ROWS)."""
    jdb, pdb = DBS[which]()
    rp = dict(rescore_mode=3, seq_id_thr=0.99, eval_thr=1e-5)
    ev = EvalueComputer.for_matrix("nucleotide_ungapped",
                                   jdb.total_residues())
    want = rescore_diagonal_jax(
        jdb, kmermatcher_jax(jdb, 22, return_arrays=True, **KW),
        RescoreParams(**rp), ev, return_flat=flat)
    hits = kmermatcher_torch(pdb, 22, torch.device("cpu"), **KW)
    before = port_backend.SELF_ROWS
    got = rescore_diagonal_torch(pdb, hits, PortRescoreParams(**rp),
                                 return_flat=flat)
    assert port_backend.SELF_ROWS - before == pdb.size
    if flat:
        np.testing.assert_array_equal(got["qk"], want["qk"])
        np.testing.assert_array_equal(got["rec"], want["rec"])
        recs = got["rec"]
    else:
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
        recs = np.concatenate(list(got.values()))
    # reverse hits survive: their query coordinates run backwards
    assert (recs["qStartPos"] > recs["qEndPos"]).sum() >= 2
    assert len(recs) > pdb.size


def test_rev_operands_rejected():
    rows = torch.zeros(12, dtype=torch.uint8)
    offs = torch.tensor([0, 6], dtype=torch.int64)
    lens = torch.tensor([4, 4], dtype=torch.int32)
    lut = torch.zeros(256, dtype=torch.uint8)
    h = torch.zeros(3, dtype=torch.int32)
    sub = torch.from_numpy(NUCL.sub.astype(np.int32))
    rv = torch.zeros(3, dtype=torch.bool)
    head = (rows, offs, lens, lut, h, h, h, sub)
    with pytest.raises(ValueError):
        rescore_e2e(*head, qrev=rv)
    with pytest.raises(TypeError):
        rescore_e2e(*head, qrev=rv.int(), **_port_rev_kw(None))
    with pytest.raises(TypeError):
        rescore_e2e(*head, qrev=rv, comp=torch.zeros(4, dtype=torch.int32),
                    code2char=torch.zeros(5, dtype=torch.uint8))
    with pytest.raises(ValueError):
        rescore_e2e(*head, uniform=(2, -3))


@pytest.mark.parametrize("which", list(INPUTS))
def test_hamming_rev_plain_matches_xla(which):
    """The plain HAMMING rescore with reverse hits equals the JAX package's
    rescore_pairs(mode=0, has_rev=True): a reverse hit's query chars are
    the canonical chars of its complemented codes."""
    codes, chars, lengths, q, t, d, rv, (rows, offsets) = INPUTS[which]()
    args = port_args(rows, offsets, lengths, q, t, d, NUCL)
    kw = _port_rev_kw(None)
    del kw["uniform"]
    got = [x.numpy() for x in rescore_hamming(
        *args[:7], qrev=torch.from_numpy(rv), **kw)]
    jdb = seqdb.SeqDB.from_records([b"A"], dbtype=seqdb.NUCLEOTIDES)
    sub_flat, comp, c2c, alpha = _score_tables(jdb)
    xla = rescore_pairs(jnp.asarray(codes), jnp.asarray(chars),
                        jnp.asarray(lengths), jnp.asarray(q), jnp.asarray(t),
                        jnp.asarray(d), jnp.asarray(rv), jnp.asarray(sub_flat),
                        jnp.asarray(comp), jnp.asarray(c2c), alpha, mode=0,
                        has_rev=True)
    for name, g, x in zip(("score", "first", "last", "idents"), got,
                          (xla[0], xla[1], xla[2], xla[5])):
        np.testing.assert_array_equal(g, np.asarray(x), err_msg=name)
    assert (got[0][rv] > 20).any() and (got[0][~rv] > 20).any()


@pytest.mark.parametrize("which", list(DBS))
def test_nucl_hamming_records_match_jax(which):
    """rescore_diagonal_torch at --rescore-mode 0 (the hits and the self
    rows through the HAMMING rescore) against rescore_diagonal_jax."""
    jdb, pdb = DBS[which]()
    rp = dict(rescore_mode=0, seq_id_thr=0.99, eval_thr=1e-5)
    ev = EvalueComputer.for_matrix("nucleotide_ungapped",
                                   jdb.total_residues())
    want = rescore_diagonal_jax(
        jdb, kmermatcher_jax(jdb, 22, return_arrays=True, **KW),
        RescoreParams(**rp), ev, return_flat=True)
    hits = kmermatcher_torch(pdb, 22, torch.device("cpu"), **KW)
    before = port_backend.SELF_ROWS
    got = rescore_diagonal_torch(pdb, hits, PortRescoreParams(**rp),
                                 return_flat=True)
    assert port_backend.SELF_ROWS - before == pdb.size
    np.testing.assert_array_equal(got["qk"], want["qk"])
    np.testing.assert_array_equal(got["rec"], want["rec"])
    assert len(got["rec"]) > pdb.size
