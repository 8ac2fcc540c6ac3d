"""PyTorch port, kernel K2: rescore_e2e_plain (the CPU path of
rescore_e2e) against the JAX package's Pallas END_TO_END rescore in
interpret mode (rows padded to a power of two, as on the TPU) and its XLA
formulation device_rescore.rescore_pairs — real hits of the mini fixture's
ORFs and of a seeded synthetic protein DB, plus synthetic edge cases.
Exact."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plass_tpu import constants
from plass_tpu.data import seqdb
from plass_tpu.data.createdb import merge_reads
from plass_tpu.ops import orf as orf_mod
from plass_tpu.ops import translate as tr
from plass_tpu.ops.backend import db_to_padded
from plass_tpu.ops.device_rescore import rescore_pairs
from plass_tpu.ops.kmermatch import kmermatcher
from plass_tpu.ops.pallas_rescore import rescore_pairs_pallas
from plass_tpu_torch.ops.rescore_kernel import rescore_e2e, rescore_e2e_plain

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
LETTERS = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)


def _mini_orfs():
    reads, _ = merge_reads(READS)
    odb, ohdb = orf_mod.extract_orfs(reads, min_length=20, max_length=32734,
                                     max_gaps=0, start_mode=0)
    return tr.translate_nucs(odb, ohdb, 1, add_orf_stop=True)


def _synthetic_db(seed=11, n=400):
    rng = np.random.default_rng(seed)
    genome = LETTERS[rng.integers(0, 20, 2500)]
    recs = []
    for _ in range(n):
        ln = int(rng.integers(20, 120))
        s = int(rng.integers(0, len(genome) - ln))
        seq = genome[s:s + ln].copy()
        mut = rng.random(ln) < 0.02
        seq[mut] = LETTERS[rng.integers(0, 20, int(mut.sum()))]
        if rng.random() < 0.3:
            seq[0] = ord("*")
        if rng.random() < 0.3:
            seq[-1] = ord("*")
        recs.append(seq.tobytes())
    return seqdb.SeqDB.from_records(recs, dbtype=seqdb.AMINO_ACIDS)


def _db_hits(db):
    """(codes, chars, lengths, qrow, trow, diag) of the host matcher's
    hits on db (self rows included)."""
    hits = kmermatcher(db, 14, kmers_per_sequence=60, hash_shift=67,
                       ignore_multi_kmer=True, include_only_extendable=False)
    codes, lengths, _ = db_to_padded(db, "score")
    chars, _, _ = db_to_padded(db, "char")
    lut = db.id_lookup_array()
    q, t, d = [], [], []
    for k, v in hits.items():
        for (tk, _s, dg) in v:
            q.append(int(lut[k]))
            t.append(int(lut[tk]))
            d.append(dg)
    i32 = lambda x: np.asarray(x, dtype=np.int32)
    return codes, chars, lengths, i32(q), i32(t), i32(d)


def _edge_cases():
    """'*' at j=0 and at ov-1, no overlap (ov <= 0), rows longer than
    1024, one- and two-residue rows, lower-case letters."""
    rng = np.random.default_rng(3)
    lens = [40, 40, 1100, 900, 1, 2, 64]
    width = 1100
    chars = np.zeros((len(lens), width), dtype=np.uint8)
    for i, n in enumerate(lens):
        chars[i, :n] = LETTERS[rng.integers(0, 20, n)]
    chars[0, 0] = chars[1, 39] = chars[2, 0] = chars[2, 1099] = ord("*")
    chars[3, 100] = chars[5, 0] = ord("*")
    chars[6, :30] += 32   # lower case: identity is case-folded
    codes = constants.blosum62().aa2num[chars].astype(np.uint8)
    codes[chars == 0] = 20
    q, t, d = [], [], []
    for a in range(len(lens)):
        for b in range(len(lens)):
            for dg in (0, 1, -1, 39, -39, 40, -899, 1099, -1099, 1100):
                q.append(a)
                t.append(b)
                d.append(dg)
    i32 = lambda x: np.asarray(x, dtype=np.int32)
    return codes, chars, i32(lens), i32(q), i32(t), i32(d)


def _pow2(codes, chars):
    w = 1 << (codes.shape[1] - 1).bit_length()
    pad = ((0, 0), (0, w - codes.shape[1]))
    return (np.pad(codes, pad, constant_values=20), np.pad(chars, pad), w)


INPUTS = {"mini_orfs": lambda: _db_hits(_mini_orfs()),
          "synthetic_db": lambda: _db_hits(_synthetic_db()),
          "edge_cases": _edge_cases}


@pytest.mark.parametrize("which", list(INPUTS))
def test_rescore_plain_matches_pallas_and_xla(which):
    codes, chars, lengths, q, t, d = INPUTS[which]()
    assert len(q) > 50
    sub = constants.blosum62().sub.astype(np.int32)
    got = [x.numpy() for x in rescore_e2e(
        *[torch.from_numpy(np.ascontiguousarray(a))
          for a in (codes, chars, lengths, q, t, d, sub)])]

    pc, pch, w = _pow2(codes, chars)
    pal = rescore_pairs_pallas(
        jnp.asarray(pc), jnp.asarray(pch), jnp.asarray(lengths),
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(d), jnp.asarray(sub),
        sub.shape[0], width=w, interpret=True)
    alpha = sub.shape[0]
    xla = rescore_pairs(jnp.asarray(codes), jnp.asarray(chars),
                        jnp.asarray(lengths), jnp.asarray(q), jnp.asarray(t),
                        jnp.asarray(d), jnp.zeros(len(q), bool),
                        jnp.asarray(sub.reshape(-1)),
                        jnp.arange(alpha, dtype=jnp.int32),
                        jnp.asarray(constants.blosum62().num2aa), alpha,
                        mode=3, has_rev=False)
    ov = np.asarray(xla[3])
    names = ("score", "first", "last", "idents")
    for name, g, p, x in zip(names, got, (pal[0], pal[1], pal[2], pal[5]),
                             (xla[0], xla[1], xla[2], xla[5])):
        np.testing.assert_array_equal(g, np.asarray(p), err_msg=name)
        # the XLA formulation leaves first/last of ov <= 0 hits unset
        m = ov > 0 if name in ("first", "last") else slice(None)
        np.testing.assert_array_equal(g[m], np.asarray(x)[m], err_msg=name)
    if which == "edge_cases":
        assert (ov <= 0).sum() > 10 and (got[1] == -1).sum() == (ov <= 0).sum()
        assert (got[1] == 1).sum() > 0 and (got[2] < ov - 1)[ov > 1].any()


def test_rescore_rejects_bad_operands():
    codes = torch.zeros((2, 4), dtype=torch.uint8)
    lens = torch.tensor([4, 4], dtype=torch.int32)
    h = torch.zeros(3, dtype=torch.int32)
    sub = torch.zeros((21, 21), dtype=torch.int32)
    with pytest.raises(TypeError):
        rescore_e2e(codes.int(), codes, lens, h, h, h, sub)
    with pytest.raises(TypeError):
        rescore_e2e(codes, codes, lens.long(), h, h, h, sub)
    with pytest.raises(TypeError):
        rescore_e2e(codes, codes, lens, h, h[:2], h, sub)
    with pytest.raises(TypeError):
        rescore_e2e(codes, codes, lens, h, h, h, torch.zeros((40, 40),
                                                             dtype=torch.int32))
    out = rescore_e2e_plain(codes, codes, lens, h[:0], h[:0], h[:0], sub)
    assert all(o.numel() == 0 for o in out)
