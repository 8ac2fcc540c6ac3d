"""PyTorch port, kernel K2: rescore_e2e_plain (the CPU path of
rescore_e2e) on the database's flat rows (bytes, offsets, lengths and the
byte -> code table) against the JAX package's Pallas END_TO_END rescore in
interpret mode (rows padded to a power of two, as on the TPU) and its XLA
formulation device_rescore.rescore_pairs — real hits of the mini fixture's
ORFs and of a seeded synthetic protein DB, synthetic edge cases, and rows
at every alignment mod 16 beside one of over 20,000 residues. Exact
(integer outputs, tolerance 0)."""
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
from plass_tpu_torch.ops.rescore_kernel import (_overlap, rescore_align_plain,
                                                rescore_e2e, rescore_e2e_plain,
                                                rescore_hamming,
                                                rescore_hamming_plain)

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


def flat_rows(chars, lengths, shift=0):
    """The rows of a padded char matrix laid out as a SeqDB's data: each
    followed by its "\\n\\0" terminator, and preceded by 0-15 filler bytes
    so that row i starts at an offset of residue (i + shift) mod 16.
    Returns (rows uint8[T], offsets int64[N])."""
    parts, offsets, pos = [], [], 0
    for i, n in enumerate(lengths):
        gap = (i + shift - pos) % 16
        offsets.append(pos + gap)
        parts += [b"Z" * gap, chars[i, :n].tobytes(), b"\n\x00"]
        pos += gap + int(n) + 2
    return (np.frombuffer(b"".join(parts), dtype=np.uint8).copy(),
            np.asarray(offsets, dtype=np.int64))


def port_args(rows, offsets, lengths, q, t, d, mat):
    """rescore_e2e's operands as CPU tensors: flat rows, the matrix's
    byte -> code table, the hits and the substitution matrix. `lengths` may
    carry the JAX package's padding rows past the DB's own."""
    arrs = (np.array(rows), np.asarray(offsets, dtype=np.int64),
            np.asarray(lengths[:len(offsets)], dtype=np.int32),
            mat.aa2num.astype(np.uint8),
            q, t, d, mat.sub.astype(np.int32))
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _db_hits(db):
    """(codes, chars, lengths, qrow, trow, diag) of the host matcher's
    hits on db (self rows included), and the DB's own (rows, offsets)."""
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
    return (codes, chars, lengths, i32(q), i32(t), i32(d),
            (np.asarray(db.data), db.offsets))


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
    return (codes, chars, i32(lens), i32(q), i32(t), i32(d),
            flat_rows(chars, lens))


def _unaligned_windows():
    """70 short rows, one of each length 1-70, whose starts take every
    residue mod 16, beside one row of 20,500 residues; '*' at row starts and ends, so at both window ends;
    hits with windows of 1-70 residues, with no overlap (ov <= 0), and far
    into the long row on both sides of its diagonal range."""
    rng = np.random.default_rng(23)
    lens = [int(x) for x in rng.permutation(np.arange(1, 71))] + [20500]
    big = len(lens) - 1
    chars = np.zeros((len(lens), max(lens)), dtype=np.uint8)
    for i, n in enumerate(lens):
        chars[i, :n] = LETTERS[rng.integers(0, 20, n)]
        if i % 3 == 0:
            chars[i, 0] = ord("*")
        if i % 4 == 0:
            chars[i, n - 1] = ord("*")
    whole = lens.index(70)
    chars[big, 5000:5070] = chars[whole, :70]     # a window that scores
    codes = constants.blosum62().aa2num[chars].astype(np.uint8)
    codes[chars == 0] = 20
    q = rng.integers(0, big + 1, 900)
    t = rng.integers(0, big + 1, 900)
    d = rng.integers(-75, 76, 900)
    long_q = q == big
    d[long_q] = rng.integers(-75, 20500, int(long_q.sum()))
    long_t = (t == big) & ~long_q
    d[long_t] = -rng.integers(0, 20500, int(long_t.sum()))
    # every short row whole against the long one: windows of 1-70
    # and the long row against itself: windows of over 20,000
    q = np.concatenate([q, np.full(big + 2, big)])
    t = np.concatenate([t, np.arange(big), [big, big]])
    d = np.concatenate([d, rng.integers(0, 20000, big), [300, -7]])
    d[900 + whole] = 5000
    i32 = lambda x: np.asarray(x, dtype=np.int32)
    rows, offsets = flat_rows(chars, lens, shift=3)
    assert len(set(int(o) % 16 for o in offsets)) == 16
    return codes, chars, i32(lens), i32(q), i32(t), i32(d), (rows, offsets)


def _pow2(codes, chars):
    w = 1 << (codes.shape[1] - 1).bit_length()
    pad = ((0, 0), (0, w - codes.shape[1]))
    return (np.pad(codes, pad, constant_values=20), np.pad(chars, pad), w)


INPUTS = {"mini_orfs": lambda: _db_hits(_mini_orfs()),
          "synthetic_db": lambda: _db_hits(_synthetic_db()),
          "edge_cases": _edge_cases,
          "unaligned_windows": _unaligned_windows}


@pytest.mark.parametrize("which", list(INPUTS))
def test_rescore_plain_matches_pallas_and_xla(which):
    codes, chars, lengths, q, t, d, (rows, offsets) = INPUTS[which]()
    assert len(q) > 50
    sub = constants.blosum62().sub.astype(np.int32)
    got = [x.numpy() for x in rescore_e2e(*port_args(
        rows, offsets, lengths, q, t, d, constants.blosum62()))]

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
    if which == "unaligned_windows":
        assert set(range(1, 71)) <= set(ov.tolist()) and ov.max() > 70
    if which in ("edge_cases", "unaligned_windows"):
        assert (ov <= 0).sum() > 10 and (got[1] == -1).sum() == (ov <= 0).sum()
        assert (got[1] == 1).sum() > 0 and (got[2] < ov - 1)[ov > 1].any()


def test_rescore_rejects_bad_operands():
    rows = torch.zeros(12, dtype=torch.uint8)
    offs = torch.tensor([0, 6], dtype=torch.int64)
    lens = torch.tensor([4, 4], dtype=torch.int32)
    lut = torch.zeros(256, dtype=torch.uint8)
    h = torch.zeros(3, dtype=torch.int32)
    sub = torch.zeros((21, 21), dtype=torch.int32)
    with pytest.raises(TypeError):
        rescore_e2e(rows.int(), offs, lens, lut, h, h, h, sub)
    with pytest.raises(TypeError):
        rescore_e2e(rows.reshape(2, 6), offs, lens, lut, h, h, h, sub)
    with pytest.raises(TypeError):
        rescore_e2e(rows, offs.int(), lens, lut, h, h, h, sub)
    with pytest.raises(TypeError):
        rescore_e2e(rows, offs, lens.long(), lut, h, h, h, sub)
    with pytest.raises(TypeError):
        rescore_e2e(rows, offs, lens, lut[:100], h, h, h, sub)
    with pytest.raises(TypeError):
        rescore_e2e(rows, offs, lens, lut, h, h[:2], h, sub)
    with pytest.raises(TypeError):
        rescore_e2e(rows, offs, lens, lut, h, h, h,
                    torch.zeros((40, 40), dtype=torch.int32))
    out = rescore_e2e_plain(rows, offs, lens, lut, h[:0], h[:0], h[:0], sub)
    assert all(o.numel() == 0 for o in out)


@pytest.mark.parametrize("which", list(INPUTS))
def test_hamming_plain_matches_xla(which):
    """The plain HAMMING rescore (--rescore-mode 0) equals the JAX
    package's rescore_pairs(mode=0) on protein hits: identical raw chars
    (lower case counts as different) over the window, first = last = -1."""
    codes, chars, lengths, q, t, d, (rows, offsets) = INPUTS[which]()
    args = port_args(rows, offsets, lengths, q, t, d, constants.blosum62())
    got = [x.numpy() for x in rescore_hamming(*args[:7])]
    alpha = 21
    xla = rescore_pairs(jnp.asarray(codes), jnp.asarray(chars),
                        jnp.asarray(lengths), jnp.asarray(q), jnp.asarray(t),
                        jnp.asarray(d), jnp.zeros(len(q), bool),
                        jnp.asarray(constants.blosum62().sub.astype(np.int32)
                                    .reshape(-1)),
                        jnp.arange(alpha, dtype=jnp.int32),
                        jnp.asarray(constants.blosum62().num2aa), alpha,
                        mode=0, has_rev=False)
    for name, g, x in zip(("score", "first", "last", "idents"), got,
                          (xla[0], xla[1], xla[2], xla[5])):
        np.testing.assert_array_equal(g, np.asarray(x), err_msg=name)
    assert (got[0] > 10).any() and (got[1] == -1).all()


def _mixed_widths(nucl, seed=5, n_hits=500, top=600):
    """Rows of 0 to `top` residues ('*' or N at some ends, some in lower
    case) and hits on them whose windows run from none to `top` residues
    in no order of width; on nucleotides, about half of them reverse.
    Returns the plain versions' operands and their keyword arguments."""
    rng = np.random.default_rng(seed)
    mat = constants.nucleotide() if nucl else constants.blosum62()
    letters = (np.frombuffer(b"ACGTNacgt", np.uint8) if nucl
               else np.concatenate([LETTERS, LETTERS + 32]))
    lens = np.concatenate([[0, 1, top], rng.integers(1, top, 37)])
    chars = np.zeros((len(lens), top), dtype=np.uint8)
    for i, n in enumerate(lens):
        chars[i, :n] = letters[rng.integers(0, len(letters), n)]
        if i % 3 == 1:
            chars[i, 0] = ord("N" if nucl else "*")
    q = rng.integers(0, len(lens), n_hits)
    t = rng.integers(0, len(lens), n_hits)
    d = rng.integers(-top, top, n_hits)
    i32 = lambda x: np.asarray(x, dtype=np.int32)
    rows, offsets = flat_rows(chars, lens, shift=5)
    args = port_args(rows, offsets, i32(lens), i32(q), i32(t), i32(d), mat)
    kw = {}
    if nucl:
        kw = dict(qrev=torch.from_numpy(rng.random(n_hits) < 0.5),
                  comp=torch.from_numpy(mat.reverse.astype(np.int32)),
                  code2char=torch.from_numpy(mat.num2aa.astype(np.uint8)))
    return args, kw


@pytest.mark.parametrize("budget", [1, 600, 5000, 1 << 16])
@pytest.mark.parametrize("nucl", [False, True])
def test_plain_chunks_equal_one_chunk(nucl, budget):
    """The plain versions take the hits in chunks of at most `budget`
    window cells, in the order of their window length: every chunking
    gives what one chunk of every hit, padded to the widest window,
    gives."""
    args, kw = _mixed_widths(nucl)
    whole = args[4].numel() * int(args[2].max())
    for name, fn, n_args in (("e2e", rescore_e2e_plain, 8),
                             ("hamming", rescore_hamming_plain, 7),
                             ("align", rescore_align_plain, 8)):
        want = fn(*args[:n_args], budget=whole, **kw)
        got = fn(*args[:n_args], budget=budget, **kw)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.numpy(), w.numpy(),
                                          err_msg=f"{name} output {i}")
    ov = _overlap(args[2], args[4].long(), args[5].long(), args[6])[0]
    assert (ov <= 0).sum() > 10 and (ov > 300).sum() > 10
