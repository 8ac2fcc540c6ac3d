"""PyTorch port: the device k-mer matcher (kmermatcher_torch on the CPU,
so kernel K1 runs as its plain version) against the JAX package's
kmermatcher_jax on CPU jax — the flat (rep, tgt, score, diag) hit arrays
with self rows must be equal."""
import os

import numpy as np
import pytest
import torch

from plass_tpu.data import seqdb
from plass_tpu.data.createdb import merge_reads
from plass_tpu.ops import orf as orf_mod
from plass_tpu.ops import translate as tr
from plass_tpu.ops import device_kmer as jdk
from plass_tpu.ops.backend import kmermatcher_jax
from plass_tpu_torch.data.seqdb import SeqDB as PortSeqDB
from plass_tpu_torch.ops import device_kmer as pdk
from plass_tpu_torch.ops.backend import kmermatcher_torch

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
LETTERS = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)


def _mini_orfs():
    reads, _ = merge_reads(READS)
    odb, ohdb = orf_mod.extract_orfs(reads, min_length=20, max_length=32734,
                                     max_gaps=0, start_mode=0)
    return tr.translate_nucs(odb, ohdb, 1, add_orf_stop=True)


def _synthetic_db(seed=21, n=700):
    """Overlapping fragments of three random proteomes, with point
    mutations, '*' ends, X residues, a low-complexity repeat (duplicate
    k-mers inside a sequence) and non-contiguous keys."""
    rng = np.random.default_rng(seed)
    genomes = [LETTERS[rng.integers(0, 20, 2500)] for _ in range(3)]
    genomes[0][400:700] = np.tile(LETTERS[rng.integers(0, 20, 5)], 60)
    recs = []
    for _ in range(n):
        g = genomes[int(rng.integers(0, 3))]
        ln = int(rng.integers(16, 150))
        s = int(rng.integers(0, len(g) - ln))
        seq = g[s:s + ln].copy()
        mut = rng.random(ln) < 0.01
        seq[mut] = LETTERS[rng.integers(0, 20, int(mut.sum()))]
        if rng.random() < 0.2:
            seq[0] = ord("*")
        if rng.random() < 0.2:
            seq[-1] = ord("*")
        if rng.random() < 0.05:
            seq[int(rng.integers(0, ln))] = ord("X")
        recs.append(seq.tobytes())
    keys = np.sort(rng.choice(5 * n, n, replace=False))
    return seqdb.SeqDB.from_records(recs, keys=keys, dbtype=seqdb.AMINO_ACIDS)


DBS = {"mini_orfs": _mini_orfs, "synthetic": _synthetic_db}
_CACHE = {}


def _db(which):
    if which not in _CACHE:
        _CACHE[which] = DBS[which]()
    return _CACHE[which]


def _port(db):
    return PortSeqDB(db.data, db.keys, db.offsets, db.lengths, db.dbtype)


@pytest.mark.parametrize("only_ext", [True, False])
@pytest.mark.parametrize("shift", [67, 68])
@pytest.mark.parametrize("which", list(DBS))
def test_kmermatcher_matches_jax(which, shift, only_ext):
    db = _db(which)
    kw = dict(kmers_per_sequence=60, hash_shift=shift, ignore_multi_kmer=True,
              include_only_extendable=only_ext)
    want = kmermatcher_jax(db, 14, return_arrays=True, **kw)
    got = kmermatcher_torch(_port(db), 14, torch.device("cpu"), **kw)
    for name, g, w in zip(("qk", "tk", "score", "diag"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)
    np.testing.assert_array_equal(got.hit_slots, want.hit_slots)
    assert len(got.hit_slots) > (5 if which == "mini_orfs" else 500)
    # the device-resident raw hits are the rows the flat arrays carry
    rep, tgt, diag, rev = got.dev
    np.testing.assert_array_equal(rep.numpy(), got[0][got.hit_slots])
    np.testing.assert_array_equal(tgt.numpy(), got[1][got.hit_slots])
    np.testing.assert_array_equal(diag.numpy(), got[3][got.hit_slots])
    assert not rev.any()    # protein hits are forward


@pytest.mark.parametrize("ignore_multi", [True, False])
def test_select_kmers_matches_jax(ignore_multi):
    """Stage A alone, where the duplicate-skip state machine lives: the
    selected (row, k-mer, pos, range key) entries in selection order are
    equal."""
    import jax.numpy as jnp
    from plass_tpu.ops.backend import db_to_padded

    db = _db("synthetic")
    codes, lengths, _ = db_to_padded(db, "kmer")
    jp = jdk.KmerParams.protein_default(ignore_multi_kmer=ignore_multi,
                                        ksel=60)
    sk, sp, sv, sh, sh16 = jdk.select_kmers(jnp.asarray(codes),
                                            jnp.asarray(lengths), jp, 67)
    sv = np.asarray(sv)
    pp = pdk.KmerParams(k=14, alphabet_size=13, kmers_per_sequence=60,
                        kmers_per_sequence_scale=0.0,
                        ignore_multi_kmer=ignore_multi, ksel=60)
    rows, kmer, pos, seq_hash, h16 = pdk.select_kmers(
        torch.from_numpy(codes), torch.from_numpy(lengths), pp, 67)
    np.testing.assert_array_equal(rows.numpy(), np.nonzero(sv)[0])
    np.testing.assert_array_equal(kmer.numpy().view(np.uint64),
                                  np.asarray(sk)[sv])
    np.testing.assert_array_equal(pos.numpy(), np.asarray(sp)[sv])
    np.testing.assert_array_equal(seq_hash.numpy().view(np.uint64),
                                  np.asarray(sh))
    # the split path's range keys: the selection hash
    np.testing.assert_array_equal(h16.numpy(), np.asarray(sh16)[sv])


def test_dup_skip_state_machine_matches_column_loop():
    """The doubling-scan form of the duplicate-skip state machine equals
    the reference's column loop on random runs of equal k-mers."""
    rng = np.random.default_rng(4)
    eq = rng.random((300, 97)) < 0.45
    eq[:, -1] = False
    state = np.zeros(300, dtype=np.int64)
    want = np.zeros_like(eq)
    for j in range(eq.shape[1]):
        e = eq[:, j]
        want[:, j] = ((state == 0) & ~e) | (state == 2)
        state = np.where(state == 0, np.where(e, 1, 0),
                         np.where(state == 1, np.where(e, 1, 2), 0))
    got = pdk._dup_skip_processed(torch.from_numpy(eq))
    np.testing.assert_array_equal(got.numpy(), want)


def test_block_selection_equals_single_block(monkeypatch):
    """Selecting rows in several blocks gives the same table."""
    db = _port(_db("synthetic"))
    kw = dict(kmers_per_sequence=60, hash_shift=67, ignore_multi_kmer=True,
              include_only_extendable=True)
    whole = kmermatcher_torch(db, 14, torch.device("cpu"), **kw)
    monkeypatch.setattr(pdk, "SELECT_CELLS", 150 * 37)
    blocks = kmermatcher_torch(_port(_db("synthetic")), 14,
                               torch.device("cpu"), **kw)
    for g, w in zip(blocks, whole):
        np.testing.assert_array_equal(g, w)
    assert blocks.table_entries == whole.table_entries


def _dict_to_flat(hits):
    """The host matcher's {query: [(target, score, diag), ...]} as flat
    (qk, tk, score, diag) arrays in its own order."""
    rows = [(q, t, s, d) for q in sorted(hits) for (t, s, d) in hits[q]]
    return [np.asarray(c, dtype=np.int64) for c in zip(*rows)]


@pytest.mark.parametrize("cov_mode", [0, 1, 2])
def test_coverage_modes_match_host_matcher(cov_mode):
    """With include_only_extendable off and -c 0.8 the length test follows
    Util::canBeCovered per mode: bidirectional (0) and query (2) coverage
    drop pairs, target coverage (1) keeps all, as the JAX package's host
    matcher does; at mode 0 the JAX device matcher agrees too."""
    from plass_tpu.ops.kmermatch import kmermatcher

    db = _db("synthetic")
    kw = dict(kmers_per_sequence=60, hash_shift=67, ignore_multi_kmer=True,
              include_only_extendable=False, cov_thr=0.8)
    want = _dict_to_flat(kmermatcher(db, 14, cov_mode=cov_mode, **kw))
    got = kmermatcher_torch(_port(db), 14, torch.device("cpu"),
                            cov_mode=cov_mode, **kw)
    for name, g, w in zip(("qk", "tk", "score", "diag"), got, want):
        np.testing.assert_array_equal(np.asarray(g, np.int64), w,
                                      err_msg=name)
    # the coverage test's effect on the synthetic DB (929 vs 2,857 hits)
    assert len(got.hit_slots) == {0: 929, 1: 2857, 2: 929}[cov_mode]
    split = kmermatcher_torch(_port(db), 14, torch.device("cpu"),
                              cov_mode=cov_mode, split_memory_limit="4K",
                              **kw)
    assert len(split.ranges) >= 8
    for g, w in zip(split, got):
        np.testing.assert_array_equal(g, w)
    if cov_mode == 0:
        jax_hits = kmermatcher_jax(db, 14, return_arrays=True, **kw)
        for g, w in zip(got, jax_hits):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
