"""PyTorch port: rescore_diagonal_torch (kernel K2 as its plain version on
the CPU, the native finish) against the JAX package's rescore_diagonal_jax
on the hits each side's matcher produced — the records must be equal, in
the flat format the extender reads and in the per-query dict format of
iteration 0; the rescore reads the DB's flat bytes and makes no padded copy
of the rows."""
import os

import numpy as np
import pytest
import torch

from plass_tpu.data import seqdb
from plass_tpu.data.createdb import merge_reads
from plass_tpu.ops import orf as orf_mod
from plass_tpu.ops import translate as tr
from plass_tpu.ops.backend import kmermatcher_jax, rescore_diagonal_jax
from plass_tpu.ops.evalue import EvalueComputer
from plass_tpu.ops.rescore import RescoreParams
from plass_tpu_torch.data.createdb import merge_reads as port_merge_reads
from plass_tpu_torch.data.seqdb import SeqDB as PortSeqDB
from plass_tpu_torch.ops import backend as port_backend
from plass_tpu_torch.ops.backend import (kmermatcher_torch,
                                         rescore_diagonal_torch)
from plass_tpu_torch.ops.rescore import RescoreParams as PortRescoreParams

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
LETTERS = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)


def _mini_orfs():
    reads, _ = merge_reads(READS)
    odb, ohdb = orf_mod.extract_orfs(reads, min_length=20, max_length=32734,
                                     max_gaps=0, start_mode=0)
    return tr.translate_nucs(odb, ohdb, 1, add_orf_stop=True)


def _synthetic_db(seed=31, n=600):
    rng = np.random.default_rng(seed)
    genome = LETTERS[rng.integers(0, 20, 3000)]
    recs = []
    for _ in range(n):
        ln = int(rng.integers(20, 140))
        s = int(rng.integers(0, len(genome) - ln))
        seq = genome[s:s + ln].copy()
        mut = rng.random(ln) < 0.03
        seq[mut] = LETTERS[rng.integers(0, 20, int(mut.sum()))]
        if rng.random() < 0.3:
            seq[0] = ord("*")
        if rng.random() < 0.3:
            seq[-1] = ord("*")
        recs.append(seq.tobytes())
    keys = np.sort(rng.choice(3 * n, n, replace=False))
    return seqdb.SeqDB.from_records(recs, keys=keys, dbtype=seqdb.AMINO_ACIDS)


DBS = {"mini_orfs": _mini_orfs, "synthetic": _synthetic_db}


def _both(which, only_ext, flat):
    db = DBS[which]()
    pdb = PortSeqDB(db.data, db.keys, db.offsets, db.lengths, db.dbtype)
    kw = dict(kmers_per_sequence=60, hash_shift=67, ignore_multi_kmer=True,
              include_only_extendable=only_ext)
    rp = dict(rescore_mode=3, seq_id_thr=0.9, eval_thr=1e-5)
    ev = EvalueComputer.for_matrix("blosum62_ungapped", db.total_residues())
    want = rescore_diagonal_jax(
        db, kmermatcher_jax(db, 14, return_arrays=True, **kw),
        RescoreParams(**rp), ev, return_flat=flat)
    got = rescore_diagonal_torch(
        pdb, kmermatcher_torch(pdb, 14, torch.device("cpu"), **kw),
        PortRescoreParams(**rp), return_flat=flat)
    return got, want


@pytest.mark.parametrize("only_ext", [True, False])
@pytest.mark.parametrize("which", list(DBS))
def test_rescore_flat_matches_jax(which, only_ext):
    got, want = _both(which, only_ext, flat=True)
    np.testing.assert_array_equal(got["qk"], want["qk"])
    np.testing.assert_array_equal(got["rec"], want["rec"])
    assert len(got["rec"]) > len(np.unique(got["qk"]))  # beyond self rows


@pytest.mark.parametrize("which", list(DBS))
def test_rescore_dict_matches_jax(which):
    got, want = _both(which, False, flat=False)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    assert sum(len(v) for v in got.values()) > len(got)


@pytest.mark.parametrize("kind", ["protein", "nucleotide"])
def test_rescore_makes_no_padded_copy(monkeypatch, kind):
    """The matcher and rescore_diagonal_torch read the DB's own bytes: the
    port has no db_to_padded, the row operand both hand on is the data
    array itself (one dimension, the DB's size), and the records still
    equal rescore_diagonal_jax's on the mini fixture's DBs."""
    if kind == "protein":
        db = _mini_orfs()
        pdb = PortSeqDB(db.data, db.keys, db.offsets, db.lengths, db.dbtype)
        k, matrix = 14, "blosum62_ungapped"
        kw = dict(kmers_per_sequence=60, hash_shift=67,
                  ignore_multi_kmer=True, include_only_extendable=False)
        rp = dict(rescore_mode=3, seq_id_thr=0.9, eval_thr=1e-5)
    else:
        db, _ = merge_reads(READS)
        pdb, _ = port_merge_reads(READS)
        k, matrix = 22, "nucleotide_ungapped"
        kw = dict(kmers_per_sequence=60, kmers_per_sequence_scale=0.1,
                  hash_shift=67, ignore_multi_kmer=True,
                  include_only_extendable=False)
        rp = dict(rescore_mode=3, seq_id_thr=0.99, eval_thr=1e-5)
    want = rescore_diagonal_jax(
        db, kmermatcher_jax(db, k, return_arrays=True, **kw),
        RescoreParams(**rp),
        EvalueComputer.for_matrix(matrix, db.total_residues()),
        return_flat=True)

    assert not hasattr(port_backend, "db_to_padded")
    seen = []

    def spy_on(module, name):
        real = getattr(module, name)

        def spy(rows, *rest, **kws):
            seen.append(rows)
            return real(rows, *rest, **kws)

        monkeypatch.setattr(module, name, spy)

    spy_on(port_backend.device_kmer, "kmermatch_device")
    spy_on(port_backend, "rescore_e2e")
    hits = kmermatcher_torch(pdb, k, torch.device("cpu"), **kw)
    got = rescore_diagonal_torch(pdb, hits, PortRescoreParams(**rp),
                                 return_flat=True)
    np.testing.assert_array_equal(got["qk"], want["qk"])
    np.testing.assert_array_equal(got["rec"], want["rec"])
    assert len(seen) == 2
    for rows in seen:
        assert rows.dim() == 1 and rows.numel() == len(pdb.data)
        assert rows.numel() == pdb.total_residues() + 2 * pdb.size


@pytest.mark.parametrize("alphabet", ["kmer", "score"])
@pytest.mark.parametrize("kind", ["protein", "nucleotide"])
def test_gathered_rows_equal_padded_codes(kind, alphabet):
    """The matcher's device gather of a block of rows from the flat bytes
    (flat_rows + gather_rows) equals the JAX package's padded codes: the
    alphabet's code of every residue, X from each row's length on."""
    from plass_tpu.ops.backend import db_to_padded

    if kind == "protein":
        db = _synthetic_db(n=80)
        pdb = PortSeqDB(db.data, db.keys, db.offsets, db.lengths, db.dbtype)
    else:
        db, _ = merge_reads(READS)
        pdb, _ = port_merge_reads(READS)
    codes, lengths, _ = db_to_padded(db, alphabet)
    n, width = db.size, int(db.seq_lens().max())
    rows, offsets, lens, lut = port_backend.flat_rows(
        pdb, torch.device("cpu"), alphabet)
    np.testing.assert_array_equal(lens.numpy(), lengths[:n])
    x_code = int(codes.max())
    idx = torch.from_numpy(np.random.default_rng(1).permutation(n))
    got = port_backend.device_kmer.gather_rows(rows, offsets, lens, lut, idx,
                                               width + 3, x_code)
    np.testing.assert_array_equal(got[:, :width].numpy(),
                                  codes[:n, :width][idx.numpy()])
    assert (got[:, width:] == x_code).all()


def _self_row_edges_db():
    """Synthetic proteins with rows whose self rows are the edges of the
    END_TO_END and HAMMING forms: no residue, a lone '*', '**', '*' at
    both ends, and lower-case residues (identity is case-folded)."""
    rng = np.random.default_rng(43)
    base = _synthetic_db(seed=43, n=300)
    recs = [bytes(base.get_data(i)[:-1]) for i in range(base.size)]
    for i in range(0, len(recs), 9):
        recs[i] = recs[i].lower()
    body = LETTERS[rng.integers(0, 20, 60)].tobytes()
    edges = [b"", b"*", b"**", b"*" + body + b"*", b"*" + body[:30].lower(),
             body[10:50] + b"*", b"", b"*", b"Ab*"]
    for j, rec in enumerate(edges):
        recs.insert(17 * j + 3, rec)
    keys = np.sort(rng.choice(4 * len(recs), len(recs), replace=False))
    return seqdb.SeqDB.from_records(recs, keys=keys,
                                    dbtype=seqdb.AMINO_ACIDS)


def _bytes(rec):
    """The records' bytes, a row a record."""
    return np.frombuffer(rec.tobytes(), np.uint8).reshape(
        len(rec), rec.dtype.itemsize)


@pytest.mark.parametrize("flat", [True, False])
@pytest.mark.parametrize("mode", [3, 0])
def test_self_rows_in_the_launch_match_jax(mode, flat):
    """The self rows are scored in the rescore's launch, one a sequence a
    call (SELF_ROWS), and the records of END_TO_END and HAMMING equal
    rescore_diagonal_jax's, whose self rows are analytic on its host, on
    rows of no residue, of '*' alone, with '*' at either end and in lower
    case; the port has no host pass of its own for them."""
    db = _self_row_edges_db()
    pdb = PortSeqDB(db.data, db.keys, db.offsets, db.lengths, db.dbtype)
    kw = dict(kmers_per_sequence=60, hash_shift=67, ignore_multi_kmer=True,
              include_only_extendable=False)
    rp = dict(rescore_mode=mode, seq_id_thr=0.9, eval_thr=1e-5)
    ev = EvalueComputer.for_matrix("blosum62_ungapped", db.total_residues())
    want = rescore_diagonal_jax(
        db, kmermatcher_jax(db, 14, return_arrays=True, **kw),
        RescoreParams(**rp), ev, return_flat=flat)
    hits = kmermatcher_torch(pdb, 14, torch.device("cpu"), **kw)
    before = port_backend.SELF_ROWS
    got = rescore_diagonal_torch(pdb, hits, PortRescoreParams(**rp),
                                 return_flat=flat)
    assert port_backend.SELF_ROWS - before == pdb.size
    # byte for byte: at END_TO_END a '*' row's self record has a seqId of
    # 0 / 0
    if flat:
        np.testing.assert_array_equal(got["qk"], want["qk"])
        np.testing.assert_array_equal(_bytes(got["rec"]), _bytes(want["rec"]))
        recs = got["rec"]
    else:
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(_bytes(got[k]), _bytes(want[k]),
                                          err_msg=str(k))
        recs = np.concatenate(list(got.values()))
    assert np.isnan(recs["seqId"]).any() == (mode == 3)
    assert len(recs) > pdb.size
    assert not hasattr(port_backend, "_self_rescore_host")


def test_rescore_takes_only_device_hits():
    db = _synthetic_db(n=20)
    pdb = PortSeqDB(db.data, db.keys, db.offsets, db.lengths, db.dbtype)
    with pytest.raises(TypeError):
        rescore_diagonal_torch(pdb, {int(k): [] for k in db.keys})
    # HAMMING (0), ALIGNMENT (2) and END_TO_END (3) are ported; modes 1
    # and 4 raise, as the JAX package fails on both
    for mode in (1, 4):
        with pytest.raises(NotImplementedError):
            rescore_diagonal_torch(pdb, None,
                                   PortRescoreParams(rescore_mode=mode))
