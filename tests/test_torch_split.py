"""PyTorch port, the memory-bounded (hash-range split) k-mer matcher, on
the CPU (kernel K1 runs as its plain version): split into at least eight
hash ranges it equals the port's monolithic matcher and both paths of the
JAX package's kmermatcher_jax (monolithic, and split by its device table
limit) on protein and nucleotide DBs; its ranges equal the JAX package's
for the same entry budget; the bucketed merge equals the whole merge where
a target segment crosses a bucket boundary; the fixture assemblies with a
tiny --split-memory-limit equal the committed goldens. Exact throughout."""
import os

import numpy as np
import pytest
import torch

from plass_tpu.ops import backend as jbackend
from plass_tpu.ops import device_kmer as jdk
from plass_tpu.ops.backend import kmermatcher_jax
from plass_tpu_torch.cli import penguin as port_penguin
from plass_tpu_torch.cli import plass as port_plass
from plass_tpu_torch.data import seqdb as port_seqdb
from plass_tpu_torch.ops import backend as pbackend
from plass_tpu_torch.ops import device_kmer as pdk
from plass_tpu_torch.ops.backend import kmermatcher_torch
from plass_tpu_torch.ops.kmermatch import ENTRY_BYTES
from test_torch_kmer import _port, _synthetic_db
from test_torch_nucl_kmer import _synthetic

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
CPU = torch.device("cpu")
KINDS = {
    "protein": (14, dict(kmers_per_sequence=60, hash_shift=67,
                         ignore_multi_kmer=True)),
    "nucleotide": (22, dict(kmers_per_sequence=60,
                            kmers_per_sequence_scale=0.1, hash_shift=67,
                            ignore_multi_kmer=True)),
}
# include_only_extendable, cov_thr (the coverage filter applies only when
# every hit is kept)
MODES = {"only_extendable": dict(include_only_extendable=True),
         "all": dict(include_only_extendable=False),
         "coverage": dict(include_only_extendable=False, cov_thr=0.5)}
_CACHE = {}


def _dbs(kind):
    """(JAX DB, port DB) of the seeded synthetic DB of `kind`."""
    if kind not in _CACHE:
        if kind == "protein":
            jdb = _synthetic_db()
            _CACHE[kind] = (jdb, _port(jdb))
        else:
            _CACHE[kind] = _synthetic()
    return _CACHE[kind]


def _assert_hits_equal(got, want):
    for name, g, w in zip(("qk", "tk", "score", "diag"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)
    np.testing.assert_array_equal(got.hit_slots, want.hit_slots)


def _assert_dev_equal(got, want):
    for g, w in zip(got.dev, want.dev):
        assert torch.equal(g, w)


def _jax_ranges(jdb, k, budget, **kw):
    """The JAX package's device ranges (its backend.py:185-207): the range
    keys of select_table_h16, the exact histogram of sort_table_by_range's
    bin boundaries, cut greedily at `budget` entries."""
    jc, jl, jk = jbackend.db_to_device(jdb, "kmer")
    is_nucl = jdb.dbtype == 1
    scale = kw.get("kmers_per_sequence_scale", 0.0)
    params = jdk.KmerParams(
        k=k, alphabet_size=5 if is_nucl else 13,
        kmers_per_sequence=kw["kmers_per_sequence"],
        kmers_per_sequence_scale=scale, is_nucl=is_nucl,
        ignore_multi_kmer=kw["ignore_multi_kmer"],
        ksel=jdk.ksel_capacity(kw["kmers_per_sequence"], scale, jc.shape[1]),
        narrow_rows=jc.shape[1] < ((1 << 15) if is_nucl else (1 << 16)))
    table = jdk.select_table_h16(jc, jl, jk, kw["hash_shift"], params)
    _, bounds = jdk.sort_table_by_range(*table)
    hist = np.diff(np.asarray(bounds))
    if int(hist.sum()) <= budget:
        return [(0, 0xFFFF)]
    return _greedy(hist, budget)


def _greedy(hist, budget):
    """The JAX package's range cut, as its backend.py:196-205 writes it."""
    ranges = []
    lo = 0
    acc = 0
    for h in range(len(hist)):
        if acc + int(hist[h]) > budget and acc > 0:
            ranges.append((lo, h - 1))
            lo = h
            acc = 0
        acc += int(hist[h])
    ranges.append((lo, len(hist) - 1))
    return ranges


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_split_equals_monolithic_and_jax(kind, mode, monkeypatch):
    """Port split (at least 8 ranges) = port monolithic = kmermatcher_jax
    monolithic = kmermatcher_jax split, flat hit arrays and the device
    hits; the port's ranges are the JAX package's for the same budget."""
    jdb, pdb = _dbs(kind)
    k, kw = KINDS[kind]
    kw = dict(kw, **MODES[mode])
    mono = kmermatcher_torch(pdb, k, CPU, **kw)
    assert mono.ranges == [(0, 0xFFFF)]
    budget = mono.table_entries // 10
    split = kmermatcher_torch(pdb, k, CPU, split_memory_limit=budget
                              * ENTRY_BYTES, **kw)
    assert split.table_entries == mono.table_entries
    assert len(split.ranges) >= 8
    _assert_hits_equal(split, mono)
    _assert_dev_equal(split, mono)
    assert len(mono.hit_slots) >= 1000
    if kind == "nucleotide":
        assert (split[2] < 0).sum() >= 500    # reverse-strand hits

    jkw = dict(kw, return_arrays=True)
    _assert_hits_equal(mono, kmermatcher_jax(jdb, k, **jkw))
    monkeypatch.setenv("PLASS_DEVICE_TABLE_LIMIT", str(budget))
    jbackend._FETCH_GUESSES.clear()
    _assert_hits_equal(split, kmermatcher_jax(jdb, k, **jkw))
    assert split.ranges == _jax_ranges(jdb, k, budget, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cut_bins_equals_the_greedy_loop(seed):
    """cut_bins (a cumulative-sum search per range) equals the JAX
    package's bin-by-bin loop: empty bins at the start, between and at the
    end, bins over the budget, budgets of 0 and above the total."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 6, 5000) * (rng.random(5000) < 0.4)
    hist[:7] = 0
    hist[-9:] = 0
    hist[rng.integers(0, 5000, 20)] = 40
    for budget in (0, 1, 5, 17, 39, 40, 41, 300, int(hist.sum()),
                   int(hist.sum()) + 1):
        assert pdk.cut_bins(hist, budget) == _greedy(hist, budget), budget
    assert pdk.cut_bins(np.zeros(10, np.int64), 3) == [(0, 9)]


def _small_protein_db():
    """A protein DB whose low-complexity repeat gives one range-key bin far
    more entries than the rest, with empty sequences among the others."""
    jdb, _ = _dbs("protein")
    recs = [jdb.get_seq_bytes(i) for i in range(120)]
    recs[5] = recs[40] = recs[41] = b""
    return port_seqdb.SeqDB.from_records(
        recs, keys=np.arange(0, 240, 2), dbtype=port_seqdb.AMINO_ACIDS)


def test_budget_below_the_largest_bin_and_empty_sequences():
    """A budget one entry below the largest bin: that bin is a range of
    its own, over the budget, and the split still equals the monolithic
    matcher; the DB holds empty sequences."""
    db = _small_protein_db()
    k, kw = KINDS["protein"]
    kw = dict(kw, include_only_extendable=False)
    mono = kmermatcher_torch(db, k, CPU, **kw)
    rows = pbackend.flat_rows(db, CPU, "kmer")
    params = pdk.KmerParams(k=k, alphabet_size=13, kmers_per_sequence=60,
                            kmers_per_sequence_scale=0.0,
                            include_only_extendable=False,
                            ksel=pdk.ksel_capacity(60, 0.0, 200))
    rkey = pdk.build_table(*rows, torch.from_numpy(db.keys.astype(np.int32)),
                           params, 67)[4]
    hist = torch.bincount(rkey, minlength=pdk.RANGE_BINS)
    largest = int(hist.max())
    assert largest >= 8
    split = kmermatcher_torch(db, k, CPU, split_memory_limit=(largest - 1)
                              * ENTRY_BYTES, **kw)
    top = int(hist.argmax())
    assert (top, top) in split.ranges
    assert len(split.ranges) >= 8
    _assert_hits_equal(split, mono)
    _assert_dev_equal(split, mono)
    assert len(mono.hit_slots) > 0


def test_budget_at_the_table_runs_one_range(monkeypatch):
    """A budget at or above the table's entries: one range, and none of the
    split path's code runs."""
    _, pdb = _dbs("nucleotide")
    k, kw = KINDS["nucleotide"]
    mono = kmermatcher_torch(pdb, k, CPU, **kw)

    def refuse(*args, **kws):
        raise AssertionError("the split path ran")

    for name in ("table_ranges", "pairs_by_range", "merge_parts"):
        monkeypatch.setattr(pdk, name, refuse)
    for entries in (mono.table_entries, mono.table_entries + 1):
        got = kmermatcher_torch(pdb, k, CPU, split_memory_limit=entries
                                * ENTRY_BYTES, **kw)
        assert got.ranges == [(0, 0xFFFF)]
        _assert_hits_equal(got, mono)


def test_empty_db():
    db = port_seqdb.SeqDB.from_records([], dbtype=port_seqdb.NUCLEOTIDES)
    k, kw = KINDS["nucleotide"]
    for limit in (0, 1):
        got = kmermatcher_torch(db, k, CPU, split_memory_limit=limit, **kw)
        assert got.table_entries == 0 and got.ranges == [(0, 0xFFFF)]
        assert all(len(x) == 0 for x in got)


def _pair_stream(seed):
    """Kept pairs (rep, tgt, diag, rev) of 40 representatives over 4
    targets and 3 diagonals, in no order, and the DB keys. Representative
    12 has a single target, 3003, the last of representative 11 and the
    first of 13: with buckets of one representative, the segment of target
    3003 crosses two bucket boundaries (the run-absorb quirk)."""
    rng = np.random.default_rng(seed)
    keys = np.arange(0, 400, 10, dtype=np.int32)
    rep, tgt = [], []
    for r in keys:
        n = int(rng.integers(1, 12))
        rep += [r] * n
        tgt += list(rng.integers(0, 4, n) * 1000 + 3)
    rep += [keys[12]] * 6 + [keys[11], keys[13]] * 3
    tgt += [3003] * 12
    rep = np.array(rep, np.int32)
    tgt = np.array(tgt, np.int32)
    tgt[rep == keys[12]] = 3003
    # 13's targets sort from 3003 on
    tgt[rep == keys[13]] = np.maximum(tgt[rep == keys[13]], 3003)
    order = rng.permutation(len(rep))
    diag = rng.integers(-1, 2, len(rep)).astype(np.int32)
    rev = rng.integers(0, 2, len(rep)).astype(np.int32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x[order]))
    return t(rep), t(tgt), t(diag), t(rev), torch.from_numpy(keys)


@pytest.mark.parametrize("budget", [1, 7, 20])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bucketed_merge_equals_whole_merge(seed, budget):
    """merge_parts over parts in range order equals stage C on all the
    pairs at once, with buckets whose last target continues into the next
    bucket, and a bucket that is a single target."""
    rep, tgt, diag, rev, keys = _pair_stream(seed)
    want = pdk.best_diagonal_hits(*pdk.sort_pairs(rep, tgt, diag, rev))
    cuts = [0, 37, 90, len(rep)]
    parts = [[rep[a:b], tgt[a:b], (diag[a:b] << 1) | rev[a:b]]
             for a, b in zip(cuts, cuts[1:])]
    got = pdk.merge_parts(parts, keys, budget)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if budget == 1:
        # every bucket is one representative: buckets 11 | 12 | 13 meet on
        # target 3003, and bucket 12 is that target alone
        s_rep, s_tgt = pdk.sort_pairs(rep, tgt, diag, rev)[:2]
        for r in (11, 12, 13):
            sel = s_tgt[s_rep == keys[r]]
            if r == 12:
                assert (sel == 3003).all()
            else:
                assert int(sel[-1 if r == 11 else 0]) == 3003
        # the absorbed entries count: representative 11's hit on 3003
        # reaches into the next representatives' entries
        hit = (want[0] == keys[11]) & (want[1] == 3003)
        assert int(want[2][hit].abs()) > int(((s_rep == keys[11])
                                              & (s_tgt == 3003)).sum())


def test_auto_budget_on_a_card(monkeypatch):
    """split_memory_limit 0: monolithic on the CPU; on a card, the split
    starts where the estimate at BYTES_PER_ENTRY exceeds AUTO_SHARE of the
    memory the process can still allocate, and the budget leaves room for
    what stays resident (card memory faked: no card here)."""
    _, pdb = _dbs("nucleotide")
    k, kw = KINDS["nucleotide"]
    params = pdk.KmerParams(k=k, alphabet_size=5, kmers_per_sequence=60,
                            kmers_per_sequence_scale=0.1, is_nucl=True,
                            ksel=pdk.ksel_capacity(60, 0.1, 200))
    assert pbackend.split_budget(pdb, params, CPU, 0) is None
    est = pdb.size * (params.ksel + 1) + pdb.size
    need = est * pbackend.BYTES_PER_ENTRY / pbackend.AUTO_SHARE
    state = {}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (state["free"], 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: 3000)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device: 1000)
    card = torch.device("cuda")
    state["free"] = int(need) - 2000 + 1
    assert pbackend.split_budget(pdb, params, card, 0) is None
    state["free"] = int(need) - 2000 - 10
    budget = pbackend.split_budget(pdb, params, card, 0)
    bound = pbackend.estimate_kmer_count(pdb, k, 60, 0.1)
    usable = pbackend.AUTO_SHARE * (state["free"] + 2000)
    assert budget == int((usable - bound * pbackend.RESIDENT_BYTES)
                         // pbackend.BYTES_PER_ENTRY)
    assert 0 < budget < est
    # an explicit limit is bytes of table at ENTRY_BYTES per entry
    assert pbackend.split_budget(pdb, params, card, "40K") == \
        (40 << 10) // ENTRY_BYTES


def test_fixture_assemblies_with_a_tiny_split_limit(tmp_path):
    """plass assemble (2 iterations, filter 0) and penguin nuclassemble (2
    iterations, min-contig-len 150) through the port's CLIs with
    --split-memory-limit 20K (1,024 entries a range) equal the goldens."""
    out = str(tmp_path / "assembly.fas")
    stats = {}
    assert port_plass.run(
        ["assemble", *READS, out, str(tmp_path / "ptmp"), "--num-iterations",
         "2", "--filter-proteins", "0", "--split-memory-limit", "20K",
         "--device", "cpu"], stats=stats) == 0
    assert open(out, "rb").read() == \
        open(os.path.join(FIX, "mini_golden_protein.fas"), "rb").read()
    assert min(stats["ranges"]) >= 8 and len(stats["ranges"]) == 3
    out = str(tmp_path / "contigs.fasta")
    stats = {}
    assert port_penguin.run(
        ["nuclassemble", *READS, out, str(tmp_path / "ntmp"),
         "--num-iterations", "2", "--min-contig-len", "150",
         "--split-memory-limit", "20K", "--device", "cpu"],
        stats=stats) == 0
    assert open(out, "rb").read() == \
        open(os.path.join(FIX, "mini_golden_nucl.fasta"), "rb").read()
    assert stats["ranges"][0] >= 8 and len(stats["ranges"]) == 2
    assert "peak_bytes" in stats and not stats["peak_bytes"]   # CPU
