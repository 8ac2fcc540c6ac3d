"""The port's batched cycle check (plass_tpu_torch.assembler.cyclecheck:
one sort, two carries and a sparse histogram for a whole DB) against the JAX
package's per-sequence merge loop, on seeded sequences. Tolerance: exact
(keys, split diagonals and the bytes of the cycle DB).

Each case is a DB of 30 sequences of one family; with the 12 edge-length
sequences below, 432 sequences in all, each checked with chop_cycle on and
off."""
import numpy as np
import pytest

from plass_tpu.assembler import cyclecheck as ref
from plass_tpu.data import seqdb as ref_seqdb
from plass_tpu_torch.assembler import cyclecheck as port
from plass_tpu_torch.data import seqdb

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
K = 22
PER_CASE = 30


def _rand(rng, n):
    return ACGT[rng.integers(0, 4, n)].copy()


def _tandem(rng, lo, hi, sub_rates=(0.0, 0.01, 0.02)):
    """A true tandem repeat: period in [lo, hi), 1.1 to 3.5 copies, with
    0-2% substitutions."""
    period = int(rng.integers(lo, hi))
    length = int(period * rng.uniform(1.1, 3.5)) + K
    s = np.tile(_rand(rng, period), length // period + 1)[:length].copy()
    mut = rng.random(length) < rng.choice(sub_rates)
    s[mut] = ACGT[rng.integers(0, 4, int(mut.sum()))]
    return s


def _family(name, rng):
    if name == "tandem_short":
        return _tandem(rng, 23, 200)
    if name == "tandem_mid":
        return _tandem(rng, 200, 1500)
    if name == "tandem_long":
        return _tandem(rng, 1500, 5000)
    if name == "tandem_exact":
        return _tandem(rng, 23, 3000, sub_rates=(0.0,))
    if name == "random":
        return _rand(rng, int(rng.integers(1, 4000)))
    if name == "homopolymer":
        return np.full(int(rng.integers(20, 3000)), ord("ACGT"[rng.integers(4)]),
                       dtype=np.uint8)
    if name == "dinucleotide":
        unit = np.frombuffer([b"AC", b"AT", b"CG", b"GA"][rng.integers(4)],
                             dtype=np.uint8)
        return np.tile(unit, int(rng.integers(10, 1500)))
    if name == "with_n":
        s = _tandem(rng, 23, 2000) if rng.random() < 0.5 \
            else _rand(rng, int(rng.integers(20, 3000)))
        mut = rng.random(len(s)) < rng.choice([0.001, 0.01, 0.1])
        s[mut] = ord("N")
        return s
    if name == "with_x_and_lower":
        s = _tandem(rng, 23, 1000)
        mut = rng.random(len(s)) < 0.02
        s[mut] = np.frombuffer(b"XxnRY*", dtype=np.uint8)[
            rng.integers(0, 6, int(mut.sum()))]
        low = rng.random(len(s)) < 0.2
        s[low] = np.char.lower(s[low].view("S1")).view(np.uint8)
        return s
    if name == "all_n":
        return np.full(int(rng.integers(20, 800)), ord("N"), dtype=np.uint8)
    if name == "repeat_in_random":
        # a repeat of a few copies inside unrelated sequence: partial bands
        s = _rand(rng, int(rng.integers(500, 4000)))
        unit = _rand(rng, int(rng.integers(23, 300)))
        copies = np.tile(unit, int(rng.integers(2, 6)))[:len(s) // 2]
        at = int(rng.integers(0, len(s) - len(copies)))
        s[at:at + len(copies)] = copies
        return s
    if name == "near_threshold":
        # periodic at the far end only: hit rates around the 0.2 threshold
        period = int(rng.integers(40, 400))
        length = int(period * rng.uniform(1.15, 1.6)) + K
        s = np.tile(_rand(rng, period), 3)[:length].copy()
        cut = int(rng.integers(0, length))
        s[:cut][rng.random(cut) < 0.08] = ord("A")
        return s
    if name == "tandem_indel":
        # copies that differ by single-base insertions and deletions: the
        # hits spread over neighbouring diagonals, so the +-1% band and its
        # "bins not above the centre" rule decide
        period = int(rng.integers(150, 1200))
        unit = _rand(rng, period)
        copies = []
        for _ in range(int(rng.integers(2, 5))):
            c = unit.copy()
            for _ in range(int(rng.integers(0, 4))):
                at = int(rng.integers(0, len(c)))
                c = np.delete(c, at) if rng.random() < 0.5 \
                    else np.insert(c, at, ACGT[rng.integers(4)])
            copies.append(c)
        s = np.concatenate(copies)
        return s[:int(len(s) * rng.uniform(0.6, 1.0))]
    if name == "period_is_third":
        # period exactly len // 3: the hits sit on the first bin
        period = int(rng.integers(23, 600))
        return np.tile(_rand(rng, period), 4)[:3 * period + int(rng.integers(3))]
    raise ValueError(name)


FAMILIES = ["tandem_indel", "period_is_third", "tandem_short", "tandem_mid",
            "tandem_long", "tandem_exact", "random", "homopolymer", "dinucleotide", "with_n",
            "with_x_and_lower", "all_n", "repeat_in_random", "near_threshold"]


def _dbs(seqs, keys=None):
    records = [bytes(s) for s in seqs]
    return (seqdb.SeqDB.from_records(records, keys, seqdb.NUCLEOTIDES),
            ref_seqdb.SeqDB.from_records(records, keys, ref_seqdb.NUCLEOTIDES))


def _assert_same(db, rdb, **kw):
    n_cycles = 0
    for chop in (False, True):
        got_db, got = port.cycle_check_db(db, chop_cycle=chop, **kw)
        want_db, want = ref.cycle_check_db(rdb, chop_cycle=chop, **kw)
        assert got == want
        assert list(got) == list(want)          # same order of discovery
        assert np.array_equal(got_db.keys, want_db.keys)
        assert np.array_equal(got_db.offsets, want_db.offsets)
        assert np.array_equal(got_db.lengths, want_db.lengths)
        assert got_db.data.tobytes() == want_db.data.tobytes()
        assert got_db.dbtype == want_db.dbtype
        n_cycles = len(want)
    return n_cycles


@pytest.mark.parametrize("family", FAMILIES)
def test_cycle_check_db_equals_reference(family):
    rng = np.random.default_rng(FAMILIES.index(family) + 100)
    seqs = [_family(family, rng) for _ in range(PER_CASE)]
    # keys that are neither dense nor the row numbers
    keys = np.cumsum(rng.integers(1, 5, PER_CASE)).astype(np.uint32)
    n_cycles = _assert_same(*_dbs(seqs, keys))
    if family.startswith("tandem"):
        assert n_cycles >= PER_CASE // 2     # the family does hold cycles
    if family == "random":
        assert n_cycles == 0


def test_edge_lengths_and_max_seq_len():
    """Lengths k-1, k, k+1, 3k and around max_seq_len (a sequence of
    max_seq_len or more is skipped, whatever it holds)."""
    rng = np.random.default_rng(7)
    unit = _rand(rng, 150)
    seqs = [np.tile(unit, 10)[:n] for n in
            (K - 1, K, K + 1, K + 2, 3 * K - 1, 3 * K, 3 * K + 1,
             598, 599, 600, 601, 1)]
    db, rdb = _dbs(seqs)
    assert _assert_same(db, rdb, max_seq_len=600) >= 2
    got = port.cycle_check_splits(db, max_seq_len=600)
    assert got[8] != 0 and got[9] == 0 and got[10] == 0
    assert not got[:2].any()


@pytest.mark.parametrize("k", [2, 3, 7])
def test_short_kmers_reach_the_last_bin(k):
    """With k < 3 a diagonal can fall on the last bin, which the diagonal
    loop never tests but a band may include."""
    rng = np.random.default_rng(k)
    seqs = []
    for _ in range(PER_CASE):
        period = int(rng.integers(1, 12))
        seqs.append(np.tile(_rand(rng, period), 40)[:int(rng.integers(3, 120))])
    db, rdb = _dbs(seqs)
    _assert_same(db, rdb, k=k)
    third = db.seq_lens() // 3
    if k == 2:
        # some sequence does hold a pair on its last bin
        assert any(len(s) % 3 == 2 and s[0] == s[3 * t] and s[1] == s[3 * t + 1]
                   for s, t in zip(seqs, third) if t)


def test_small_batches_and_band_rounds(monkeypatch):
    """The same answers when the DB is cut into many batches and the band
    test into many rounds (each round decides the sequences it can)."""
    rng = np.random.default_rng(11)
    seqs = [_family(FAMILIES[i % len(FAMILIES)], rng) for i in range(48)]
    db, rdb = _dbs(seqs)
    whole = port.cycle_check_splits(db)
    monkeypatch.setattr(port, "BATCH_RESIDUES", 5000)
    monkeypatch.setattr(port, "BAND_BUDGET", 64)
    assert np.array_equal(port.cycle_check_splits(db), whole)
    _assert_same(db, rdb)


def test_plain_version_is_the_reference():
    """cycle_check_seq, the port's plain version, is the reference's."""
    rng = np.random.default_rng(13)
    for name in ("tandem_short", "with_n", "homopolymer", "random"):
        s = _family(name, rng)
        assert port.cycle_check_seq(s) == ref.cycle_check_seq(s)


def test_empty_db():
    db, rdb = _dbs([])
    assert _assert_same(db, rdb) == 0
