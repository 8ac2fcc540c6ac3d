"""PyTorch port, nucleotide k-mer matcher (kmermatcher_torch on the CPU, so
kernel K1 runs as its plain version) against the JAX package on CPU jax,
stage by stage and as a whole: canonical 2-bit k-mers with the bit-63
forward marker, strand-aware diagonals, reverse-strand hits. Inputs are the
merged fixture reads (each package's own merge_reads) and a seeded
synthetic DB of reads from both strands. Exact."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plass_tpu.data import seqdb
from plass_tpu.data.createdb import merge_reads
from plass_tpu.ops import backend as jbackend
from plass_tpu.ops import device_kmer as jdk
from plass_tpu.ops.backend import kmermatcher_jax
from plass_tpu_torch.data import seqdb as port_seqdb
from plass_tpu_torch.data.createdb import merge_reads as port_merge_reads
from plass_tpu_torch.ops import device_kmer as pdk
from plass_tpu_torch.ops.backend import kmermatcher_torch

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
RC = np.arange(256, dtype=np.uint8)
RC[np.frombuffer(b"ACGTN", np.uint8)] = np.frombuffer(b"TGCAN", np.uint8)
# the nuclassemble defaults (Nuclassembler.cpp:10-32)
K = 22
KW = dict(kmers_per_sequence=60, kmers_per_sequence_scale=0.1, hash_shift=67,
          ignore_multi_kmer=True)


def _mini_reads():
    """(JAX DB, port DB) of the merged fixture reads."""
    jdb, _ = merge_reads(READS)
    pdb, _ = port_merge_reads(READS)
    assert np.array_equal(np.asarray(jdb.data), np.asarray(pdb.data))
    return jdb, pdb


def sample_reads(genome, n, rng, lo=60, hi=200, sub_rate=0.005):
    """n reads of genome with uniform starts and lengths in [lo, hi), half
    of them reverse complemented, with seeded substitutions and a few N."""
    recs = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi))
        s = int(rng.integers(0, len(genome) - ln))
        seq = genome[s:s + ln].copy()
        mut = rng.random(ln) < sub_rate
        seq[mut] = ACGT[rng.integers(0, 4, int(mut.sum()))]
        if rng.random() < 0.05:
            seq[int(rng.integers(0, ln))] = ord("N")
        if rng.random() < 0.5:
            seq = RC[seq[::-1]]
        recs.append(seq.tobytes())
    return recs


def _both(recs, keys):
    return (seqdb.SeqDB.from_records(recs, keys=keys,
                                     dbtype=seqdb.NUCLEOTIDES),
            port_seqdb.SeqDB.from_records(recs, keys=keys,
                                          dbtype=port_seqdb.NUCLEOTIDES))


def _synthetic(seed=5, n=600):
    """Reads of two random genomes from both strands, non-contiguous keys,
    one genome with a tandem repeat (duplicate k-mers inside a read)."""
    rng = np.random.default_rng(seed)
    genomes = [ACGT[rng.integers(0, 4, 3000)] for _ in range(2)]
    genomes[1][1000:1400] = np.tile(ACGT[rng.integers(0, 4, 25)], 16)
    recs = []
    for g in genomes:
        recs += sample_reads(g, n // 2, rng)
    keys = np.sort(rng.choice(4 * n, n, replace=False))
    return _both(recs, keys)


DBS = {"mini_reads": _mini_reads, "synthetic": _synthetic}
# (hits, reverse-strand hits) each DB has at least, with either
# include_only_extendable
MIN_HITS = {"mini_reads": (10, 5), "synthetic": (2000, 1000)}
_CACHE = {}


def _dbs(which):
    if which not in _CACHE:
        _CACHE[which] = DBS[which]()
    return _CACHE[which]


def _assert_hits_equal(got, want):
    for name, g, w in zip(("qk", "tk", "score", "diag"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)
    np.testing.assert_array_equal(got.hit_slots, want.hit_slots)
    # the device-resident raw hits are the rows the flat arrays carry
    rep, tgt, diag, rev = got.dev
    np.testing.assert_array_equal(rep.numpy(), got[0][got.hit_slots])
    np.testing.assert_array_equal(tgt.numpy(), got[1][got.hit_slots])
    np.testing.assert_array_equal(diag.numpy(), got[3][got.hit_slots])
    np.testing.assert_array_equal(rev.numpy(), got[2][got.hit_slots] < 0)


@pytest.mark.parametrize("only_ext", [True, False])
@pytest.mark.parametrize("which", list(DBS))
def test_nucl_kmermatcher_matches_jax(which, only_ext):
    jdb, pdb = _dbs(which)
    kw = dict(KW, include_only_extendable=only_ext)
    want = kmermatcher_jax(jdb, K, return_arrays=True, **kw)
    got = kmermatcher_torch(pdb, K, torch.device("cpu"), **kw)
    _assert_hits_equal(got, want)
    n_hits, n_rev = MIN_HITS[which]
    assert len(got.hit_slots) >= n_hits
    assert (got[2] < 0).sum() >= n_rev     # reverse-strand hits


def _jax_params(lmax, **kw):
    return jdk.KmerParams(
        k=K, alphabet_size=5, kmers_per_sequence=60,
        kmers_per_sequence_scale=0.1, is_nucl=True,
        ksel=jdk.ksel_capacity(60, 0.1, lmax),
        narrow_rows=lmax < (1 << 15), **kw)


def _port_params(**kw):
    return pdk.KmerParams(k=K, alphabet_size=5, kmers_per_sequence=60,
                          kmers_per_sequence_scale=0.1, is_nucl=True, **kw)


@pytest.mark.parametrize("which", list(DBS))
def test_nucl_select_kmers_matches_jax(which):
    """Stage A: canonical k-mers, palindromes dropped, reverse picks stored
    at len-pos-k with bit 63 clear, the duplicate skip on the strand-masked
    k-mer: the selected (row, k-mer, pos, range key) in selection order
    are equal."""
    jdb, _ = _dbs(which)
    codes, lengths, _ = jbackend.db_to_padded(jdb, "kmer")
    n = jdb.size
    sk, sp, sv, sh, sh16 = jdk.select_kmers(jnp.asarray(codes),
                                            jnp.asarray(lengths),
                                            _jax_params(codes.shape[1]), 67)
    sv = np.asarray(sv)[:n]
    rows, kmer, pos, seq_hash, h16 = pdk.select_kmers(
        torch.from_numpy(codes[:n]), torch.from_numpy(lengths[:n]),
        _port_params(), 67)
    np.testing.assert_array_equal(rows.numpy(), np.nonzero(sv)[0])
    want_kmer = np.asarray(sk)[:n][sv]
    np.testing.assert_array_equal(kmer.numpy().view(np.uint64), want_kmer)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(sp)[:n][sv])
    np.testing.assert_array_equal(seq_hash.numpy().view(np.uint64),
                                  np.asarray(sh)[:n])
    # the split path's range keys: the hash of the canonical k-mer
    np.testing.assert_array_equal(h16.numpy(), np.asarray(sh16)[:n][sv])
    fwd = want_kmer >> np.uint64(63)
    assert 0 < fwd.sum() < len(fwd)   # both strands picked


@pytest.mark.parametrize("only_ext", [True, False])
@pytest.mark.parametrize("which", list(DBS))
def test_nucl_pairs_and_sort_match_jax(which, only_ext):
    """Stages B and C on the JAX package's own table: the kept pairs in
    table order (representative carried with its strand, strand-aware
    diagonal, reverse flag), then stably sorted by (rep, tgt, diag)."""
    jdb, _ = _dbs(which)
    codes, lengths, keys = jbackend.db_to_padded(jdb, "kmer")
    jp = _jax_params(codes.shape[1], include_only_extendable=only_ext)
    kmer, sid, pos, slen, valid = jdk._stage_select(
        jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(keys), 67, jp)
    rep, tgt, diag, rev, keep = (np.asarray(x) for x in jdk.pairs_from_table(
        kmer, sid, pos, slen, valid, jp))
    v = np.asarray(valid)
    table = (torch.from_numpy(np.asarray(kmer)[v].view(np.int64)),
             torch.from_numpy(np.asarray(sid)[v].astype(np.int32)),
             torch.from_numpy(np.asarray(pos)[v]),
             torch.from_numpy(np.asarray(slen)[v]))
    pairs = pdk.pairs_from_table(*table,
                                 _port_params(include_only_extendable=only_ext))
    for name, g, w in zip(("rep", "tgt", "diag", "rev"), pairs,
                          (rep, tgt, diag, rev)):
        np.testing.assert_array_equal(g.numpy(), w[keep].astype(np.int64),
                                      err_msg=name)
    assert pairs[3].sum() >= MIN_HITS[which][1]
    s_rep, s_tgt, s_diag, s_rev, s_keep = (np.asarray(x) for x in
                                           jdk.sort_pairs(rep, tgt, diag,
                                                          rev, keep))
    m = int(keep.sum())
    for name, g, w in zip(("rep", "tgt", "diag", "rev"),
                          pdk.sort_pairs(*pairs),
                          (s_rep, s_tgt, s_diag, s_rev)):
        np.testing.assert_array_equal(g.numpy(), w[:m].astype(np.int64),
                                      err_msg=name)


def _long_db(seed=9, long_len=70_000, n_short=48):
    """One sequence of long_len nt among short reads of it from both
    strands: some anywhere, some beyond position 65,536 and some across its
    end, which extend it."""
    rng = np.random.default_rng(seed)
    genome = ACGT[rng.integers(0, 4, long_len + 2000)]
    recs = [genome[:long_len].tobytes()]
    recs += sample_reads(genome, n_short // 2, rng, lo=80, hi=300)
    recs += sample_reads(genome[60_000:], n_short // 4, rng, lo=80, hi=300)
    recs += sample_reads(genome[long_len - 300:long_len + 400], n_short // 4,
                         rng, lo=80, hi=300)
    keys = np.arange(len(recs)) * 3
    return _both(recs, keys)


@pytest.mark.parametrize("only_ext", [True, False])
def test_sequence_over_65536_matches_jax(monkeypatch, only_ext):
    """Lengths, positions and diagonals past 16 bits: the JAX side takes
    its wide branches (no narrow rows, no packed positions). Its padding
    buckets are turned off (padding does not change the hits) so that it
    pads 49 rows and not 2,048. The port selects the long row in a block
    of its own and the reads in a block only as wide as the longest read."""
    monkeypatch.setattr(jbackend, "_bucket", lambda x, step: max(x, 1))
    monkeypatch.setattr(pdk, "SELECT_CELLS", 70_000)
    jdb, pdb = _long_db()
    kw = dict(KW, include_only_extendable=only_ext)
    want = kmermatcher_jax(jdb, K, return_arrays=True, **kw)
    got = kmermatcher_torch(pdb, K, torch.device("cpu"), **kw)
    _assert_hits_equal(got, want)
    hit_diag = np.abs(got[3][got.hit_slots])
    assert (hit_diag >= 1 << 16).sum() > 0
    assert (got[2] < 0).sum() > 0


def test_sequence_at_the_limit_raises():
    rng = np.random.default_rng(2)
    recs = [ACGT[rng.integers(0, 4, n)].tobytes()
            for n in (pdk.MAX_LEN, 150, 150)]
    pdb = port_seqdb.SeqDB.from_records(recs,
                                        dbtype=port_seqdb.NUCLEOTIDES)
    with pytest.raises(ValueError, match="not supported"):
        kmermatcher_torch(pdb, K, torch.device("cpu"), **KW)
