"""PyTorch port: the profile subsystem's ops (ops/profiledb.py,
ops/profile_query.py, ops/msa.py, ops/profilestates.py) and the profile
branches of the prefilter and the amino-acid aligner, against the JAX
package on the same seeded protein families. The profile DB is made with
the JAX package's CLI (a self search with backtraces, then
result2profile). All of it is integer or the same host float code, so
everything is exact."""
import os

import numpy as np
import pytest

from plass_tpu.cli import tools_profile as ref_tools_profile
from plass_tpu.data import seqdb as ref_seqdb
from plass_tpu.ops import msa as ref_msa
from plass_tpu.ops import prefilter as ref_pf
from plass_tpu.ops import profile_query as ref_pq
from plass_tpu.ops import profiledb as ref_profiledb
from plass_tpu.ops import profilestates as ref_ps
from plass_tpu.ops import protein_align as ref_align
from plass_tpu_torch import constants as port_constants
from plass_tpu_torch.data import seqdb as port_seqdb
from plass_tpu_torch.ops import msa as port_msa
from plass_tpu_torch.ops import prefilter as port_pf
from plass_tpu_torch.ops import profile_query as port_pq
from plass_tpu_torch.ops import profiledb as port_profiledb
from plass_tpu_torch.ops import profilestates as port_ps
from plass_tpu_torch.ops import protein_align as port_align

from test_torch_tools import ref_run

ALPHABET = list("ACDEFGHIKLMNPQRSTVWY")


def family_rows(rng, base, n, n_mut=18):
    """Members of one family, as the JAX package's profile tests make them:
    n_mut random substitutions each, a 3-residue deletion in every third
    member and a 4-residue insertion in the next."""
    rows = []
    for i in range(n):
        mut = list(base)
        for j in rng.choice(len(base), n_mut, replace=False):
            mut[j] = rng.choice(ALPHABET)
        if i % 3 == 1:
            del mut[40:43]
        if i % 3 == 2:
            mut[60:60] = list(rng.choice(ALPHABET, 4))
        rows.append("".join(mut))
    return rows


def profile_inputs(d):
    """Two families of 120-residue roots: a target DB of 6 members each, a
    query DB of 2 each, the targets' self alignments with backtraces (the
    sensitive prefilter at -s 4, then align -a -e 10000) and
    their profile DB (the JAX package's CLI). Returns the paths."""
    rng = np.random.RandomState(7)
    bases = ["".join(rng.choice(ALPHABET, 120)) for _ in range(2)]
    trows = family_rows(rng, bases[0], 6) + family_rows(rng, bases[1], 6)
    qrows = family_rows(rng, bases[0], 2) + family_rows(rng, bases[1], 2)
    p = {k: os.path.join(d, k) for k in ("t", "q", "tpref", "taln", "prof")}
    for name, rows in (("t", trows), ("q", qrows)):
        with open(p[name] + ".fasta", "w") as fh:
            fh.writelines(f">{name}{i}\n{s}\n" for i, s in enumerate(rows))
        assert ref_run(["createdb", p[name] + ".fasta", p[name]]) == 0
    for argv in (["prefilter", p["t"], p["t"], p["tpref"], "-s", "4"],
                 ["align", p["t"], p["t"], p["tpref"], p["taln"], "-a", "-e",
                  "10000"],
                 ["result2profile", p["t"], p["t"], p["taln"], p["prof"]]):
        assert ref_run(argv) == 0, argv[0]
    return p


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    p = profile_inputs(str(tmp_path_factory.mktemp("profile_ops")))
    return {k: (ref_seqdb.SeqDB.open(v), port_seqdb.SeqDB.open(v))
            for k, v in p.items() if k != "tpref"}


def _records(db):
    return [db.get_data(i).tobytes() for i in range(db.size)]


def _assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("add_pc", [False, True])
def test_read_profile_scores_and_pssm_lines_equal_jax(dbs, add_pc):
    ref_prof, _ = dbs["prof"]
    recs = _records(ref_prof)
    assert len(recs) == 12 and all(len(r) % 23 == 0 for r in recs)
    for rec in recs:
        want = ref_profiledb.read_profile(rec, add_pc=add_pc)
        got = port_profiledb.read_profile(rec, add_pc=add_pc)
        _assert_dicts_equal(got, want)
        np.testing.assert_array_equal(port_profiledb.profile_scores(got),
                                      ref_profiledb.profile_scores(want))
        for bias in (True, False):
            assert port_profiledb.profile_to_pssm_lines(got, bias) == \
                ref_profiledb.profile_to_pssm_lines(want, bias)


def test_profile_query_and_its_kmers_equal_jax(dbs):
    """ProfileQuery's matrices, with and without the composition bias, and
    the per-window similar k-mers of every profile at the profile k-mer
    thresholds of k 5 and 6."""
    ref_prof, _ = dbs["prof"]
    n_kmers = 0
    for rec in _records(ref_prof):
        for bias in (True, False):
            want = ref_pq.ProfileQuery(rec, comp_bias=bias)
            got = port_pq.ProfileQuery(rec, comp_bias=bias)
            for name in port_pq.ProfileQuery.__slots__:
                np.testing.assert_array_equal(getattr(got, name),
                                              getattr(want, name), name)
            for k, sens in ((5, 5.7), (6, 4.0)):
                positions = np.nonzero(port_pf.SPACED_PATTERNS[k])[0]
                thr = port_pf.kmer_threshold(sens, k, profile=True)
                assert thr == ref_pf.kmer_threshold(sens, k, profile=True)
                gk = port_pq.enumerate_profile_kmers(got, positions, thr)
                wk = ref_pq.enumerate_profile_kmers(want, positions, thr)
                for a, b in zip(gk, wk):
                    np.testing.assert_array_equal(a, b)
                n_kmers += len(gk[2])
    assert n_kmers > 1000


def test_msa_pssm_and_filter_equal_jax(dbs):
    """compute_msa, msa_filter (default and with coverage and sequence
    identity filters) and compute_pssm on each target's alignments."""
    ref_t, _ = dbs["t"]
    ref_aln, _ = dbs["taln"]
    mat = port_constants.blosum62()
    n_msa = 0
    for i in range(ref_aln.size):
        center, edge_seqs, alns = ref_tools_profile._collect_msa_inputs(
            ref_t, ref_t, ref_aln, i, True, None, mat)
        if not alns:
            continue
        n_msa += 1
        want, wlen = ref_msa.compute_msa(center, edge_seqs, alns)
        got, glen = port_msa.compute_msa(center, edge_seqs, alns)
        np.testing.assert_array_equal(got, want)
        assert glen == wlen
        for kw in ({}, dict(coverage=50, qid_vec=(0, 20), max_seqid=60,
                            ndiff=2)):
            wkeep, wsize = ref_msa.msa_filter(want, wlen, **kw)
            gkeep, gsize = port_msa.msa_filter(got, glen, **kw)
            np.testing.assert_array_equal(gkeep, wkeep)
            assert gsize == wsize
        for kw in ({}, dict(wg=True, pca=0.0)):
            _assert_dicts_equal(port_msa.compute_pssm(got, glen, **kw),
                                ref_msa.compute_pssm(want, wlen, **kw))
        res = port_msa.compute_pssm(got, glen)
        port_msa.mask_profile(center, res)
        rec = port_msa.profile_record(center, res)
        wres = ref_msa.compute_pssm(want, wlen)
        ref_msa.mask_profile(center, wres)
        assert rec == ref_msa.profile_record(center, wres)
        for a, b in zip(port_msa.parse_profile_record(rec),
                        ref_msa.parse_profile_record(rec)):
            np.testing.assert_array_equal(a, b)
    assert n_msa >= 2


@pytest.mark.parametrize("alph", [219, 255])
def test_profile_states_discretisation_equals_jax(dbs, alph):
    ref_prof, _ = dbs["prof"]
    got_ps, want_ps = port_ps.ProfileStates(alph), ref_ps.ProfileStates(alph)
    np.testing.assert_array_equal(got_ps.profiles, want_ps.profiles)
    np.testing.assert_array_equal(got_ps.prior, want_ps.prior)
    for rec in _records(ref_prof):
        prob = ref_profiledb.read_profile(rec, add_pc=True)["prob"]
        if alph == 219:
            got, want = (got_ps.discretize_cs219(prob),
                         want_ps.discretize_cs219(prob))
        else:
            got, want = got_ps.discretize(prob), want_ps.discretize(prob)
        np.testing.assert_array_equal(got, want)


# (query, target, sensitivity, k-mer size): a profile query DB against
# sequences, sequences against a profile target DB
PREFILTER_CASES = {"profile-query": ("prof", "t", 4.0, 0),
                   "profile-query-k5": ("prof", "t", 5.7, 5),
                   "profile-target": ("q", "prof", 4.0, 0),
                   "profile-target-k5": ("q", "prof", 5.7, 5)}


@pytest.mark.parametrize("case", list(PREFILTER_CASES))
def test_prefilter_with_profiles_equals_jax(dbs, case):
    qname, tname, sens, k = PREFILTER_CASES[case]
    (rq, pq), (rt, pt) = dbs[qname], dbs[tname]
    want = ref_pf.prefilter(rq, rt, ref_pf.PrefilterParams(
        sensitivity=sens, kmer_size=k))
    got = port_pf.prefilter(pq, pt, port_pf.PrefilterParams(
        sensitivity=sens, kmer_size=k))
    assert got == want
    assert sum(len(v) for v in got.values()) > 2 * len(got)


@pytest.mark.parametrize("kw", [{}, dict(add_backtrace=True),
                                dict(realign=True, add_backtrace=True),
                                dict(realign=True, cov_thr=0.5)],
                         ids=["default", "backtrace", "realign-backtrace",
                              "realign-cov"])
def test_align_protein_with_profile_queries_equals_jax(dbs, kw):
    """A profile query DB against sequences, on the host on both sides (the
    device pre-score is skipped by the DB's type, also when forced)."""
    (rprof, pprof), (rt, pt) = dbs["prof"], dbs["t"]
    hits = ref_pf.prefilter(rprof, rt, ref_pf.PrefilterParams(
        sensitivity=4.0))
    want = ref_align.align_protein(rprof, hits, tdb=rt, eval_thr=10.0,
                                   device_prefilter=False, **kw)
    counts = {}
    got = port_align.align_protein(pprof, hits, tdb=pt, eval_thr=10.0,
                                   device_prefilter=True, device="cpu",
                                   counts=counts, **kw)
    assert got == want
    assert counts["candidate_pairs"] > 0 and counts["device_pairs"] == 0
    assert sum(len(v) for v in got.values()) > len(got)
    assert port_align.protein_align_results_to_db(
        got, add_backtrace=True).data.tobytes() == \
        ref_align.protein_align_results_to_db(
            want, add_backtrace=True).data.tobytes()
