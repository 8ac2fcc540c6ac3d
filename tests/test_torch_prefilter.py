"""PyTorch port: the sensitive prefilter (ops/prefilter.py, host numpy and
the native tantan and ungapped-diagonal kernels, as in the JAX package)
against the JAX package on the same seeded protein families: the hits and
the prefilter DB's bytes, self and query against target, at -s 5.7 and
1.0 with masking on and off; the similar-k-mer enumeration, tantan, the
ungapped prefilter and a saved index. All of it is integer or the same
float64 host code, so everything is exact."""
import numpy as np
import pytest

from plass_tpu import constants as ref_constants
from plass_tpu.data import seqdb as ref_seqdb
from plass_tpu.ops import prefilter as ref_pf
from plass_tpu.ops import tantan as ref_tantan
from plass_tpu_torch import constants as port_constants
from plass_tpu_torch.data import seqdb as port_seqdb
from plass_tpu_torch.ops import prefilter as port_pf
from plass_tpu_torch.ops import tantan as port_tantan


def family_records(n_fam, seed=17, median=150):
    """Seeded protein families the way chip_smoke.family_fasta makes them
    (BLOSUM62 background letters; 1 + Poisson(3) members with 1-20%
    substitutions, indels and trimmed ends; shuffled), with shorter roots
    (log-normal of the given median, 40 to 400 residues) to keep the JAX
    package's prefilter quick on the CPU. Returns the records' bytes."""
    mat = ref_constants.blosum62()
    freq = np.asarray(mat.pback[:20], dtype=np.float64)
    freq /= freq.sum()
    letters = mat.num2aa[:20]
    rng = np.random.default_rng(seed)

    def draw(n):
        return letters[rng.choice(20, n, p=freq)]

    recs = []
    for _ in range(n_fam):
        root = draw(int(np.clip(rng.lognormal(np.log(median), 0.5), 40, 400)))
        recs.append(root)
        for _ in range(rng.poisson(3)):
            s = root.copy()
            mut = rng.random(len(s)) < rng.uniform(0.01, 0.2)
            s[mut] = draw(int(mut.sum()))
            for _ in range(rng.poisson(len(root) / 200)):
                at, n = int(rng.integers(0, len(s))), int(rng.integers(1, 6))
                s = np.delete(s, slice(at, at + n)) if rng.random() < 0.5 \
                    else np.insert(s, at, draw(n))
            cut = int(rng.integers(0, max(1, int(0.15 * len(s)))))
            a = int(rng.integers(0, cut + 1))
            recs.append(s[a:len(s) - (cut - a)])
    return [recs[i].tobytes() for i in rng.permutation(len(recs))]


def family_dbs(n_fam, seed=17, median=150):
    """(JAX package's SeqDB, port's) of family_records, amino acids."""
    ref = ref_seqdb.SeqDB.from_records(family_records(n_fam, seed, median),
                                       dbtype=ref_seqdb.AMINO_ACIDS)
    return ref, to_port(ref)


def to_port(db):
    return port_seqdb.SeqDB(db.data, db.keys, db.offsets, db.lengths,
                            db.dbtype)


def query_subset(db, every, seqdb_mod):
    return seqdb_mod.subdb(db, [int(k) for k in db.keys][::every])


def db_bytes(db):
    return (db.data.tobytes(), db.keys.tolist(), db.offsets.tolist(),
            db.lengths.tolist(), db.dbtype)


@pytest.fixture(scope="module")
def fams():
    return family_dbs(12)


# (sensitivity, --mask, self search); each axis takes both of its values
CASES = [(5.7, 1, True), (5.7, 0, False), (1.0, 1, False), (1.0, 0, True)]


@pytest.mark.parametrize("sens,mask,self_search", CASES)
def test_prefilter_equals_jax_package(fams, sens, mask, self_search):
    ref_db, port_db = fams
    if self_search:
        args = ((ref_db, ref_db), (port_db, port_db))
    else:
        args = ((query_subset(ref_db, 3, ref_seqdb), ref_db),
                (query_subset(port_db, 3, port_seqdb), port_db))
    want = ref_pf.prefilter(*args[0], ref_pf.PrefilterParams(
        sensitivity=sens, mask=mask))
    got = port_pf.prefilter(*args[1], port_pf.PrefilterParams(
        sensitivity=sens, mask=mask))
    assert got == want
    n = sum(len(v) for v in got.values())
    assert n > 2 * len(got)
    qorder = [int(k) for k in args[0][0].keys][::-1]
    assert db_bytes(port_pf.prefilter_to_db(got, qorder)) == db_bytes(
        ref_pf.prefilter_to_db(want, qorder))


def test_prefilter_kmer_count_mode_and_coverage_filter(fams):
    """Diagonal scoring off (cluster's first step) and the post-hoc
    coverage filter, with --add-self-matches."""
    ref_db, port_db = fams
    kw = dict(sensitivity=4.0, diag_score=False, min_ungapped_score=0,
              comp_bias_corr=False, max_seqs=20, add_self_matches=True,
              cov_thr=0.8, cov_mode=0)
    want = ref_pf.prefilter(query_subset(ref_db, 2, ref_seqdb), ref_db,
                            ref_pf.PrefilterParams(**kw))
    got = port_pf.prefilter(query_subset(port_db, 2, port_seqdb), port_db,
                            port_pf.PrefilterParams(**kw))
    assert got == want
    assert any(h[1] == 255 for v in got.values() for h in v)


def test_enumerate_similar_equals_jax_package():
    rng = np.random.default_rng(3)
    sub20 = ref_constants.vtml80_8().sub[:20, :20].astype(np.int32)
    for k in (5, 6, 7):
        # thresholds from -s 7.5 to -s 4 at this k, as the prefilter's are
        ukm = np.unique(rng.integers(0, 20, (100, k)), axis=0)
        thr = rng.integers(ref_pf.kmer_threshold(7.5, k),
                           ref_pf.kmer_threshold(4.0, k),
                           len(ukm)).astype(np.int32)
        want = ref_pf.enumerate_similar(sub20, ukm, thr)
        got = port_pf.enumerate_similar(sub20, ukm, thr)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert len(got[1]) > len(ukm)


def test_tantan_mask_equals_jax_package(fams):
    ref_db, _ = fams
    ref_m = ref_tantan.TantanMasker(ref_constants.vtml80_8())
    port_m = port_tantan.TantanMasker(port_constants.vtml80_8())
    mat = port_constants.vtml80_8()
    rng = np.random.default_rng(9)
    repeat = np.tile(rng.integers(0, 20, 7), 30).astype(np.uint8)
    seqs = [mat.aa2num[np.asarray(ref_db.get_seq(i))] for i in range(8)]
    masked = 0
    for num in seqs + [repeat, np.concatenate([seqs[0], repeat, seqs[1]])]:
        got = port_m.mask(num)
        np.testing.assert_array_equal(got, ref_m.mask(num))
        masked += int((got != num).sum())
    assert masked > 100


def test_ungapped_prefilter_equals_jax_package(fams):
    ref_db, port_db = fams
    want = ref_pf.ungapped_prefilter(ref_db)
    got = port_pf.ungapped_prefilter(port_db)
    assert got == want
    q_ref = query_subset(ref_db, 4, ref_seqdb)
    q_port = query_subset(port_db, 4, port_seqdb)
    assert port_pf.ungapped_prefilter(q_port, port_db, max_seqs=5) == \
        ref_pf.ungapped_prefilter(q_ref, ref_db, max_seqs=5)


def test_index_saved_by_the_port_loads_back(fams, tmp_path):
    """A target index the port saves loads back in both packages (the
    same `.idx` files) and gives the prefilter's own hits."""
    _, port_db = fams
    seed = port_constants.vtml80_8()
    k, thr = 6, port_pf.kmer_threshold(5.7, 6)
    index = port_pf.KmerIndex(port_db, k, thr, seed, True, 1)
    base = str(tmp_path / "target")
    port_pf.save_prefilter_index(index, base, thr, 1, True,
                                 port_db.dbtype)
    got = port_pf.load_prefilter_index(base, k, thr, 1, True,
                                       seq_type=port_db.dbtype, comp_bias=1)
    ref = ref_pf.load_prefilter_index(base, k, thr, 1, True,
                                      seq_type=port_db.dbtype, comp_bias=1)
    for name in ("kmers", "sid", "pos", "order", "uniq", "starts", "counts"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(index, name))
        np.testing.assert_array_equal(getattr(ref, name),
                                      getattr(index, name))
    assert all(np.array_equal(a, b) for a, b in zip(got.nums, index.nums))
    # an incompatible parameter is no match
    assert port_pf.load_prefilter_index(base, k, thr + 1, 1, True) is None
    p = port_pf.PrefilterParams(sensitivity=5.7)
    p.prebuilt_index = got
    q = query_subset(port_db, 3, port_seqdb)
    assert port_pf.prefilter(q, port_db, p) == port_pf.prefilter(
        q, port_db, port_pf.PrefilterParams(sensitivity=5.7))


def test_profile_databases_raise_with_a_pointer_to_the_roadmap(fams):
    """A profile query DB against a profile target DB raises the JAX
    package's ValueError (profile queries and profile targets each search,
    tests/test_torch_profile_ops.py)."""
    errors = []
    for db, mod, pf in ((fams[0], ref_seqdb, ref_pf),
                        (fams[1], port_seqdb, port_pf)):
        prof = mod.SeqDB(db.data, db.keys, db.offsets, db.lengths,
                         mod.HMM_PROFILE)
        with pytest.raises(ValueError) as err:
            pf.prefilter(prof, prof, pf.PrefilterParams())
        errors.append(str(err.value))
    assert errors[1] == errors[0]
    assert "target-profile" in errors[1]
