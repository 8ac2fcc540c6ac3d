"""PyTorch port: the linear-time search (ops/linsearch.py,
cli/tools_linsearch.py) and the prefilter index tools, clusterupdate and
enrich, held against the JAX package on the same seeded inputs through
both packages' CLIs, byte for byte (a .npz payload array for array). The
port runs with --device cpu (kernel B9 as its plain version).

The port's `rescorediagonal` reads its target DB from its second argument
(ROADMAP C4); the JAX package's looks every target key up in the query DB.
Where the two DBs differ in content, the port is held against the JAX
package's CLI with that one command replaced by the oracle below: the JAX
package's own `rescore_diagonal(..., tdb=...)` and `results_to_db`."""
import os
import shutil

import numpy as np
import pytest

from plass_tpu.cli import tools as ref_tools
from plass_tpu.data import seqdb as ref_seqdb
from plass_tpu.ops import linsearch as ref_ls
from plass_tpu.ops import rescore as ref_rescore
from plass_tpu_torch.cli import plass as port_plass
from plass_tpu_torch.data import seqdb as port_seqdb
from plass_tpu_torch.ops import linsearch as port_ls

from test_torch_prefilter import family_records
from test_torch_tools import port_run, ref_run

COMP = bytes.maketrans(b"ACGT", b"TGCA")


def nucl_records(n_base=6, copies=6, seed=5):
    """Seeded nucleotide families: n_base random genomes of 400-800 nt,
    each with `copies` members at 2-8% substitutions, some with an indel,
    every fourth reverse-complemented; shuffled."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    recs = []
    for _ in range(n_base):
        base = acgt[rng.integers(0, 4, int(rng.integers(400, 801)))]
        for c in range(copies):
            s = base.copy()
            mut = rng.random(len(s)) < rng.uniform(0.02, 0.08)
            s[mut] = acgt[rng.integers(0, 4, int(mut.sum()))]
            if c % 3 == 1:
                at = int(rng.integers(50, len(s) - 50))
                s = np.delete(s, slice(at, at + int(rng.integers(1, 8))))
            elif c % 3 == 2:
                at = int(rng.integers(50, len(s) - 50))
                s = np.insert(s, at, acgt[rng.integers(0, 4, 5)])
            rec = s.tobytes()
            recs.append(rec[::-1].translate(COMP) if c % 4 == 3 else rec)
    return [recs[i] for i in rng.permutation(len(recs))]


def write_fasta(path, recs, prefix):
    with open(path, "w") as fh:
        for i, rec in enumerate(recs):
            fh.write(f">{prefix}{i} record {i}\n{rec.decode()}\n")


def subset(d, src, name, keys):
    """`createsubdb` of src's records (and headers) with these keys."""
    with open(os.path.join(d, name + ".keys"), "w") as fh:
        fh.writelines(f"{k}\n" for k in keys)
    for suffix in ("", "_h"):
        assert ref_run(["createsubdb", os.path.join(d, name + ".keys"),
                        os.path.join(d, src + suffix),
                        os.path.join(d, name + suffix)]) == 0


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The DBs (JAX package's createdb and createsubdb): `seq`, 40 seeded
    protein families; `sub`, every third record of it (a key-preserving
    subset); `rest`, the other records (the queries left out of the
    targets); `nseq` / `nsub` / `nrest` the same of seeded nucleotide
    families; `qfa` / `tfa`, the subset's and the rest's FASTA files, for
    DBs created separately (both keyed from 0)."""
    d = str(tmp_path_factory.mktemp("linsearch"))
    for name, recs, prefix in (("seq", family_records(40), "f"),
                               ("nseq", nucl_records(), "n")):
        fasta = os.path.join(d, name + ".fasta")
        write_fasta(fasta, recs, prefix)
        assert ref_run(["createdb", fasta, os.path.join(d, name)]) == 0
        keys = sorted(int(k) for k in ref_seqdb.SeqDB.open(
            os.path.join(d, name)).keys)
        pre = name[:-3]
        subset(d, name, pre + "sub", keys[::3])
        subset(d, name, pre + "rest", [k for k in keys if k % 3])
    recs = family_records(40)
    write_fasta(os.path.join(d, "qfa"), recs[::3], "q")
    write_fasta(os.path.join(d, "tfa"), [r for i, r in enumerate(recs)
                                         if i % 3], "t")
    return d


def tree(root):
    """{path relative to root: bytes, or a .npz's {array name: list}} of
    every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".npz"):
                with np.load(path) as z:
                    out[rel] = {k: z[k].tolist() for k in z.files}
            else:
                out[rel] = open(path, "rb").read()
    return out


def run_both(tmp_path, inputs, dbs, steps, ref=ref_run):
    """Each argv of steps(d) through the JAX package's CLI (`ref`) and the
    port's, each in its own dir d holding copies of the input DBs `dbs`
    (with their headers); returns the trees of both dirs."""
    got = []
    for tag, run in (("ref", ref), ("port", port_run)):
        d = str(tmp_path / tag)
        os.makedirs(d)
        for db in dbs:
            for suffix in ("", "_h"):
                for ext in ("", ".index", ".dbtype"):
                    src = os.path.join(inputs, db + suffix + ext)
                    if os.path.exists(src):
                        shutil.copyfile(src, os.path.join(
                            d, db + suffix + ext))
        for argv in steps(d):
            assert run(argv) == 0, (tag, argv[0])
        got.append(tree(d))
    return got


def oracle_rescorediagonal(positional, space):
    """The JAX package's rescorediagonal with the hits' target keys looked
    up in <i:tDB> when it is another DB: its own rescore_diagonal(...,
    tdb=tdb), then results_to_db."""
    same = os.path.realpath(positional[0]) == os.path.realpath(positional[1])
    tdb = None if same else ref_seqdb.SeqDB.open(positional[1])
    real = ref_rescore.rescore_diagonal
    ref_rescore.rescore_diagonal = \
        lambda db, hits, rp: real(db, hits, rp, tdb=tdb)
    try:
        return ref_tools._rescorediagonal(positional, space)
    finally:
        ref_rescore.rescore_diagonal = real


@pytest.fixture
def oracle():
    """ref_run with the JAX CLI's rescorediagonal replaced by the oracle
    (its BASE_COMMANDS entry, which the in-process steps look up)."""
    i = next(n for n, c in enumerate(ref_tools.BASE_COMMANDS)
             if c.name == "rescorediagonal")
    cmd = ref_tools.BASE_COMMANDS[i]
    ref_tools.BASE_COMMANDS[i] = type(cmd)(
        cmd.name, oracle_rescorediagonal, cmd.params_fn, cmd.usage,
        cmd.description, cmd.hidden)
    try:
        yield ref_run
    finally:
        ref_tools.BASE_COMMANDS[i] = cmd


# ---------------------------------------------------------------------------
# the index and kmersearch

@pytest.mark.parametrize("kind", ["protein", "nucleotide"])
def test_index_arrays_equal(inputs, tmp_path, kind):
    name = "seq" if kind == "protein" else "nseq"
    got = []
    for tag, mod, ls in (("ref", ref_seqdb, ref_ls),
                         ("port", port_seqdb, port_ls)):
        path = str(tmp_path / tag)
        for ext in ("", ".index", ".dbtype"):
            shutil.copyfile(os.path.join(inputs, name + ext), path + ext)
        ls.build_linindex(mod.SeqDB.open(path), path,
                          seed_sub_mat="blosum62.out", kmers_per_sequence=21)
        with np.load(path + ".linidx.npz") as z:
            got.append((ls.load_linindex(path), {k: z[k] for k in z.files}))
    (ref_idx, ref_npz), (port_idx, port_npz) = got
    assert set(ref_npz) == set(port_npz)
    for k in ref_npz:
        np.testing.assert_array_equal(port_npz[k], ref_npz[k], err_msg=k)
    assert len(ref_npz["kmer"]) > 100
    assert {k: v for k, v in port_idx.items() if not hasattr(v, "shape")} \
        == {k: v for k, v in ref_idx.items() if not hasattr(v, "shape")}


@pytest.mark.parametrize("kind", ["protein", "nucleotide"])
@pytest.mark.parametrize("direction", ["0", "1"])
def test_kmersearch_writes_what_the_jax_package_writes(inputs, tmp_path,
                                                       kind, direction):
    """kmersearch of the subset against the whole DB's index, in both
    result directions."""
    t, q = ("seq", "sub") if kind == "protein" else ("nseq", "nsub")
    search_type = [] if kind == "protein" else ["--search-type", "3"]

    def steps(d):
        return [["createlinindex", f"{d}/{t}", f"{d}/itmp", *search_type],
                ["kmersearch", f"{d}/{q}", f"{d}/{t}.linidx", f"{d}/pref",
                 "--seed-sub-mat", "blosum62.out", "--kmer-per-seq", "21",
                 "--result-direction", direction]]
    ref, port = run_both(tmp_path, inputs, [t, q], steps)
    assert port == ref
    assert ref["pref"].count(b"\n") > 20


@pytest.mark.parametrize("kind", ["protein", "nucleotide"])
def test_kmersearch_reemits_a_last_kmer_match_as_the_jax_package_does(
        inputs, tmp_path, kind):
    """The merge's quirk (kmersearch.cpp:363-418): when the query table's
    largest key matches the index, that match is emitted again until the
    write cursor reaches it. A query table always ends in the
    whole-sequence placeholder (SIZE_T_MAX), which the index drops, so
    the index here gets one entry of that key."""
    t, q = ("seq", "sub") if kind == "protein" else ("nseq", "nsub")
    got = []
    for mod, ls in ((ref_seqdb, ref_ls), (port_seqdb, port_ls)):
        path = str(tmp_path / mod.__name__)
        for ext in ("", ".index", ".dbtype"):
            shutil.copyfile(os.path.join(inputs, t + ext), path + ext)
        ls.build_linindex(mod.SeqDB.open(path), path,
                          seed_sub_mat="blosum62.out", kmers_per_sequence=21)
        index = ls.load_linindex(path)
        qdb = mod.SeqDB.open(os.path.join(inputs, q))
        plain = ls.kmersearch(qdb, index, seed_sub_mat="blosum62.out")
        for name, fill in (("kmer", np.uint64(0xFFFFFFFFFFFFFFFF)),
                           ("id", index["id"][0]), ("pos", 0),
                           ("seq_len", index["seq_len"][0])):
            index[name] = np.append(index[name], np.asarray(
                fill, dtype=index[name].dtype))
        quirk = ls.kmersearch(qdb, index, seed_sub_mat="blosum62.out")
        got.append([(db.data.tobytes(), db.keys.tolist(),
                     db.lengths.tolist()) for db in (plain, quirk)])
    assert got[1] == got[0]
    plain, quirk = got[0]
    # the placeholder's target gains a record of the re-emitted matches
    assert quirk != plain


def test_kmerindexdb_writes_what_the_jax_package_writes(inputs, tmp_path):
    """kmerindexdb at its global defaults (VTML80 seeds), the index beside
    a second name, with the sequence and source DBs it materialises."""
    ref, port = run_both(tmp_path, inputs, ["seq"], lambda d: [
        ["kmerindexdb", f"{d}/seq", f"{d}/idx"]])
    assert port == ref
    assert {"idx.linidx.npz", "idx.linidx_seq", "idx.linidx_seq_h"} <= set(
        ref)


@pytest.mark.parametrize("db,flags", [
    ("seq", []), ("nseq", ["--search-type", "3"])],
    ids=["protein", "nucleotide"])
def test_createlinindex_writes_what_the_jax_package_writes(inputs, tmp_path,
                                                           db, flags):
    ref, port = run_both(tmp_path, inputs, [db], lambda d: [
        ["createlinindex", f"{d}/{db}", f"{d}/tmp", *flags]])
    assert port == ref
    assert f"{db}.linidx.npz" in ref


@pytest.mark.parametrize("command", ["createlinindex", "createindex"])
def test_translated_index_fails_as_in_the_jax_package(inputs, tmp_path,
                                                      caplog, command):
    """--search-type 2 on a nucleotide DB: both packages pass extractorfs
    --min-length, a flag their extractorfs does not have (it takes
    --orf-min-length), and exit 1 with that error (ROADMAP C5)."""
    for tag, run in (("ref", ref_run), ("port", port_run)):
        d = str(tmp_path / tag)
        os.makedirs(d)
        for ext in ("", ".index", ".dbtype"):
            shutil.copyfile(os.path.join(inputs, "nseq" + ext),
                            os.path.join(d, "nseq" + ext))
        caplog.clear()
        assert run([command, f"{d}/nseq", f"{d}/tmp", "--search-type",
                    "2"]) == 1, tag
        assert "unknown flag --min-length" in caplog.text, tag


# ---------------------------------------------------------------------------
# linsearch

def _linsearch_steps(q, t, flags=()):
    nucl = t.startswith("n")
    return lambda d: [
        ["createlinindex", f"{d}/{t}", f"{d}/itmp",
         *(["--search-type", "3"] if nucl else [])],
        ["linsearch", f"{d}/{q}", f"{d}/{t}", f"{d}/out", f"{d}/tmp",
         *flags]]


# rescorediagonal's ungapped alignments of the queries, whose E-values
# the port computes on the size of the query DB, the JAX package on the
# target DB's: only their keys (filterdb's filter file) reach the output
# of a protein linsearch
REV_UNGAP = "tmp/reverse_ungapaln"


@pytest.mark.parametrize("flags", [(), ("--min-seq-id", "0.5", "-c", "0.5")],
                         ids=["defaults", "min-seq-id-cov"])
def test_linsearch_of_a_subset_writes_what_the_jax_package_writes(
        inputs, tmp_path, flags):
    """Protein queries that are a key-preserving subset of the targets:
    the JAX CLI's bytes but for the ungapped filter's E-values."""
    ref, port = run_both(tmp_path, inputs, ["seq", "sub"],
                         _linsearch_steps("sub", "seq", flags))
    assert set(port) == set(ref)
    assert {k: v for k, v in port.items() if k != REV_UNGAP} == \
        {k: v for k, v in ref.items() if k != REV_UNGAP}
    assert ref["tmp/pref"].count(b"\n") > 50


def test_nucleotide_linsearch_of_a_subset_equals_the_oracle(
        inputs, tmp_path, oracle):
    """Nucleotide queries that are a subset of the targets; the ungapped
    alignments are merged into the output, so their E-values show: held
    against the oracle, and against the JAX CLI but for those."""
    ref, port = run_both(tmp_path / "oracle", inputs, ["nseq", "nsub"],
                         _linsearch_steps("nsub", "nseq"), ref=oracle)
    assert port == ref
    assert ref["out"].count(b"\n") > 10
    jax, _ = run_both(tmp_path / "jax", inputs, ["nseq", "nsub"],
                      _linsearch_steps("nsub", "nseq"))
    for name in ("tmp/pref", "tmp/pref_filter", "tmp/reverse_aln", "out"):
        assert len(jax[name].splitlines()) == len(port[name].splitlines())
    assert jax["tmp/reverse_aln"] == port["tmp/reverse_aln"]


def test_linsearch_of_left_out_queries_equals_the_oracle(inputs, tmp_path,
                                                         oracle):
    ref, port = run_both(tmp_path, inputs, ["rest", "sub"],
                         _linsearch_steps("sub", "rest"), ref=oracle)
    assert port == ref
    assert ref["tmp/reverse_aln"].count(b"\n") > 10
    assert ref["out"].count(b"\n") > 10


def test_nucleotide_linsearch_of_left_out_queries_fails_in_both(inputs,
                                                                tmp_path):
    """Nucleotide queries left out of the targets: the JAX package fails in
    rescorediagonal (C4); the port gets past it to the nucleotide `align`
    (ops/nucl_align.align_nucl), which in both packages aligns a DB
    against itself only and looks the queries' keys up in the index's DB,
    where they are not (ROADMAP C4)."""
    for tag, run, error in (("ref", ref_run, IndexError),
                            ("port", port_run, TypeError)):
        d = str(tmp_path / tag)
        os.makedirs(d)
        for db in ("nrest", "nsub"):
            for ext in ("", ".index", ".dbtype"):
                shutil.copyfile(os.path.join(inputs, db + ext),
                                os.path.join(d, db + ext))
        assert run(["createlinindex", f"{d}/nrest", f"{d}/itmp",
                    "--search-type", "3"]) == 0
        with pytest.raises(error):
            run(["linsearch", f"{d}/nsub", f"{d}/nrest", f"{d}/out",
                 f"{d}/tmp"])
    assert os.path.getsize(tmp_path / "port" / "tmp" / "pref_filter") > 100


@pytest.mark.parametrize("mode", ["0", "2", "3"])
@pytest.mark.parametrize("q,t", [("sub", "rest"), ("qdb", "tdb")],
                         ids=["left-out", "separate"])
def test_rescorediagonal_of_distinct_dbs_equals_the_oracle(
        inputs, tmp_path, oracle, mode, q, t):
    """rescorediagonal of a prefilter's hits of queries against other
    targets: left out of the same DB (keys kept) or created separately
    (both keyed from 0), at each rescore mode."""
    def steps(d):
        make = [["createdb", f"{inputs}/qfa", f"{d}/qdb"],
                ["createdb", f"{inputs}/tfa", f"{d}/tdb"]] \
            if q == "qdb" else []
        return make + [["prefilter", f"{d}/{q}", f"{d}/{t}", f"{d}/pref"],
                       ["rescorediagonal", f"{d}/{q}", f"{d}/{t}",
                        f"{d}/pref", f"{d}/out", "--rescore-mode", mode]]
    ref, port = run_both(tmp_path, inputs, [] if q == "qdb" else [q, t],
                         steps, ref=oracle)
    assert port == ref
    assert ref["out"].count(b"\n") > 20


def test_jax_linsearch_fails_on_left_out_queries(inputs, tmp_path):
    """C4 in the JAX package: its rescorediagonal looks the queries' keys
    up in the index's DB, where they are not."""
    d = str(tmp_path)
    for db in ("rest", "sub"):
        for ext in ("", ".index", ".dbtype"):
            shutil.copyfile(os.path.join(inputs, db + ext),
                            os.path.join(d, db + ext))
    assert ref_run(["createlinindex", f"{d}/rest", f"{d}/itmp"]) == 0
    with pytest.raises(IndexError):
        ref_run(["linsearch", f"{d}/sub", f"{d}/rest", f"{d}/out",
                 f"{d}/tmp"])
    assert port_run(["linsearch", f"{d}/sub", f"{d}/rest", f"{d}/out",
                     f"{d}/ptmp"]) == 0


def test_easy_linsearch_of_separate_dbs_equals_the_oracle(inputs, tmp_path,
                                                          oracle):
    """easy-linsearch: query and target DBs created separately, both keyed
    from 0, so each key names another sequence in each."""
    ref, port = run_both(tmp_path, inputs, [], lambda d: [
        ["easy-linsearch", f"{inputs}/qfa", f"{inputs}/tfa", f"{d}/out.m8",
         f"{d}/tmp"]], ref=oracle)
    assert port == ref
    assert ref["out.m8"].count(b"\n") > 10


def test_linsearch_reports_its_stages_and_pairs(inputs, tmp_path):
    d = str(tmp_path)
    for db in ("rest", "sub"):
        for ext in ("", ".index", ".dbtype"):
            shutil.copyfile(os.path.join(inputs, db + ext),
                            os.path.join(d, db + ext))
    assert port_run(["createlinindex", f"{d}/rest", f"{d}/itmp"]) == 0
    stats = {}
    assert port_plass.run(["linsearch", f"{d}/sub", f"{d}/rest", f"{d}/out",
                           f"{d}/tmp", "--device", "cpu"], stats=stats) == 0
    assert list(stats["seconds"]) == ["kmersearch", "rescorediagonal",
                                      "filterdb", "align", "swapresults"]
    assert stats["pairs"]["candidate_pairs"] > 0


# ---------------------------------------------------------------------------
# the prefilter index, clusterupdate and enrich

def test_indexdb_and_createindex_write_what_the_jax_package_writes(
        inputs, tmp_path):
    """indexdb and createindex of the DB, then a search of the subset that
    reads createindex's index."""
    ref, port = run_both(tmp_path, inputs, ["seq", "sub"], lambda d: [
        ["indexdb", f"{d}/seq", f"{d}/copy", "-s", "6"],
        ["createindex", f"{d}/seq", f"{d}/itmp"],
        ["search", f"{d}/sub", f"{d}/seq", f"{d}/aln", f"{d}/stmp"]])
    assert port == ref
    assert {"copy.idx.npz", "seq.idx.npz"} <= set(ref)
    assert ref["aln"].count(b"\n") > 20


@pytest.fixture(scope="module")
def update_inputs(tmp_path_factory):
    """clusterupdate's inputs (JAX package's CLI): an old DB of 10
    families' records, its clustering, and a new DB that drops every
    fifth old record, keeps the others under new keys and adds 4
    families."""
    d = str(tmp_path_factory.mktemp("update"))
    recs = family_records(14, seed=23)
    old = recs[:-15]
    new = [r for i, r in enumerate(old) if i % 5] + recs[-15:]
    names = {r: f"p{i}" for i, r in enumerate(recs)}
    for name, rs in (("old", old), ("new", new[::-1])):
        with open(os.path.join(d, name + ".fasta"), "w") as fh:
            fh.writelines(f">{names[r]} protein\n{r.decode()}\n" for r in rs)
        assert ref_run(["createdb", os.path.join(d, name + ".fasta"),
                        os.path.join(d, name)]) == 0
    assert ref_run(["cluster", os.path.join(d, "old"),
                    os.path.join(d, "oldclu"), os.path.join(d, "ctmp")]) == 0
    return d


@pytest.mark.parametrize("flags", [(), ("--recover-deleted",)],
                         ids=["defaults", "recover-deleted"])
def test_clusterupdate_writes_what_the_jax_package_writes(update_inputs,
                                                          tmp_path, flags):
    ref, port = run_both(tmp_path, update_inputs, ["old", "new", "oldclu"],
                         lambda d: [["clusterupdate", f"{d}/old", f"{d}/new",
                                     f"{d}/oldclu", f"{d}/newmap",
                                     f"{d}/newclu", f"{d}/tmp", *flags]])
    assert port == ref
    assert ref["newclu"].count(b"\n") >= 40


@pytest.fixture(scope="module")
def enrich_inputs(tmp_path_factory):
    """enrich's inputs (JAX package's CLI): `seq`, 8 seeded families;
    `sub`, every third record; `self`, seq's self search with backtraces
    (the profiles' own results); `prof`, result2profile of it."""
    d = str(tmp_path_factory.mktemp("enrich"))
    write_fasta(os.path.join(d, "seq.fasta"), family_records(8, seed=29),
                "e")
    assert ref_run(["createdb", os.path.join(d, "seq.fasta"),
                    os.path.join(d, "seq")]) == 0
    subset(d, "seq", "sub", sorted(int(k) for k in ref_seqdb.SeqDB.open(
        os.path.join(d, "seq")).keys)[::3])
    for argv in (["search", "seq", "seq", "self", "stmp", "-a"],
                 ["result2profile", "seq", "seq", "self", "prof"]):
        assert ref_run([argv[0], *[a if a.startswith("-") else
                                   os.path.join(d, a)
                                   for a in argv[1:]]]) == 0, argv[0]
    return d


def test_enrich_writes_what_the_jax_package_writes(enrich_inputs, tmp_path):
    """enrich of the subset through the profiles, 2 iterations."""
    d = enrich_inputs
    ref, port = run_both(tmp_path, d, [], lambda out: [
        ["enrich", f"{d}/sub", f"{d}/seq", f"{d}/prof", f"{d}/self",
         f"{out}/out", f"{out}/tmp", "--num-iterations", "2"]])
    assert port == ref
    assert ref["out"].count(b"\n") > 10
