"""PyTorch port: the taxonomy slice (data/taxonomy.py, cli/tools.py's
twelve taxonomy commands, cli/tools_misc.py's easy-taxonomy) and
`proteinaln2nucl`, held against the JAX package through both packages'
CLIs on the same inputs, byte for byte; data/taxonomy.py's tree helpers,
serializer and majority vote against the JAX module's. The port runs with
--device cpu. `taxonomy --lca-mode 4` and `--lca-mode 1` align through
`search`, whose candidate pairs kernel B9 scores first on a card; here
its plain version is made to score them (a card does so from 512 pairs)
and the outputs still equal the JAX package's, rejections against
--max-rejected 5 included.

The inputs are seeded protein families (test_torch_prefilter's
family_records) labelled by a synthetic NCBI dump written the way
util/gen_goldens_tax.sh writes it: GENERA genera of SPECIES species under
Bacteria, a family's members spread over its genus's species. Some
records carry the taxa the edge cases need: an unclassified-sequences
taxon (the default blacklist) and a merged id; a deleted id in the
mapping makes majoritylca fail on both."""
import gzip
import os
import shutil

import numpy as np
import pytest

from plass_tpu.cli import tools as ref_tools
from plass_tpu.data import taxonomy as ref_tax
from plass_tpu_torch.cli import tools as port_tools
from plass_tpu_torch.data import taxonomy as port_tax

from test_torch_prefilter import family_records
from test_torch_tools import port_run, ref_run

N_FAMILIES = 25
GENERA = 6
SPECIES = 3
QUERY_EVERY = 4
# taxa of the edge cases: a child of "unclassified sequences", a merged id
# (into species 1000) and a deleted one
UNCLASSIFIED, MERGED, DELETED = 12909, 99, 98


def species(fam, member):
    return 1000 + 10 * (fam % GENERA) + member % SPECIES


def write_dump(d):
    """nodes.dmp, names.dmp, merged.dmp and delnodes.dmp of the synthetic
    taxonomy, in the NCBI files' column layout."""
    os.makedirs(d)
    nodes = [(1, 1, "no rank", "root"),
             (131567, 1, "no rank", "cellular organisms"),
             (2, 131567, "superkingdom", "Bacteria"),
             (12908, 1, "no rank", "unclassified sequences"),
             (UNCLASSIFIED, 12908, "no rank", "unclassified Bacteria"),
             (28384, 1, "no rank", "other sequences")]
    for g in range(GENERA):
        nodes.append((100 + g, 2, "genus", f"Genus{g}"))
        nodes += [(1000 + 10 * g + s, 100 + g, "species", f"Species{g}_{s}")
                  for s in range(SPECIES)]
    with open(os.path.join(d, "nodes.dmp"), "w") as f:
        f.writelines(f"{t}\t|\t{p}\t|\t{r}\t|\t\t|\t0\t|\n"
                     for t, p, r, _ in nodes)
    with open(os.path.join(d, "names.dmp"), "w") as f:
        for t, _, _, name in nodes:
            f.write(f"{t}\t|\t{name}\t|\t\t|\tscientific name\t|\n")
            f.write(f"{t}\t|\t{name.lower()}\t|\t\t|\tsynonym\t|\n")
    with open(os.path.join(d, "merged.dmp"), "w") as f:
        f.write(f"{MERGED}\t|\t1000\t|\n")
    with open(os.path.join(d, "delnodes.dmp"), "w") as f:
        f.write(f"{DELETED}\t|\n")


def taxon_of(i, fam):
    """Record i's taxon: its family's species, or an edge case."""
    return {5: UNCLASSIFIED, 11: MERGED}.get(i % 23, species(fam, i))


@pytest.fixture(scope="module")
def tax(tmp_path_factory):
    """(JAX package's CLI) the dump; q.fasta, every QUERY_EVERY-th family
    record, and t.fasta, the rest, made into DBs q and t; t's taxonomy
    (createtaxdb, binary dump) and t0, the same DB with the dmp files
    (--tax-db-mode 0); aln, a search of q against t; lca, its LCA; sets, a
    set DB of q's keys in three sets; nr, a DB of NR-style headers with
    t's taxonomy and an accession2taxid file."""
    d = str(tmp_path_factory.mktemp("tax"))
    write_dump(os.path.join(d, "dump"))
    fams = []
    recs = family_records(N_FAMILIES, families=fams)
    with open(os.path.join(d, "q.fasta"), "w") as q, \
            open(os.path.join(d, "t.fasta"), "w") as t, \
            open(os.path.join(d, "acc.tsv"), "w") as acc:
        for i, (rec, fam) in enumerate(zip(recs, fams)):
            (q if i % QUERY_EVERY == 0 else t).write(
                f">fam{i} protein {i}\n{rec.decode()}\n")
            acc.write(f"fam{i}\t{taxon_of(i, fam)}\n")

    def p(name):
        return os.path.join(d, name)
    for argv in (["createdb", p("q.fasta"), p("q")],
                 ["createdb", p("t.fasta"), p("t")],
                 ["createdb", p("t.fasta"), p("t0")],
                 ["createtaxdb", p("t"), p("ctmp"), "--ncbi-tax-dump",
                  p("dump"), "--tax-mapping-file", p("acc.tsv")],
                 ["createtaxdb", p("t0"), p("ctmp0"), "--ncbi-tax-dump",
                  p("dump"), "--tax-mapping-file", p("acc.tsv"),
                  "--tax-db-mode", "0"],
                 ["search", p("q"), p("t"), p("aln"), p("stmp"), "-a"],
                 ["lca", p("t"), p("aln"), p("lca")]):
        assert ref_run(argv) == 0, argv[0]
    from plass_tpu.data import seqdb
    keys = sorted(int(k) for k in seqdb.SeqDB.open(p("q")).keys)
    w = seqdb.DBWriter(seqdb.GENERIC_DB)
    for s in range(3):
        w.write(10 * (s + 1), "".join(f"{k}\n" for k in keys[s::3]).encode(),
                add_newline=False)
    w.finish().save(p("sets"))
    # nrtotaxmapping: accessions found in the file, names in brackets,
    # several entries a header (\x01), a header row parsing to taxid 0
    rows = [("WP_001.1 protein [Species0_1]", 0), ("XP_002.2 [Genus1]", 1),
            ("NOACC x [Species2_0]\x01WP_001.1 again [Species0_0]", 2),
            ("ZZZ_9.9 nothing [NotATaxon]", 3),
            ("YP_003.1 multi [Genus3] protein [Species3_2]", 4),
            ("YP_004.1 bad [bad [Species4_1]", 5)]
    with open(p("nr.fasta"), "w") as f:
        f.writelines(f">{h}\n{recs[i].decode()}\n" for h, i in rows)
    with gzip.open(p("acc2taxid.gz"), "wt") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n"
                "WP_001\tWP_001.1\t1001\t1\nYP_003\tYP_003.1\t1032\t2\n"
                "XP_002\tXP_002.2\t101\t3\n")
    assert ref_run(["createdb", p("nr.fasta"), p("nr")]) == 0
    shutil.copyfile(p("t_taxonomy"), p("nr_taxonomy"))
    return d


def outputs(d):
    """{name: bytes} of the files directly in d (symlinks followed)."""
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, name))}


def both(tmp_path, argv):
    """argv (OUT and TMP inside each run's dir) through both CLIs; returns
    the files each run left in its dir."""
    got = []
    for tag, run in (("ref", ref_run), ("port", port_run)):
        d = str(tmp_path / tag)
        os.makedirs(d)
        assert run([a.replace("OUT", os.path.join(d, "out"))
                    .replace("TMP", os.path.join(d, "tmp"))
                    for a in argv]) == 0, tag
        got.append(outputs(d))
    return got


# (command line; {d} is the fixture's dir, OUT the output in the run's dir)
CASES = {
    "createbintaxonomy": ["createbintaxonomy", "{d}/dump/names.dmp",
                          "{d}/dump/nodes.dmp", "{d}/dump/merged.dmp", "OUT"],
    "nrtotaxmapping": ["nrtotaxmapping", "{d}/acc2taxid.gz", "{d}/nr", "OUT"],
    "lca": ["lca", "{d}/t", "{d}/aln", "OUT"],
    "lca-dmp-files": ["lca", "{d}/t0", "{d}/aln", "OUT"],
    "lca-ranks-lineage-1": ["lca", "{d}/t", "{d}/aln", "OUT", "--lca-ranks",
                            "superkingdom,genus,species", "--tax-lineage",
                            "1"],
    "lca-ranks-lineage-2": ["lca", "{d}/t", "{d}/aln", "OUT", "--lca-ranks",
                            "genus", "--tax-lineage", "2"],
    "lca-no-blacklist": ["lca", "{d}/t", "{d}/aln", "OUT", "--blacklist",
                         ""],
    **{f"majoritylca-vote-mode-{m}": [
        "majoritylca", "{d}/t", "{d}/aln", "OUT", "--vote-mode", str(m),
        "--majority", "0.6"] for m in range(3)},
    "addtaxonomy": ["addtaxonomy", "{d}/t", "{d}/aln", "OUT"],
    "addtaxonomy-query": ["addtaxonomy", "{d}/t", "{d}/aln", "OUT",
                          "--pick-id-from", "1", "--tax-lineage", "1",
                          "--lca-ranks", "genus"],
    "taxonomyreport": ["taxonomyreport", "{d}/t", "{d}/lca", "OUT"],
    "filtertaxdb": ["filtertaxdb", "{d}/t", "{d}/lca", "OUT", "--taxon-list",
                    "2,!1001"],
    **{f"aggregatetax-vote-mode-{m}": [
        "aggregatetax", "{d}/t", "{d}/sets", "{d}/lca", "OUT", "--vote-mode",
        str(m)] for m in range(3)},
    **{f"aggregatetaxweights-vote-mode-{m}": [
        "aggregatetaxweights", "{d}/t", "{d}/sets", "{d}/lca", "{d}/aln",
        "OUT", "--vote-mode", str(m), "--majority", "0.4"]
       for m in range(3)},
    "aggregatetaxweights-ranks-lineage": [
        "aggregatetaxweights", "{d}/t", "{d}/sets", "{d}/lca", "{d}/aln",
        "OUT", "--lca-ranks", "genus,species", "--tax-lineage", "1"],
    "filtertaxseqdb": ["filtertaxseqdb", "{d}/t", "OUT", "--taxon-list",
                       "100,101"],
    "filtertaxseqdb-soft": ["filtertaxseqdb", "{d}/t", "OUT", "--taxon-list",
                            "!102", "--subdb-mode", "1"],
    **{f"taxonomy-lca-mode-{m}": ["taxonomy", "{d}/q", "{d}/t", "OUT", "TMP",
                                  "--lca-mode", m] for m in ("1", "3", "4")},
    **{f"taxonomy-tax-output-mode-{m}": [
        "taxonomy", "{d}/q", "{d}/t", "OUT", "TMP", "--tax-output-mode", m]
       for m in ("1", "2")},
    "taxonomy-lca-mode-4-both": ["taxonomy", "{d}/q", "{d}/t", "OUT", "TMP",
                                 "--lca-mode", "4", "--tax-output-mode", "2",
                                 "--lca-ranks", "genus"],
    "easy-taxonomy": ["easy-taxonomy", "{d}/q.fasta", "{d}/t", "OUT", "TMP"],
    "easy-taxonomy-lca-mode-4": ["easy-taxonomy", "{d}/q.fasta", "{d}/t",
                                 "OUT", "TMP", "--lca-mode", "4",
                                 "--tax-lineage", "1"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_taxonomy_command_writes_what_the_jax_package_writes(tax, tmp_path,
                                                             case):
    ref, port = both(tmp_path, [a.format(d=tax) for a in CASES[case]])
    assert port == ref
    assert any(name.startswith("out") and data.count(b"\n") >= 2
               for name, data in ref.items())


@pytest.mark.parametrize("mode,extra", [("1", ()), ("4", ()),
                                        ("4", ("-s", "7.5"))])
def test_taxonomy_with_b9_scoring_every_pair(tax, tmp_path, monkeypatch,
                                             mode, extra):
    """`taxonomy --lca-mode 1|4` with B9's plain version scoring every
    candidate pair first, as a card does from 512 of them: the JAX
    package's bytes; at -s 7.5 B9 rejects pairs, which count against
    --max-rejected 5 as the host's rejections do."""
    from plass_tpu_torch.cli import plass as port_plass
    from plass_tpu_torch.ops import protein_align
    real = protein_align._maybe_device_prefilter
    monkeypatch.setattr(protein_align, "_maybe_device_prefilter",
                        lambda *a: real(*a[:9], True, a[10]))
    ref_d, port_d = str(tmp_path / "ref"), str(tmp_path / "port")
    stats = {}
    args = ["--lca-mode", mode, *extra]
    assert ref_run(["taxonomy", f"{tax}/q", f"{tax}/t", f"{ref_d}/out",
                    f"{ref_d}/tmp", *args]) == 0
    assert port_plass.run(["taxonomy", f"{tax}/q", f"{tax}/t",
                           f"{port_d}/out", f"{port_d}/tmp", *args,
                           "--device", "cpu"], stats=stats) == 0
    assert outputs(port_d) == outputs(ref_d)
    pairs = stats["pairs"]
    assert pairs["device_pairs"] == pairs["candidate_pairs"] > 50
    assert (pairs["device_rejected"] > 10) == bool(extra)
    assert {"prefilter", "align"} <= set(stats["seconds"])


def test_taxonomy_runs_reach_every_rank(tax, tmp_path):
    """The cases above are not vacuous: the LCA of the default taxonomy
    run names species, genera and the unclassified."""
    ref, port = both(tmp_path, ["taxonomy", f"{tax}/q", f"{tax}/t", "OUT",
                                "TMP"])
    assert port == ref
    ranks = [line.split(b"\t")[1] for line in ref["out"].split(b"\n")
             if b"\t" in line]
    assert {b"species", b"genus"} <= set(ranks)
    assert ranks.count(b"species") >= 5


def _taxdb_copy(src, dst):
    for ext in ("", ".index", ".dbtype", ".lookup"):
        shutil.copyfile(src + ext, dst + ext)


@pytest.mark.parametrize("mode", ["0", "1"])
def test_createtaxdb_and_each_package_reads_the_others(tax, tmp_path, mode):
    """createtaxdb at --tax-db-mode 0 (dmp copies) and 1 (binary dump)
    through both CLIs, byte for byte; then each package's lca on the DB
    the other package's createtaxdb made equals its own."""
    made = {}
    for tag, run in (("ref", ref_run), ("port", port_run)):
        d = str(tmp_path / tag)
        os.makedirs(d)
        _taxdb_copy(f"{tax}/t", f"{d}/t")
        assert run(["createtaxdb", f"{d}/t", f"{d}/tmp", "--ncbi-tax-dump",
                    f"{tax}/dump", "--tax-mapping-file", f"{tax}/acc.tsv",
                    "--tax-db-mode", mode]) == 0
        made[tag] = outputs(d)
    assert made["port"] == made["ref"]
    names = {"0": ["t_mapping", "t_names.dmp", "t_nodes.dmp", "t_merged.dmp",
                   "t_delnodes.dmp"], "1": ["t_mapping", "t_taxonomy"]}[mode]
    assert set(names) <= set(made["ref"])
    lcas = {}
    for reader, run in (("ref", ref_run), ("port", port_run)):
        for maker in ("ref", "port"):
            out = str(tmp_path / f"lca_{reader}_{maker}")
            assert run(["lca", str(tmp_path / maker / "t"), f"{tax}/aln",
                        out, "--tax-lineage", "1"]) == 0
            lcas[reader, maker] = outputs(str(tmp_path))[
                f"lca_{reader}_{maker}"]
    assert len(set(lcas.values())) == 1


def test_majoritylca_fails_on_a_deleted_taxon_as_the_jax_package(
        tax, tmp_path, caplog):
    """A _mapping of deleted taxa: both CLIs exit 1 with the reference's
    message."""
    db = str(tmp_path / "t")
    _taxdb_copy(f"{tax}/t", db)
    shutil.copyfile(f"{tax}/t_taxonomy", db + "_taxonomy")
    with open(db + "_mapping", "w") as f:
        f.writelines(line.split("\t")[0] + f"\t{DELETED}\n"
                     for line in open(f"{tax}/t_mapping"))
    for run in (ref_run, port_run):
        caplog.clear()
        assert run(["majoritylca", db, f"{tax}/aln",
                    str(tmp_path / "out")]) == 1
        assert f"taxonid: {DELETED} does not match" in caplog.text


def test_createtaxdb_is_offline(tax, tmp_path):
    """Without --ncbi-tax-dump and --tax-mapping-file both packages refuse
    (no download) and exit 1 through their CLIs."""
    args = [f"{tax}/t", str(tmp_path / "tmp")]
    for tools, extra in ((ref_tools, ()), (port_tools, ({},))):
        cmd = next(c for c in tools.BASE_COMMANDS if c.name == "createtaxdb")
        with pytest.raises(ValueError, match="downloads are unavailable"):
            cmd.fn(args, cmd.params_fn(), *extra)
    assert ref_run(["createtaxdb", *args]) == 1
    assert port_run(["createtaxdb", *args]) == 1


# ---------------------------------------------------------------------------
# proteinaln2nucl

# the standard genetic code, codons in TCAG order
CODE = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
CODONS = [a + b + c for a in "TCAG" for b in "TCAG" for c in "TCAG"]


@pytest.fixture(scope="module")
def nucl(tmp_path_factory):
    """(JAX package's CLI) genes that encode seeded family proteins (a
    seeded codon for each residue, a stop codon at the end), made into a
    nucleotide DB `n`; `translatenucs` of it, the amino-acid DB `a` with
    the same keys; `aln`, a search of `a` against itself with backtraces
    (the families' indels give gapped ones)."""
    d = str(tmp_path_factory.mktemp("p2n"))
    by_aa = {}
    for codon, aa in zip(CODONS, CODE):
        by_aa.setdefault(aa, []).append(codon)
    rng = np.random.default_rng(23)
    with open(os.path.join(d, "n.fasta"), "w") as f:
        for i, rec in enumerate(family_records(6, seed=29)):
            genes = [by_aa[chr(c)][int(rng.integers(len(by_aa[chr(c)])))]
                     for c in rec if chr(c) in by_aa]
            f.write(f">gene{i}\n{''.join(genes)}TAA\n")

    def p(name):
        return os.path.join(d, name)
    for argv in (["createdb", p("n.fasta"), p("n")],
                 ["translatenucs", p("n"), p("a")],
                 ["search", p("a"), p("a"), p("aln"), p("stmp"), "-a"]):
        assert ref_run(argv) == 0, argv[0]
    return d


@pytest.mark.parametrize("gaps", [(), ("--gap-open", "7", "--gap-extend",
                                       "3")])
def test_proteinaln2nucl_writes_what_the_jax_package_writes(nucl, tmp_path,
                                                            gaps):
    d = nucl
    ref, port = both(tmp_path, ["proteinaln2nucl", f"{d}/n", f"{d}/n",
                                f"{d}/a", f"{d}/a", f"{d}/aln", "OUT",
                                *gaps])
    assert port == ref
    lines = [line.split(b"\t") for line in ref["out"].split(b"\n")
             if line.count(b"\t") >= 10]
    assert len(lines) >= 20
    # gapped backtraces reached the nucleotide rescoring
    assert any(b"I" in f[10] or b"D" in f[10] for f in lines)


# ---------------------------------------------------------------------------
# data/taxonomy.py against the JAX module

@pytest.fixture(scope="module")
def trees(tax):
    """(JAX module's Taxonomy, port's) of the dump's dmp files and of the
    binary dump each serializer makes of them."""
    dump = os.path.join(tax, "dump")
    files = [os.path.join(dump, n) for n in ("names.dmp", "nodes.dmp",
                                             "merged.dmp")]
    blob = {"ref": ref_tax.serialize_taxonomy(*files),
            "port": port_tax.serialize_taxonomy(*files)}
    return blob, (ref_tax.Taxonomy.open(f"{tax}/t0"),
                  port_tax.Taxonomy.open(f"{tax}/t0"),
                  ref_tax.unserialize_taxonomy(blob["ref"]),
                  port_tax.unserialize_taxonomy(blob["port"]))


def _nodes(t):
    return {k: (n.tax_id, n.parent_tax_id, n.rank, n.name)
            for k, n in t.nodes.items()}


def test_serializer_and_readers_equal_the_jax_module(trees):
    blob, (ref_dmp, port_dmp, ref_bin, port_bin) = trees
    assert blob["port"] == blob["ref"]
    assert _nodes(port_dmp) == _nodes(ref_dmp)
    assert _nodes(port_bin) == _nodes(ref_bin)
    assert port_dmp.merged == ref_dmp.merged == {MERGED: 1000}
    assert port_bin.merged == ref_bin.merged


def test_tree_helpers_equal_the_jax_module(trees):
    _, (ref_t, port_t, _, _) = trees
    ids = sorted(ref_t.nodes) + [MERGED, DELETED, 0]
    rng = np.random.default_rng(3)
    for a in ids:
        for b in ids:
            assert port_t.is_ancestor(a, b) == ref_t.is_ancestor(a, b)
        for _ in range(5):
            taxa = [int(x) for x in rng.choice(ids, 3)] + [a]
            want = ref_t.lca(taxa)
            got = port_t.lca(taxa)
            assert (got and got.tax_id) == (want and want.tax_id)
        node_r, node_p = ref_t.node(a), port_t.node(a)
        assert (node_p is None) == (node_r is None)
        if node_r is None:
            continue
        ranks = ["superkingdom", "genus", "species", "kingdom"]
        assert port_t.at_ranks(node_p, ranks) == ref_t.at_ranks(node_r,
                                                                ranks)
        for named in (True, False):
            assert port_t.tax_lineage(node_p, named) == \
                ref_t.tax_lineage(node_r, named)
    for text in ("2", "100,!1001", "!12908", "101,102,!1021"):
        rx = ref_tax.TaxonomyExpression(text, ref_t)
        px = port_tax.TaxonomyExpression(text, port_t)
        assert [px.matches(t) for t in ids] == [rx.matches(t) for t in ids]
    black = ref_tax.parse_blacklist(ref_t, ref_tax.DEFAULT_BLACKLIST)
    assert port_tax.parse_blacklist(port_t, port_tax.DEFAULT_BLACKLIST) == \
        black == [12908, 28384]


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_weighted_majority_lca_equals_the_jax_module(trees, mode):
    _, (ref_t, port_t, _, _) = trees
    ids = sorted(ref_t.nodes) + [0]
    rng = np.random.default_rng(mode)
    for _ in range(60):
        n = int(rng.integers(1, 8))
        values = [float(v) for v in rng.uniform(1e-30, 200.0, n)]
        taxa = [int(x) for x in rng.choice(ids, n)]
        cut = float(rng.uniform(0.2, 0.9))
        got, want = (
            mod.weighted_majority_lca_full(t, [
                (x, mod.weighted_tax_hit_weight(v, mode))
                for x, v in zip(taxa, values)], cut)
            for mod, t in ((port_tax, port_t), (ref_tax, ref_t)))
        assert got == want
