"""PyTorch port: the base tools of the `plass` and `penguin` CLIs
(cli/tools.py) and the product CLIs' hidden tools, run through both
packages' CLIs on the same inputs, byte for byte: every registered command
parses the same command line to the same values; the DB tools, the
prefilter, align, search and cluster commands and their easy-* forms, and
the hidden tools write the same files as the JAX package's. The port runs
with --device cpu (kernel B9 as its plain version)."""
import os
import shutil

import pytest

from plass_tpu.cli import app as ref_app
from plass_tpu.cli import penguin as ref_penguin
from plass_tpu.cli import plass as ref_plass
from plass_tpu_torch.cli import penguin as port_penguin
from plass_tpu_torch.cli import plass as port_plass
from plass_tpu_torch.cli import tools as port_tools
from plass_tpu_torch.data import seqdb as port_seqdb

from test_torch_prefilter import family_records

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = [os.path.join(ROOT, "tests", "fixtures", f"mini_{i}.fastq.gz")
         for i in (1, 2)]
CLIS = {"plass": (ref_plass, port_plass), "penguin": (ref_penguin,
                                                      port_penguin)}
HIDDEN = {"plass": ["assembleresults", "findassemblystart",
                    "filternoncoding", "mergereads", "createhdb"],
          "penguin": ["nuclassembleresults", "cyclecheck",
                      "guidedassembleresults", "mergereads", "createhdb"]}


def ref_run(argv, binary="plass"):
    return ref_app.run_app(binary, CLIS[binary][0].commands(), argv)


def port_run(argv, binary="plass"):
    return CLIS[binary][1].run([*argv, "--device", "cpu"])


# ---------------------------------------------------------------------------
# every command parses the same argv to the same values

# flags set on each command that has them; None is a bare boolean
FLAG_VALUES = [("--threads", "4"), ("-v", "2"), ("-s", "6.5"),
               ("--min-seq-id", "0.8"), ("-c", "0.7"), ("--cov-mode", "1"),
               ("-e", "0.01"), ("--max-seqs", "50"), ("--cluster-mode", "2"),
               ("--alignment-mode", "3"), ("-a", None), ("--sens-steps", "2"),
               ("--filter-expression", "$3>0.5"), ("--preserve-keys", None),
               ("--use-fasta-header", None), ("--num-iterations", "3"),
               ("--comp-bias-corr", "0"), ("--mask", "0"),
               ("--extract-lines", "2"), ("--subdb-mode", "1")]


def _plain(values):
    return {k: (v.aminoacids, v.nucleotides) if hasattr(v, "aminoacids")
            else v for k, v in values.items()}


def _registered():
    return [(binary, c.name) for binary, (_, port) in CLIS.items()
            for c in port.commands()
            if c.name in HIDDEN[binary] or c.name in {
                b.name for b in port_tools.BASE_COMMANDS}]


@pytest.mark.parametrize("binary,name", _registered(),
                         ids=[f"{b}-{n}" for b, n in _registered()])
def test_command_parses_as_the_jax_package(binary, name):
    ref_cmd = next(c for c in CLIS[binary][0].commands() if c.name == name)
    port_cmd = next(c for c in CLIS[binary][1].commands() if c.name == name)
    ref, port = ref_cmd.params_fn(), port_cmd.params_fn()
    argv = ["in1", "in2"]
    for flag, value in FLAG_VALUES:
        if flag in ref.flags:
            argv += [flag] if value is None else [flag, value]
    argv.append("out")
    assert port.parse_args(argv) == ref.parse_args(argv)
    values = _plain(port.values)
    assert values.pop("device") == "cuda"
    assert values == _plain(ref.values)
    assert port.was_set == ref.was_set
    assert ref_cmd.hidden == port_cmd.hidden


def test_the_commands_left_out_are_unregistered(capsys):
    ported = {c.name for c in port_plass.commands()}
    for name in ("rbh", "map", "taxonomy", "enrich", "linsearch",
                 "ungappedprefilter", "createindex"):
        assert name not in ported
        assert port_plass.run([name, "a", "b"]) == 1
    assert "Invalid command 'rbh'" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the tools' outputs

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Seeded protein families as a FASTA, and (with the JAX package's
    CLI) their DB, a second DB of every third record, a search's
    alignment DB of the one against the other and a cluster DB."""
    d = str(tmp_path_factory.mktemp("inputs"))
    p = {k: os.path.join(d, k) for k in ("fasta", "seq", "sub", "aln",
                                         "aln2", "clu", "keys")}
    with open(p["fasta"], "w") as fh:
        for i, rec in enumerate(family_records(10)):
            fh.write(f">fam{i} protein {i}\n{rec.decode()}\n")
    assert ref_run(["createdb", p["fasta"], p["seq"]]) == 0
    keys = [int(k) for k in port_seqdb.SeqDB.open(p["seq"]).keys][::3]
    with open(p["keys"], "w") as fh:
        fh.writelines(f"{k}\n" for k in keys)
    assert ref_run(["createsubdb", p["keys"], p["seq"], p["sub"]]) == 0
    assert ref_run(["createsubdb", p["keys"], p["seq"] + "_h",
                    p["sub"] + "_h"]) == 0
    assert ref_run(["search", p["sub"], p["seq"], p["aln"],
                    os.path.join(d, "stmp"), "-a"]) == 0
    assert ref_run(["filterdb", p["aln"], p["aln2"], "--extract-lines",
                    "2"]) == 0
    assert ref_run(["cluster", p["seq"], p["clu"], os.path.join(d, "ctmp"),
                    "--min-seq-id", "0.5"]) == 0
    return p


def _outputs(d):
    """{name: bytes} of the files and links an output left in d (tmp
    dirs are the workflows' own)."""
    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if os.path.isfile(path):
            out[name] = open(path, "rb").read()
    return out


def _both(tmp_path, argv_fn, binary="plass", copies=()):
    """argv_fn(out_dir) run through both CLIs, each into its own dir (the
    inputs named in `copies` copied there first); returns their outputs."""
    got = []
    for tag, run in (("ref", ref_run), ("port", port_run)):
        d = str(tmp_path / tag)
        os.makedirs(d)
        for src in copies:
            for ext in ("", ".index", ".dbtype"):
                shutil.copyfile(src + ext, os.path.join(
                    d, os.path.basename(src) + ext))
        assert run(argv_fn(d), binary) == 0, tag
        got.append(_outputs(d))
    return got


# (command line; {} names an input, OUT the output in the run's dir)
TOOL_CASES = {
    "createdb": ["createdb", "{fasta}", "OUT"],
    "createsubdb": ["createsubdb", "{keys}", "{seq}", "OUT"],
    "concatdbs": ["concatdbs", "{seq}", "{sub}", "OUT"],
    "concatdbs-preserve-keys": ["concatdbs", "{seq}", "{sub}", "OUT",
                                "--preserve-keys", "--take-larger-entry"],
    "convert2fasta": ["convert2fasta", "{seq}", "OUT"],
    "filterdb-expression": ["filterdb", "{aln}", "OUT", "--filter-expression",
                            "$2 > 40 && $3 >= 0.5"],
    "filterdb-column": ["filterdb", "{aln}", "OUT", "--filter-column", "3",
                        "--comparison-operator", "ge", "--comparison-value",
                        "0.6"],
    "result2repseq": ["result2repseq", "{seq}", "{clu}", "OUT"],
    "createtsv": ["createtsv", "{sub}", "{seq}", "{aln}", "OUT"],
    "createtsv-3": ["createtsv", "{sub}", "{aln}", "OUT"],
    "mergedbs": ["mergedbs", "{sub}", "OUT", "{aln}", "{aln2}"],
    "sortresult": ["sortresult", "{aln}", "OUT"],
    "swapresults": ["swapresults", "{sub}", "{seq}", "{aln}", "OUT"],
    "convertalis": ["convertalis", "{sub}", "{seq}", "{aln}", "OUT"],
    "convertalis-no-backtrace": ["convertalis", "{sub}", "{seq}", "{aln2}",
                                 "OUT"],
    "cpdb": ["cpdb", "{aln}", "OUT"],
    "kmermatcher": ["kmermatcher", "{seq}", "OUT"],
    "prefilter": ["prefilter", "{sub}", "{seq}", "OUT", "-s", "6"],
    "align": ["align", "{sub}", "{seq}", "{pref}", "OUT"],
    "align-backtrace": ["align", "{sub}", "{seq}", "{pref}", "OUT", "-a",
                        "--alignment-mode", "3"],
    "lcaalign": ["lcaalign", "{sub}", "{seq}", "{pref}", "OUT"],
    "search": ["search", "{sub}", "{seq}", "OUT", "TMP"],
    "search-sens-steps": ["search", "{sub}", "{seq}", "OUT", "TMP",
                          "--sens-steps", "2", "-s", "6"],
    "clust": ["clust", "{seq}", "{aln_self}", "OUT"],
    "mergeclusters": ["mergeclusters", "{seq}", "OUT", "{clu}", "{clu}"],
    "cluster": ["cluster", "{seq}", "OUT", "TMP", "--min-seq-id", "0.9",
                "-c", "0.9"],
    "cluster-defaults": ["cluster", "{seq}", "OUT", "TMP"],
    "result2flat": ["result2flat", "{seq}", "{seq}", "{clu}", "OUT",
                    "--use-fasta-header"],
    "createseqfiledb": ["createseqfiledb", "{seq}", "{clu}", "OUT"],
    "easy-search": ["easy-search", "{fasta}", "{fasta}", "OUT", "TMP"],
    "easy-cluster": ["easy-cluster", "{fasta}", "OUT", "TMP"],
    "easy-linclust": ["easy-linclust", "{fasta}", "OUT", "TMP"],
}


@pytest.fixture(scope="module")
def more_inputs(inputs, tmp_path_factory):
    """inputs, with a prefilter DB of the subset against the DB and a
    self search's alignment DB (the JAX package's CLI)."""
    d = str(tmp_path_factory.mktemp("more"))
    p = dict(inputs, pref=os.path.join(d, "pref"),
             aln_self=os.path.join(d, "aln_self"))
    assert ref_run(["prefilter", p["sub"], p["seq"], p["pref"]]) == 0
    assert ref_run(["search", p["seq"], p["seq"], p["aln_self"],
                    os.path.join(d, "tmp")]) == 0
    return p


@pytest.mark.parametrize("case", list(TOOL_CASES))
def test_tool_writes_what_the_jax_package_writes(more_inputs, tmp_path, case):
    def argv(d):
        return [a.format(**more_inputs).replace("OUT", os.path.join(d, "out"))
                .replace("TMP", os.path.join(d, "tmp"))
                for a in TOOL_CASES[case]]
    ref, port = _both(tmp_path, argv)
    assert port == ref
    assert any(name.startswith("out") and data for name, data in ref.items())


def test_mvdb_lndb_rmdb_as_the_jax_package(inputs, tmp_path):
    for argv in (["mvdb", "aln", "moved"], ["lndb", "aln", "linked"],
                 ["rmdb", "aln"]):
        ref, port = _both(tmp_path / argv[0], lambda d: [
            argv[0], *[os.path.join(d, a) for a in argv[1:]]],
            copies=[inputs["aln"]])
        assert port == ref


def test_profile_and_iterative_search_raise_with_a_pointer(inputs, tmp_path):
    """The paths that raised before the profile subsystem was ported: a
    profile query DB (result2profile of the search's alignments) through
    `prefilter` writes what the JAX package writes, and a profile query DB
    against a profile target DB fails on both CLIs. The searches against
    profiles and the iterative search: tests/test_torch_profile_search.py."""
    prof = str(tmp_path / "prof")
    assert ref_run(["result2profile", inputs["sub"], inputs["seq"],
                    inputs["aln"], prof]) == 0
    ref, port = _both(tmp_path / "pref", lambda d: [
        "prefilter", prof, inputs["seq"], os.path.join(d, "out")])
    assert port == ref and ref["out"]
    for tag, run in (("ref", ref_run), ("port", port_run)):
        assert run(["prefilter", prof, prof, str(tmp_path / tag)]) == 1


def test_search_and_cluster_report_stages_and_pairs(inputs, tmp_path):
    stats = {}
    assert port_plass.run(["search", inputs["sub"], inputs["seq"],
                           str(tmp_path / "aln"), str(tmp_path / "t"),
                           "--device", "cpu"], stats=stats) == 0
    assert set(stats["seconds"]) == {"prefilter", "align", "merge"}
    assert stats["pairs"]["candidate_pairs"] > 0
    stats = {}
    assert port_plass.run(["cluster", inputs["seq"], str(tmp_path / "clu"),
                           str(tmp_path / "ct"), "--device", "cpu"],
                          stats=stats) == 0
    assert {"linclust", "prefilter_0", "align_2", "clust_2", "merge"} <= set(
        stats["seconds"])


# ---------------------------------------------------------------------------
# the hidden tools of the product CLIs

@pytest.fixture(scope="module")
def reads_dbs(tmp_path_factory):
    """From the fixture reads, with the JAX package's tools: the merged
    reads, their ORFs and translations, a k-mer match and rescore of each
    (the proteins' with backtraces) and the proteins' alignments mapped to
    nucleotides."""
    d = str(tmp_path_factory.mktemp("reads"))
    p = {k: os.path.join(d, k) for k in (
        "reads", "orf", "aa", "pref_aa", "aln_aa", "naln", "pref_nt",
        "aln_nt")}
    for argv, binary in (
            (["mergereads", *READS, p["reads"]], "plass"),
            (["extractorfs", p["reads"], p["orf"], "--orf-min-length", "20"],
             "plass"),
            (["translatenucs", p["orf"], p["aa"]], "plass"),
            (["kmermatcher", p["aa"], p["pref_aa"]], "plass"),
            (["rescorediagonal", p["aa"], p["aa"], p["pref_aa"], p["aln_aa"],
              "-a", "--min-seq-id", "0.9"], "plass"),
            (["proteinaln2nucl", p["orf"], p["orf"], p["aa"], p["aa"],
              p["aln_aa"], p["naln"]], "penguin"),
            (["kmermatcher", p["reads"], p["pref_nt"]], "penguin"),
            (["rescorediagonal", p["reads"], p["reads"], p["pref_nt"],
              p["aln_nt"], "--min-seq-id", "0.99"], "penguin")):
        assert ref_run(argv, binary) == 0, argv[0]
    for name in ("aln_aa", "naln", "aln_nt"):
        assert os.path.getsize(p[name]) > 1000, name
    return p


HIDDEN_CASES = {
    ("plass", "assembleresults"): ["{aa}", "{aln_aa}", "OUT"],
    ("plass", "findassemblystart"): ["{aa}", "{aln_aa}", "OUT"],
    ("plass", "filternoncoding"): ["{aa}", "OUT"],
    ("plass", "mergereads"): [*READS, "OUT"],
    ("plass", "createhdb"): ["{aa}", "OUT"],
    ("penguin", "nuclassembleresults"): ["{reads}", "{aln_nt}", "OUT"],
    ("penguin", "cyclecheck"): ["{reads}", "OUT"],
    ("penguin", "guidedassembleresults"): ["{orf}", "{aa}", "{naln}", "OUT",
                                           "OUT_aa"],
    ("penguin", "mergereads"): [*READS, "OUT"],
    ("penguin", "createhdb"): ["{reads}", "{aa}", "OUT"],
}


@pytest.mark.parametrize("binary,name", list(HIDDEN_CASES),
                         ids=[f"{b}-{n}" for b, n in HIDDEN_CASES])
def test_hidden_tool_writes_what_the_jax_package_writes(reads_dbs, tmp_path,
                                                        binary, name):
    def argv(d):
        return [name] + [a.format(**reads_dbs).replace(
            "OUT", os.path.join(d, "out")) for a in HIDDEN_CASES[binary,
                                                                 name]]
    ref, port = _both(tmp_path, argv, binary)
    assert port == ref
    assert any(data for n, data in ref.items() if n.startswith("out"))
