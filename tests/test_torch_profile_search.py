"""PyTorch port: the profile searches of `search` (cli/tools.py): the
iterative search (--num-iterations 2 and 3), search against a profile
target DB at the defaults and with coverage modes that swap, and the
exhaustive (sliced) target-profile search, through both packages' CLIs
byte for byte on seeded protein families. The port runs with --device
cpu; the iterative search's first step, whose candidate pairs B9 scores
on a card, is also run with B9's plain version forced on."""
import os

import numpy as np
import pytest

from plass_tpu.cli import plass as ref_plass
from plass_tpu.data import seqdb as ref_seqdb
from plass_tpu_torch.cli import plass as port_plass
from plass_tpu_torch.cli import tools as port_tools
from plass_tpu_torch.data import seqdb as port_seqdb
from plass_tpu_torch.ops import protein_align

from test_torch_prefilter import family_records
from test_torch_tools import _both, ref_run


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """family_records(10) as a DB, every third record of it as queries,
    and a profile DB of the queries (result2profile of an iterative
    search's alignments; the JAX package's CLI)."""
    d = str(tmp_path_factory.mktemp("profile_search"))
    p = {k: os.path.join(d, k) for k in ("fasta", "seq", "sub", "keys",
                                         "aln", "prof")}
    with open(p["fasta"], "w") as fh:
        for i, rec in enumerate(family_records(10)):
            fh.write(f">fam{i} protein {i}\n{rec.decode()}\n")
    assert ref_run(["createdb", p["fasta"], p["seq"]]) == 0
    keys = [int(k) for k in ref_seqdb.SeqDB.open(p["seq"]).keys][::3]
    with open(p["keys"], "w") as fh:
        fh.writelines(f"{k}\n" for k in keys)
    for argv in (["createsubdb", p["keys"], p["seq"], p["sub"]],
                 ["search", p["sub"], p["seq"], p["aln"],
                  os.path.join(d, "tmp"), "--num-iterations", "2"],
                 ["result2profile", p["sub"], p["seq"], p["aln"], p["prof"]]):
        assert ref_run(argv) == 0, argv[0]
    assert ref_seqdb.read_dbtype(p["prof"]) == ref_seqdb.HMM_PROFILE
    return p


# (command line; {} names an input, OUT the output, TMP the tmp dir)
CASES = {
    "iterative-2": ["{sub}", "{seq}", "--num-iterations", "2"],
    "iterative-3": ["{sub}", "{seq}", "--num-iterations", "3"],
    "target-profiles": ["{seq}", "{prof}"],
    "target-profiles-cov-mode-1": ["{seq}", "{prof}", "--cov-mode", "1",
                                   "-c", "0.5"],
    "target-profiles-cov-mode-2": ["{seq}", "{prof}", "--cov-mode", "2",
                                   "-c", "0.5", "-a"],
    "exhaustive": ["{seq}", "{prof}", "--exhaustive-search"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_profile_search_writes_what_the_jax_package_writes(inputs, tmp_path,
                                                           case):
    q, t, *flags = CASES[case]

    def argv(d):
        return ["search", q.format(**inputs), t.format(**inputs),
                os.path.join(d, "out"), os.path.join(d, "tmp"), *flags]
    ref, port = _both(tmp_path, argv)
    assert port == ref
    assert ref["out"] and ref["out.index"]


def test_exhaustive_search_filter_fails_as_in_the_jax_package(inputs,
                                                               tmp_path):
    """--exhaustive-search-filter 1 runs filterresult on the target-key
    records of --alignment-output-mode 1; the JAX package's parser of
    alignment lines fails on them, and the port's, a copy, fails alike."""
    errors = []
    for tag, commands, extra in (("ref", ref_plass.commands(), []),
                                 ("port", port_plass.commands(),
                                  ["--device", "cpu"])):
        cmd = next(c for c in commands if c.name == "search")
        space = cmd.params_fn()
        pos = space.parse_args([
            inputs["seq"], inputs["prof"], str(tmp_path / tag / "out"),
            str(tmp_path / tag / "tmp"), "--exhaustive-search",
            "--exhaustive-search-filter", "1", *extra])
        with pytest.raises(IndexError) as err:
            cmd.fn(pos, space, *([{}] if tag == "port" else []))
        errors.append(str(err.value))
    assert errors[1] == errors[0]


def test_profile_queries_against_profile_targets_raise_as_in_the_jax_package(
        inputs, tmp_path):
    errors = []
    for tag, commands, extra in (("ref", ref_plass.commands(), []),
                                 ("port", port_plass.commands(),
                                  ["--device", "cpu"])):
        cmd = next(c for c in commands if c.name == "search")
        space = cmd.params_fn()
        pos = space.parse_args([inputs["prof"], inputs["prof"],
                                str(tmp_path / tag / "out"),
                                str(tmp_path / tag / "tmp"), *extra])
        with pytest.raises(ValueError) as err:
            cmd.fn(pos, space, *([{}] if tag == "port" else []))
        errors.append(str(err.value))
    assert errors[1] == errors[0] and "target-profile" in errors[0]
    assert port_plass.run(["search", inputs["prof"], inputs["prof"],
                           str(tmp_path / "cli"), str(tmp_path / "clitmp"),
                           "--device", "cpu"]) == 1


def test_iterative_search_reports_each_step(inputs, tmp_path):
    """The iterative search's stats name each step's stages and pairs; a
    --device cpu run takes the plain versions from start to end."""
    stats = {}
    assert port_plass.run(["search", inputs["sub"], inputs["seq"],
                           str(tmp_path / "out"), str(tmp_path / "tmp"),
                           "--num-iterations", "2", "--device", "cpu"],
                          stats=stats) == 0
    assert set(stats["seconds"]) == {
        "prefilter_0", "align_0", "result2profile_0", "prefilter_1",
        "subtractdbs_1", "align_1", "mergedbs_1"}
    assert stats["pairs"]["candidate_pairs_0"] > 0
    assert stats["pairs"]["device_pairs_0"] == 0
    assert "candidate_pairs_1" in stats["pairs"]
    stats = {}
    assert port_plass.run(["search", inputs["seq"], inputs["prof"],
                           str(tmp_path / "tp"), str(tmp_path / "tptmp"),
                           "--device", "cpu"], stats=stats) == 0
    assert set(stats["seconds"]) == {"prefilter", "swapresults", "align"}
    assert stats["pairs"]["candidate_pairs"] > 0


def test_iterative_first_step_with_forced_pre_scoring_is_unchanged(
        inputs, tmp_path):
    """Step 0 of the iterative search (align -a --realign -e 0.001 on
    the sequence queries' prefilter DB): with every candidate pair scored
    first by B9's plain version, as on a card, the results equal the
    step's own; so they do with seeded unrelated candidates added, which
    the pre-score rejects."""
    tmp = str(tmp_path / "tmp")
    assert port_plass.run(["search", inputs["sub"], inputs["seq"],
                           str(tmp_path / "out"), tmp, "--num-iterations",
                           "2", "--device", "cpu"]) == 0
    qdb = port_seqdb.SeqDB.open(inputs["sub"])
    tdb = port_seqdb.SeqDB.open(inputs["seq"])
    hits = port_tools.load_prefilter(os.path.join(tmp, "pref_0"))
    kw = dict(tdb=tdb, eval_thr=1e-3, alignment_mode=2, add_backtrace=True,
              realign=True, device="cpu")
    counts = {}
    forced = protein_align.align_protein(qdb, hits, device_prefilter=True,
                                         counts=counts, **kw)
    assert counts["device_pairs"] == counts["candidate_pairs"] > 0
    assert protein_align.protein_align_results_to_db(
        forced, add_backtrace=True,
        key_order=list(hits)).data.tobytes() == open(
            os.path.join(tmp, "aln_0"), "rb").read()
    rng = np.random.default_rng(5)
    keys = [int(k) for k in tdb.keys]
    more = {q: h + [(int(t), 1, 0) for t in rng.choice(keys, 4, replace=False)
                    if int(t) not in {x[0] for x in h}]
            for q, h in hits.items()}
    counts = {}
    forced = protein_align.align_protein(qdb, more, device_prefilter=True,
                                         counts=counts, **kw)
    assert forced == protein_align.align_protein(
        qdb, more, device_prefilter=False, **kw)
    assert counts["device_rejected"] > 0
