"""chip_smoke.py, the port's GPU smoke run, on a machine without a card:
its CPU rehearsal drives every phase at a tiny size (the split matcher's
phases, the DB tools', the port-only run and the sharded matcher's ranks
included) and prints
no result;
run alone, outside the repo, it fails without printing a result; its
`kernels` line holds every key for every kernel."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TTY"] = "0"
    return env


def test_cpu_rehearsal_runs_every_phase():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py", "--cpu-rehearsal"], cwd=ROOT,
        env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    out = proc.stdout
    for tag in ("[env]", "[k1]",
                "[fixture] 2 iterations, filter 0: byte-identical",
                "[standalone] plass_tpu_torch/ alone as working directory "
                "and PYTHONPATH, find_spec('plass_tpu') None",
                "byte-identical to both goldens",
                "[scale] reads", "[main] matcher", "[main] K2 on",
                "[nucl-fixture] 2 iterations, min-contig-len 150: "
                "byte-identical", "[nucl-scale] reads", "[nucl-main] matcher",
                "[nucl-main] K2 rescore_e2e_rev_uniform",
                "[nucl-main] K2 rescore_e2e_rev ",
                "[guided-fixture] default parameters --num-iterations 2, "
                "min-contig-len 150:", "byte-identical to the run with "
                "--device cpu", "[guided-fixture] seconds per stage: ingest",
                "[guided-scale] reads 600, ORFs", "only-assembled",
                "[guided-scale] seconds per stage: ingest",
                "; nuclassemble [ingest", "; linclust [kmermatch",
                "[guided-scale] wall", "[guided-main] aa matcher on",
                "[guided-main] K2 rescore_e2e on", "windows with '*' at both "
                "ends: equal to the plain version",
                "[guided-main] K1, the aa matcher's 6 scans",
                "[split-main] protein x400 iteration 0:",
                "[split-main] nucl-scale iteration 0:",
                "[split-main] nucl-scale last iteration:",
                "[split-main] guided-scale aa iteration 0:",
                "equal to the monolithic matcher",
                "[nucl-split] --split-memory-limit", "equal to nucl-scale's",
                "[linclust-aa] phase 4's", "proteins of family_fasta made",
                "[linclust-aa] contigs defaults:",
                "[linclust-aa] contigs --min-seq-id 0.95:",
                "[linclust-aa] families defaults:", "candidate pairs in the "
                "align stage", "[search-aa] target DB of 47 proteins",
                "th) with `plass createsubdb`", "byte-identical to the "
                "align stage with --device cpu", "[search-aa] seconds per "
                "stage: prefilter", "[search-aa] ", "scored by B9",
                "[profile-aa] run 1: `plass search --num-iterations 2`",
                "step 0's align stage byte-identical with --device cpu",
                "[profile-aa] run 1 seconds per stage and step: prefilter_0",
                "subtractdbs_1", "mergedbs_1", "result2profile_0",
                "step 1: ", "B9 launches by step [0, 0]",
                "[profile-aa] run 2: `plass result2profile` of run 1",
                "[profile-aa] run 2 seconds per stage: prefilter",
                "swapresults",
                "[cluster-aa] `plass cluster --min-seq-id 0.9 -c 0.9`:",
                "[cluster-aa] seconds per stage and step: linclust",
                "prefilter_0", "align_0", "clust_0", "[easy-aa] dev: "
                "easy-search and easy-cluster", "[easy-aa] m8 ",
                "_all_seqs.fasta", "byte-identical to the runs with --device "
                "cpu", "[easy-aa] dev: easy-rbh and easy-linsearch of records "
                "f1, f3, ... against f0, f2, ... to f99", "rbh.m8 ", "linsearch.m8 ",
                "[linsearch-aa] 23 queries (odd keys) against 24 targets",
                "the align stage byte-identical with --device cpu",
                "[linsearch-aa] seconds per stage: kmersearch",
                "rescorediagonal", "pass the ungapped filter",
                "[rbh-aa] 24 records in A, 23 in B:", "reciprocal best hits",
                "[rbh-aa] seconds per stage: prefilter_AB", "align_BA",
                "B9 launches by search [0, 0]",
                "[multihit-nt] 16 coding genomes of 2000 nt in 8 target sets",
                "[multihit-nt] seconds per stage: prefilter",
                "[easy-aa] dev: easy-taxonomy of records f1, f3, ... against "
                "the taxonomy DB of f0, f2, ... to f99", "_tophit_aln ",
                "[taxonomy-aa] 10 queries (every 5th record) and 37 targets",
                "`plass createtaxdb`", "[taxonomy-aa] default: `plass "
                "taxonomy` in", "[taxonomy-aa] lca-mode-4: `plass taxonomy "
                "--lca-mode 4` in", "ranks {", "[taxonomy-aa] lca-mode-4: "
                "seconds per stage: prefilter", "[taxonomy-aa] lca-mode-4: "
                "the align stage byte-identical with --device cpu",
                "[db-tools] 34 runs of 30 commands on 47 family proteins "
                "and 16 coding genomes of 2000 nt, each on the card and with "
                "--device cpu, byte for byte equal", "cut: alignall on the "
                "first", "kernel launches during the runs: 0",
                "[db-tools] countkmer: ", "[db-tools] transitivealign: ",
                "[db-tools] databases-entry: ", "[db-tools] extractframes: ",
                "[db-tools] apply: ",
                "[sw-side] waited", "[sw-side] B9 on the 36 candidate pairs "
                "of taxonomy's align stage", "[sw-side] B9 on linsearch's ",
                "[sw-side] B9 on rbh's ", "[sw-side] B9 on multihit's ",
                "[sw-main] B9 on the contigs' ",
                "[sw-main] B9 on the families' ", "[sw-main] B9 on "
                "search-aa's ", "candidate pairs of search-aa's align stage",
                "failing the E-value test", "[sw-main] B9 on 28 "
                "edge pairs", "equal to the plain version and to the native "
                "ssw", "[hamming] plass assemble --rescore-mode 0",
                "[hamming] penguin nuclassemble --rescore-mode 0",
                "[hamming] rescore_hamming on", "[hamming] "
                "rescore_hamming_rev on",
                "[nucl-large] 3000 reads", "equal hits, sha256",
                "[sharded] world 1 (gloo): `plass assemble --backend "
                "sharded` of protein x400", "[sharded] world 1 rank 0: "
                "ingest", "exchanges table ", "[sharded] world 1: "
                "byte-identical to phase 4's assembly", "[sharded] world 2 "
                "(gloo): the iteration-0 sharded matcher on protein x400's "
                "DB", "on the card equals it on the CPU in both ranks",
                "[sharded] world 2: `plass assemble --backend sharded`",
                "[sharded] world 2 rank 1: ingest", "[sharded] world 2: "
                "`penguin nuclassemble --backend sharded` on the fixture, "
                "card and --device cpu in both ranks", "[sharded] world 2: "
                "`penguin guided_nuclassemble --backend sharded`",
                "[sharded] a failing rank (rank 1's input missing): exit "
                "codes [1, 1]", "[sharded] waited",
                "[align] plass assemble --rescore-mode 2: ",
                "[align] penguin nuclassemble --rescore-mode 2 "
                "--min-contig-len 150: ", "byte-identical to the run with "
                "--device cpu and to tests/fixtures/mini_golden_nucl.fasta",
                "[align] the protein edge rows hold ",
                "windows that begin and end with '*'",
                "[align] rescore_align on ", "[align] rescore_align_rev "
                "(generic matrix) on ", "[align] rescore_align_rev (uniform "
                "matrix) on ", "windows with no positive score",
                "[align-scale] `plass assemble --rescore-mode 2` of 2048 "
                "reads", "[align-scale] seconds per stage: ingest",
                "[align-scale] launches: seg_scan 0", "phase 4's assembly at "
                "--rescore-mode 3",
                "[done] all phases in", "[rehearsal]"):
        assert tag in out, out
    assert '"ok"' not in out


def test_alone_it_fails_without_a_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_cards_mode_needs_the_cards():
    """--cards N fails without N cards and prints no result."""
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--cards", "2"],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode not in (0, 2)
    assert "card(s) visible" in proc.stderr
    assert '"ok"' not in proc.stdout


KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


def test_kernels_line_has_every_key_for_every_kernel():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    m = {"max_abs_err": 0, "ms": 0.05, "plain_ms": 3.0, "bound_ms": 0.01,
         "bound_by": "bytes", "bytes": 1000}
    names = ["seg_scan", "rescore_e2e", "rescore_e2e_rev",
             "rescore_e2e_rev_uniform"]
    launches = {
        "assemble": {"seg_scan": 78, "rescore_e2e": 13},
        "nuclassemble": {"seg_scan": 48, "rescore_e2e_rev_uniform": 8},
        "guided_nuclassemble": {"seg_scan": 60, "rescore_e2e": 5,
                                "rescore_e2e_rev_uniform": 5},
        "split": {"seg_scan": 150, "rescore_e2e_rev_uniform": 8}}
    kernels = chip_smoke.kernels_summary(
        dict(m, copy_ms=0.06, elements=100), m, {n: m for n in names[2:]},
        launches)
    line = json.loads(json.dumps({"kernels": kernels}))["kernels"]
    assert [k["name"] for k in line] == names
    for k in line:
        assert KERNEL_KEYS <= set(k), k["name"]
        assert k["route"] == "cuda" and k["library_ms"] is None
        assert os.path.exists(os.path.join(ROOT, k["source"]))
        ref_file, ref_line = k["replaces"].split(":")
        text = open(os.path.join(ROOT, ref_file)).read().splitlines()
        assert "pallas_call" in text[int(ref_line) - 1], k["replaces"]
        assert set(k["launches_by_path"]) == set(launches)
        assert k["launches"] == sum(k["launches_by_path"].values())
    by_name = {k["name"]: k for k in line}
    assert by_name["seg_scan"]["launches"] == 336
    assert by_name["rescore_e2e"]["launches_by_path"] == {
        "assemble": 13, "nuclassemble": 0, "guided_nuclassemble": 5,
        "split": 0}
    assert by_name["rescore_e2e_rev"]["launches"] == 0


def test_kernels_line_with_the_aligner_and_hamming_kernels():
    """With B9's and the HAMMING forms' measurements the line also lists
    sw_score, rescore_hamming and rescore_hamming_rev, each replacing the
    JAX package's device function, with every key and the new paths."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    m = {"max_abs_err": 0, "ms": 0.05, "plain_ms": 3.0, "bound_ms": 0.01,
         "bound_by": "bytes", "bytes": 1000}
    sw = dict(m, bound_by="operations", operations=6000, cells=1000,
              gcups=20.0, pairs=10)
    sw["contigs"] = dict(sw)
    launches = {
        "assemble": {"seg_scan": 78, "rescore_e2e": 13},
        "linclust": {"sw_score": 2},
        "rescore_mode_0": {"seg_scan": 30, "rescore_hamming": 3,
                           "rescore_hamming_rev": 2}}
    kernels = chip_smoke.kernels_summary(
        dict(m, copy_ms=0.06, elements=100), m,
        {n: m for n in ("rescore_e2e_rev", "rescore_e2e_rev_uniform")},
        launches, sw, {n: m for n in ("rescore_hamming",
                                      "rescore_hamming_rev")})
    line = json.loads(json.dumps({"kernels": kernels}))["kernels"]
    by_name = {k["name"]: k for k in line}
    assert list(by_name)[-3:] == ["sw_score", "rescore_hamming",
                                  "rescore_hamming_rev"]
    wants = {"sw_score": ("plass_tpu/ops/device_align.py", "def sw_score_batch"),
             "rescore_hamming": ("plass_tpu/ops/device_rescore.py",
                                 "mode == 0"),
             "rescore_hamming_rev": ("plass_tpu/ops/device_rescore.py",
                                     "mode == 0")}
    for name, (ref_file, code) in wants.items():
        k = by_name[name]
        assert KERNEL_KEYS <= set(k) and k["library_ms"] is None
        assert k["replaces"].split(":")[0] == ref_file
        text = open(os.path.join(ROOT, ref_file)).read().splitlines()
        line_no = int(k["replaces"].split(":")[1])
        assert code in "".join(text[line_no - 1:line_no + 1]), name
        assert os.path.exists(os.path.join(ROOT, k["source"]))
        assert set(k["launches_by_path"]) == set(launches)
    assert by_name["sw_score"]["launches"] == 2
    assert by_name["sw_score"]["bound_by"] == "operations"
    assert by_name["sw_score"]["contigs"]["gcups"] == 20.0
    assert by_name["rescore_hamming"]["launches_by_path"]["rescore_mode_0"] \
        == 3
    assert by_name["seg_scan"]["launches"] == 108


def test_kernels_line_with_the_search_paths():
    """B9's entry counts its launches by the search, cluster and easy-*
    paths too and carries its measurements on search-aa's pairs, the
    share it rejects included."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    m = {"max_abs_err": 0, "ms": 0.05, "plain_ms": 3.0, "bound_ms": 0.01,
         "bound_by": "bytes", "bytes": 1000}
    sw = dict(m, bound_by="operations", operations=6000, cells=1000,
              gcups=20.0, pairs=10, rejected=0)
    sw["contigs"] = dict(sw)
    sw["search"] = dict(sw, pairs=15000, rejected=12000, gcups=150.0)
    launches = {"assemble": {"seg_scan": 78, "rescore_e2e": 13},
                "linclust": {"sw_score": 2}, "search": {"sw_score": 1},
                "cluster": {"sw_score": 2}, "easy": {"sw_score": 0}}
    kernels = chip_smoke.kernels_summary(
        dict(m, copy_ms=0.06, elements=100), m,
        {n: m for n in ("rescore_e2e_rev", "rescore_e2e_rev_uniform")},
        launches, sw)
    line = json.loads(json.dumps({"kernels": kernels}))["kernels"]
    b9 = next(k for k in line if k["name"] == "sw_score")
    assert KERNEL_KEYS <= set(b9)
    assert b9["launches"] == 5
    assert b9["launches_by_path"] == {"assemble": 0, "linclust": 2,
                                      "search": 1, "cluster": 2, "easy": 0}
    assert b9["search"] == {"ms": 0.05, "plain_ms": 3.0, "bound_ms": 0.01,
                            "cells": 1000, "gcups": 150.0, "pairs": 15000,
                            "rejected": 12000}
    assert b9["contigs"]["pairs"] == 10


def test_kernels_line_counts_the_profile_path():
    """B9's launches on profile-aa's iterative search (its first step)
    are a path of their own in the kernels line."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    m = {"max_abs_err": 0, "ms": 0.05, "plain_ms": 3.0, "bound_ms": 0.01,
         "bound_by": "bytes", "bytes": 1000}
    sw = dict(m, bound_by="operations", operations=6000, cells=1000,
              gcups=20.0, pairs=10)
    launches = {"search": {"sw_score": 1}, "profile": {"sw_score": 1},
                "cluster": {"sw_score": 2}}
    kernels = chip_smoke.kernels_summary(
        dict(m, copy_ms=0.06, elements=100), m,
        {n: m for n in ("rescore_e2e_rev", "rescore_e2e_rev_uniform")},
        launches, sw)
    b9 = next(k for k in kernels if k["name"] == "sw_score")
    assert b9["launches_by_path"] == {"search": 1, "profile": 1,
                                      "cluster": 2}
    assert b9["launches"] == 4
    assert chip_smoke.PROFILE_ITERATIONS == 2
    assert set(chip_smoke.PROFILE_SHA256) == {"iterative",
                                              "target-profiles"}
    assert all(len(v) == 64 for v in chip_smoke.PROFILE_SHA256.values())


def test_kernels_line_counts_the_linsearch_rbh_and_multihit_paths():
    """B9's launches on linsearch-aa, rbh-aa and multihit-nt (the slice's
    process) are paths of their own in the kernels line, beside the
    earlier ones."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    m = {"max_abs_err": 0, "ms": 0.05, "plain_ms": 3.0, "bound_ms": 0.01,
         "bound_by": "bytes", "bytes": 1000}
    sw = dict(m, bound_by="operations", operations=6000, cells=1000,
              gcups=20.0, pairs=10)
    launches = {"search": {"sw_score": 1}, "profile": {"sw_score": 1},
                "linsearch": {"sw_score": 1}, "rbh": {"sw_score": 2},
                "multihit": {"sw_score": 1}}
    kernels = chip_smoke.kernels_summary(
        dict(m, copy_ms=0.06, elements=100), m,
        {n: m for n in ("rescore_e2e_rev", "rescore_e2e_rev_uniform")},
        launches, sw)
    b9 = next(k for k in kernels if k["name"] == "sw_score")
    assert b9["launches_by_path"] == {"search": 1, "profile": 1,
                                      "linsearch": 1, "rbh": 2,
                                      "multihit": 1}
    assert b9["launches"] == 6
    seg = next(k for k in kernels if k["name"] == "seg_scan")
    assert seg["launches_by_path"]["rbh"] == 0
    assert set(chip_smoke.SIDE_TAGS) == {"profile-aa", "slice", "sharded",
                                         "align-scale"}
    assert chip_smoke.RBH_RECORDS == 1200
    assert (chip_smoke.MULTIHIT_SETS, chip_smoke.MULTIHIT_EVERY,
            chip_smoke.MULTIHIT_QUERY_FILES) == (8, 13, 2)


def test_kernels_line_counts_the_taxonomy_path_and_the_side_pairs():
    """B9's launches on taxonomy-aa (the slice's process) are a path of
    their own, and its measurements on the side process's pairs
    (linsearch, rbh, multihit, taxonomy) go into its entry; the default
    run's and the --lca-mode 4 run's sha256 are recorded."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    m = {"max_abs_err": 0, "ms": 0.05, "plain_ms": 3.0, "bound_ms": 0.01,
         "bound_by": "bytes", "bytes": 1000}
    sw = dict(m, bound_by="operations", operations=6000, cells=1000,
              gcups=20.0, pairs=10)
    side = {name: dict(sw, pairs=n, block_pairs=1) for name, n in (
        ("linsearch", 2390), ("rbh", 1510), ("multihit", 3141),
        ("taxonomy", 3663))}
    launches = {"search": {"sw_score": 1}, "linsearch": {"sw_score": 1},
                "rbh": {"sw_score": 2}, "multihit": {"sw_score": 1},
                "taxonomy": {"sw_score": 1}}
    kernels = chip_smoke.kernels_summary(
        dict(m, copy_ms=0.06, elements=100), m,
        {n: m for n in ("rescore_e2e_rev", "rescore_e2e_rev_uniform")},
        launches, dict(sw, **side))
    line = json.loads(json.dumps({"kernels": kernels}))["kernels"]
    b9 = next(k for k in line if k["name"] == "sw_score")
    assert b9["launches_by_path"]["taxonomy"] == 1
    assert b9["launches"] == 6
    for name, n in (("linsearch", 2390), ("taxonomy", 3663)):
        assert b9[name]["pairs"] == n and b9[name]["block_pairs"] == 1
        assert set(b9[name]) == {"ms", "plain_ms", "bound_ms", "cells",
                                 "gcups", "pairs", "block_pairs"}
    assert "[taxonomy-aa]" in chip_smoke.SIDE_TAGS["slice"]
    assert "[sw-side]" in chip_smoke.SIDE_TAGS["slice"]
    assert "taxonomy" in chip_smoke.REFERENCE_RUNS
    assert set(chip_smoke.TAXONOMY_SHA256) == {"default", "lca-mode-4"}
    assert all(len(v) == 64 for v in chip_smoke.TAXONOMY_SHA256.values())
    assert (chip_smoke.TAX_GENERA, chip_smoke.TAX_FAMILIES,
            chip_smoke.TAX_SPECIES, chip_smoke.TAXONOMY_QUERY_EVERY) == \
        (150, 10, 3, 5)


def test_family_fasta_names_each_records_family(tmp_path):
    """family_fasta's optional out-list leaves the FASTA's bytes as they
    are and gives each record's family: a family's records follow its root
    in f<i> order, the roots numbered 0, 1, ...; the process's cached
    matrix keeps its background frequencies."""
    from plass_tpu_torch import constants
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    pback = constants.blosum62().pback.copy()
    families = []
    n = chip_smoke.family_fasta(str(tmp_path / "a.fasta"), 40,
                                families=families)
    chip_smoke.family_fasta(str(tmp_path / "b.fasta"), 40)
    assert (tmp_path / "a.fasta").read_bytes() == \
        (tmp_path / "b.fasta").read_bytes()
    assert len(families) == n and families == sorted(families)
    assert set(families) == set(range(40)) and n > 80
    assert (constants.blosum62().pback == pback).all()


def test_kernels_line_counts_the_sharded_path():
    """K1's and K2's launches in the ranks of the sharded phase's protein
    x400 assemblies are a path of their own ("sharded") in the kernels
    line; --cpu-reference takes "sharded" and its sha256 is recorded."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    m = {"max_abs_err": 0, "ms": 0.05, "plain_ms": 3.0, "bound_ms": 0.01,
         "bound_by": "bytes", "bytes": 1000}
    launches = {"assemble": {"seg_scan": 78, "rescore_e2e": 13},
                "sharded": {"seg_scan": 234, "rescore_e2e": 39}}
    kernels = chip_smoke.kernels_summary(
        dict(m, copy_ms=0.06, elements=100), m,
        {n: m for n in ("rescore_e2e_rev", "rescore_e2e_rev_uniform")},
        launches)
    line = json.loads(json.dumps({"kernels": kernels}))["kernels"]
    by_name = {k["name"]: k for k in line}
    assert by_name["seg_scan"]["launches_by_path"] == {"assemble": 78,
                                                       "sharded": 234}
    assert by_name["rescore_e2e"]["launches"] == 52
    assert by_name["rescore_e2e_rev_uniform"]["launches_by_path"][
        "sharded"] == 0
    for k in line:
        assert KERNEL_KEYS <= set(k)
    assert "sharded" in chip_smoke.REFERENCE_RUNS
    assert "sharded" not in chip_smoke.SCALE_RUNS
    assert len(chip_smoke.SHARDED_SHA256) == 64
    assert chip_smoke.SIDE_TAGS["sharded"] == ("[sharded]",)


def test_kernels_line_counts_the_alignment_rescore():
    """B12's two forms (rescore_align, rescore_align_rev) are entries of
    their own, replacing the JAX package's host loop of mode 2, with their
    launches on the fixture runs at --rescore-mode 2 and on protein x400
    at mode 2 as paths of their own; --cpu-reference takes "align"."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    m = {"max_abs_err": 0, "ms": 0.05, "plain_ms": 3.0, "bound_ms": 0.01,
         "bound_by": "bytes", "bytes": 1000}
    launches = {"assemble": {"seg_scan": 78, "rescore_e2e": 13},
                "rescore_mode_2": {"seg_scan": 126, "rescore_align": 13,
                                   "rescore_align_rev": 8},
                "rescore_mode_2_x400": {"seg_scan": 78, "rescore_align": 13}}
    kernels = chip_smoke.kernels_summary(
        dict(m, copy_ms=0.06, elements=100), m,
        {n: m for n in ("rescore_e2e_rev", "rescore_e2e_rev_uniform")},
        launches, align={n: dict(m, operations=4000)
                         for n in ("rescore_align", "rescore_align_rev")})
    line = json.loads(json.dumps({"kernels": kernels}))["kernels"]
    by_name = {k["name"]: k for k in line}
    assert list(by_name)[-2:] == ["rescore_align", "rescore_align_rev"]
    for name in ("rescore_align", "rescore_align_rev"):
        k = by_name[name]
        assert KERNEL_KEYS <= set(k) and k["library_ms"] is None
        assert k["operations"] == 4000
        assert k["source"] == "plass_tpu_torch/csrc/rescore.cu"
        ref_file, ref_line = k["replaces"].split(":")
        text = open(os.path.join(ROOT, ref_file)).read().splitlines()
        assert "RESCORE_ALIGNMENT" in text[int(ref_line) - 1]
    assert by_name["rescore_align"]["launches_by_path"] == {
        "assemble": 0, "rescore_mode_2": 13, "rescore_mode_2_x400": 13}
    assert by_name["rescore_align_rev"]["launches"] == 8
    assert by_name["rescore_e2e"]["launches"] == 13
    assert "align" in chip_smoke.REFERENCE_RUNS
    assert "align" not in chip_smoke.SCALE_RUNS
    assert chip_smoke.SIDE_TAGS["align-scale"] == ("[align-scale]",)
