"""chip_smoke.py, the port's GPU smoke run, on a machine without a card:
its CPU rehearsal drives every phase at a tiny size (the split matcher's
phases included) and prints no result;
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
                "cpu", "[sw-main] B9 on the contigs' ",
                "[sw-main] B9 on the families' ", "[sw-main] B9 on "
                "search-aa's ", "candidate pairs of search-aa's align stage",
                "failing the E-value test", "[sw-main] B9 on 28 "
                "edge pairs", "equal to the plain version and to the native "
                "ssw", "[hamming] plass assemble --rescore-mode 0",
                "[hamming] penguin nuclassemble --rescore-mode 0",
                "[hamming] rescore_hamming on", "[hamming] "
                "rescore_hamming_rev on",
                "[nucl-large] 3000 reads", "equal hits, sha256",
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
