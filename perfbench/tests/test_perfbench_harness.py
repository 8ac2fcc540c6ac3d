"""The harness: cells found by name, the generator's DB handed on
unchanged, the module check, the exits without a card, the counts and
the trace readers."""
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, cells
from perfbench import counts, generate, run, trace
from perfbench.metrics import (device_idle_pct, h2d_mb, k1_roofline,
                               k2_roofline, kmermatch_ms, rescore_ms)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_finds_everything_by_name():
    spec = run.load_spec(ROOT)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and os.path.exists(
            os.path.join(ROOT, c["file"]))
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        run.resolve(ROOT, spec, w["name"])
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "perfbench", "metrics",
                                           m["name"] + ".py"))
        assert m["moves"] == "step_ms"
    assert [m["name"] for m in spec["end_to_end"]] == ["step_ms", "peak_gib",
                                                       "setup_s"]


def test_generator_db_reaches_the_program_unchanged(tiny_root, monkeypatch):
    from plass_tpu_torch.ops import backend
    seen = []
    match = backend.match_kmers

    def spy(db, *a, **k):
        seen.append(db)
        return match(db, *a, **k)

    monkeypatch.setattr(backend, "match_kmers", spy)
    r = run.run_cell(tiny_root, "plass-orfs-500k", 2 ** 35 + 1, 0.0, False,
                     "cpu")
    assert r["correct"]
    _, cfg, traffic = run.resolve(tiny_root, run.load_spec(tiny_root),
                                  "plass-orfs-500k")
    want = generate.make_db(traffic, 2 ** 35 + 1, "cpu")
    for db in seen:
        for a in ("data", "keys", "offsets", "lengths"):
            np.testing.assert_array_equal(getattr(db, a), getattr(want, a))


def test_a_new_config_and_workload_add_a_cell(tiny_root):
    """Only data: a configuration file, a traffic file and the entries in
    BENCHMARK.json."""
    pb = os.path.join(tiny_root, "perfbench")
    with open(os.path.join(pb, "configs", "plass-assemble.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "plass-assemble-k13"
    cfg["k"] = 13
    with open(os.path.join(pb, "configs", "plass-assemble-k13.json"),
              "w") as fh:
        json.dump(cfg, fh)
    shutil.copy(os.path.join(pb, "traffic", "orfs-500k.json"),
                os.path.join(pb, "traffic", "orfs-small.json"))
    path = os.path.join(tiny_root, "BENCHMARK.json")
    spec = run.load_spec(tiny_root)
    spec["configs"].append(dict(
        spec["configs"][0], name="plass-assemble-k13",
        file="perfbench/configs/plass-assemble-k13.json"))
    spec["workloads"].append({"name": "plass-k13", "config":
                              "plass-assemble-k13", "traffic": "orfs-small",
                              "chips": 1, "why": "a test"})
    with open(path, "w") as fh:
        json.dump(spec, fh)
    r = run.run_cell(tiny_root, "plass-k13", 5, 0.2, False, "cpu")
    assert r["correct"]
    assert set(r["metrics"]) == {"step_ms", "peak_gib", "setup_s"}


def test_traced_run_reports_the_span_metrics(tiny_root):
    r = run.run_cell(tiny_root, "penguin-contigs-25k", 6, 0.2, True, "cpu")
    assert r["correct"]
    assert {"kmermatch_ms", "rescore_ms"} <= set(r["metrics"])
    assert all(v["value"] > 0 for v in r["metrics"].values())


def test_module_check_compares_whole_top_level_names():
    assert run.forbidden_modules(["plass_tpu_torch", "plass_tpu_torch.ops",
                                  "numpy", "jaxtyping"]) == []
    assert run.forbidden_modules(["plass_tpu.ops.backend", "jax.numpy",
                                  "jaxlib", "flax.linen", "torch"]) == \
        ["flax", "jax", "jaxlib", "plass_tpu"]


def _run_script(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cells()[0],
         "--seed", str(2 ** 40), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run_script(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(tmp_path, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    proc = _run_script(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_counts_hold_the_recorded_figures():
    # K1's rows in the kernel table: the x400 table's first scan and a
    # 25,165,824-element one-column scan
    assert counts.scan_bytes(7_363_410, 3) == 184_085_250
    assert counts.scan_bytes(25_165_824, 1) == 226_492_416
    # a launch of 10 forward hits over 300 window residues on a DB of
    # 1,000 bytes in 8 rows, alphabet 21
    n, ops = counts.rescore_counts(1000, 8, 10, 300, False, 21)
    assert n == 600 + 8 * 12 + 10 * 12 + 256 + 21 * 21 * 4 + 4 * 4 * 10
    assert ops == 600
    # rows never count more than the DB holds; reverse hits add a byte
    n2, _ = counts.rescore_counts(100, 8, 10, 300, True, 5)
    assert n2 == 100 + 8 * 12 + 10 * 13 + 256 + 25 * 4 + 25 + 160


class _Ev:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _record():
    rec = trace.Record(steps=2, spans={"kmermatch": [0.1, 0.3],
                                       "rescore": [0.5, 0.7]})
    rec.window = (0.0, 1_000_000.0)
    s = {"stream": 7}
    rec.device = [
        ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 0, 1000,
         {"bytes": 3_000_000, **s}),
        ("gpu_memset", "Memset (Device)", 1000, 1010, s),
        ("kernel", "void scan_lookback<0, 3, false>", 1010, 1110, s),
        ("gpu_memset", "Memset (Device)", 2000, 2010, s),
        ("kernel", "void rescore_e2e_kernel<false, false, false>", 2010, 2060,
         s),
        ("kernel", "void rescore_e2e_kernel<false, false, true>", 2060, 2070,
         s),
        ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 3000, 3100,
         {"bytes": 5, **s}),
    ]
    rec.host = [("user_annotation", "rescore", 1500, 500_000),
                ("cpu_op", "aten::copy_", 1600, 1700)]
    return rec


def test_trace_readers():
    rec = _record()
    assert trace.window_seconds(rec) == 1.0
    assert trace.busy_seconds(rec) == pytest.approx(
        (1000 + 110 + 70 + 100) / 1e6)
    assert device_idle_pct.read(rec) == pytest.approx(
        100 * (1 - 1280 / 1e6))
    assert h2d_mb.read(rec) == pytest.approx(1.5)
    assert kmermatch_ms.read(rec) == pytest.approx(200.0)
    assert rescore_ms.read(rec) == pytest.approx(600.0)
    assert trace.kernel_seconds(rec, "scan_lookback") == \
        (1, pytest.approx(110e-6))
    assert trace.kernel_seconds(rec, "rescore_e2e_kernel") == \
        (1, pytest.approx(70e-6))
    rec.k1 = [trace.Launch({"n": 1_000_000, "ncols": 3})]
    want = counts.scan_bytes(1_000_000, 3) / counts.HBM_BYTES_PER_S
    assert k1_roofline.read(rec) == pytest.approx(100 * want / 110e-6)
    # the profiler saw another number of launches: CUDA events decide
    rec.k2 = [trace.Launch({"hits": 10, "window_residues": 300,
                            "rows_bytes": 1000, "n_seqs": 8,
                            "reverse": False, "alpha": 21},
                           (_Ev(0.0), _Ev(0.5))) for _ in range(2)]
    n, ops = counts.rescore_counts(1000, 8, 10, 300, False, 21)
    assert k2_roofline.read(rec) == pytest.approx(
        100 * 2 * counts.bound_seconds(n, ops) / 1e-3)
    b = trace.breakdown(rec)
    assert b["device_ops"][0][0].startswith("Memcpy HtoD")
    assert b["idle_gaps"][0][0] == "between:host"
    assert any(k.startswith("rescore:") for k, _ in b["idle_gaps"])


def test_readers_return_nothing_without_a_trace():
    rec = trace.Record(steps=1, spans={"kmermatch": [], "rescore": []})
    for m in (device_idle_pct, h2d_mb, k1_roofline, k2_roofline,
              kmermatch_ms, rescore_ms):
        assert m.read(rec) is None
