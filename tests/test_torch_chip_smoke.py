"""chip_smoke.py, the port's GPU smoke run, on a machine without a card:
its CPU rehearsal drives every phase at a tiny size and prints no result;
run alone, outside the repo, it fails without printing a result."""
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
                "[nucl-main] K2 rescore_e2e_rev ", "[rehearsal]"):
        assert tag in out, out
    assert '"ok"' not in out


def test_alone_it_fails_without_a_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
