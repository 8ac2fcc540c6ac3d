"""Tests of the benchmark's harness and reference, on the CPU at a tiny
size, through the port's CPU path (the kernels' plain versions):

    python -m pytest perfbench/tests -q
"""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# each cell's traffic at a size a test can hold: (sequences, genomes)
TINY = {"orfs-500k": (3000, 30), "reads-500k": (3000, 3),
        "contigs-25k": (120, 3)}


def shrink(traffic, name):
    n, g = TINY.get(name, (2000, 3))
    return dict(traffic, sequences=n,
                community=dict(traffic["community"], genomes=g))


def make_root(path):
    """A checkout's benchmark files with every traffic at a tiny size."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), path)
    for sub in ("configs", "traffic"):
        shutil.copytree(os.path.join(ROOT, "perfbench", sub),
                        os.path.join(path, "perfbench", sub))
    tdir = os.path.join(path, "perfbench", "traffic")
    for f in os.listdir(tdir):
        p = os.path.join(tdir, f)
        with open(p) as fh:
            t = json.load(fh)
        with open(p, "w") as fh:
            json.dump(shrink(t, f[:-5]), fh)
    return str(path)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return [w["name"] for w in json.load(fh)["workloads"]]
