"""The plain reference against the port, the control and the planted
faults that `correct` has to catch, on the CPU at a tiny size."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, cells
from perfbench import compare, generate, reference, run
from perfbench.entries import device_step
from perfbench.readings import control_step


def _cell(root, name):
    _, cfg, traffic = run.resolve(root, run.load_spec(root), name)
    return cfg, traffic


@pytest.mark.parametrize("name", cells())
def test_port_step_equals_reference(tiny_root, name):
    cfg, traffic = _cell(tiny_root, name)
    db = generate.make_db(traffic, 2 ** 40 + 3, "cpu")
    out = device_step.prepare(cfg, db, "cpu")()
    ref = reference.reference_step(db, cfg, "cpu")
    nums = compare.step_numbers(*out, *ref)
    assert len(ref[0][0]) > 50 and len(ref[1]["qk"]) > db.size
    assert nums["hit_mismatches"] == 0
    assert nums["record_mismatches"] == 0
    assert nums["eval_rel_gap"] <= cfg["limits"]["eval_rel_gap"]
    if cfg["dbtype"] == "nucleotide":
        assert (ref[0][2] < 0).any(), "no reverse-strand hit"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference, perfbench.generate, "
            "perfbench.compare, perfbench.counts; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('plass_tpu_torch', 'plass_tpu', 'jax', 'jaxlib', 'flax')); "
            "print(bad); sys.exit(1 if bad else 0)" % ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for f in ("reference.py", "generate.py", "compare.py", "counts.py"):
        with open(os.path.join(ROOT, "perfbench", f)) as fh:
            assert "plass_tpu" not in fh.read().replace(
                "plass_tpu_torch.ops.backend", "")


def test_xxh64_matches_the_port():
    from plass_tpu_torch.ops.hashes import xxh64_u64_np
    v = np.random.default_rng(5).integers(0, 2 ** 63, 4096, dtype=np.int64)
    v[:3] = (0, 1, 2 ** 63 - 1)
    for seed in (67, 68):
        got = reference.xxh64_u64(torch.from_numpy(v), seed).numpy()
        want = xxh64_u64_np(v.astype(np.uint64), seed).view(np.int64)
        np.testing.assert_array_equal(got, want)


def test_tables_equal_the_port_constants():
    from plass_tpu_torch import constants
    t = reference.tables()
    for name, m in (("reduced13", constants.reduced(13)),
                    ("blosum62", constants.blosum62()),
                    ("nucleotide", constants.nucleotide())):
        assert t[name]["letters"] == m.letters
        np.testing.assert_array_equal(t[name]["aa2num"], m.aa2num)
        if "sub" in t[name]:
            np.testing.assert_array_equal(t[name]["sub"], m.sub)
    np.testing.assert_array_equal(t["nucleotide"]["reverse"],
                                  constants.nucleotide().reverse)
    for name, v in t["evalue"].items():
        assert v == [float(x) for x in constants.evalue_params(name)]


def test_orfs_translate_with_table_one():
    from plass_tpu_torch import constants
    codes = constants.genetic_codes()
    lut, _ = codes[1]
    cls = codes["nucl_class"]
    got = generate._table1_acgt()
    for c in range(64):
        b = [ord("ACGT"[x]) for x in (c >> 4, (c >> 2) & 3, c & 3)]
        assert got[c] == lut[cls[b[0]], cls[b[1]], cls[b[2]]]


@pytest.mark.parametrize("name", cells())
def test_control_is_not_correct(tiny_root, name):
    """The reference with float32 E-values in the program's place."""
    r = run.run_cell(tiny_root, name, 11, 0.0, False, "cpu",
                     program=control_step)
    assert not r["correct"]
    assert r["checks"]["eval_rel_gap"]["value"] > \
        r["checks"]["eval_rel_gap"]["limit"]


def _alter_hit(out):
    rep, tgt, score, diag, n, ranges = out
    diag = diag.clone()
    diag[len(diag) // 2] += 1
    return rep, tgt, score, diag, n, ranges


def _drop_half(out):
    rep, tgt, score, diag, n, ranges = out
    keep = torch.arange(len(rep)) % 2 == 0
    return rep[keep], tgt[keep], score[keep], diag[keep], n, ranges


@pytest.mark.parametrize("name", cells())
@pytest.mark.parametrize("fault", ["hit_altered", "half_left_out",
                                   "record_altered"])
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, fault, name):
    """The timed path broken underneath: a hit's diagonal altered or half
    of the hits left out where the matcher makes them, a record's score
    altered where the rescore makes it."""
    from plass_tpu_torch.ops import backend, device_kmer
    if fault == "record_altered":
        finish = backend._rescore_finish

        def broken(*a, **k):
            rec, keep = finish(*a, **k)
            i = np.nonzero(keep)[0][-1]
            rec["score"][i] += 1
            return rec, keep
        monkeypatch.setattr(backend, "_rescore_finish", broken)
    else:
        match = device_kmer.kmermatch_device
        alter = _alter_hit if fault == "hit_altered" else _drop_half
        monkeypatch.setattr(device_kmer, "kmermatch_device",
                            lambda *a, **k: alter(match(*a, **k)))
    r = run.run_cell(tiny_root, name, 12, 0.0, False, "cpu")
    assert not r["correct"] and r["failed"] == r["attempted"] >= 1
    key = "record_mismatches" if fault == "record_altered" \
        else "hit_mismatches"
    assert r["checks"][key]["value"] > 0


def test_sound_run_is_correct(tiny_root):
    r = run.run_cell(tiny_root, "penguin-reads-500k", 13, 0.5, False, "cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert json.loads(json.dumps(r))["checks"]["hit_mismatches"] == \
        {"value": 0, "limit": 0}
