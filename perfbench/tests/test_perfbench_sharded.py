"""The sharded cell's entry (perfbench/entries/sharded_step.py) on the CPU
at a tiny size, four ranks over gloo: run_cell reads `correct` against the
reference and the entry's ranks exit 0 once the step is dropped; a rank
holding another DB fails the digest on every rank; a rank killed between
steps makes rank 0 raise within a short PLASS_DIST_TIMEOUT and leaves no
process behind; faults planted on rank 0, in its hits or its exchanges,
are not correct; and the cell's four readers on a hand-made record."""
import gc
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import generate, run, trace
from perfbench.entries import sharded_step
from perfbench.metrics import (allrank_host_ms, exchange_mb, exchange_ms,
                               nccl_ms)

CELL = "plass-orfs-sharded4"
SEED = 2 ** 35 + 7
WORLD = 4


def test_cell_is_correct_and_its_ranks_exit(tiny_root):
    procs = []

    def program(cfg, db, device):
        step = sharded_step.prepare(cfg, db, device)
        procs.extend(step.procs)
        return step

    r = run.run_cell(tiny_root, CELL, SEED, 0.0, True, "cpu",
                     program=program)
    assert r["correct"], r["checks"]
    assert r["sizes"]["hits"] > 0
    m = r["metrics"]
    assert m["exchange_ms"]["value"] > 0
    assert m["exchange_mb"]["value"] > 0
    assert m["allrank_host_ms"]["value"] > 0
    assert "nccl_ms" not in m          # gloo: no NCCL kernel
    assert len(procs) == WORLD - 1
    assert [p.returncode for p in procs] == [0] * (WORLD - 1)


def _broken_hits(fault):
    """device_kmer._hits with a hit's diagonal altered or half of the hits
    left out, where each rank's part of the matcher makes them."""
    from plass_tpu_torch.ops import device_kmer
    hits = device_kmer._hits

    def broken(*a, **k):
        rep, tgt, score, diag = hits(*a, **k)
        if fault == "half_left_out":
            keep = torch.arange(len(rep)) % 2 == 0
            return rep[keep], tgt[keep], score[keep], diag[keep]
        diag = diag.clone()
        diag[len(diag) // 2] += 1
        return rep, tgt, score, diag

    return device_kmer, "_hits", broken


def _dropped_exchange(which):
    """mesh.exchange with the later half of what the exchange `which`
    brings in left out: the entries that the last ranks sent."""
    from plass_tpu_torch.parallel import mesh
    exchange = mesh.exchange

    def dropped(fields, dest, world, stats=None, name="exchange"):
        got = exchange(fields, dest, world, stats, name)
        return [f[:len(f) // 2] for f in got] if name == which else got

    return mesh, "exchange", dropped


FAULTS = {
    "hit_altered": lambda: _broken_hits("hit_altered"),
    "half_left_out": lambda: _broken_hits("half_left_out"),
    "table_exchange_cut": lambda: _dropped_exchange("table"),
    "pair_exchange_cut": lambda: _dropped_exchange("pairs"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_on_rank_zero_is_not_correct(tiny_root, monkeypatch, fault):
    """The sharded path broken underneath on rank 0 (this process): a
    hit's diagonal altered or half of its hits left out where its part of
    the matcher makes them, or half of what its table or pair exchange
    receives left out."""
    monkeypatch.setattr(*FAULTS[fault]())
    r = run.run_cell(tiny_root, CELL, SEED, 0.0, False, "cpu")
    assert not r["correct"] and r["failed"] == r["attempted"] >= 1
    assert r["checks"]["hit_mismatches"]["value"] > 0


def _cell(tiny_root, seed=SEED):
    _, cfg, traffic = run.resolve(tiny_root, run.load_spec(tiny_root), CELL)
    return cfg, generate.make_db(traffic, seed, "cpu")


def test_a_rank_with_another_db_fails_the_digest(tiny_root, tmp_path):
    cfg, db = _cell(tiny_root)
    _, other = _cell(tiny_root, SEED + 1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(WORLD):
        d = tmp_path / f"rank{rank}"
        d.mkdir()
        for name in sharded_step.ARRAYS:
            np.save(d / f"{name}.npy", getattr(other if rank == 2 else db,
                                               name))
        with open(d / "job.json", "w") as fh:
            json.dump({"cfg": cfg, "db": str(d), "device": "cpu",
                       "parent": os.getpid()}, fh)
        env = dict(os.environ, PLASS_COORDINATOR=f"127.0.0.1:{port}",
                   PLASS_NUM_PROCESSES=str(WORLD), PLASS_PROCESS_ID=str(rank),
                   PLASS_DIST_TIMEOUT="30", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, sharded_step.__file__, str(d / "job.json")],
            env=env, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode != 0
        assert "ranks [2] hold another DB than rank 0" in out, out[-2000:]


def test_a_killed_rank_makes_rank_zero_raise(tiny_root, monkeypatch):
    monkeypatch.setenv("PLASS_DIST_TIMEOUT", "30")
    cfg, db = _cell(tiny_root)
    step = sharded_step.prepare(cfg, db, "cpu")
    procs = step.procs
    try:
        step()
        procs[1].kill()
        procs[1].wait()
        # rank 0 goes into the step's collectives without telling the
        # others, as though rank 2 had died inside the step
        with monkeypatch.context() as m:
            m.setattr(sharded_step._Ranks, "step", lambda self: None)
            t0 = time.perf_counter()
            with pytest.raises(RuntimeError):
                step()
            assert time.perf_counter() - t0 < 75
        # and a dead rank is found before the next step starts
        with pytest.raises(RuntimeError, match="rank 2 exited"):
            step()
    finally:
        del step
        gc.collect()
    assert all(p.poll() is not None for p in procs)
    assert procs[0].returncode == 0 and procs[2].returncode == 0


def _record():
    """Two steps of rank 0 in a window from 0 to 1,000,000 microseconds."""
    ua = "user_annotation"
    rec = trace.Record(steps=2, spans={
        "kmermatch": [], "rescore": [],
        "exchange_bytes": [{"table": 3e6, "pairs": 2e6, "gather": 1e6},
                           {"table": 2e6, "pairs": 1e6, "gather": 1e6}]})
    rec.window = (0.0, 1_000_000.0)
    for base in (1_000, 501_000):
        rec.host += [
            (ua, "kmermatch", base, base + 300_000),
            (ua, "kmermatch.table", base, base + 10_000),
            (ua, "kmermatch.exchange.table", base + 10_000, base + 40_000),
            (ua, "kmermatch.pairs", base + 40_000, base + 50_000),
            (ua, "kmermatch.exchange.pairs", base + 50_000, base + 70_000),
            (ua, "kmermatch.hits", base + 70_000, base + 80_000),
            (ua, "kmermatch.rank_rescore", base + 80_000, base + 81_000),
            (ua, "kmermatch.exchange.gather", base + 81_000, base + 91_000),
            (ua, "kmermatch.order", base + 91_000, base + 151_000),
            (ua, "kmermatch.self_hits", base + 151_000, base + 200_000),
            (ua, "rescore.index", base + 300_000, base + 320_000),
            (ua, "rescore.pre", base + 320_000, base + 325_000),
            (ua, "rescore.launch", base + 325_000, base + 330_000),
            (ua, "rescore.finish", base + 330_000, base + 430_000),
            (ua, "rescore.group", base + 430_000, base + 480_000),
        ]
        rec.device += [
            ("kernel", "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)",
             base + 20_000, base + 25_000, {}),
            ("kernel", "ncclKernel_AllGather_RING_LL_Sum_int8_t",
             base + 85_000, base + 87_000, {}),
            ("kernel", "rescore_e2e_kernel", base + 80_500, base + 80_900,
             {}),
            ("gpu_memcpy", "Memcpy DtoD (Device -> Device)", base + 88_000,
             base + 89_000, {}),
        ]
    return rec


@pytest.mark.parametrize("reader,want", [
    # exchanges 30 + 20 and the gather 10
    (exchange_ms, 60.0),
    # the two NCCL kernels, 5 + 2
    (nccl_ms, 7.0),
    # 6 and 4 MB
    (exchange_mb, 5.0),
    # order 60 + self hits 49 + index 20 + pre 5 + finish 100 + group 50
    (allrank_host_ms, 284.0),
])
def test_sharded_readers(reader, want):
    assert reader.read(_record()) == pytest.approx(want)


@pytest.mark.parametrize("reader", [exchange_ms, nccl_ms, exchange_mb,
                                    allrank_host_ms])
def test_sharded_readers_return_none_without_spans(reader):
    rec = _record()
    # a program without the spans, a run without NCCL, an entry without
    # the byte counts
    rec.host = [e for e in rec.host if "." not in e[1]]
    rec.device = [e for e in rec.device if "nccl" not in e[1]]
    rec.spans = {"kmermatch": [], "rescore": []}
    assert reader.read(rec) is None
    assert reader.read(trace.Record(steps=1, spans={})) is None


def test_a_rank_keeps_the_memory_it_frees_until_told_not_to():
    """A freed 256 MiB array stays in the process (its pages resident)
    while the rank keeps freed memory, and goes back when it stops."""
    code = """if True:
        import numpy as np
        from perfbench.entries import sharded_step

        def rss():
            with open("/proc/self/statm") as fh:
                return int(fh.read().split()[1]) * 4096 / 2 ** 20

        sharded_step.keep_freed_memory()
        a = np.ones(2 ** 25)
        before = rss()
        del a
        kept = rss()
        sharded_step.keep_freed_memory(False)
        print(before - kept, kept - rss())
    """
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    held, handed_back = map(float, out.stdout.split())
    assert held < 16 and handed_back > 200
