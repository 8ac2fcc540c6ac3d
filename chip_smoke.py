"""Smoke run of the PyTorch/CUDA port (plass_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. environment: versions, the card's name and power limit, the kernel
     builds (nvcc, from csrc/ in this checkout) and the host C++ build;
  2. kernel K1 (segmented scan) against its plain PyTorch version on the
     card, exact, at 1,031 and 24M elements;
  4. the fixture assembly through the CLI, byte for byte against the
     committed golden, then with default parameters;
  5. a default assembly of 409,600 reads (the 512 fixture reads x800 with
     1.5% seeded substitutions), with per-stage seconds;
  3. both kernels at the shapes of phase 5's iteration 0: the matcher
     with K1 equals the matcher with K1's plain version, and K2 equals its
     plain version on the real hits and on synthetic edge cases (exact);
     the table's first-carry scan and the real rescore are timed.
The kernels' launch counters are set to 0 just before phase 5 and read
just after; both kernels must have run there. The last lines are a JSON
summary of the kernels, the card's name and power limit, and
{"ok": true, "device": {...}}.

--cpu-rehearsal runs every phase on the CPU at a tiny size (the kernels'
plain versions against themselves) to check the script itself; it never
prints a result and exits with code 2.
"""
import argparse
import gzip
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
GOLDEN = os.path.join(FIX, "mini_golden_protein.fas")


def say(*parts):
    print(*parts, flush=True)


def smi():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def cuda_ms(fn, reps, device):
    """Mean milliseconds of fn() over reps launches, by CUDA events."""
    import torch
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def max_abs_err(got, want):
    import torch
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


# ---------------------------------------------------------------------------

def phase_env(device, rehearsal):
    import torch
    from plass_tpu_torch import native
    from plass_tpu_torch.kernels import build

    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    say(f"[env] card: {smi()}")
    if not rehearsal:
        for name in ("seg_scan", "rescore"):
            info = build.build(name)
            say(f"[env] built {os.path.relpath(info.path, ROOT)} in "
                f"{info.seconds:.1f} s")
            for line in info.log.splitlines():
                if "registers" in line or "spill" in line:
                    say(f"[env]   ptxas: {line.strip()}")
            build.load(name)
    t0 = time.perf_counter()
    native.lib()
    say(f"[env] host library ready in {time.perf_counter() - t0:.1f} s")


def phase_k1(device, sizes, reps):
    """K1 against its plain version: every kind, direction and column
    count, three segment densities; times at the largest size."""
    import torch
    from plass_tpu_torch.ops.seg_scan import seg_scan, seg_scan_plain

    combos = [(k, nv) for k in ("first", "cummax") for nv in (1, 2, 3)] + \
        [("sfx2", 2), ("sfx2", 3)]
    worst = 0
    checked = 0
    for t in sizes:
        rng = np.random.default_rng(t)
        vals = [torch.from_numpy(rng.integers(-2**31, 2**31, t, dtype=np.int64)
                                 .astype(np.int32)).to(device)]
        # sfx2 keys: few distinct counts so that ties happen
        vals.append(torch.from_numpy(rng.integers(-1, 2**24, t)
                                     .astype(np.int32)).to(device))
        vals.append(torch.from_numpy(rng.integers(-2**31, 2**31, t,
                                                  dtype=np.int64)
                                     .astype(np.int32)).to(device))
        small = torch.from_numpy(rng.integers(-1, 50, t).astype(np.int32)) \
            .to(device)
        for dens in (0.005, 0.05, 0.5):
            fl = rng.random(t) < dens
            for reverse in (False, True):
                f = fl.copy()
                f[-1 if reverse else 0] = True
                flag = torch.from_numpy(f).to(device)
                for kind, nv in combos:
                    cols = ([small] + vals[1:nv]) if kind == "sfx2" \
                        else vals[:nv]
                    got = seg_scan(kind, flag, *cols, reverse=reverse)
                    want = seg_scan_plain(kind, flag, *cols, reverse=reverse)
                    err = max_abs_err(got, want)
                    worst = max(worst, err)
                    checked += 1
                    if err:
                        raise AssertionError(
                            f"K1 {kind} nv={nv} reverse={reverse} T={t} "
                            f"density={dens}: max |err| {err}")
                    timed = (t == sizes[-1] and dens == 0.05 and
                             (kind, nv, reverse) in (("first", 3, False),
                                                     ("cummax", 1, True),
                                                     ("sfx2", 3, True)))
                    if timed:
                        ms = cuda_ms(lambda: seg_scan(
                            kind, flag, *cols, reverse=reverse), reps, device)
                        pms = cuda_ms(lambda: seg_scan_plain(
                            kind, flag, *cols, reverse=reverse), reps, device)
                        say(f"[k1] T={t} {kind} nvals={nv} "
                            f"{'reverse' if reverse else 'forward'}: kernel "
                            f"{ms:.4f} ms, plain {pms:.4f} ms")
        say(f"[k1] T={t}: all kinds/directions/densities equal")
    say(f"[k1] {checked} comparisons, max |err| {worst}")
    return worst


def fixture_cli(out_dir, extra, device):
    from plass_tpu_torch.cli.plass import run
    out = os.path.join(out_dir, "assembly.fas")
    rc = run(["assemble", *READS, out, os.path.join(out_dir, "tmp"),
              "--device", str(device), *extra])
    if rc != 0:
        raise AssertionError(f"CLI exit code {rc}")
    return out


def phase_fixture(device, work):
    from plass_tpu_torch.ops import rescore_kernel, seg_scan

    before = (seg_scan.LAUNCHES, rescore_kernel.LAUNCHES)
    out = fixture_cli(os.path.join(work, "fix2"),
                      ["--num-iterations", "2", "--filter-proteins", "0"],
                      device)
    if open(out, "rb").read() != open(GOLDEN, "rb").read():
        raise AssertionError("fixture assembly differs from "
                             "tests/fixtures/mini_golden_protein.fas")
    say("[fixture] 2 iterations, filter 0: byte-identical to the golden")
    t0 = time.perf_counter()
    out = fixture_cli(os.path.join(work, "fix12"), [], device)
    n = sum(1 for line in open(out) if line.startswith(">"))
    say(f"[fixture] default parameters (12 iterations, filter on): {n} "
        f"contigs in {time.perf_counter() - t0:.1f} s")
    after = (seg_scan.LAUNCHES, rescore_kernel.LAUNCHES)
    if device.type == "cuda" and not (after[0] > before[0]
                                      and after[1] > before[1]):
        raise AssertionError(f"kernel launch counters did not rise: "
                             f"{before} -> {after}")
    say(f"[fixture] launches: seg_scan {after[0] - before[0]}, "
        f"rescore_e2e {after[1] - before[1]}")


def make_reads(path, copies, seed=42):
    """Single-end FASTA: the 512 fixture reads x copies; every copy after
    the first with 1.5% seeded ACGT substitutions."""
    seqs = []
    for f in READS:
        lines = gzip.open(f, "rt").read().splitlines()
        seqs += [s.encode() for s in lines[1::4]]
    base = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    lens = np.array([len(s) for s in seqs])
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(seed)
    key = 0
    with open(path, "wb") as fh:
        for c in range(copies):
            s = base.copy()
            if c:
                mask = rng.random(len(s)) < 0.015
                s[mask] = acgt[rng.integers(0, 4, int(mask.sum()))]
            raw = s.tobytes()
            fh.write(b"".join(b">%d\n%s\n" % (key + i, raw[a:a + n])
                              for i, (a, n) in enumerate(zip(starts, lens))))
            key += len(seqs)
    return key


def phase_scale(device, work, copies):
    import torch
    from plass_tpu_torch.cli.plass import run
    from plass_tpu_torch.ops import rescore_kernel, seg_scan

    t0 = time.perf_counter()
    fasta = os.path.join(work, "reads.fasta")
    n_reads = make_reads(fasta, copies)
    say(f"[scale] {n_reads} reads written in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(work, "scale", "assembly.fas")
    tmp = os.path.join(work, "scale", "tmp")
    stats = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    seg_scan.LAUNCHES = 0
    rescore_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = run(["assemble", fasta, out, tmp, "--device", str(device)],
             stats=stats)
    wall = time.perf_counter() - t0
    launches = {"seg_scan": seg_scan.LAUNCHES,
                "rescore_e2e": rescore_kernel.LAUNCHES}
    if rc != 0:
        raise AssertionError(f"CLI exit code {rc}")
    lines = open(out).read().splitlines()
    heads, body = lines[0::2], lines[1::2]
    for h, s in zip(heads, body):
        if not h.startswith(">") or not h.endswith(f" len:{len(s)}"):
            raise AssertionError(f"malformed FASTA record {h!r}")
    if not body:
        raise AssertionError("the assembly produced no contigs")
    digest = hashlib.sha256(open(out, "rb").read()).hexdigest()
    say(f"[scale] reads {stats['reads']}, ORFs {stats['orfs']}, "
        f"iteration-0 table entries {stats['table_entries']}, "
        f"iteration-0 hits {stats['hits']}")
    say("[scale] seconds per stage: " + ", ".join(
        f"{k} {v:.2f}" for k, v in stats["seconds"].items()))
    say(f"[scale] wall {wall:.1f} s, {stats['reads'] / wall:.0f} reads/s, "
        f"{len(body)} contigs, sha256 {digest}")
    say(f"[scale] launches: seg_scan {launches['seg_scan']}, rescore_e2e "
        f"{launches['rescore_e2e']}")
    if device.type == "cuda":
        say(f"[scale] max_memory_allocated "
            f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
        if min(launches.values()) == 0:
            raise AssertionError(f"a kernel of the main path never launched: "
                                 f"{launches}")
    return launches, os.path.join(tmp, "latest", "aa_6f_start_long")


def _edge_case_rows(device):
    """Synthetic K2 inputs: '*' at j=0 and at ov-1, no overlap (ov <= 0),
    rows longer than 1024, lower-case letters."""
    import torch
    from plass_tpu_torch import constants

    rng = np.random.default_rng(7)
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX", dtype=np.uint8)
    lens = [40, 40, 3000, 2500, 1, 2, 1500, 64]
    width = max(lens)
    chars = np.zeros((len(lens), width), dtype=np.uint8)
    for i, n in enumerate(lens):
        chars[i, :n] = letters[rng.integers(0, len(letters), n)]
    chars[0, 0] = chars[1, 39] = chars[2, 0] = chars[2, 2999] = ord("*")
    chars[3, 100] = chars[5, 0] = ord("*")
    chars[7, :32] = np.char.lower(chars[7, :32].view("S1")).view(np.uint8)
    codes = constants.blosum62().aa2num[chars].astype(np.uint8)
    codes[chars == 0] = 20
    q, t, d = [], [], []
    for a in range(len(lens)):
        for b in range(len(lens)):
            for dg in (0, 1, -1, 5, -5, 39, -39, 40, -40, 1499, -2499, 2999,
                       -2999, 3000, -3000):
                q.append(a)
                t.append(b)
                d.append(dg)
    i32 = lambda x: torch.tensor(np.asarray(x, dtype=np.int32), device=device)
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(chars).to(device), i32(lens), i32(q), i32(t),
            i32(d))


def phase_main_shapes(device, db_path, reps):
    """K1 and K2 at the shapes of phase 5's iteration 0 (its first match
    and rescore): the matcher with every scan in the kernel equals the
    matcher with every scan in the plain version; the table's first-carry
    scan and the rescore of the real hits are timed against their plain
    versions; K2 also runs on synthetic edge cases."""
    import torch
    from plass_tpu_torch import constants
    from plass_tpu_torch.data import seqdb
    from plass_tpu_torch.ops import device_kmer
    from plass_tpu_torch.ops.backend import db_to_padded, kmermatcher_torch
    from plass_tpu_torch.ops.rescore_kernel import (rescore_e2e,
                                                    rescore_e2e_plain)
    from plass_tpu_torch.ops.seg_scan import seg_scan, seg_scan_plain

    db = seqdb.SeqDB.open(db_path)
    kw = dict(kmers_per_sequence=60, hash_shift=67, ignore_multi_kmer=True,
              include_only_extendable=False)
    hits = kmermatcher_torch(db, 14, device, **kw)
    device_kmer.seg_scan = seg_scan_plain
    try:
        plain_hits = kmermatcher_torch(db, 14, device, **kw)
    finally:
        device_kmer.seg_scan = seg_scan
    k1_err = max(int(np.abs(np.asarray(g, np.int64)
                            - np.asarray(w, np.int64)).max(initial=0))
                 for g, w in zip(hits, plain_hits))
    if k1_err or len(hits[0]) != len(plain_hits[0]):
        raise AssertionError(f"K1 in the matcher: max |err| {k1_err}")
    say(f"[main] matcher on {db.size} ORFs ({hits.table_entries} table "
        f"entries, {len(hits.hit_slots)} hits): kernel scans equal plain")
    codes_k, lengths = db_to_padded(db, "kmer", min_width=14)
    table = device_kmer.build_table(
        torch.from_numpy(codes_k).to(device),
        torch.from_numpy(lengths).to(device),
        torch.from_numpy(db.keys.astype(np.int32)).to(device),
        device_kmer.KmerParams(k=14, alphabet_size=13, kmers_per_sequence=60,
                               kmers_per_sequence_scale=0.0, ksel=60), 67)
    cols = device_kmer.sort_table(*table)
    k1_ms = cuda_ms(lambda: seg_scan("first", *cols), reps, device)
    k1_pms = cuda_ms(lambda: seg_scan_plain("first", *cols), reps, device)
    say(f"[main] K1 first-carry, 3 columns, T={cols[0].numel()}: kernel "
        f"{k1_ms:.4f} ms, plain {k1_pms:.4f} ms")

    sub = torch.from_numpy(constants.blosum62().sub.astype(np.int32)) \
        .to(device)
    rep, tgt, diag = hits.dev
    lut = torch.from_numpy(db.id_lookup_array().astype(np.int64)).to(device)
    codes, _ = db_to_padded(db, "score")
    chars, _ = db_to_padded(db, "char")
    args = (torch.from_numpy(codes).to(device),
            torch.from_numpy(chars).to(device),
            torch.from_numpy(lengths).to(device),
            lut[rep.long()].to(torch.int32), lut[tgt.long()].to(torch.int32),
            diag.contiguous(), sub)
    err = max_abs_err(rescore_e2e(*args), rescore_e2e_plain(*args))
    if err:
        raise AssertionError(f"K2 on real hits: max |err| {err}")
    n_hits = args[3].numel()
    say(f"[main] K2 on {n_hits} iteration-0 hits (width {codes.shape[1]}): "
        f"equal to the plain version")
    k2_ms = cuda_ms(lambda: rescore_e2e(*args), reps, device)
    k2_pms = cuda_ms(lambda: rescore_e2e_plain(*args), reps, device)
    say(f"[main] K2 {n_hits} hits: kernel {k2_ms:.4f} ms, plain "
        f"{k2_pms:.4f} ms")
    edge = _edge_case_rows(device) + (sub,)
    want = rescore_e2e_plain(*edge)
    e2 = max_abs_err(rescore_e2e(*edge), want)
    if e2:
        raise AssertionError(f"K2 on edge cases: max |err| {e2}")
    say(f"[main] K2 on {edge[3].numel()} synthetic edge-case hits "
        f"({int((want[1] == -1).sum())} with no overlap, rows up to 3000): "
        f"equal to the plain version")
    return (k1_err, (k1_ms, k1_pms)), (max(err, e2), (k2_ms, k2_pms))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase on the CPU at a tiny size; "
                         "prints no result, exits 2")
    args = ap.parse_args()

    import torch
    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from plass_tpu_torch.utils.device import pick_device
    device = pick_device("cpu" if rehearsal else "cuda")

    phase_env(device, rehearsal)
    reps = 2 if rehearsal else 20
    k1_err = phase_k1(
        device, [2**10 + 7, 3 * 2**12 if rehearsal else 24 * 2**20], reps)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as work:
        phase_fixture(device, work)
        launches, db_path = phase_scale(device, work, 4 if rehearsal else 800)
        (k1_main_err, k1_times), (k2_err, k2_times) = phase_main_shapes(
            device, db_path, reps)
    k1_err = max(k1_err, k1_main_err)

    if rehearsal:
        say("[rehearsal] all phases ran on the CPU; no result")
        return 2
    kernels = [
        {"name": "seg_scan", "route": "cuda",
         "source": "plass_tpu_torch/csrc/seg_scan.cu",
         "replaces": "plass_tpu/ops/pallas_scan.py:168",
         "launches": launches["seg_scan"], "max_abs_err": k1_err,
         "ms": k1_times[0], "plain_ms": k1_times[1]},
        {"name": "rescore_e2e", "route": "cuda",
         "source": "plass_tpu_torch/csrc/rescore.cu",
         "replaces": "plass_tpu/ops/pallas_rescore.py:449",
         "launches": launches["rescore_e2e"], "max_abs_err": k2_err,
         "ms": k2_times[0], "plain_ms": k2_times[1]},
    ]
    say(json.dumps({"kernels": kernels}))
    say(smi())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
