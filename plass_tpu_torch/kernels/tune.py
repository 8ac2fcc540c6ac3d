"""Times variants of the port's two CUDA kernels on one GPU.

    python -m plass_tpu_torch.kernels.tune

Each variant is the kernel's source with its tuning constants replaced
(K1: threads per block, 16-byte vectors per thread, resident blocks the
compiler plans for; K2: lanes per hit, long-window threshold), built with
the flags of kernels/build.py into the build directory, held against the
plain PyTorch version (exact) and timed with CUDA events on seeded data of
the main paths' sizes: 25,165,824-element scans; 317,648 hits on 100,000
reads of 150 nt, 426,248 hits on 217,020 ORFs of 20-89 aa, and 681,312 hits
on 100,000 contigs of up to 19,997 nt. The sources' own constants are the
first variant of each list. Prints one line per variant; needs nvcc and a
CUDA device.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from .. import BUILD_DIR, constants
from ..ops.rescore_kernel import (rescore_e2e, rescore_e2e_plain,
                                  uniform_pattern)
from ..ops.seg_scan import seg_scan, seg_scan_plain
from . import build

# (threads, vectors per thread, planned blocks per SM); vectors * warps <= 32
K1_VARIANTS = [(256, 4, 2), (256, 4, 3), (512, 2, 2), (512, 2, 1), (256, 2, 4),
               (128, 4, 4), (1024, 1, 1), (512, 1, 3)]
# (lanes per hit, long-window threshold)
K2_VARIANTS = [(2, 512), (8, 512), (4, 512), (1, 512), (2, 256), (2, 1024)]
K1_CONSTANTS = ("constexpr int kThreads = {};", "constexpr int kVecs = {};",
                "constexpr int kMinBlocks = {};")
K2_CONSTANTS = ("constexpr int kGroup = {};", "constexpr int kLongWindow = {};")


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps launches. The card is kept busy
    while the host enqueues them, so that they run back to back and the
    events time the kernels, not the rate the host launches them at."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1e6 * reps))   # about 0.6 ms per launch
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def differs(got, want):
    return sum(int(not torch.equal(g, w)) for g, w in zip(got, want))


def build_variants(name, constants_, variants):
    """Compile one library per variant, all nvcc processes at once. Returns
    {variant: ctypes library with the kernel's signatures}."""
    src = open(os.path.join(build.CSRC_DIR, name + ".cu")).read()
    out_dir = os.path.join(BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for v in variants:
        text = src
        for pattern, value, own in zip(constants_, v, variants[0]):
            if pattern.format(own) not in text:
                raise RuntimeError(f"{name}.cu does not hold "
                                   f"{pattern.format(own)!r}")
            text = text.replace(pattern.format(own), pattern.format(value))
        tag = "_".join(str(x) for x in v)
        path = os.path.join(out_dir, f"{name}_{tag}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        so = path[:-3] + ".so"
        procs[v] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, path, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {so}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn, (argtypes, restype) in build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[v] = lib
    return libs


def tune_k1(device, reps):
    t = 24 * 2**20
    rng = np.random.default_rng(1)
    vals = [torch.from_numpy(rng.integers(-2**31, 2**31, t, dtype=np.int64)
                             .astype(np.int32)).to(device) for _ in range(3)]
    small = torch.from_numpy(rng.integers(-1, 50, t).astype(np.int32)) \
        .to(device)
    cases = []
    for kind, cols, reverse in (("first", vals, False),
                                ("cummax", vals[:1], True),
                                ("sfx2", [small] + vals[1:], True)):
        f = rng.random(t) < 0.05
        f[-1 if reverse else 0] = True
        flag = torch.from_numpy(f).to(device)
        cases.append((kind, flag, cols, reverse,
                      seg_scan_plain(kind, flag, *cols, reverse=reverse)))
    for v, lib in build_variants("seg_scan", K1_CONSTANTS, K1_VARIANTS).items():
        build._LIBS["seg_scan"] = lib
        bad, times = 0, []
        for kind, flag, cols, reverse, want in cases:
            run = lambda: seg_scan(kind, flag, *cols, reverse=reverse)
            bad += differs(run(), want)
            times.append(f"{kind}/{len(cols)}{'r' if reverse else ''} "
                         f"{cuda_ms(run, reps):.4f}")
        print(f"K1 threads {v[0]} vectors {v[1]} blocks {v[2]}: "
              f"{bad} outputs differ; T={t} ms: " + ", ".join(times),
              flush=True)
    del build._LIBS["seg_scan"]


def synthetic_hits(rng, lens, n_hits, mat, letters, max_diag, device):
    """K2's operands for random hits between random rows of the given
    lengths, laid out as a SeqDB's data."""
    n = len(lens)
    offs = np.concatenate([[0], np.cumsum(lens + 2)[:-1]])
    rows = np.full(int((lens + 2).sum()), 10, np.uint8)
    total = int(lens.sum())
    idx = np.repeat(offs, lens) + (np.arange(total)
                                   - np.repeat(np.cumsum(lens) - lens, lens))
    rows[idx] = letters[rng.integers(0, len(letters), total)]
    arrs = (rows, offs.astype(np.int64), lens.astype(np.int32),
            mat.aa2num.astype(np.uint8),
            np.sort(rng.integers(0, n, n_hits)).astype(np.int32),
            rng.integers(0, n, n_hits).astype(np.int32),
            rng.integers(-max_diag, max_diag, n_hits).astype(np.int32),
            mat.sub.astype(np.int32))
    return [torch.from_numpy(a).to(device) for a in arrs]


def tune_k2(device, reps):
    rng = np.random.default_rng(0)
    nucl, prot = constants.nucleotide(), constants.blosum62()
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rkw = dict(comp=torch.from_numpy(nucl.reverse.astype(np.int32)).to(device),
               code2char=torch.from_numpy(nucl.num2aa.astype(np.uint8))
               .to(device))
    uni = uniform_pattern(nucl.sub)
    late_lens = np.minimum((150 + rng.exponential(1500, 100000))
                           .astype(np.int64), 19997)
    data = {
        "reads": synthetic_hits(rng, np.full(100000, 150), 317648, nucl, acgt,
                                75, device),
        "orfs": synthetic_hits(
            rng, rng.integers(20, 90, 217020), 426248, prot,
            np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8), 25, device),
        "contigs": synthetic_hits(rng, late_lens, 681312, nucl, acgt, 400,
                                  device)}
    rev = {k: torch.from_numpy(rng.random(v[4].numel()) < 0.5).to(device)
           for k, v in data.items() if k != "orfs"}
    calls = [("reads uniform", data["reads"],
              dict(qrev=rev["reads"], uniform=uni, **rkw)),
             ("reads generic", data["reads"], dict(qrev=rev["reads"], **rkw)),
             ("orfs", data["orfs"], {}),
             ("contigs uniform", data["contigs"],
              dict(qrev=rev["contigs"], uniform=uni, **rkw))]
    wants = [rescore_e2e_plain(*args, **{k: v for k, v in kw.items()
                                         if k != "uniform"})
             for _, args, kw in calls]
    for v, lib in build_variants("rescore", K2_CONSTANTS, K2_VARIANTS).items():
        build._LIBS["rescore"] = lib
        bad, times = 0, []
        for (name, args, kw), want in zip(calls, wants):
            run = lambda: rescore_e2e(*args, **kw)
            bad += differs(run(), want)
            times.append(f"{name} {cuda_ms(run, reps):.4f}")
        print(f"K2 lanes per hit {v[0]} long window {v[1]}: {bad} outputs "
              f"differ; ms: " + ", ".join(times), flush=True)
    del build._LIBS["rescore"]


def main():
    if not torch.cuda.is_available():
        print("tune: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    tune_k1(device, 50)
    tune_k2(device, 50)
    return 0


if __name__ == "__main__":
    sys.exit(main())
