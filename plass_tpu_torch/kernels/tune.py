"""Times variants of the port's CUDA kernels on one GPU.

    python -m plass_tpu_torch.kernels.tune [k1] [k2] [b12] [b10] [b9] [rates]
    python -m plass_tpu_torch.kernels.tune [floor] [compare PARENT_TREE]

Each variant is the kernel's source with its tuning constants replaced
(K1: threads per block, 16-byte vectors per thread, resident blocks the
compiler plans for; K2: lanes per hit, long-window threshold; B9: warps
per block, the most rows a lane holds, lanes per pair of the shortest
queries, and the schedule's block-path threshold), built with the flags
of kernels/build.py into the build directory, held against the plain
PyTorch version (exact) and timed with CUDA events on seeded data of the
main paths' sizes: 25,165,824-element scans; 317,648 hits on 100,000
reads of 150 nt, 426,248 hits on 217,020 ORFs of 20-89 aa, and 681,312
hits on 100,000 contigs of up to 19,997 nt; B9 on seeded pairs with the
length profiles of linclust's contigs and families, search's candidates
and long edge pairs (B9_PROFILES). The sources' own constants are the
first variant of each list. Prints one line per variant (B9's also with
its registers, spills and resident warps an SM); needs nvcc and a CUDA
device. "b12" and "b10" hold this tree's B12 and B10 on the same hits
(B12 on 50,000 of the contigs' and on rows over 32,768 nt whose best
diagonal is another than their own) and time them. "rates" measures the
int32 instructions B9's cell is made of (DPX included), in lanes an SM
completes a clock. With nothing named, runs them all but "floor", which
times the rescore kernels (K2, B10, B12) on one hit and on hits without
a window, and "compare", which times them against those of another
checkout of the repository, in turns on the same inputs.
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
from ..ops import device_align
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
# (warps per block, blocks an SM planned for, most rows a lane, lanes per
# shortest pair; the schedule's tail share (a pair takes the block path
# from the larger of BLOCK_CELLS and that part of the call's cells, 0 =
# only queries past a strip) and full warps (from which a block-path pair
# takes the most rows a lane)); the last two are the schedule's
B9_VARIANTS = [(8, 2, 16, 1, 512, 2048), (8, 2, 16, 1, 256, 2048),
               (8, 2, 16, 1, 2048, 2048), (8, 2, 16, 1, 0, 2048),
               (8, 2, 16, 1, 512, 1 << 40), (8, 2, 16, 1, 512, 0),
               (8, 1, 16, 1, 512, 2048), (8, 3, 16, 1, 512, 2048),
               (4, 4, 16, 1, 512, 2048), (16, 1, 16, 1, 512, 2048),
               (8, 2, 8, 1, 512, 2048), (8, 2, 16, 4, 512, 2048),
               (8, 2, 16, 8, 512, 2048)]
B9_CONSTANTS = ("constexpr int kWarps = {};", "constexpr int kMinBlocks = {};",
                "constexpr int kMaxR = {};", "constexpr int kMinLanes = {};")
# B9's seeded pairs: (name, pairs, query median, query range, target =
# query x uniform(lo, hi) or None for an unrelated target of the same
# profile); the sizes of chip_smoke.py's sw-main inputs
B9_PROFILES = (("contigs", 1672, 65, (20, 116), (0.85, 1.15)),
               ("families", 1638, 300, (80, 1166), (0.8, 1.2)),
               ("search", 13477, 300, (80, 1104), None))


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


def differs(got, want, name=None):
    """The outputs of got that differ from want's; with a name, prints the
    first differing element of each."""
    bad = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if torch.equal(g, w):
            continue
        bad += 1
        if name is not None:
            at = torch.nonzero(g != w)[:, 0]
            print(f"  {name}: output {i} differs at {at.numel()} of "
                  f"{g.numel()}, first {int(at[0])}: {int(g[at[0]])} "
                  f"against {int(w[at[0]])}", flush=True)
    return bad


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
    calls = rescore_calls(device)
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


def rescore_calls(device, contigs=681312):
    """The rescore's seeded calls: (name, operands, keyword operands) of
    the nucleotide reads' hits with both matrix forms, the ORFs' protein
    hits, and `contigs` hits on contigs of up to 19,997 nt."""
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
        "contigs": synthetic_hits(rng, late_lens, contigs, nucl, acgt, 400,
                                  device)}
    rev = {k: torch.from_numpy(rng.random(v[4].numel()) < 0.5).to(device)
           for k, v in data.items() if k != "orfs"}
    return [("reads uniform", data["reads"],
             dict(qrev=rev["reads"], uniform=uni, **rkw)),
            ("reads generic", data["reads"], dict(qrev=rev["reads"], **rkw)),
            ("orfs", data["orfs"], {}),
            ("contigs uniform", data["contigs"],
             dict(qrev=rev["contigs"], uniform=uni, **rkw))]


def wide_rows_call(device):
    """B12's operands for rows over 32,768 nt: 64 pairs of 40,000 and
    70,000 by 5,000 nt, each hit on 16 diagonals of both strands, one
    planted run of equal bases a pair on a diagonal 65,536 from the
    hit's."""
    rng = np.random.default_rng(5)
    nucl = constants.nucleotide()
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lens = np.array([40000, 40000, 70000, 5000] * 16)
    rows, offsets, lengths, lut, _, _, _, sub = synthetic_hits(
        rng, lens, 1, nucl, acgt, 1, device)
    rows = rows.cpu().numpy()
    offs = offsets.cpu().numpy()
    q = np.repeat(np.arange(0, len(lens), 2), 16)
    t = q + 1
    d = rng.integers(-39000, 39000, len(q))
    d[::16] = np.where(lens[q[::16]] == 40000, 30000, 1000)
    for i in range(0, len(lens), 2):   # q[0:2000] = t[35536:37536]
        if lens[i] == 40000:
            rows[offs[i]:offs[i] + 2000] = rows[offs[i + 1] + 35536:
                                                offs[i + 1] + 37536]
        else:                          # q[66536:69000] = t[0:2464]
            rows[offs[i] + 66536:offs[i] + 69000] = rows[offs[i + 1]:
                                                         offs[i + 1] + 2464]
    i32 = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(device)
    rkw = dict(qrev=torch.from_numpy(rng.random(len(q)) < 0.5).to(device),
               comp=torch.from_numpy(nucl.reverse.astype(np.int32)).to(device),
               code2char=torch.from_numpy(nucl.num2aa.astype(np.uint8))
               .to(device), uniform=uniform_pattern(nucl.sub))
    return ((torch.from_numpy(rows).to(device), offsets, lengths, lut,
             i32(q), i32(t), i32(d), sub), rkw)


def check_b12(device, reps):
    """B12 against its plain version on rescore_calls' inputs and on rows
    over 32,768 nt, and its times there."""
    from ..ops.rescore_kernel import rescore_align, rescore_align_plain
    calls = rescore_calls(device, contigs=50000)
    calls.append(("wide rows", *wide_rows_call(device)))
    bad, times = 0, []
    for name, args, kw in calls:
        want = rescore_align_plain(*args, **kw)
        run = lambda: rescore_align(*args, **kw)
        bad += differs(run(), want, name)
        times.append(f"{name} {cuda_ms(run, reps):.4f}")
    won = int((want[4] != args[6]).sum())
    print(f"B12: {bad} outputs differ ({won} wide-row hits won by another "
          f"diagonal); ms: " + ", ".join(times), flush=True)


def check_b10(device, reps):
    """B10 against its plain version on rescore_calls' inputs, and its
    times there."""
    from ..ops.rescore_kernel import rescore_hamming, rescore_hamming_plain
    bad, times = 0, []
    for name, args, kw in rescore_calls(device):
        if name == "reads generic":
            continue
        kw = {k: v for k, v in kw.items() if k != "uniform"}
        run = lambda: rescore_hamming(*args[:7], **kw)
        bad += differs(run(), rescore_hamming_plain(*args[:7], **kw), name)
        times.append(f"{name} {cuda_ms(run, reps):.4f}")
    print(f"B10: {bad} outputs differ; ms: " + ", ".join(times), flush=True)


def rescore_entries(calls, parent=False):
    """{(kernel, input): launch} for the rescore library that
    build._LIBS["rescore"] holds: K2's three forms, B10's two and B12's
    three on rescore_calls' reads and ORFs; parent: the library is the
    parent tree's, whose B10 and B12 take K2's queue and whose
    rescore_align writes four outputs."""
    from ..ops import rescore_kernel as rk
    by = {name: (args, kw) for name, args, kw in calls}
    out = {}
    for kernel, entry, name, form in (
            ("K2", "rescore_e2e", "orfs", None),
            ("K2-rev", "rescore_e2e_rev", "reads generic", "rev"),
            ("K2-fast", "rescore_e2e_rev", "reads uniform", "rev"),
            ("B10", "rescore_hamming", "orfs", "ham"),
            ("B10-rev", "rescore_hamming", "reads uniform", "ham"),
            ("B12", "rescore_align", "orfs", "rev"),
            ("B12-rev", "rescore_align", "reads generic", "rev"),
            ("B12-fast", "rescore_align", "reads uniform", "rev")):
        args, kw = by[name]
        qrev, comp, code2char = (kw.get(k) for k in ("qrev", "comp",
                                                     "code2char"))
        sub = args[7]
        tensors = [x for x in (*args, qrev, comp, code2char)
                   if x is not None]
        if form is None:
            middle = (build.ptr(sub), sub.shape[0])
        elif form == "ham":
            middle = (build.ptr(qrev), build.ptr(comp), build.ptr(code2char),
                      comp.numel() if comp is not None else 32)
        else:
            middle = rk._rev_middle(qrev, sub, comp, code2char,
                                    kw.get("uniform"))
        n_out = 5 if entry == "rescore_align" and not parent else 4
        out[kernel, name] = (lambda e=entry, a=args, t=tensors, m=middle,
                             n=n_out: rk._launch(e, *a[:7], t, m, n))
    return out


def floors(device, reps):
    """K2's, B10's and B12's forms on rescore_calls' ORF and read hits, on
    one hit, and on all hits moved off their rows (no window: the launch
    and the hit -> row chain alone)."""
    calls = rescore_calls(device, contigs=100)
    variants = {"all": calls,
                "one hit": [(n, (*a[:4], *(x[:1] for x in a[4:7]), a[7]),
                             {k: v[:1] if k == "qrev" else v
                              for k, v in kw.items()})
                            for n, a, kw in calls],
                "no window": [(n, (*a[:6], torch.full_like(a[6], 1 << 30),
                                   a[7]), kw) for n, a, kw in calls]}
    for what, cs in variants.items():
        entries = rescore_entries(cs)
        print(f"floor ({what}): " + ", ".join(
            f"{k} on {n} {cuda_ms(run, reps):.4f}"
            for (k, n), run in entries.items()) + " ms", flush=True)


def compare(device, parent, reps, rounds=2):
    """K2's, B10's and B12's forms of this tree against those of the tree
    at `parent` (its plass_tpu_torch/csrc/rescore.cu, whose rescore_align
    writes four outputs), on rescore_calls' inputs, in turns: parent,
    this, this, parent, `rounds` times; prints each kernel's times."""
    src = os.path.join(parent, "plass_tpu_torch", "csrc", "rescore.cu")
    out_dir = os.path.join(BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "rescore_parent.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, src, "-o", so],
                   check=True, capture_output=True)
    libs = {"parent": ctypes.CDLL(so), "this": build.load("rescore")}
    for fn, (argtypes, restype) in build.SIGNATURES["rescore"].items():
        if fn == "rescore_align":   # the parent's has no diag_out
            argtypes = argtypes[:-1]
        getattr(libs["parent"], fn).argtypes = argtypes
        getattr(libs["parent"], fn).restype = restype
    calls = rescore_calls(device)
    entries = {}
    for who, lib in libs.items():
        build._LIBS["rescore"] = lib
        entries[who] = rescore_entries(calls, parent=who == "parent")
    times = {key: {"parent": [], "this": []} for key in entries["this"]}
    for _ in range(rounds):
        for who in ("parent", "this", "this", "parent"):
            build._LIBS["rescore"] = libs[who]
            for key, run in entries[who].items():
                times[key][who].append(cuda_ms(run, reps))
    build._LIBS["rescore"] = libs["this"]
    for (kernel, name), t in times.items():
        p, c = np.median(t["parent"]), np.median(t["this"])
        print(f"compare {kernel} on {name}: parent "
              + " ".join(f"{x:.4f}" for x in t["parent"]) + " ms, this "
              + " ".join(f"{x:.4f}" for x in t["this"])
              + f" ms; medians {p:.4f} / {c:.4f} ({100 * (c / p - 1):+.1f}%)",
              flush=True)


def sw_pairs(rng, n_pairs, median, lo_hi, ratio, device, wide_bias=False):
    """B9's operands (all but the plan's and the gaps) for n_pairs seeded
    pairs: queries of a lognormal length profile, a query each pair,
    targets as its ratio or drawn alike; codes 0-19 as the rows' own bytes
    (an identity code table), bias in [-2, 2] as the families' (or in
    [-100, 100] with wide_bias, past the folded table's span)."""
    def lens(n):
        return np.clip(rng.lognormal(np.log(median), 0.5, n), *lo_hi) \
            .astype(np.int64)
    qlens = lens(n_pairs)
    tlens = lens(n_pairs) if ratio is None else np.maximum(
        (qlens * rng.uniform(*ratio, n_pairs)).astype(np.int64), 1)
    return sw_operands(rng, qlens, tlens, device, wide_bias)


def sw_operands(rng, qlens, tlens, device, wide_bias=False):
    """B9's operands for one query and one target a pair, of these
    lengths, and the pairs' (order, plan, strip_cols) schedule."""
    n = len(qlens)
    qoff = np.concatenate([[0], np.cumsum(qlens)[:-1]]).astype(np.int64)
    toff = np.concatenate([[0], np.cumsum(tlens)[:-1]]).astype(np.int64)
    span = 100 if wide_bias else 2
    arrs = (rng.integers(0, 20, int(qlens.sum())).astype(np.uint8), qoff,
            qlens.astype(np.int32),
            rng.integers(-span, span + 1, int(qlens.sum())).astype(np.int8),
            rng.integers(0, 20, int(tlens.sum())).astype(np.uint8), toff,
            tlens.astype(np.int32), np.arange(256).astype(np.uint8),
            np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32))
    return [torch.from_numpy(a).to(device) for a in arrs], (qlens, tlens)


def sw_bound_ms(cells):
    """B9's bound: 6 DPX-fused int32 operations a cell over 132 SMs x 64
    INT32 lanes x clocks.max.sm."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])
    return 6 * cells / (132 * 64 * mhz * 1e6) * 1e3


def tune_b9(device, reps):
    rng = np.random.default_rng(3)
    sub = torch.from_numpy(constants.blosum62().sub.astype(np.int32)) \
        .to(device)
    cases = [(name, *sw_pairs(rng, n, med, lo_hi, ratio, device))
             for name, n, med, lo_hi, ratio in B9_PROFILES]
    # long pairs: the 5,000 x 6,000 pair alone, and 300 pairs of 1,025 to
    # 5,000 residues against 700 to 6,000, more than the card's blocks
    cases.append(("edge", *sw_operands(rng, np.array([5000]),
                                       np.array([6000]), device)))
    cases.append(("long", *sw_operands(
        rng, rng.integers(1025, 5001, 300), rng.integers(700, 6001, 300),
        device)))
    cases.append(("wide bias", *sw_pairs(rng, 1638, 300, (80, 1166),
                                         (0.8, 1.2), device, True)))
    wants = {}
    for v, lib in build_variants(
            "sw_score", B9_CONSTANTS,
            list(dict.fromkeys(x[:4] for x in B9_VARIANTS))).items():
        build._LIBS["sw_score"] = lib
        regs, local, smem = (ctypes.c_int32(), ctypes.c_int32(),
                             ctypes.c_int32())
        lib.sw_score_attributes(21, 5, ctypes.byref(regs),
                                ctypes.byref(local), ctypes.byref(smem))
        blocks = lib.sw_score_resident_blocks(21, 5)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        for share, full in [x[4:] for x in B9_VARIANTS if x[:4] == v]:
            bad, times = 0, []
            for name, ops, (qlens, tlens) in cases:
                sched = device_align.schedule(
                    qlens, tlens, (int(ops[3].min()), int(ops[3].max())),
                    **device_align.kernel_shape(lib),
                    tail_share=share, full_warps=full)
                args = (*ops, torch.from_numpy(sched[0]).to(device),
                        *sched[1:], sub)
                for gaps in ((11, 1), (5, 2)):
                    if (name, gaps) not in wants:
                        wants[name, gaps] = device_align.sw_score_plain(
                            *args, *gaps, budget=1 << 25)
                    bad += differs([device_align.sw_score(*args, *gaps)],
                                   [wants[name, gaps]])
                run = lambda: device_align.sw_score(*args, 11, 1)
                ms = cuda_ms(run, reps)
                cells = int((qlens * tlens).sum())
                times.append(f"{name} {ms:.4f} ({int(sched[1][4:7].sum())} on the "
                             f"block path, {cells / ms / 1e6:.1f} "
                             f"GCUPS, {100 * sw_bound_ms(cells) / ms:.1f}% "
                             f"of bound)")
            print(f"B9 warps {v[0]} min blocks {v[1]} max R {v[2]} min "
                  f"lanes {v[3]} tail share {share} full warps {full}: "
                  f"{bad} outputs differ; "
                  f"{regs.value} registers, {local.value} B local, "
                  f"{smem.value} B shared, {blocks // sms} blocks "
                  f"({blocks // sms * v[0]} warps) an SM; ms: "
                  + ", ".join(times), flush=True)
    del build._LIBS["sw_score"]


# The int32 instructions B9's cell is made of, each in 8 independent
# chains a thread at full occupancy: how many lanes an SM completes a
# clock (NVIDIA publishes no DPX rate).
RATE_SOURCE = r"""
#define CHAINS(OP)                                                             \
  int x0 = a + threadIdx.x, x1 = x0 ^ 1, x2 = x0 ^ 2, x3 = x0 ^ 3, x4 = x0 ^ 4, \
      x5 = x0 ^ 5, x6 = x0 ^ 6, x7 = x0 ^ 7;                                   \
  for (int i = 0; i < n; ++i) {                                                \
    OP(x0); OP(x1); OP(x2); OP(x3); OP(x4); OP(x5); OP(x6); OP(x7);            \
  }                                                                            \
  out[blockIdx.x * blockDim.x + threadIdx.x] = x0 + x1 + x2 + x3 + x4 + x5 + x6 + x7;
#define ADDMAX(x) x = __viaddmax_s32(x, b, c)
#define ADDMAXR(x) x = __viaddmax_s32_relu(x, b, c)
#define MAD(x) x = x * b + c
extern "C" __global__ void k_addmax(int a, int b, int c, int n, int* out) { CHAINS(ADDMAX) }
extern "C" __global__ void k_addmax_relu(int a, int b, int c, int n, int* out) { CHAINS(ADDMAXR) }
extern "C" __global__ void k_mad(int a, int b, int c, int n, int* out) { CHAINS(MAD) }
"""


def int_rates(device):
    """(lanes an SM completes a clock at clocks.max.sm, instructions of
    the timed kind in the SASS) for each of RATE_SOURCE's kernels; nvcc
    builds a cubin, which libcuda loads."""
    import ctypes.util
    out_dir = os.path.join(BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "int_rates.cu")
    with open(src, "w") as fh:
        fh.write(RATE_SOURCE)
    cubin = src[:-3] + ".cubin"
    subprocess.run([build.nvcc_path(), "-cubin", "-O3", "-gencode",
                    "arch=compute_90a,code=sm_90a", src, "-o", cubin],
                   check=True)
    sass = subprocess.run([os.path.join(os.path.dirname(build.nvcc_path()),
                                        "cuobjdump"), "-sass", cubin],
                          capture_output=True, text=True).stdout
    torch.zeros(1, device=device)   # the primary context
    cuda = ctypes.CDLL(ctypes.util.find_library("cuda") or "libcuda.so.1")
    mod = ctypes.c_void_p()
    assert cuda.cuModuleLoad(ctypes.byref(mod), cubin.encode()) == 0
    props = torch.cuda.get_device_properties(device)
    sms = props.multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])
    out = torch.empty(sms * 8 * 256, dtype=torch.int32, device=device)
    n = 4096
    rates = {}
    for name in ("k_addmax", "k_addmax_relu", "k_mad"):
        fn = ctypes.c_void_p()
        assert cuda.cuModuleGetFunction(ctypes.byref(fn), mod,
                                        name.encode()) == 0
        vals = [ctypes.c_int(3), ctypes.c_int(-1 if "max" in name else 3),
                ctypes.c_int(5),
                ctypes.c_int(n), ctypes.c_void_p(out.data_ptr())]
        params = (ctypes.c_void_p * 5)(*[ctypes.cast(ctypes.byref(v),
                                                     ctypes.c_void_p)
                                          for v in vals])

        def run():
            assert cuda.cuLaunchKernel(fn, sms * 8, 1, 1, 256, 1, 1, 0,
                                       None, params, None) == 0
        ms = cuda_ms(run, 5)
        lanes = sms * 8 * 256 * n * 8
        rates[name] = lanes / (ms * 1e-3) / (mhz * 1e6) / sms
    body = {k: sum(1 for line in sass.split("Function : " + k)[1]
                   .split("Function :")[0].splitlines() if op in line)
            for k, op in (("k_addmax", "VIADDMNMX"),
                          ("k_addmax_relu", "VIADDMNMX"), ("k_mad", "IMAD"))}
    return rates, body


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    # a directory: the tree to compare this one's rescore kernels with
    parents = [a for a in argv if os.path.isdir(a)]
    which = set(argv) - set(parents) \
        or {"k1", "k2", "b12", "b10", "b9", "rates"}
    if not torch.cuda.is_available():
        print("tune: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    if "k1" in which:
        tune_k1(device, 50)
    if "k2" in which:
        tune_k2(device, 50)
    if "b12" in which:
        check_b12(device, 50)
    if "b10" in which:
        check_b10(device, 50)
    if "floor" in which:
        floors(device, 50)
    if "compare" in which:
        for parent in parents:
            compare(device, parent, 50)
    if "rates" in which:
        rates, body = int_rates(device)
        print("int32 lanes an SM a clock (8 chains a thread, 8 warps a "
              "block, 8 blocks an SM; the op's SASS instructions in the "
              "kernel): " + ", ".join(f"{k[2:]} {v:.1f} ({body[k]})"
                                      for k, v in rates.items()),
              flush=True)
    if "b9" in which:
        tune_b9(device, 20)
    return 0


if __name__ == "__main__":
    sys.exit(main())
