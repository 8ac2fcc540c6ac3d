"""Runs one cell of BENCHMARK.json once and prints its result as the last
line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (counted in setup_s, from the start of this script): the cell's
environment, imports, the DB made from the seed on the card, the
program's step prepared and run once. The window then runs whole steps
until `--seconds` have passed; step_ms is its length over the steps, and
peak_gib the card's allocation peak over them (reset after the warm-up).
With --trace 1 the same window runs under torch.profiler with the kernel
spies on, and the per-layer metrics are read from it instead. Once the
window has closed, the plain reference works the step out from the same
DB and every step's output is compared with it (compare.py); the numbers
compared are printed, each beside its limit, as the last lines of
standard error and under "checks" in the result.

Everything is found by name: the cell in BENCHMARK.json's workloads, its
configuration file (configs), its traffic file
perfbench/traffic/<traffic>.json, the entry that traffic names
(perfbench/entries/<entry>.py) and each per-layer metric's reader
(perfbench/metrics/<name>.py).

Exits non-zero, printing no result, without a card, with fewer cards than
the cell asks for, where the program is missing, or where jax, jaxlib,
flax or plass_tpu has been imported.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level modules that may not be loaded in a run: JAX and the JAX
# package (the port's own name, plass_tpu_torch, is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "plass_tpu")


class CellError(RuntimeError):
    pass


def forbidden_modules(names=None):
    """The FORBIDDEN top-level names among `names` (default: sys.modules),
    each module name compared by its part before the first dot."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_spec(root):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def resolve(root, spec, workload):
    """(cell, configuration, traffic) of a workload name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(root, "perfbench", "traffic",
                           cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    return cell, cfg, traffic


def metrics_of(spec, kind, workload):
    """The cell's metric entries of `kind` ("end_to_end", "per_layer")."""
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def set_environment(root, cfg):
    """Thread counts and every build and kernel cache at fixed paths inside
    the checkout; set before torch and the program are imported."""
    os.environ["OMP_NUM_THREADS"] = str(cfg["threads"])
    cache = os.path.join(root, "perfbench", ".cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)


def run_cell(root, workload, seed, seconds, traced, device="cuda", t0=None,
             program=None):
    """One run of a cell; returns the result (without printing it).

    program(cfg, db, device) builds the step in place of the cell's entry
    (the control; tests plant faults through it)."""
    import torch

    from perfbench import compare, generate, reference, trace

    t0 = time.perf_counter() if t0 is None else t0
    spec = load_spec(root)
    cell, cfg, traffic = resolve(root, spec, workload)
    device = torch.device(device)
    cuda = device.type == "cuda"
    entry = importlib.import_module(f"perfbench.entries.{traffic['entry']}")

    db = generate.make_db(traffic, seed, device)
    if cuda:
        torch.cuda.empty_cache()
    step = (program or entry.prepare)(cfg, db, device)
    step()                                   # warm-up: builds and loads
    gc.collect()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    rec = trace.Record(steps=0, spans={k: [] for k in entry.LAYERS})
    spans = rec.spans if traced else None
    remove, prof = None, None
    if traced and cuda:
        remove = trace.install_spies(rec)
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    outputs = []
    with prof if prof is not None else contextlib.nullcontext():
        with (torch.profiler.record_function("window") if traced
              else contextlib.nullcontext()):
            start = time.perf_counter()
            ends = []
            while True:
                outputs.append(step(spans))
                ends.append(time.perf_counter() - start)
                if ends[-1] >= seconds:
                    break
            elapsed = ends[-1]
    if remove is not None:
        remove()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise CellError(f"modules loaded in the run: {', '.join(found)}")
    rec.steps = len(outputs)

    result_metrics = {}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    extra = {}
    if traced:
        if prof is not None:
            trace.read_profile(prof, rec)
        for m in metrics_of(spec, "per_layer", workload):
            reader = importlib.import_module(f"perfbench.metrics.{m['name']}")
            v = reader.read(rec)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if rec.window and rec.device:
            dev["busy_s"] = trace.busy_seconds(rec)
            dev["window_s"] = trace.window_seconds(rec)
            extra["breakdown"] = trace.breakdown(rec)
    else:
        e2e = {"step_ms": 1e3 * elapsed / len(outputs),
               "peak_gib": peak / 2 ** 30, "setup_s": setup_s}
        for m in metrics_of(spec, "end_to_end", workload):
            result_metrics[m["name"]] = {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
    del step, prof, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference.reference_step(db, cfg, device)
    checks, failed = compare.judge(outputs, ref, cfg["limits"])
    ref_s = time.perf_counter() - t_ref
    sizes = {"sequences": db.size, "residues": int((db.lengths - 2).sum()),
             "hits": len(ref[0][0]), "records": len(ref[1]["qk"]),
             "reference_s": round(ref_s, 3),
             "steps_ms": [round(1e3 * (b - a), 1)
                          for a, b in zip([0.0] + ends, ends)]}
    return {"correct": failed == 0 and len(outputs) > 0,
            "attempted": len(outputs), "failed": failed,
            "metrics": result_metrics, "device": dev, **extra,
            "checks": checks, "sizes": sizes}


def check_lines(checks):
    return [f"{k} {c['value']!r} limit {c['limit']!r}"
            for k, c in checks.items()]


def card_line():
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        spec = load_spec(ROOT)
        cell, cfg, _ = resolve(ROOT, spec, args.workload)
    except (OSError, CellError, KeyError, ValueError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    set_environment(ROOT, cfg)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {cell['chips']} cards needed, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    torch.set_num_threads(cfg["threads"])
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", T0)
    except CellError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules loaded in the run: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(f"perfbench: {card_line()}; {json.dumps(result.pop('sizes'))}",
          file=sys.stderr)
    checks = result.pop("checks")
    result["checks"] = checks
    for line in check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
