"""Readings that the limits of `correct` are set from (not run by the
benchmark's own runs): for each seed, in one process, the numbers that
compare.py gives for

  port     the program's step, as the window runs it, at the cell's size
  control  the plain reference put in the program's place with its
           E-value computed in float32, the precision below the float64
           that the configurations state

each against the float64 reference on the same DB. One JSON line a seed.

    python3 perfbench/readings.py --workload <cell> --seeds <n> [<n> ...]
"""
import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_step(cfg, db, device):
    """The control in the program's place: the reference with float32
    E-values."""
    import torch

    from perfbench import reference

    def step(spans=None):
        return reference.reference_step(db, cfg, device, torch.float32)

    return step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from perfbench import run

    spec = run.load_spec(ROOT)
    _, cfg, traffic = run.resolve(ROOT, spec, args.workload)
    run.set_environment(ROOT, cfg)
    import torch

    from perfbench import compare, generate, reference
    torch.set_num_threads(cfg["threads"])
    entry = importlib.import_module(f"perfbench.entries.{traffic['entry']}")
    device = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        db = generate.make_db(traffic, seed, device)
        out = entry.prepare(cfg, db, device)()
        ref = reference.reference_step(db, cfg, device)
        ctl = control_step(cfg, db, device)()
        line = {"workload": args.workload, "seed": seed,
                "sequences": db.size,
                "residues": int((db.lengths - 2).sum()),
                "hits": len(ref[0][0]),
                "reverse_hits": int((ref[0][2] < 0).sum()),
                "records": len(ref[1]["qk"]),
                "port": compare.step_numbers(*out, *ref),
                "control": compare.step_numbers(*ctl, *ref),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
