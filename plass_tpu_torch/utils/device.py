"""Device selection: the device runs the k-mer matcher, the rescore and
the coding filter; everything else stays on the host.

The choice is explicit. `cuda` without a visible card is an error, never a
quiet run on the CPU; `cpu` runs every kernel's plain PyTorch version.

`--backend` (resolve_backend) chooses between the single-device matcher on
that device and the matcher across the ranks of a process group
(parallel/).
"""
import contextlib
import time

import torch


def pick_device(name="cuda"):
    """torch.device for `name` ("cuda", "cuda:<i>" or "cpu"), or raise."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but no CUDA device is available "
                "(pass --device cpu to run the plain PyTorch versions)")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {name!r}: only "
                               f"{torch.cuda.device_count()} CUDA device(s)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


BACKENDS = ("auto", "numpy", "jax", "sharded")


def resolve_backend(requested, device, rescore_mode=None):
    """"sharded" (the matcher across the process group's ranks) or
    "single" (the single-device matcher) for --backend `requested`, this
    rank's device being `device`. sharded and auto first join the group the
    environment names (parallel/distributed.maybe_initialize); sharded
    without one runs in a group of this process alone, as on a one-device
    mesh. sharded is sharded; auto is sharded when the group has more than
    one rank; numpy and jax, the JAX package's host and single-device
    paths, are the single-device path.

    The sharded path takes no --rescore-mode 2 (ALIGNMENT): its ranks
    rescore their hits at END_TO_END, and the JAX package's sharded path,
    which rescores only modes 0 and 3 on the device, fails on it. With
    `rescore_mode` 2, sharded raises before the group is joined, and auto
    as soon as it resolves to sharded."""
    from ..ops.rescore import RESCORE_ALIGNMENT
    from ..parallel import distributed
    if requested not in BACKENDS:
        raise ValueError(f"--backend must be one of {', '.join(BACKENDS)}; "
                         f"got {requested!r}")
    refuse = rescore_mode == RESCORE_ALIGNMENT
    message = ("--backend sharded does not take --rescore-mode 2 "
               "(ALIGNMENT); use --backend numpy or jax, the single-device "
               "path")
    if requested == "sharded" and refuse:
        raise ValueError(message)
    if requested in ("auto", "sharded"):
        multi = distributed.maybe_initialize(
            device, one_rank=requested == "sharded")
        if requested == "sharded" or multi:
            if refuse:
                raise ValueError(message + " (auto chose sharded: the "
                                 "process group has several ranks)")
            return "sharded"
    return "single"


def synchronize(device):
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage_timer(device, seconds, peaks=None):
    """timed(stage): a context manager that adds the block's wall seconds
    to seconds[stage], read after the device has finished its queued work
    on both sides. With `peaks` on a card, peaks[stage] is also the largest
    torch.cuda.max_memory_allocated of the stage's blocks, the peak reset
    as each block starts."""
    measure = peaks is not None and device.type == "cuda"

    @contextlib.contextmanager
    def timed(stage):
        synchronize(device)
        if measure:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        yield
        synchronize(device)
        seconds[stage] = seconds.get(stage, 0.0) + time.perf_counter() - t0
        if measure:
            peaks[stage] = max(peaks.get(stage, 0),
                               torch.cuda.max_memory_allocated(device))
    return timed
