"""Device selection: the device runs the k-mer matcher, the rescore and
the coding filter; everything else stays on the host.

The choice is explicit. `cuda` without a visible card is an error, never a
quiet run on the CPU; `cpu` runs every kernel's plain PyTorch version.
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
