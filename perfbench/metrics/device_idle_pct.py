"""The device: share of the traced window in which the card runs no
kernel, copy or memset (the union of the profiler's device intervals)."""
from .. import trace


def read(rec):
    if not rec.window or not rec.device:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(rec) / trace.window_seconds(rec))
