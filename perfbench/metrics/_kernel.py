"""A kernel's share of its roofline over the traced window's launches:
the sum of each launch's least time (counts.bound_seconds) over the sum of
their device times. Device times come from the profiler's timeline by
kernel name when it holds as many launches as the spy saw, else from the
spy's CUDA events around each launch. None where nothing launched."""
from .. import trace


def roofline_pct(rec, launches, kernel_name, bound):
    if not launches:
        return None
    need = sum(bound(launch.counts) for launch in launches)
    n, sec = trace.kernel_seconds(rec, kernel_name) if rec.window else (0, 0)
    if n != len(launches) or sec <= 0:
        sec = sum(launch.seconds() for launch in launches)
    return 100.0 * need / sec if sec > 0 else None
