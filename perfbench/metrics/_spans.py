"""The program's own spans (plass_tpu_torch.utils.trace.span, dotted
names such as rescore.finish): the profiler's user_annotation events that
start inside the traced window, on the host's view of time. A reader
returns None where the run recorded none of its spans, as with a program
that has none."""


def spans(rec, match):
    """(t0, t1) in microseconds of the window's user_annotation events
    whose name satisfies match(name)."""
    if not rec.window or not rec.steps:
        return []
    w0, w1 = rec.window
    return [(t0, t1) for cat, nm, t0, t1 in rec.host
            if cat == "user_annotation" and w0 <= t0 < w1 and match(nm)]


def ms_per_step(rec, match):
    """The spans' summed milliseconds over the window's steps, or None."""
    found = spans(rec, match)
    if not found:
        return None
    return sum(t1 - t0 for t0, t1 in found) / 1e3 / rec.steps


def named(*names):
    return lambda name: name in names
