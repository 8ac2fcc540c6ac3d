"""Uploads (ops.backend: the DB's rows, the hits' host-made columns):
megabytes (10^6 bytes) copied host to device a step, from the profiler's
memcpy events inside the traced window."""


def read(rec):
    if not rec.window or not rec.steps:
        return None
    w0, w1 = rec.window
    n = sum(float(args.get("bytes", 0)) for cat, nm, t0, _, args in rec.device
            if cat == "gpu_memcpy" and "HtoD" in nm and w0 <= t0 < w1)
    return n / 1e6 / rec.steps if n > 0 else None
