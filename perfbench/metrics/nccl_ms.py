"""The exchanges on the card: mean milliseconds a step of rank 0's NCCL
kernels (name holding "nccl") in the traced window, from the profiler's
device timeline. exchange_ms less this is rank 0 waiting for the other
ranks and for the syncs around the collectives. None where no NCCL kernel
ran (gloo, or one rank)."""


def read(rec):
    if not rec.window or not rec.steps:
        return None
    w0, w1 = rec.window
    us = sum(t1 - t0 for cat, nm, t0, t1, _ in rec.device
             if cat == "kernel" and "nccl" in nm.lower() and w0 <= t0 < w1)
    return us / 1e3 / rec.steps if us > 0 else None
