"""The rescore's host work around K2 (ops.backend.rescore_diagonal_torch):
mean milliseconds a step of every rescore.* span of the program but
rescore.fetch, where the host waits for K2 and copies its output."""
from ._spans import ms_per_step


def _host(name):
    return name.startswith("rescore.") and name != "rescore.fetch"


def read(rec):
    return ms_per_step(rec, _host)
