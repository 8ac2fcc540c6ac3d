"""The matcher's host part (ops.backend.kmermatcher_torch): mean
milliseconds a step of the program's kmermatch.budget span (the split
decision) and kmermatch.self_hits span (the self rows interleaved on the
host)."""
from ._spans import ms_per_step, named


def read(rec):
    return ms_per_step(rec, named("kmermatch.budget", "kmermatch.self_hits"))
