"""The rescore's self rows (ops.backend._self_rescore_host, a pass over
every residue of the DB on the host, and their scatter into the hit
rows): mean milliseconds a step of the program's rescore.self_rows span."""
from ._spans import ms_per_step, named


def read(rec):
    return ms_per_step(rec, named("rescore.self_rows"))
