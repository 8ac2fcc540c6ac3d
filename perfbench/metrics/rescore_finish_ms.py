"""The rescore's finish (ops.backend: the overlaps, per hit in numpy, and
the native finish.cpp pass to records): mean milliseconds a step of the
program's rescore.finish span."""
from ._spans import ms_per_step, named


def read(rec):
    return ms_per_step(rec, named("rescore.finish"))
