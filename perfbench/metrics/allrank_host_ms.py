"""The host work over all hits after the matcher, which every rank of the
sharded matcher repeats on the gathered hits: mean milliseconds a step of
the program's kmermatch.order (sharded only: the sort by representative
key, the fetches and the `pre` columns), kmermatch.self_hits,
rescore.index, rescore.pre (sharded only: the `pre` columns scattered into
the rescore's), rescore.finish and rescore.group spans. On one card the
same work of the one rank, the two sharded spans aside."""
from ._spans import ms_per_step, named


def read(rec):
    return ms_per_step(rec, named("kmermatch.order", "kmermatch.self_hits",
                                  "rescore.index", "rescore.pre",
                                  "rescore.finish", "rescore.group"))
