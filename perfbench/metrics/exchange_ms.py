"""The sharded matcher's exchanges (parallel/mesh.py,
ops/backend.kmermatcher_sharded_torch): mean milliseconds a step, on rank
0, of the program's collective spans, kmermatch.exchange.<name>: the
table and pair exchanges and the all-gather of the hits. Each starts once
rank 0's own queued work is done, so it holds the collectives and the
wait for the slower ranks."""
from ._spans import ms_per_step


def _exchange(name):
    return name.startswith("kmermatch.exchange.")


def read(rec):
    return ms_per_step(rec, _exchange)
