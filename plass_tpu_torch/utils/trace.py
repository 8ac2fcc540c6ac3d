"""Named spans of the program's sub-steps on the profiler's timeline.

    with span("rescore.finish"):
        ...

Under `torch.profiler.profile` a span is a `record_function`: a
user_annotation on the same clock as the device's kernels, copies and
memsets, so each idle gap of the device falls inside the sub-step the host
was in. Outside a profiler, span() returns one shared null context after a
single check of the profiler's state; it records nothing and synchronises
nothing. A span measures the host's view: where the host waits for the
device (a fetch), the wait falls in the span that blocks.

Names are dotted, `<layer>.<sub-step>`: kmermatch.{budget, table, pairs,
hits, fetch, self_hits}, rescore.{index, self_rows, launch, fetch,
finish, group}, and upload.rows for each upload of a DB's rows. The
sharded matcher (parallel/mesh.py, ops/backend.kmermatcher_sharded_torch)
has kmermatch.{table, pairs, hits} on each rank's part too, with
kmermatch.exchange.table between .table and .pairs, .exchange.pairs
inside .pairs (where the pairs are routed, then sorted) and
kmermatch.rank_rescore, then kmermatch.exchange.gather (the
all-gather of every rank's hits), kmermatch.order (the sort by
representative key, the fetches and the `pre` columns) and
kmermatch.self_hits, and its hits' rescore columns are scattered into the
rescore's in rescore.pre; each exchange's span starts after a device
sync, so it holds the collectives and the wait for the other ranks.
"""
import contextlib

import torch

NULL = contextlib.nullcontext()


def span(name):
    """record_function(name) while a profiler records, else NULL."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return NULL
