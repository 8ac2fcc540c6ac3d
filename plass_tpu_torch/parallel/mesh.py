"""The k-mer matcher across ranks (the JAX package's parallel/mesh.py,
kmermatcher.cpp:594-779 and :632-658 in the reference).

One matcher iteration, each rank on its own contiguous block of rows, with
the sequences themselves replicated (every rank holds the whole DB, as the
reference's ranks share an NFS mmap):

 1. select the block's k-mers, with one whole-sequence hash entry per row;
 2. route each table entry to the rank that owns its 16-bit range key
    (exchange): a k-mer group, both strands included, lands whole on one
    rank;
 3. sort the received table, give every group its representative, emit
    the kept (rep, target, diagonal, reverse) pairs (K1);
 4. route each pair to the rank that owns its representative's row range,
    so that every rank holds a contiguous segment of the globally sorted
    pair stream, then sort it and emit the best-diagonal hits of that
    segment alone (K1). Runs are cut at the world - 1 segment edges, as
    the JAX package cuts them (its backend.py:401-408);
 5. rescore the rank's own hits END_TO_END (K2) against the DB's flat
    rows.

Exchanges move exact per-destination counts (one all_to_all_single of the
counts, then one of each field), so nothing overflows and nothing is
retried: the JAX package's bucket capacities, its overflow retry and its
selection-demand probe have no counterpart.

Stages 1-4 are ops/device_kmer.kmermatch_device's, whose route here
(_Route) is the two exchanges; its spans kmermatch.table, .pairs and
.hits hold them, and stage 5 runs in kmermatch.rank_rescore. Each
exchange's collectives run in a span of their own,
kmermatch.exchange.<name> (timed): from a device sync, so the wait for
the slowest rank falls in it.
"""
import time

import torch
import torch.distributed as dist

from ..ops import device_kmer
from ..ops.rescore_kernel import rescore_e2e
from ..utils.device import synchronize
from ..utils.trace import span
from . import distributed


class ExchangeStats:
    """Bytes this rank sends and wall seconds (from a device sync before
    to one after) of the collectives, by exchange name."""

    def __init__(self):
        self.bytes = {}
        self.seconds = {}

    def add(self, name, n_bytes, seconds):
        self.bytes[name] = self.bytes.get(name, 0) + n_bytes
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds


def timed(stats, name, device, fn, n_bytes):
    """fn()'s result, once the device has run the work queued before it:
    the span kmermatch.exchange.<name> (utils/trace.span) holds fn() and a
    second device sync, so the collectives and the wait for the other
    ranks alone. With stats, n_bytes and the span's wall seconds are added
    under `name`."""
    synchronize(device)
    with span(f"kmermatch.exchange.{name}"):
        t0 = time.perf_counter()
        out = fn()
        synchronize(device)
    if stats is not None:
        stats.add(name, n_bytes, time.perf_counter() - t0)
    return out


def exchange(fields, dest, world, stats=None, name="exchange"):
    """Send entry i of every field (tensors of equal dim 0) to rank
    dest[i] (int64, in [0, world)). Returns the fields' received entries:
    in source-rank order, and within a source in its send order (what the
    JAX package's exchange buffers hold once their padding is dropped)."""
    device = dest.device
    order = torch.argsort(dest, stable=True)
    send = torch.bincount(dest, minlength=world)
    recv = torch.empty_like(send)

    def swap():
        dist.all_to_all_single(recv, send)
        send_l, recv_l = send.tolist(), recv.tolist()
        out = []
        for f in fields:
            f = f[order]
            r = f.new_empty((sum(recv_l),) + tuple(f.shape[1:]))
            dist.all_to_all_single(r, f, output_split_sizes=recv_l,
                                   input_split_sizes=send_l)
            out.append(r)
        return out

    n_bytes = send.numel() * send.element_size() + sum(
        f.numel() * f.element_size() for f in fields)
    return timed(stats, name, device, swap, n_bytes)


class _Route:
    """kmermatch_device's route across the ranks: table entries to the
    rank that owns their 16-bit range key (stage 2), pairs to the rank
    that owns their representative's row range, sorted there (stage 4)."""

    def __init__(self, world, rows_per_shard, stats):
        self.world, self.rows_per_shard, self.stats = (world, rows_per_shard,
                                                       stats)

    def table(self, kmer, sid, pos, slen, rkey):
        dest = (rkey.long() * self.world) // device_kmer.RANGE_BINS
        kmer, cols = exchange([kmer, torch.stack([sid, pos, slen], 1)],
                              dest, self.world, self.stats, "table")
        return (kmer, *cols.unbind(1))

    def pairs(self, rep, tgt, diag, rev):
        dest = torch.clamp(rep.long() // self.rows_per_shard,
                           max=self.world - 1)
        (got,) = exchange([torch.stack([rep, tgt, (diag << 1) | rev], 1)],
                          dest, self.world, self.stats, "pairs")
        rep, tgt, dr = got.unbind(1)
        return device_kmer.sort_pairs(rep, tgt, dr >> 1, dr & 1)


def sharded_iteration(kmer_rows, score_rows, sub, params, hash_shift,
                      rows_per_shard, rescore_kw=None, stats=None):
    """This rank's part of one matcher iteration (stages 1-5 above) over
    the DB's flat rows on the rank's device.

    kmer_rows, score_rows: (rows uint8[T], offsets int64[N], lengths
    int32[N], code_lut uint8[256]) of the whole DB, read through the k-mer
    and the scoring alphabet (ops/backend.flat_rows); the row index is the
    sequence id throughout. sub: int32[A, A], the scoring matrix;
    rescore_kw: K2's reverse-strand operands (qrev is taken from the
    hits). Rank r owns rows [r * rows_per_shard, (r + 1) * rows_per_shard)
    (the last rank also the rows after) and the representatives among them.
    stats: an ExchangeStats for the two exchanges ("table", "pairs").

    Returns (rep, tgt, score, diag, r_score, first, last, idents) int32 of
    this rank's hits, in pair order (rep ascending, then target); a
    negative score marks a reverse-strand hit; r_score .. idents are K2's
    columns — and the number of table entries this rank selected."""
    rows, offsets, lengths, code_lut = kmer_rows
    device = rows.device
    world, me = distributed.world(), distributed.rank()
    n = lengths.numel()
    lo = min(me * rows_per_shard, n)
    hi = n if me == world - 1 else min(lo + rows_per_shard, n)

    # ---- stages 1-4: the matcher on this rank's rows, its table and
    # pairs routed to the ranks that own them
    h_rep, h_tgt, h_score, h_diag, selected, _ = \
        device_kmer.kmermatch_device(
            rows, offsets[lo:hi], lengths[lo:hi], code_lut,
            torch.arange(lo, hi, dtype=torch.int32, device=device),
            hash_shift, params, route=_Route(world, rows_per_shard, stats))

    # ---- stage 5: K2 on this rank's hits
    kw = dict(rescore_kw or {})
    if "comp" in kw:
        kw["qrev"] = h_score < 0
    with span("kmermatch.rank_rescore"):
        r_score, first, last, idents = rescore_e2e(
            *score_rows, h_rep, h_tgt, h_diag.contiguous(), sub, **kw)
    return (h_rep, h_tgt, h_score, h_diag, r_score, first, last, idents,
            selected)
