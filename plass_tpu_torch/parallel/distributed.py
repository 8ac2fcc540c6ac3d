"""Multi-process runtime of the sharded k-mer matcher, over
torch.distributed (the JAX package's parallel/distributed.py).

A rank is one process and plays the part of one device of the JAX
package's mesh. Ranks are launched like MPI ranks, one command each:

    PLASS_COORDINATOR=host0:port PLASS_NUM_PROCESSES=2 PLASS_PROCESS_ID=i \\
        python -m plass_tpu_torch.cli.plass assemble ... --backend sharded

torchrun's MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK stand in for the
three PLASS_* variables where those are unset. Every rank runs the whole
workflow on the same input files and writes the paths it was given; only
the matcher's exchanges and the gather of its hits are collective.

The collective backend is decided before the group exists, by one rule:
gloo on the CPU; on cards, "cpu:gloo,cuda:nccl" (NCCL for the card's
tensors) when every rank holds a card of its own, and gloo when ranks
share one, which NCCL refuses. Each rank names its card (host and UUID)
in the coordinator's store, and the names decide. Nothing is decided by
catching a failure.
"""
import atexit
import datetime
import logging
import os
import socket

import torch
import torch.distributed as dist

from ..utils.device import pick_device
from ..utils.log import logger

# seconds a rank waits at the coordinator and in a collective before it
# fails (PLASS_DIST_TIMEOUT overrides): a rank that dies makes the others
# fail within it, never hang
DEFAULT_TIMEOUT = 600


def _env(*names):
    """The first of the environment variables `names` that is set."""
    for name in names:
        value = os.environ.get(name)
        if value:
            return value
    return None


def coordinator():
    """(host, port, world, rank) from the environment, or None when no
    coordinator is named (a single process)."""
    coord = _env("PLASS_COORDINATOR")
    if coord is None and _env("MASTER_ADDR"):
        coord = f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT') or 29500}"
    if coord is None:
        return None
    world = _env("PLASS_NUM_PROCESSES", "WORLD_SIZE")
    rank = _env("PLASS_PROCESS_ID", "RANK")
    if world is None or rank is None:
        raise ValueError(f"coordinator {coord} given without "
                         "PLASS_NUM_PROCESSES and PLASS_PROCESS_ID")
    host, _, port = coord.rpartition(":")
    world, rank = int(world), int(rank)
    if not 0 <= rank < world:
        raise ValueError(f"process {rank} of {world}")
    return host, int(port), world, rank


def _local_rank():
    """This process's index among the ranks of its host: torchrun's
    LOCAL_RANK, else its rank (every rank on one host)."""
    local = _env("LOCAL_RANK")
    if local is not None:
        return int(local)
    if dist.is_initialized():
        return dist.get_rank()
    coord = coordinator()
    return 0 if coord is None else coord[3]


def rank_device(name):
    """The torch.device of this rank for --device `name`: `cuda` is the
    card of index local rank mod the cards' count, `cuda:<i>` is kept as
    given, `cpu` is the CPU; `cuda` without a card raises."""
    dev = pick_device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank() % torch.cuda.device_count())
    return dev


def _card(device):
    """The name of the card `device` is: its host and UUID."""
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def collective_backend(device, cards):
    """The group's backend for ranks on `device` holding the cards
    `cards` (one name per rank; None on the CPU)."""
    if device.type != "cuda":
        return "gloo"
    if len(set(cards)) == len(cards):
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def _timeout():
    return datetime.timedelta(seconds=float(
        os.environ.get("PLASS_DIST_TIMEOUT", DEFAULT_TIMEOUT)))


def maybe_initialize(device, one_rank=False):
    """Join the process group the environment names (coordinator()), once
    per process; `device` is this rank's (rank_device). Without a
    coordinator there is no group, or with one_rank a group of this
    process alone (the sharded path's world 1). Ranks other than 0 log
    errors only. Returns whether the group has more than one rank."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coord = coordinator()
    if coord is None and not one_rank:
        return False
    timeout = _timeout()
    if coord is None:
        host, port, world, rank = None, 0, 1, 0
        store = dist.HashStore()
    else:
        host, port, world, rank = coord
        store = dist.TCPStore(host, port, world, is_master=rank == 0,
                              timeout=timeout)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        store.set(f"plass_card_{rank}", _card(device))
        cards = [store.get(f"plass_card_{r}").decode() for r in range(world)]
    else:
        cards = [None] * world
    backend = collective_backend(device, cards)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    atexit.register(_shutdown)
    if rank != 0:
        # non-master verbosity squelch (MMseqsMPI.cpp:17-21)
        logger.setLevel(logging.ERROR)
    logger.info("torch.distributed: process %d/%d on %s, backend %s%s",
                rank, world, device, backend,
                "" if host is None else f", coordinator {host}:{port}")
    return world > 1


def _shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multiprocess():
    return dist.is_initialized() and dist.get_world_size() > 1


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def world():
    return dist.get_world_size() if dist.is_initialized() else 1


def backend():
    """The group's backend as maybe_initialize chose it (None without a
    group)."""
    return dist.get_backend() if dist.is_initialized() else None


def gather(x):
    """Every rank's rows of x (dim 0 may differ between ranks, the other
    dims may not) concatenated in rank order, on every rank: an all-gather
    of the row counts, then of the payload padded to the largest."""
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    counts = [torch.empty_like(n) for _ in range(world())]
    dist.all_gather(counts, n)
    counts = [int(c) for c in counts]
    padded = x.new_zeros((max(counts),) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    parts = [torch.empty_like(padded) for _ in counts]
    dist.all_gather(parts, padded)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])
