"""The device step of an assembly iteration across the ranks of a process
group, one rank a card, as `plass assemble --backend sharded` runs it when
upstream's RUNNER (`mpirun -np N`) starts N ranks on the cards of one host:

    device = plass_tpu_torch.parallel.distributed.rank_device("cuda")
    matcher = resolve_backend("sharded", device, rescore_mode)  # joins
    hits = backend.match_kmers(db, k, device, matcher, **matcher_kw)
    recs = backend.rescore_diagonal_torch(db, hits, rescore_params,
                                          evaluer, return_flat=True)

`prepare(cfg, db, device)` makes this process rank 0 of cfg["world"]
ranks. It names a coordinator on this host in the PLASS_* variables that
parallel/distributed.py reads, writes the DB to a temporary directory,
starts ranks 1 .. world - 1 as processes of this file, and joins the group
with them, the configuration's "backend" resolved as --backend is; every
rank then checks that the group has cfg["world"] ranks, on a card over
cfg["collective"], and a digest of its DB against every other rank's,
before anything runs. Every rank's malloc keeps the memory it frees for
its next step (keep_freed_memory); rank 0's goes back to glibc's defaults
when the step is dropped. `step(spans=None)` keeps device_step.py's
contract and layers: each step of rank 0 first tells the other ranks, on
their standard input, to run theirs, and returns rank 0's hits and records
(every rank gathers the same hits and computes the same records). With
`spans`, "exchange_bytes" also gets a dict a step: the bytes rank 0 sent,
by exchange (match_kmers' stats, from parallel/mesh.ExchangeStats).

The other ranks wait for a step on their standard input, with no timeout,
so rank 0 may pause between steps for as long as it needs. Dropping the
step closes their inputs: they leave the group and exit, and are joined
(killed after JOIN_SECONDS). A rank that has died makes rank 0's next step
raise; one that dies inside a step makes rank 0's collective fail within
PLASS_DIST_TIMEOUT (DIST_TIMEOUT seconds where it is unset), and each rank
is killed when rank 0's process ends (PR_SET_PDEATHSIG).

    python perfbench/entries/sharded_step.py <job.json>

runs one rank (the PLASS_* variables name it) on the job's configuration
and DB directory, stepping once for each line "step" on its standard
input until that closes.
"""
import contextlib
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import weakref

import numpy as np

LAYERS = ("kmermatch", "rescore", "exchange_bytes")
ARRAYS = ("data", "keys", "offsets", "lengths")
# seconds a rank waits in a collective or at the coordinator before it
# fails, where PLASS_DIST_TIMEOUT is unset: the first step's kernel builds
# with room to spare
DIST_TIMEOUT = 120
JOIN_SECONDS = 60
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PR_SET_PDEATHSIG = 1
# glibc's mallopt parameters, and its defaults for the two
M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4
DEFAULT_TRIM_THRESHOLD, DEFAULT_MMAP_MAX = 128 * 1024, 65536


def keep_freed_memory(keep=True):
    """Has glibc's malloc in this process keep what it frees for later
    allocations (no mapping of its own for large blocks, no trimming of
    the heap), or, with keep False, go back to its defaults and hand the
    kept memory back.

    A rank allocates and frees gigabytes of host arrays a step. Four ranks
    on one host that map and fault theirs anew at the same time contend in
    the host's memory management: on four H100s, one set of ranks took
    10,582 ms a step (median of 4 steps of 10,050-11,399) mapping them anew
    and 8,249 ms (8,067-8,480) keeping them, where one process on one card
    took the same time either way (PERF.md section 6)."""
    import ctypes
    libc = ctypes.CDLL(None)
    if keep:
        libc.mallopt(M_MMAP_MAX, 0)
        libc.mallopt(M_TRIM_THRESHOLD, 2 ** 31 - 1)
    else:
        libc.mallopt(M_MMAP_MAX, DEFAULT_MMAP_MAX)
        libc.mallopt(M_TRIM_THRESHOLD, DEFAULT_TRIM_THRESHOLD)
        libc.malloc_trim(0)


def _digest(arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).view(np.uint8))
    return h.digest()


def _join(cfg, arrays, device_name):
    """Joins the group the environment names as the workflows do, checks
    its size and backend against the configuration's and that every rank
    holds the same DB, and returns (device, run):
    run(stats) is one step of this rank, (hits, records), each layer
    inside layer(name)."""
    import torch
    import torch.distributed as dist
    from plass_tpu_torch.data import seqdb
    from plass_tpu_torch.ops import backend
    from plass_tpu_torch.ops.evalue import EvalueComputer
    from plass_tpu_torch.ops.rescore import RescoreParams
    from plass_tpu_torch.parallel import distributed
    from plass_tpu_torch.utils.device import resolve_backend

    device = distributed.rank_device(device_name)
    matcher = resolve_backend(cfg["backend"], device, cfg["rescore_mode"])
    if distributed.world() != cfg["world"]:
        raise RuntimeError(f"{distributed.world()} ranks joined, the "
                           f"configuration names {cfg['world']}")
    if device.type == "cuda" and cfg["collective"] not in \
            distributed.backend():
        raise RuntimeError(f"collectives over {distributed.backend()}, the "
                           f"configuration names {cfg['collective']}")
    mine = torch.tensor(list(_digest(arrays)), dtype=torch.uint8)
    every = [torch.empty_like(mine) for _ in range(distributed.world())]
    dist.all_gather(every, mine)
    other = [r for r, d in enumerate(every) if not torch.equal(d, every[0])]
    if other:
        raise RuntimeError(f"ranks {other} hold another DB than rank 0 "
                           "(sha256 of its arrays)")

    nucleotide = cfg["dbtype"] == "nucleotide"
    sdb = seqdb.SeqDB(*arrays, seqdb.NUCLEOTIDES if nucleotide
                      else seqdb.AMINO_ACIDS)
    matcher_kw = dict(
        kmers_per_sequence=cfg["kmers_per_sequence"],
        kmers_per_sequence_scale=cfg["kmers_per_sequence_scale"],
        hash_shift=cfg["hash_shift"],
        ignore_multi_kmer=cfg["ignore_multi_kmer"],
        include_only_extendable=cfg["include_only_extendable"],
        cov_thr=cfg["cov_thr"], cov_mode=cfg["cov_mode"])
    params = RescoreParams(rescore_mode=cfg["rescore_mode"],
                           seq_id_thr=cfg["min_seq_id"],
                           cov_thr=cfg["cov_thr"], cov_mode=cfg["cov_mode"],
                           eval_thr=cfg["eval_thr"],
                           aln_len_thr=cfg["min_aln_len"],
                           seq_id_mode=cfg["seq_id_mode"])
    evaluer = EvalueComputer.for_matrix(cfg["evalue_params"],
                                        sdb.total_residues())

    def run(stats, layer=lambda name: contextlib.nullcontext()):
        with layer("kmermatch"):
            hits = backend.match_kmers(sdb, cfg["k"], device, matcher,
                                       stats=stats, **matcher_kw)
        with layer("rescore"):
            recs = backend.rescore_diagonal_torch(sdb, hits, params, evaluer,
                                                  return_flat=True)
        return hits, recs

    return device, run


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Ranks:
    """Ranks 1 .. world - 1: their processes, logs and standard inputs, and
    the environment this process had before it became rank 0 (whose malloc
    keeps what it frees until close)."""

    def __init__(self, cfg, db, world, device_type):
        self.tmp = tempfile.mkdtemp(prefix="plass-sharded-")
        self.procs, self.logs = [], []
        self.saved = {}
        for name in ARRAYS:
            np.save(os.path.join(self.tmp, name + ".npy"), getattr(db, name))
        job = os.path.join(self.tmp, "job.json")
        with open(job, "w") as fh:
            json.dump({"cfg": cfg, "db": self.tmp, "device": device_type,
                       "parent": os.getpid()}, fh)
        group = {"PLASS_COORDINATOR": f"127.0.0.1:{_free_port()}",
                 "PLASS_NUM_PROCESSES": str(world),
                 "PLASS_DIST_TIMEOUT": os.environ.get("PLASS_DIST_TIMEOUT",
                                                      str(DIST_TIMEOUT))}
        for r in range(1, world):
            log = os.path.join(self.tmp, f"rank{r}.log")
            with open(log, "wb") as out:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), job],
                    env=dict(os.environ, **group, PLASS_PROCESS_ID=str(r)),
                    stdin=subprocess.PIPE, stdout=out,
                    stderr=subprocess.STDOUT, cwd=ROOT))
            self.logs.append(log)
        for key, value in dict(group, PLASS_PROCESS_ID="0").items():
            self.saved[key] = os.environ.get(key)
            os.environ[key] = value
        keep_freed_memory()

    def tail(self, i, n=2000):
        try:
            with open(self.logs[i], "rb") as fh:
                return fh.read()[-n:].decode(errors="replace")
        except OSError:
            return ""

    def step(self):
        """Tells every other rank to run a step; raises, telling none, if
        one has died."""
        for i, p in enumerate(self.procs):
            if p.poll() is not None:
                raise RuntimeError(f"rank {i + 1} exited with "
                                   f"{p.returncode}:\n{self.tail(i)}")
        for p in self.procs:
            p.stdin.write(b"step\n")
            p.stdin.flush()

    def restore_environment(self):
        """The PLASS_* variables as they were before this process became
        rank 0 (the group reads them only when it is joined)."""
        for key, value in self.saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value

    def close(self):
        """Stops the ranks, leaves the group, removes the directory and puts
        this process's malloc back to its defaults."""
        import torch.distributed as dist

        for p in self.procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        if dist.is_initialized():
            dist.destroy_process_group()
        for i, p in enumerate(self.procs):
            try:
                p.wait(JOIN_SECONDS)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            if p.returncode != 0:
                print(f"sharded_step: rank {i + 1} exited with "
                      f"{p.returncode}:\n{self.tail(i)}", file=sys.stderr)
        shutil.rmtree(self.tmp, ignore_errors=True)
        keep_freed_memory(False)


def prepare(cfg, db, device):
    import torch
    from perfbench.entries.device_step import _Span
    from plass_tpu_torch.parallel import distributed

    device = torch.device(device)
    ranks = _Ranks(cfg, db, cfg["world"], device.type)
    try:
        arrays = tuple(getattr(db, name) for name in ARRAYS)
        device, run = _join(cfg, arrays, device.type)
    except BaseException:
        ranks.close()
        raise
    finally:
        ranks.restore_environment()
    print(f"sharded_step: rank 0 of {distributed.world()} on {device}, "
          f"backend {distributed.backend()}", file=sys.stderr)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def step(spans=None):
        ranks.step()
        stats = {}
        if spans is None:
            hits, recs = run(stats)
        else:
            hits, recs = run(stats, lambda name: _Span(name, spans, sync))
        sync()
        if spans is not None:
            spans["exchange_bytes"].append(stats.get("exchange_bytes", {}))
        qk, tk, score, diag = hits
        s = hits.hit_slots
        return (qk[s], tk[s], score[s], diag[s]), recs

    step.procs = ranks.procs
    weakref.finalize(step, ranks.close)
    return step


def _die_with_parent(parent):
    """SIGKILL to this process when the process that started it ends."""
    import ctypes
    import signal
    ctypes.CDLL(None).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != parent:
        os._exit(1)


def worker(job_path):
    with open(job_path) as fh:
        job = json.load(fh)
    _die_with_parent(job["parent"])
    keep_freed_memory()
    import torch
    torch.set_num_threads(job["cfg"]["threads"])
    arrays = tuple(np.load(os.path.join(job["db"], name + ".npy"))
                   for name in ARRAYS)
    _, run = _join(job["cfg"], arrays, job["device"])
    for line in sys.stdin:
        if line.strip() != "step":
            break
        run({})


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    worker(sys.argv[1])
    sys.exit(0)
