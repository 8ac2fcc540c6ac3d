"""PyTorch port, the k-mer matcher across ranks (parallel/, ops/backend.
kmermatcher_sharded_torch, --backend sharded) on the CPU over gloo: the
ranks are processes of this file (its __main__ branch is the worker), and
the JAX package's mesh runs in this process on conftest.py's 8 virtual
devices. At worlds 1, 2, 4 and 8 the port's sharded step and driver equal
plass_tpu's (the hits and their rescore columns, exactly), the segment
edge cuts a run where plass_tpu's does, the fixture workflows at world 2
are byte-equal to the committed goldens and to plass_tpu's sharded runs,
and a rank that fails makes every rank exit non-zero, none hanging.

    python tests/test_torch_sharding.py <jobs.json> <out_dir>

runs the jobs of a worker rank (PLASS_COORDINATOR, PLASS_NUM_PROCESSES and
PLASS_PROCESS_ID name its group; without them it runs as world 1)."""
import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
WORKER_TIMEOUT = 300
# the step's workload: tests/test_sharding.py's batch and parameters
STEP_ROWS = 32
STEP_KSEL = 16
STEP_KPS = 8
# the drivers' protein matcher (tests/test_sharding.py's)
DRIVER_KW = dict(kmers_per_sequence=8)
# the nucleotide matcher as nuclassemble calls it
NUCL_KW = dict(kmers_per_sequence=60, kmers_per_sequence_scale=0.1,
               ignore_multi_kmer=True, include_only_extendable=True)
# the edge DB: every k-mer selected, every hit kept
EDGE_KW = dict(kmers_per_sequence=200, include_only_extendable=False)
# rows of the edge DB: X is a target of both A and B, A < X < 1,024 <= B
EDGE_ROWS = 1100
EDGE_A, EDGE_X, EDGE_B = 1000, 1010, 1030
ASSEMBLE_ARGS = ("--num-iterations", "2", "--filter-proteins", "0")
NUCL_ARGS = ("--num-iterations", "2", "--min-contig-len", "150")
MODE0_ARGS = ("--rescore-mode", "0", "--num-iterations", "3",
              "--filter-proteins", "0")


# ---------------------------------------------------------------------------
# the worker (one rank)

def _flat(arr, lengths):
    """(rows, offsets, lengths) tensors of a padded [N, L] uint8 array laid
    out flat, row i at offset i * L."""
    import torch
    n, width = arr.shape
    return (torch.from_numpy(np.ascontiguousarray(arr).reshape(-1)),
            torch.arange(n, dtype=torch.int64) * width,
            torch.from_numpy(lengths.astype(np.int32)))


def _step_job(job, out):
    """The port's sharded step on the batch, gathered in rank order."""
    import torch
    from plass_tpu_torch import constants
    from plass_tpu_torch.ops.device_kmer import KmerParams
    from plass_tpu_torch.parallel import distributed, mesh

    b = np.load(job["batch"])
    blosum = constants.blosum62()
    params = KmerParams(k=14, alphabet_size=13,
                        kmers_per_sequence=STEP_KPS,
                        kmers_per_sequence_scale=0.0, ksel=STEP_KSEL)
    kmer_rows = (*_flat(b["seqs"], b["lengths"]),
                 torch.arange(256, dtype=torch.int32).to(torch.uint8))
    score_rows = (*_flat(b["chars"], b["lengths"]),
                  torch.from_numpy(blosum.aa2num.astype(np.uint8)))
    sub = torch.from_numpy(blosum.sub.astype(np.int32))
    *cols, _ = mesh.sharded_iteration(kmer_rows, score_rows, sub, params,
                                      67, job["rows_per_shard"])
    got = distributed.gather(torch.stack(cols, 1))
    np.save(out, got.numpy())


def _hits_arrays(hits):
    arrs = {f"flat{i}": np.asarray(x) for i, x in enumerate(hits)}
    if hits.pre is not None:
        arrs.update({f"pre{i}": x for i, x in enumerate(hits.pre)})
        arrs["pre_mode"] = np.int64(hits.pre_mode)
        arrs["table_entries"] = np.int64(hits.table_entries)
        arrs["exchange_bytes"] = np.array(
            [hits.exchange.bytes[n] for n in ("table", "pairs", "gather")])
    arrs["dev"] = np.stack([x.numpy().astype(np.int64) for x in hits.dev])
    return arrs


def _matcher_job(job, out):
    import torch
    from plass_tpu_torch.data import seqdb
    from plass_tpu_torch.ops import backend

    db = seqdb.SeqDB.open(job["db"])
    fn = (backend.kmermatcher_sharded_torch if job["kind"] == "driver"
          else backend.kmermatcher_torch)
    hits = fn(db, job["k"], torch.device("cpu"), **job["kw"])
    arrs = _hits_arrays(hits)
    if job.get("rescore"):
        arrs.update(_rescore_arrays(db, hits))
    np.savez(out, **arrs)


def _rescore_arrays(db, hits):
    """The END_TO_END flat records of the hits, the self rows handed to
    the rescore's launch (backend.SELF_ROWS) and the hits of each K2 call."""
    from plass_tpu_torch.ops import backend
    from plass_tpu_torch.ops.rescore import RescoreParams

    real, launched = backend.rescore_e2e, []

    def spy(*args, **kw):
        launched.append(args[4].numel())
        return real(*args, **kw)

    backend.rescore_e2e = spy
    before = backend.SELF_ROWS
    try:
        got = backend.rescore_diagonal_torch(
            db, hits, RescoreParams(rescore_mode=3, seq_id_thr=0.9,
                                    eval_thr=1e-5), return_flat=True)
    finally:
        backend.rescore_e2e = real
    return {"rec_qk": got["qk"], "rec": got["rec"],
            "self_rows": np.int64(backend.SELF_ROWS - before),
            "launched": np.array(launched, dtype=np.int64)}


def _cli_job(job, rank):
    from plass_tpu_torch.cli import penguin, plass
    from plass_tpu_torch.parallel import distributed
    from plass_tpu_torch.utils.device import resolve_backend

    run = plass.run if job["binary"] == "plass" else penguin.run
    argv = [a.format(rank=rank) for a in job["argv"]]
    if run(argv) != 0:
        raise RuntimeError(f"{job['binary']} {argv[0]} failed")
    import torch
    return {"world": distributed.world(), "backend": distributed.backend(),
            "auto": resolve_backend("auto", torch.device("cpu"))}


def worker(jobs_path, out_dir):
    import torch
    from plass_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    coord = distributed.coordinator()
    rank = 0 if coord is None else coord[3]
    info = {}
    for job in json.load(open(jobs_path)):
        out = os.path.join(out_dir, f"{job['id']}_r{rank}")
        kind = job["kind"]
        if kind == "cli":
            info[job["id"]] = _cli_job(job, rank)
            continue
        distributed.maybe_initialize(torch.device("cpu"), one_rank=True)
        if kind == "fail" and rank == job["rank"]:
            raise RuntimeError(f"rank {rank} fails on purpose")
        if kind == "step":
            _step_job(job, out + ".npy")
        elif kind in ("driver", "single"):
            _matcher_job(job, out + ".npz")
    with open(os.path.join(out_dir, f"info_r{rank}.json"), "w") as f:
        json.dump(info, f)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    worker(*sys.argv[1:3])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the tests

import pytest  # noqa: E402
import torch  # noqa: E402

from plass_tpu.ops.backend import kmermatcher_sharded  # noqa: E402
from plass_tpu_torch.data import seqdb as port_seqdb  # noqa: E402
from plass_tpu_torch.parallel import distributed  # noqa: E402
from plass_tpu_torch.utils.device import resolve_backend  # noqa: E402


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(world, jobs, out_dir, coordinator=True, timeout=None,
               expect_ok=True):
    """Run `world` worker ranks of this file on `jobs` and wait for them;
    returns their (exit code, output) pairs. Ranks still running at the
    timeout are killed, and the test fails."""
    os.makedirs(out_dir, exist_ok=True)
    jobs_path = os.path.join(out_dir, "jobs.json")
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PLASS_", "MASTER_", "WORLD_SIZE", "RANK",
                                "LOCAL_RANK"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", TTY="0")
    port = _free_port()
    procs = []
    for rank in range(world):
        if coordinator:
            env.update(PLASS_COORDINATOR=f"127.0.0.1:{port}",
                       PLASS_NUM_PROCESSES=str(world),
                       PLASS_PROCESS_ID=str(rank), PLASS_DIST_TIMEOUT="60")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), jobs_path, out_dir],
            env=dict(env), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout or WORKER_TIMEOUT)
            results.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if expect_ok:
        for rc, out in results:
            assert rc == 0, out[-3000:]
    return results


class _Ranks:
    """The worker ranks of one world, started once per module and read by
    the tests that need them."""

    def __init__(self, tmp, world, jobs, coordinator=True):
        self.dir = str(tmp / f"world{world}")
        self.world = world
        self.results = _run_ranks(world, jobs, self.dir, coordinator)

    def npz(self, job_id, rank=0):
        return np.load(os.path.join(self.dir, f"{job_id}_r{rank}.npz"))

    def npy(self, job_id, rank=0):
        return np.load(os.path.join(self.dir, f"{job_id}_r{rank}.npy"))

    def info(self, rank=0):
        return json.load(open(os.path.join(self.dir, f"info_r{rank}.json")))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The DBs and the batch, written once for the workers, and the JAX
    package's DBs."""
    import __graft_entry__ as g
    from test_torch_nucl_kmer import _synthetic

    tmp = tmp_path_factory.mktemp("sharding")
    seqs, lengths, keys = g._example_batch(n=STEP_ROWS, lmax=48, seed=1)
    rng = np.random.default_rng(2)
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    chars = np.zeros(seqs.shape, dtype=np.uint8)
    for i in range(STEP_ROWS):
        chars[i, :lengths[i]] = letters[rng.integers(0, 20, lengths[i])]
    np.savez(tmp / "batch.npz", seqs=seqs, lengths=lengths, chars=chars)
    dbs = {"protein": g.synthetic_protein_db(n=1024, seed=5, skew_frac=0.2),
           "skew": g.synthetic_protein_db(n=2048, seed=7, skew_frac=0.3),
           "edge": _edge_db()}
    jnucl, pnucl = _synthetic(seed=5, n=1500)
    dbs["nucl"] = jnucl
    paths = {}
    for name, db in dbs.items():
        paths[name] = str(tmp / name)
        (pnucl if name == "nucl" else db).save(paths[name])
    return {"tmp": tmp, "batch": str(tmp / "batch.npz"),
            "batch_arrays": (seqs, lengths, keys, chars), "jax": dbs,
            "paths": paths}


# plass_tpu's sharded fixture workflows on a mesh of 2 virtual devices
JAX_WORKFLOWS = r"""
import sys
import jax
from plass_tpu.workflow.assemble import AssembleParams, run_assemble
from plass_tpu.workflow.nuclassemble import NuclAssembleParams, run_nuclassemble
assert len(jax.devices()) == 2, jax.devices()
out = sys.argv[1]
run_assemble(sys.argv[2:], out + "/assembly.fas", out + "/atmp",
             AssembleParams(num_iterations=2, filter_proteins=0,
                            backend="sharded"))
run_nuclassemble(sys.argv[2:], out + "/contigs.fasta", out + "/ntmp",
                 NuclAssembleParams(num_iterations=2, min_contig_len=150,
                                    backend="sharded"))
run_assemble(sys.argv[2:], out + "/assembly_mode0.fas", out + "/mtmp",
             AssembleParams(num_iterations=3, filter_proteins=0,
                            rescore_mode=0, backend="sharded"))
"""


@pytest.fixture(scope="module")
def jax_workflows(data):
    """The directory of plass_tpu's sharded fixture runs (assembly.fas,
    contigs.fasta, assembly_mode0.fas at --rescore-mode 0), made in a
    process of their own (XLA_FLAGS gives it 2
    devices, as tests/test_sharding.py's processes get theirs), started
    with the module."""
    out = data["tmp"] / "jax_workflows"
    out.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.Popen([sys.executable, "-c", JAX_WORKFLOWS, str(out),
                             *READS], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _edge_db():
    """EDGE_ROWS unrelated random proteins of 100 residues, but for three
    rows: X (80 residues) at EDGE_X, A (130) at EDGE_A holding X's first 40
    residues and B (130) at EDGE_B holding X's last 40. A and B share no
    k-mer, so A's hits end with target X and B's begin with it: on one
    device the run of target X goes on from A's pairs into B's (the
    reference's run-absorb quirk), while at world 2 the segment edge (row
    1,024) falls between A and B and cuts it."""
    from plass_tpu.data import seqdb

    rng = np.random.default_rng(11)
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)

    def rand(n):
        return letters[rng.integers(0, 20, n)].tobytes()

    x = rand(80)
    rows = {EDGE_X: x, EDGE_A: rand(45) + x[:40] + rand(45),
            EDGE_B: rand(45) + x[40:] + rand(45)}
    writer = seqdb.DBWriter(seqdb.AMINO_ACIDS)
    for i in range(EDGE_ROWS):
        writer.write(i, rows.get(i) or rand(100))
    return writer.finish()


def _driver_jobs(data, names):
    kws = {"protein": (14, DRIVER_KW), "skew": (14, DRIVER_KW),
           "edge": (14, EDGE_KW), "nucl": (22, NUCL_KW)}
    return [{"id": f"driver_{n}", "kind": "driver", "db": data["paths"][n],
             "k": kws[n][0], "kw": kws[n][1]} for n in names]


def _cli_jobs(out):
    return [
        {"id": "cli_assemble", "kind": "cli", "binary": "plass",
         "argv": ["assemble", *READS, os.path.join(out, "assembly_r{rank}.fas"),
                  os.path.join(out, "tmp_a{rank}"), *ASSEMBLE_ARGS,
                  "--device", "cpu", "--backend", "sharded"]},
        {"id": "cli_nuclassemble", "kind": "cli", "binary": "penguin",
         "argv": ["nuclassemble", *READS,
                  os.path.join(out, "contigs_r{rank}.fasta"),
                  os.path.join(out, "tmp_n{rank}"), *NUCL_ARGS,
                  "--device", "cpu", "--backend", "sharded"]},
        # HAMMING: the sharded hits' rescore columns are END_TO_END's, so
        # the rescore runs again on their device hits
        {"id": "cli_assemble_mode0", "kind": "cli", "binary": "plass",
         "argv": ["assemble", *READS,
                  os.path.join(out, "assembly_mode0_r{rank}.fas"),
                  os.path.join(out, "tmp_m{rank}"), *MODE0_ARGS,
                  "--device", "cpu", "--backend", "sharded"]}]


WORLD_JOBS = {1: ("protein",), 2: ("protein", "edge", "nucl"),
              4: ("protein",), 8: ("skew",)}


def _world_jobs(data, world):
    """The jobs of `world`'s ranks. World 1 runs without a coordinator, its
    first job the CLI (so that the CLI makes the one-rank group); world 2
    also runs both fixture workflows."""
    out = str(data["tmp"] / f"world{world}")
    jobs = []
    if world == 1:
        jobs = _cli_jobs(out)[:1]
        jobs.append({"id": "single_protein", "kind": "single",
                     "db": data["paths"]["protein"], "k": 14,
                     "kw": DRIVER_KW})
        jobs += [{"id": f"{kind}_cov{mode}", "kind": kind,
                  "db": data["paths"]["protein"], "k": 14,
                  "kw": dict(DRIVER_KW, include_only_extendable=False,
                             cov_thr=0.5, cov_mode=mode)}
                 for mode in (0, 1) for kind in ("driver", "single")]
    if world == 2:
        jobs = _cli_jobs(out)
        jobs.append({"id": "single_edge", "kind": "single",
                     "db": data["paths"]["edge"], "k": 14, "kw": EDGE_KW})
    jobs.append({"id": "step", "kind": "step", "batch": data["batch"],
                 "rows_per_shard": STEP_ROWS // world})
    jobs += _driver_jobs(data, WORLD_JOBS[world])
    for job in jobs:
        # world 1 also rescores the protein hits of both matchers
        if world == 1 and job["id"] in ("driver_protein", "single_protein"):
            job["rescore"] = True
    return jobs


@pytest.fixture(scope="module")
def ranks(data, jax_workflows):
    """ranks(world): the worker ranks of `world`. The worlds run one after
    another in a thread of their own, started with the first test that
    needs them (as are plass_tpu's workflows), while the JAX package's side
    runs in this process."""
    pool = ThreadPoolExecutor(1)
    futures = {world: pool.submit(_Ranks, data["tmp"], world,
                                  _world_jobs(data, world), world > 1)
               for world in WORLD_JOBS}
    yield lambda world: futures[world].result(timeout=4 * WORKER_TIMEOUT)
    pool.shutdown(wait=True)


def _jax_step(data, world):
    """The JAX package's sharded step on the batch over `world` of the 8
    virtual devices: its valid hits and columns in shard order."""
    import jax
    import jax.numpy as jnp
    from plass_tpu import constants
    from plass_tpu.ops.device_kmer import KmerParams
    from plass_tpu.parallel.mesh import make_mesh, sharded_iteration_fn

    seqs, lengths, keys, chars = data["batch_arrays"]
    params = KmerParams.protein_default(ksel=STEP_KSEL,
                                        kmers_per_sequence=STEP_KPS)
    blosum = constants.blosum62()
    cap = STEP_ROWS * (STEP_KSEL + 1)
    fn = sharded_iteration_fn(make_mesh(world), params, cap, cap,
                              blosum.alphabet_size)
    out = fn(jnp.asarray(seqs), jnp.asarray(lengths), jnp.asarray(keys),
             jnp.asarray(blosum.aa2num[chars]), jnp.asarray(chars),
             jnp.asarray(lengths),
             jnp.asarray(blosum.sub.astype(np.int32).reshape(-1)),
             jnp.asarray(np.arange(blosum.alphabet_size, dtype=np.int32)),
             jnp.asarray(blosum.num2aa.astype(np.uint8)),
             jnp.asarray(np.int32(67)))
    cr, ct, cs, cd, cv, score, first, last, idents, overflow, _ = (
        np.asarray(x) for x in out)
    assert int(overflow.sum()) == 0 and len(jax.devices()) >= world
    return np.stack([c[cv].astype(np.int64) for c in (
        cr, ct, cs, cd, score, first, last, idents)], 1)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_sharded_step_equals_jax_mesh_step(data, ranks, world):
    """sharded_iteration on `world` ranks, its hits gathered in rank order,
    equals plass_tpu's sharded_iteration_fn on a `world`-device mesh: the
    hits, their k-mer scores and diagonals, and K2's score, first, last and
    identity columns, row for row."""
    got = ranks(world).npy("step").astype(np.int64)
    want = _jax_step(data, world)
    assert len(want) > 40
    np.testing.assert_array_equal(got, want)


def _jax_driver(data, name, world, return_arrays=True):
    k, kw = {"nucl": (22, NUCL_KW), "edge": (14, EDGE_KW)}.get(
        name, (14, DRIVER_KW))
    return kmermatcher_sharded(data["jax"][name], k, n_devices=world,
                               return_arrays=return_arrays, **kw)


def _to_dict(flat):
    out = {}
    for q, t, s, d in zip(*(np.asarray(x).tolist() for x in flat[:4])):
        out.setdefault(q, []).append((t, s, d))
    return out


@pytest.mark.parametrize("world,name", [
    (world, name) for world, names in WORLD_JOBS.items() for name in names])
def test_sharded_driver_equals_jax(data, ranks, world, name):
    """kmermatcher_sharded_torch on `world` ranks equals plass_tpu's
    kmermatcher_sharded(n_devices=world), exactly: the flat arrays, the
    rescore columns they carry, and the hits dict of its dict path; every
    rank holds the same hits."""
    r = ranks(world)
    got = r.npz(f"driver_{name}")
    want = _jax_driver(data, name, world)
    for i in range(4):
        np.testing.assert_array_equal(got[f"flat{i}"], want[i], err_msg=i)
    for i in range(4):
        np.testing.assert_array_equal(got[f"pre{i}"], want.pre[i],
                                      err_msg=f"pre{i}")
    assert int(got["pre_mode"]) == want.pre_mode == 3
    assert _to_dict([got[f"flat{i}"] for i in range(4)]) == \
        _jax_driver(data, name, world, return_arrays=False)
    # the device hits are the flat hit rows, the rank's data its own
    slots = np.nonzero(got["flat0"] != got["flat1"])[0]
    np.testing.assert_array_equal(got["dev"][0], got["flat0"][slots])
    np.testing.assert_array_equal(got["dev"][3], got["flat2"][slots] < 0)
    for rank in range(1, world):
        other = r.npz(f"driver_{name}", rank)
        for key in got.files:
            if key != "exchange_bytes":
                np.testing.assert_array_equal(other[key], got[key])
    if name == "nucl":
        assert int((got["flat2"] < 0).sum()) > 500   # reverse-strand hits
    assert len(slots) > (1 if name == "edge" else 100)


def test_world_1_equals_the_single_device_matcher(data, ranks):
    """At world 1 there is no segment edge: the sharded driver equals
    kmermatcher_torch, flat arrays and device hits, and its rescore columns
    are K2's on those hits; with --cov-mode 0 and 1 too (the JAX package's
    device matchers take no cov_mode, the port's both honour it: C10)."""
    r = ranks(1)
    for sharded, single in (("driver_protein", "single_protein"),
                            ("driver_cov0", "single_cov0"),
                            ("driver_cov1", "single_cov1")):
        got, want = r.npz(sharded), r.npz(single)
        for key in ("flat0", "flat1", "flat2", "flat3", "dev"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert not np.array_equal(r.npz("driver_cov0")["flat0"],
                              r.npz("driver_cov1")["flat0"])
    assert int(r.npz("driver_protein")["table_entries"]) > 8000
    with pytest.raises(TypeError, match="cov_mode"):
        kmermatcher_sharded(data["jax"]["protein"], 14, cov_mode=1,
                            **DRIVER_KW)


def test_world_1_records_equal_the_single_device_path(data, ranks):
    """At world 1 rescore_diagonal_torch gives the same END_TO_END records
    on the sharded driver's hits as on kmermatcher_torch's: the driver's
    hits keep their K2 columns and the self rows, one a sequence, go to
    one launch of their own, while the single-device path launches the
    hits and the self rows together."""
    r = ranks(1)
    got, want = r.npz("driver_protein"), r.npz("single_protein")
    np.testing.assert_array_equal(got["rec_qk"], want["rec_qk"])
    np.testing.assert_array_equal(got["rec"], want["rec"])
    n = data["jax"]["protein"].size
    assert int(got["self_rows"]) == int(want["self_rows"]) == n
    assert got["launched"].tolist() == [n]
    assert want["launched"].tolist() == [len(want["flat0"])]
    assert len(got["rec"]) > n


def test_segment_edge_cuts_a_run_as_the_jax_package_does(data, ranks):
    """On the edge DB at world 2 the run of target X goes from A's pairs
    into B's on one device (hit (A, X) counts B's entries too) but stops at
    the segment edge between them: the sharded hits differ from
    kmermatcher_torch's in exactly that hit's score and best diagonal, and
    equal plass_tpu's sharded hits (test_sharded_driver_equals_jax)."""
    r = ranks(2)
    got, single = r.npz("driver_edge"), r.npz("single_edge")
    for i in (0, 1):
        np.testing.assert_array_equal(got[f"flat{i}"], single[f"flat{i}"])
    differ = np.nonzero((got["flat2"] != single["flat2"])
                        | (got["flat3"] != single["flat3"]))[0]
    assert [(int(got["flat0"][i]), int(got["flat1"][i])) for i in differ] \
        == [(EDGE_A, EDGE_X)]
    i = differ[0]
    assert 0 < got["flat2"][i] < single["flat2"][i]
    # B's hit on X is the same on both sides of the edge
    b_x = np.nonzero((got["flat0"] == EDGE_B) & (got["flat1"] == EDGE_X))[0]
    assert len(b_x) == 1 and got["flat2"][b_x[0]] > 0


def test_ranks_without_representatives(data, ranks):
    """At n 1,024 and world 2 the JAX package's padded row count is 2,048,
    so rank 0 owns every representative and rank 1 none: rank 1 selects
    and exchanges nothing of its own rows and sends nothing to gather."""
    r = ranks(2)
    assert int(r.npz("driver_protein", 1)["exchange_bytes"][2]) == 4
    assert int(r.npz("driver_protein", 0)["exchange_bytes"][2]) > 4


@pytest.mark.parametrize("workflow,golden,name", [
    ("assemble", "mini_golden_protein.fas", "assembly{}.fas"),
    ("nuclassemble", "mini_golden_nucl.fasta", "contigs{}.fasta"),
    ("assemble_mode0", None, "assembly_mode0{}.fas")])
def test_fixture_workflow_at_world_2_equals_golden_and_jax(
        ranks, jax_workflows, workflow, golden, name):
    """`plass assemble` / `penguin nuclassemble --backend sharded` on the
    fixture at world 2 (and `plass assemble --rescore-mode 0`, whose
    HAMMING rescore runs on the sharded matcher's device hits): each
    rank's output is byte-equal to plass_tpu's sharded run on a 2-device
    mesh and to the committed golden."""
    r = ranks(2)
    proc, out = jax_workflows
    log, _ = proc.communicate(timeout=WORKER_TIMEOUT)
    assert proc.returncode == 0, log[-3000:]
    want = (out / name.format("")).read_bytes()
    assert want.count(b">") >= 3
    if golden:
        assert want == open(os.path.join(FIX, golden), "rb").read()
    for rank in range(2):
        got = open(os.path.join(r.dir, name.format(f"_r{rank}")), "rb").read()
        assert got == want, rank
    info = r.info(0)[f"cli_{workflow}"]
    assert (info["world"], info["backend"], info["auto"]) == \
        (2, "gloo", "sharded")


def test_cli_sharded_without_a_coordinator_runs_world_1(ranks):
    """`plass assemble --backend sharded` with no coordinator in the
    environment runs in a gloo group of one rank, byte-equal to the
    golden; there auto stays on the single-device path."""
    r = ranks(1)
    info = r.info(0)["cli_assemble"]
    assert (info["world"], info["backend"], info["auto"]) == \
        (1, "gloo", "single")
    assert open(os.path.join(r.dir, "assembly_r0.fas"), "rb").read() == \
        open(os.path.join(FIX, "mini_golden_protein.fas"), "rb").read()


def test_backend_and_device_rules(monkeypatch):
    """resolve_backend: auto without a coordinator, numpy and jax are the
    single-device path and join no group; an unknown name raises. The
    collective backend follows the card names, never a failure. --device
    cuda without a card raises."""
    for name in ("PLASS_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    cpu = torch.device("cpu")
    for requested in ("auto", "numpy", "jax"):
        assert resolve_backend(requested, cpu) == "single"
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="--backend"):
        resolve_backend("tpu", cpu)
    card = torch.device("cuda", 0)
    assert distributed.collective_backend(cpu, [None, None]) == "gloo"
    assert distributed.collective_backend(card, ["h/a", "h/b"]) == \
        "cpu:gloo,cuda:nccl"
    assert distributed.collective_backend(card, ["h/a", "h/a"]) == "gloo"
    assert distributed.collective_backend(card, ["h/a"]) == \
        "cpu:gloo,cuda:nccl"
    assert distributed.rank_device("cpu") == cpu
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.rank_device("cuda")
    monkeypatch.setenv("PLASS_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("PLASS_NUM_PROCESSES", "4")
    monkeypatch.setenv("PLASS_PROCESS_ID", "3")
    assert distributed.coordinator() == ("127.0.0.1", 1, 4, 3)
    monkeypatch.delenv("PLASS_PROCESS_ID")
    with pytest.raises(ValueError, match="PLASS_PROCESS_ID"):
        distributed.coordinator()
    monkeypatch.delenv("PLASS_COORDINATOR")
    monkeypatch.delenv("PLASS_NUM_PROCESSES")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29501")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert distributed.coordinator() == ("10.0.0.1", 29501, 2, 1)


def test_a_failing_rank_fails_every_rank_without_hanging(data, tmp_path):
    """Rank 1 raises after joining the group; rank 0, in the exchange of
    the driver, fails too instead of waiting, and both exit non-zero well
    within the group's timeout."""
    import time

    jobs = [{"id": "fail", "kind": "fail", "rank": 1}] + \
        _driver_jobs(data, ("protein",))
    t0 = time.perf_counter()
    results = _run_ranks(2, jobs, str(tmp_path / "fail"), timeout=120,
                         expect_ok=False)
    assert time.perf_counter() - t0 < 100
    assert [rc != 0 for rc, _ in results] == [True, True], results
    assert "fails on purpose" in results[1][1]


@pytest.mark.parametrize("n", [0, 1, 1024, 2048, 2049, 16384, 16385,
                               217020, 10**6])
def test_segment_edges_follow_the_jax_padded_rows(n):
    """The sharded driver's segment length is plass_tpu's padded row count
    over the world: padded_rows equals its backend._bucket at
    db_to_padded's 2,048-row step (protein x400's 217,020 ORFs pad to
    229,376)."""
    from plass_tpu.ops.backend import _bucket
    from plass_tpu_torch.ops.backend import padded_rows

    assert padded_rows(n) == _bucket(n, 2048)
    if n == 217020:
        assert padded_rows(n) == 229376


def test_port_reads_a_db_the_jax_package_wrote(data):
    """The workers open the DBs this module writes with plass_tpu's
    DBWriter through the port's SeqDB: the same keys and residues."""
    for name in ("edge", "protein"):
        port = port_seqdb.SeqDB.open(data["paths"][name])
        jdb = data["jax"][name]
        np.testing.assert_array_equal(port.keys, jdb.keys)
        assert port.get_seq_bytes(port.size - 1) == \
            jdb.get_seq_bytes(jdb.size - 1)
