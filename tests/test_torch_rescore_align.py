"""PyTorch port, kernel B12: the ALIGNMENT rescore of --rescore-mode 2.
rescore_align_plain (the CPU path of rescore_align, the oracle of the
CUDA kernel) hit by hit against the JAX package's host loop
ops/rescore.ungapped_by_diagonal (mode 2) on edge rows of both alphabets;
rescore_diagonal_torch at mode 2 record for record against the JAX
package's host rescore_diagonal on seeded protein and nucleotide DBs;
`plass assemble` and `penguin nuclassemble` at --rescore-mode 2 byte for
byte against plass_tpu at backend "numpy" (its host path, the only one
that takes mode 2); and the modes and backends the port refuses. Exact:
every output is an integer, a record or a file's bytes."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from plass_tpu import constants
from plass_tpu.data import seqdb
from plass_tpu.ops.evalue import EvalueComputer
from plass_tpu.ops.rescore import (RescoreParams, rescore_diagonal,
                                   ungapped_by_diagonal)
from plass_tpu.workflow.assemble import AssembleParams as JaxParams
from plass_tpu.workflow.assemble import run_assemble as jax_run_assemble
from plass_tpu.workflow.nuclassemble import NuclAssembleParams as JaxNuclParams
from plass_tpu.workflow.nuclassemble import run_nuclassemble as jax_run_nucl
from plass_tpu_torch.data import seqdb as port_seqdb
from plass_tpu_torch.ops.backend import (kmermatcher_torch,
                                         rescore_diagonal_torch)
from plass_tpu_torch.ops.rescore import RescoreParams as PortRescoreParams
from plass_tpu_torch.ops.rescore_kernel import (rescore_align,
                                                rescore_align_plain,
                                                uniform_pattern)
from test_torch_nucl_kmer import ACGT, sample_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
GOLDEN = {"assemble": os.path.join(FIX, "mini_golden_protein.fas"),
          "nuclassemble": os.path.join(FIX, "mini_golden_nucl.fasta")}
AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
CPU = torch.device("cpu")


def _matrix(nucl):
    return constants.nucleotide() if nucl else constants.blosum62()


def _flat(seqs):
    """(rows, offsets, lengths) tensors of the byte arrays `seqs` laid out
    as a SeqDB's data, each followed by its "\\n\\0" terminator."""
    parts, offsets, pos = [], [], 0
    for s in seqs:
        offsets.append(pos)
        parts.append(s.tobytes() + b"\n\x00")
        pos += len(s) + 2
    return (torch.from_numpy(np.frombuffer(b"".join(parts), np.uint8).copy()),
            torch.tensor(offsets, dtype=torch.int64),
            torch.tensor([len(s) for s in seqs], dtype=torch.int32))


def _edge_seqs(nucl, rng):
    """Rows that give windows of 1, all-negative windows, runs of X (N)
    and '*' at both ends, ties between equal maxima (a positive run, a
    negative run that brings the sum back to 0, the same positive run),
    lower case, and random rows of the alphabet with '*' and X."""
    if nucl:
        letters = np.frombuffer(b"ACGTNacgt*", np.uint8)
        fixed = [b"A", b"N", b"NNNN", b"**", b"NNACGTACNN", b"*ACGTA*",
                 b"ACGTNNNNNNNNACGT", b"AAAANNNNNNNNNNNNNNNNNNNNAAAA",
                 b"acgtACGT", b"TTTT"]
    else:
        letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX*xa", np.uint8)
        fixed = [b"W", b"X", b"XXXX", b"**", b"XX*WCW*XX", b"*ACDEW*",
                 b"W" + b"X" * 11 + b"W", b"WWXXXXXXXXXXXXXXXXXXXXXXWW",
                 b"wcWC", b"PPPP"]
    seqs = [np.frombuffer(s, np.uint8).copy() for s in fixed]
    seqs += [letters[rng.integers(0, len(letters), int(n))]
             for n in rng.integers(1, 90, 40)]
    return seqs


def _host_align(seqs, q, t, d, rv, mat):
    """(score, first, last, idents) per hit from the JAX package's host
    loop: the segment's case-folded identities as its rescore_diagonal
    counts them; no overlap gives (0, -1, -1, 0), no positive score
    (0, 0, 0, 0)."""
    def revcomp(arr):
        return mat.num2aa[mat.reverse[mat.aa2num[arr]]][::-1]
    out = []
    for i in range(len(q)):
        qs = revcomp(seqs[q[i]]) if rv[i] else seqs[q[i]]
        ts = seqs[t[i]]
        sc, st, en, dl, dist = ungapped_by_diagonal(qs, ts, int(d[i]),
                                                    mat.ascii_mat, 2)
        if dl == 0:
            out.append((0, -1, -1, 0))
            continue
        if sc == 0:
            out.append((0, 0, 0, 0))
            continue
        qo, to = (dist, 0) if d[i] >= 0 else (0, dist)
        qw = qs[st + qo:en + qo + 1] & 0xDF
        tw = ts[st + to:en + to + 1] & 0xDF
        out.append((sc, st, en, int((qw == tw).sum())))
    return np.array(out, dtype=np.int64).reshape(-1, 4)


@pytest.mark.parametrize("nucl", [False, True], ids=["protein", "nucl"])
def test_align_plain_matches_host_loop(nucl):
    """Every pair of edge rows on a spread of diagonals (overlaps from none
    to the whole row), nucleotide hits on both strands."""
    rng = np.random.default_rng(5 if nucl else 4)
    mat = _matrix(nucl)
    seqs = _edge_seqs(nucl, rng)
    n = len(seqs)
    a, b = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    q = np.repeat(a.ravel(), 3)
    t = np.repeat(b.ravel(), 3)
    d = rng.integers(-95, 95, len(q))
    d[::3] = 0
    rv = rng.random(len(q)) < 0.5 if nucl else np.zeros(len(q), bool)
    # row 6 with itself on its diagonal, forward: two equal maxima
    tie = (6 * n + 6) * 3
    rv[tie] = False
    rows, offsets, lengths = _flat(seqs)
    kw = {}
    if nucl:
        kw = dict(qrev=torch.from_numpy(rv),
                  comp=torch.from_numpy(mat.reverse.astype(np.int32)),
                  code2char=torch.from_numpy(mat.num2aa.astype(np.uint8)),
                  uniform=uniform_pattern(mat.sub))
    i32 = lambda x: torch.from_numpy(np.asarray(x, dtype=np.int32))
    args = (rows, offsets, lengths,
            torch.from_numpy(mat.aa2num.astype(np.uint8)), i32(q), i32(t),
            i32(d), torch.from_numpy(mat.sub.astype(np.int32)))
    # a small budget: many chunks, each as wide as the longest window
    got = np.stack([x.numpy() for x in rescore_align_plain(
        *args, budget=4096, **kw)], 1)
    want = _host_align(seqs, q, t, d, rv, mat)
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        np.stack([x.numpy() for x in rescore_align(*args, **kw)], 1), want)
    # the cases are there: no overlap, windows of 1, no positive score,
    # segments that stop short of either window end, a tie kept at its
    # first end (the W...W self row), and reverse hits that score
    ov = np.minimum(lengths.numpy()[t], lengths.numpy()[q])
    assert (want[:, 1] == -1).sum() and ((want[:, 0] == 0)
                                          & (want[:, 1] == 0)).sum()
    assert ((d == 0) & (ov == 1) & (want[:, 1] == 0)).sum()
    assert ((want[:, 0] > 0) & (want[:, 1] > 0)).sum()
    assert q[tie] == t[tie] == 6 and d[tie] == 0
    assert tuple(want[tie, :3]) == ((8, 0, 3) if nucl else (11, 0, 0))
    if nucl:
        assert (want[rv, 0] > 0).sum() > 10


def _protein_dbs(seed=11, n=300):
    """Reads of one random protein with 2% substitutions, some beginning or
    ending with '*', and rows that begin and end with runs of X and '*'
    (their self rows stop short of both ends)."""
    rng = np.random.default_rng(seed)
    genome = AA[rng.integers(0, 20, 2000)]
    recs = []
    for i in range(n):
        ln = int(rng.integers(20, 110))
        s = int(rng.integers(0, len(genome) - ln))
        seq = genome[s:s + ln].copy()
        mut = rng.random(ln) < 0.02
        seq[mut] = AA[rng.integers(0, 20, int(mut.sum()))]
        if i % 5 == 0:
            seq[0] = ord("*")
        if i % 7 == 0:
            seq[-1] = ord("*")
        if i % 11 == 0:
            k = int(rng.integers(2, 9))
            seq[:k] = ord("X")
            seq[-k:] = ord("X")
            seq[k] = ord("*")
        recs.append(seq.tobytes())
    recs += [b"XXXXXX", b"**X**", b"X*W*X"]
    return (seqdb.SeqDB.from_records(recs, dbtype=seqdb.AMINO_ACIDS),
            port_seqdb.SeqDB.from_records(recs,
                                          dbtype=port_seqdb.AMINO_ACIDS))


def _nucl_dbs(seed=17, n=400):
    """Reads of one random genome from both strands with 1% substitutions,
    some with runs of N at both ends, some in lower case."""
    rng = np.random.default_rng(seed)
    genome = ACGT[rng.integers(0, 4, 3000)]
    recs = sample_reads(genome, n, rng, sub_rate=0.01)
    recs = [b"NNN" + r[3:-3] + b"NNN" if i % 9 == 0 else r
            for i, r in enumerate(recs)]
    recs = [r.lower() if i % 7 == 0 else r for i, r in enumerate(recs)]
    return (seqdb.SeqDB.from_records(recs, dbtype=seqdb.NUCLEOTIDES),
            port_seqdb.SeqDB.from_records(recs,
                                          dbtype=port_seqdb.NUCLEOTIDES))


def _hits_dict(hits):
    """The port's KmerHits (self rows included) as the JAX package's hits
    dict, in the same order."""
    out = {}
    for q, t, s, d in zip(*(np.asarray(x).tolist() for x in hits)):
        out.setdefault(q, []).append((t, s, d))
    return out


DBS = {"protein": (_protein_dbs, 14, dict(
           kmers_per_sequence=60, hash_shift=67, ignore_multi_kmer=True,
           include_only_extendable=False), 0.9),
       "nucl": (_nucl_dbs, 22, dict(
           kmers_per_sequence=60, kmers_per_sequence_scale=0.1,
           hash_shift=67, ignore_multi_kmer=True,
           include_only_extendable=False), 0.99)}


@pytest.mark.parametrize("which", list(DBS))
def test_align_records_match_host_rescore(which):
    """rescore_diagonal_torch(mode 2) on kmermatcher_torch's hits against
    the JAX package's host rescore_diagonal(mode 2) on the same hits:
    the same records per query, self rows included; mode 3's records
    differ on some of them."""
    make, k, kw, seq_id = DBS[which]
    jdb, pdb = make()
    hits = kmermatcher_torch(pdb, k, CPU, **kw)
    rp = dict(rescore_mode=2, seq_id_thr=seq_id, eval_thr=1e-5)
    nucl = which == "nucl"
    ev = EvalueComputer.for_matrix(
        "nucleotide_ungapped" if nucl else "blosum62_ungapped",
        jdb.total_residues())
    want = rescore_diagonal(jdb, _hits_dict(hits), RescoreParams(**rp), ev)
    got = rescore_diagonal_torch(pdb, hits, PortRescoreParams(**rp))
    assert got.keys() == want.keys()
    # every field exact but the E-value: the port's records come from the
    # native finish (native/finish.cpp, libm's exp and erfc), the host
    # path's from numpy, and the two differ in the last bits (relative
    # 1.1e-13 here); no stage reads the field, and the filters it gates
    # are held by the workflows' byte equality below
    for key in want:
        g, w = got[key], want[key]
        assert len(g) == len(w), key
        for name in w.dtype.names:
            if name == "eval":
                np.testing.assert_allclose(g[name], w[name], rtol=1e-12,
                                           err_msg=str(key))
            else:
                np.testing.assert_array_equal(g[name], w[name],
                                              err_msg=f"{key} {name}")
    recs = np.concatenate(list(got.values()))
    assert len(recs) > pdb.size
    if nucl:   # reverse hits survive: their query coordinates run backwards
        assert (recs["qStartPos"] > recs["qEndPos"]).sum() >= 2
    # self rows that stop short of their ends (runs of X or '*')
    lens = jdb.seq_lens()
    lut = jdb.id_lookup_array()
    short_self = [r for key, rs in got.items() for r in rs
                  if r["dbKey"] == key and r["alnLength"] < lens[lut[key]]]
    assert short_self
    e2e = rescore_diagonal_torch(pdb, hits, PortRescoreParams(
        **dict(rp, rescore_mode=3)))
    differ = sum(len(e2e[key]) != len(got[key])
                 or not np.array_equal(e2e[key], got[key]) for key in got)
    assert differ > 5


def _make_reads():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_reads


@pytest.mark.parametrize("workflow", ["assemble", "nuclassemble"])
@pytest.mark.parametrize("reads", ["fixture", "substituted"])
def test_workflow_mode_2_equals_jax_host_path(tmp_path, workflow, reads):
    """Two iterations at --rescore-mode 2 through the port's CLI equal
    plass_tpu's run at backend "numpy": on the fixture (the committed
    goldens, which plass_tpu's mode-2 run also gives) and on the fixture's
    reads twice, the second copy with 1.5% substitutions, where mode 3
    gives other bytes."""
    from plass_tpu_torch.cli import penguin, plass

    inputs = READS
    if reads == "substituted":
        inputs = [str(tmp_path / "reads.fasta")]
        _make_reads()(inputs[0], 2)
    nucl = workflow == "nuclassemble"
    extra = ["--num-iterations", "2"] + (
        ["--min-contig-len", "150"] if nucl else ["--filter-proteins", "0"])
    want = str(tmp_path / "jax.out")
    if nucl:
        jax_run_nucl(inputs, want, str(tmp_path / "jtmp"), JaxNuclParams(
            num_iterations=2, min_contig_len=150, rescore_mode=2,
            backend="numpy"))
    else:
        jax_run_assemble(inputs, want, str(tmp_path / "jtmp"), JaxParams(
            num_iterations=2, filter_proteins=0, rescore_mode=2,
            backend="numpy"))
    run = (penguin if nucl else plass).run

    def port(mode):
        out = str(tmp_path / f"port{mode}.out")
        assert run([workflow, *inputs, out, str(tmp_path / f"ptmp{mode}"),
                    "--rescore-mode", str(mode), "--device", "cpu",
                    *extra]) == 0
        return open(out, "rb").read()

    data = port(2)
    assert data == open(want, "rb").read()
    if reads == "fixture":
        assert data == open(GOLDEN[workflow], "rb").read()
    else:
        assert data.count(b">") > 50
        assert port(3) != data


def test_refused_modes_and_backend(tmp_path):
    """Modes 1 and 4 raise in the rescore, as plass_tpu fails on both on
    every path; --backend sharded refuses mode 2 before it joins a process
    group, as plass_tpu's sharded path fails on it."""
    import torch.distributed as dist
    from plass_tpu_torch.workflow.assemble import (AssembleParams,
                                                   run_assemble)
    from plass_tpu_torch.workflow.nuclassemble import (NuclAssembleParams,
                                                       run_nuclassemble)

    _, pdb = _protein_dbs(n=40)
    hits = kmermatcher_torch(pdb, 14, CPU, **DBS["protein"][2])
    for mode in (1, 4):
        with pytest.raises(NotImplementedError, match=f"mode {mode}"):
            rescore_diagonal_torch(pdb, hits,
                                   PortRescoreParams(rescore_mode=mode))
    for run, params in ((run_assemble, AssembleParams),
                        (run_nuclassemble, NuclAssembleParams)):
        with pytest.raises(ValueError, match="rescore-mode 2"):
            run(READS, str(tmp_path / "x.out"), str(tmp_path / "tmp"),
                params(device="cpu", backend="sharded", rescore_mode=2))
    assert not dist.is_initialized()
    assert not (tmp_path / "x.out").exists()


def test_native_extender_failure_raises(monkeypatch):
    """A failure of the native protein extender (extend.cpp) raises: no
    silent fallback to the Python pass."""
    from plass_tpu_torch.assembler import extend

    def fail(*args, **kw):
        raise RuntimeError("native extender failed")

    monkeypatch.setattr(extend, "_assemble_native", fail)
    _, pdb = _protein_dbs(n=40)
    with pytest.raises(RuntimeError, match="native extender failed"):
        extend.assemble(pdb, {int(k): [] for k in pdb.keys})
