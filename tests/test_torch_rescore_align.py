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
from hypothesis import given, settings
from hypothesis import strategies as st

from plass_tpu import constants
from plass_tpu.data import seqdb
from plass_tpu.ops.evalue import EvalueComputer
from plass_tpu.ops.rescore import (RescoreParams, rescore_diagonal,
                                   ungapped_best, ungapped_by_diagonal)
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
    # no row passes 32,768: each hit's own diagonal is its only candidate
    want = np.concatenate([_host_align(seqs, q, t, d, rv, mat), d[:, None]],
                          1)
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


# ---------------------------------------------------------------------------
# Rows over 32,768 residues: the host's ungapped_best scores every diagonal
# 65,536 apart that shares the hit's 16 low bits (negative ones first, the
# first strictly greater score wins) and reports the winner's diagonal

NT = np.frombuffer(b"ACGT", np.uint8)


def _revcomp(seq):
    mat = constants.nucleotide()
    return mat.num2aa[mat.reverse[mat.aa2num[seq]]][::-1].copy()


def _wrap_rows(rng, qlen, tlen, runs):
    """A query and a target row of random bases where, for each (diagonal,
    run length, run offset) of `runs`, the diagonal's window mismatches on
    every residue but a run of equal bases at the offset: that window's
    best segment is the run, its score twice the run's length."""
    q = NT[rng.integers(0, 4, qlen)]
    t = NT[rng.integers(0, 4, tlen)]
    taken = np.zeros(qlen, bool)
    for d, n, off in runs:
        qo, to = (d, 0) if d >= 0 else (0, -d)
        ov = min(qlen - qo, tlen - to)
        assert ov > off + n and not taken[qo:qo + ov].any()
        taken[qo:qo + ov] = True
        tw = t[to:to + ov]
        qw = NT[(np.searchsorted(NT, tw) + 1) % 4]
        qw[off:off + n] = tw[off:off + n]
        q[qo:qo + ov] = qw
    return q, t


# (query length, target length, hit diagonal, runs, reverse): the runs'
# diagonals are the candidates the case plants segments on
C12_CASES = {
    # the wrapped diagonal r - 65,536 outscores the hit's own
    "wrapped": (40000, 40000, 30000, ((30000, 300, 4000),
                                      (-35536, 900, 1000)), False),
    # equal scores: the negative candidate, scored first, keeps the tie
    "tie": (40000, 40000, 30000, ((30000, 500, 7000),
                                  (-35536, 500, 2000)), False),
    # the hit's own diagonal wins: a later candidate needs a greater score
    "own": (40000, 40000, 30000, ((30000, 800, 100),
                                  (-35536, 799, 3000)), False),
    # a reverse-strand hit: the planted rows are the query's reverse
    # complement, as the rescore reads it
    "reverse": (40000, 40000, 30000, ((30000, 200, 9000),
                                      (-35536, 400, 10)), True),
    # a query over 65,536: the positive candidate 65,536 + u16 wins, also
    # for a hit whose own diagonal is that candidate's twin
    "long_row": (70000, 5000, 1000, ((1000, 100, 50),
                                     (66536, 700, 2000)), False),
}


def _c12_hits(nucl_rows, cases):
    """A nucleotide DB of each case's query and target rows, and the
    port's KmerHits of one hit a case (self rows included)."""
    from plass_tpu_torch.ops.backend import _insert_self_hits

    keys = np.arange(len(nucl_rows), dtype=np.uint32)
    recs = [r.tobytes() for r in nucl_rows]
    jdb = seqdb.SeqDB.from_records(recs, dbtype=seqdb.NUCLEOTIDES)
    pdb = port_seqdb.SeqDB.from_records(recs, dbtype=port_seqdb.NUCLEOTIDES)
    rep, tgt, score, diag = (np.array(x) for x in zip(*cases))
    hits = _insert_self_hits(pdb, rep.astype(np.uint32),
                             tgt.astype(np.uint32), score, diag)
    dev = lambda x, dt: torch.from_numpy(np.asarray(x).astype(dt))
    hits.dev = (dev(rep, np.int32), dev(tgt, np.int32),
                dev(diag, np.int32), dev(score < 0, bool))
    assert np.array_equal(pdb.keys, keys)
    return jdb, pdb, hits


def _c12_inputs(names):
    rng = np.random.default_rng(23)
    rows, cases = [], []
    for name in names:
        qlen, tlen, d, runs, rv = C12_CASES[name]
        q, t = _wrap_rows(rng, qlen, tlen, runs)
        if rv:
            q = _revcomp(q)
        cases.append((len(rows), len(rows) + 1, -30 if rv else 30, d))
        rows += [q, t]
    # a second hit on "long_row"'s rows whose own diagonal is 66,536
    if "long_row" in names:
        i = names.index("long_row")
        cases.append((2 * i, 2 * i + 1, 30, 66536))
    return _c12_hits(rows, cases)


@pytest.mark.parametrize("name", list(C12_CASES))
def test_align_long_rows_match_host_rescore(name):
    """rescore_diagonal_torch at mode 2 on rows over 32,768 residues: the
    records of plass_tpu's host rescore_diagonal (ungapped_best), field
    for field; the planted winner is the one reported."""
    jdb, pdb, hits = _c12_inputs([name])
    rp = dict(rescore_mode=2, eval_thr=1e-5)
    ev = EvalueComputer.for_matrix("nucleotide_ungapped",
                                   jdb.total_residues())
    want = rescore_diagonal(jdb, _hits_dict(hits), RescoreParams(**rp), ev)
    got = rescore_diagonal_torch(pdb, hits, PortRescoreParams(**rp))
    assert got.keys() == want.keys()
    for key in want:
        g, w = got[key], want[key]
        assert len(g) == len(w), key
        for field in w.dtype.names:
            if field == "eval":
                np.testing.assert_allclose(g[field], w[field], rtol=1e-12,
                                           err_msg=str(key))
            else:
                np.testing.assert_array_equal(g[field], w[field],
                                              err_msg=f"{key} {field}")
    # the winner: alnLength is the planted run's, and the target start
    # gives the winning diagonal
    n, d = {"wrapped": (900, -35536), "tie": (500, -35536),
            "own": (800, 30000), "reverse": (400, -35536),
            "long_row": (700, 66536)}[name]
    runs = C12_CASES[name][3]
    off = runs[[x[0] for x in runs].index(d)][2]
    recs = [r for r in got[0] if r["dbKey"] == 1]
    assert [r["alnLength"] for r in recs] == [n] * len(recs)
    assert [r["dbStartPos"] for r in recs] == [off + max(-d, 0)] * len(recs)
    assert len(recs) == (2 if name == "long_row" else 1)


def test_align_plain_wrap_candidates_match_ungapped_best():
    """rescore_align_plain's five outputs on rows over 32,768 against
    plass_tpu's ungapped_best hit by hit: every C12 case, each on a spread
    of diagonals, both strands, and rows with no positive window (the
    port keeps the hit's own diagonal and its (0, 0, 0, 0) or (0, -1, -1,
    0) there, where the host reports (0, -1, -1) on diagonal 0; the
    rescore drops those hits either way)."""
    mat = constants.nucleotide()
    rng = np.random.default_rng(29)
    rows = []
    for name in C12_CASES:
        qlen, tlen, _, runs, _ = C12_CASES[name]
        rows += list(_wrap_rows(rng, qlen, tlen, runs))
    # rows that mismatch on every diagonal of both strands: no candidate
    # scores above 0
    rows += [np.full(34000, ord("A"), np.uint8),
             np.full(34000, ord("C"), np.uint8)]
    n = len(rows)
    q = np.repeat(np.arange(0, n, 2), 8)
    t = q + 1
    d = rng.integers(-39000, 39000, len(q))
    d[::8] = [C12_CASES[x][2] for x in C12_CASES] + [0]
    d[1::8] = 66536
    rv = rng.random(len(q)) < 0.5
    rv[::8] = False
    rows_t, offsets, lengths = _flat(rows)
    i32 = lambda x: torch.from_numpy(np.asarray(x, dtype=np.int32))
    got = np.stack([x.numpy() for x in rescore_align_plain(
        rows_t, offsets, lengths,
        torch.from_numpy(mat.aa2num.astype(np.uint8)), i32(q), i32(t), i32(d),
        torch.from_numpy(mat.sub.astype(np.int32)),
        qrev=torch.from_numpy(rv),
        comp=torch.from_numpy(mat.reverse.astype(np.int32)),
        code2char=torch.from_numpy(mat.num2aa.astype(np.uint8)),
        uniform=uniform_pattern(mat.sub))], 1)
    won = 0
    for i in range(len(q)):
        qs = _revcomp(rows[q[i]]) if rv[i] else rows[q[i]]
        sc, st, en, dl, dist, dg = ungapped_best(qs, rows[t[i]], int(d[i]),
                                                 mat.ascii_mat, 2)
        if sc == 0:
            assert got[i, 0] == 0 and got[i, 4] == d[i], i
            continue
        assert tuple(got[i, [0, 1, 2, 4]]) == (sc, st, en, dg), i
        won += dg != d[i]
    assert won >= 5 and (got[:, 0] == 0).sum() >= 8


# ---------------------------------------------------------------------------
# B12's scans and fold (csrc/rescore.cu: align_scan, combine_align,
# align_short), as Python: summaries of contiguous pieces of a window, each
# with its identity counts, folded into the host loop's (score, start,
# end, idents)

NEG_INF = -(1 << 30)


def _scan_piece(s, e, lo, hi):
    """align_scan over [lo, hi): s the window's scores, e its case-folded
    identities (0/1)."""
    r = dict(sum=0, isum=0, mn=0, mn_at=lo - 1, imn=0, mx=NEG_INF, mx_at=lo,
             imx=0, best=0, start=0, end=0, bid=0)
    score = ic = 0
    for p in range(lo, hi):
        ic += e[p]
        r["sum"] += s[p]
        if r["sum"] > r["mx"]:
            r.update(mx=r["sum"], mx_at=p, imx=ic)
        reset = score + s[p] <= 0
        score = max(0, score + s[p])
        if reset:
            r.update(mn_at=p, imn=ic)
        if score > r["best"]:
            r.update(best=score, start=r["mn_at"] + 1, end=p,
                     bid=ic - r["imn"])
    r.update(isum=ic, mn=r["sum"] - score)
    return r


def _combine(lt, rt):
    """combine_align: the summary of lt's piece followed by rt's."""
    c = dict(sum=lt["sum"] + rt["sum"], isum=lt["isum"] + rt["isum"])
    if lt["sum"] + rt["mn"] <= lt["mn"]:
        c.update(mn=lt["sum"] + rt["mn"], mn_at=rt["mn_at"],
                 imn=lt["isum"] + rt["imn"])
    else:
        c.update(mn=lt["mn"], mn_at=lt["mn_at"], imn=lt["imn"])
    if rt["mx"] != NEG_INF and lt["sum"] + rt["mx"] > lt["mx"]:
        c.update(mx=lt["sum"] + rt["mx"], mx_at=rt["mx_at"],
                 imx=lt["isum"] + rt["imx"])
    else:
        c.update(mx=lt["mx"], mx_at=lt["mx_at"], imx=lt["imx"])
    across = (NEG_INF if rt["mx"] == NEG_INF
              else lt["sum"] + rt["mx"] - lt["mn"])
    if across > rt["best"] or (across == rt["best"]
                               and rt["mx_at"] < rt["end"]):
        seg = (across, lt["mn_at"] + 1, rt["mx_at"],
               lt["isum"] + rt["imx"] - lt["imn"])
    else:
        seg = (rt["best"], rt["start"], rt["end"], rt["bid"])
    if lt["best"] >= seg[0]:
        seg = (lt["best"], lt["start"], lt["end"], lt["bid"])
    c.update(best=seg[0], start=seg[1], end=seg[2], bid=seg[3])
    return c


def _scan_short(s, e, n):
    """align_short: the first pass's scan of a whole window, positions and
    identity counts packed as (position << 16) | identities."""
    score = ic = best = 0
    at_min = at_start = at_end = 0
    for p in range(n):
        ic += e[p]
        reset = score + s[p] <= 0
        score = max(0, score + s[p])
        if reset:
            at_min = ((p + 1) << 16) + ic
        if score > best:
            best, at_start, at_end = score, at_min, (p << 16) + ic
    return dict(best=best, start=at_start >> 16, end=at_end >> 16,
                bid=(at_end & 0xFFFF) - (at_start & 0xFFFF))


def _tree_fold(parts):
    """The fold of fold_align: at step o, piece i takes in piece i + o."""
    parts = list(parts)
    o = 1
    while o < len(parts):
        parts = [_combine(p, parts[i + o]) if i + o < len(parts) else p
                 for i, p in enumerate(parts)]
        o *= 2
    return parts[0]


@settings(max_examples=400, deadline=None)
@given(st.data())
def test_align_fold_matches_host_loop(data):
    """For random windows, of an alphabet that makes ties common, split at
    random points into pieces (some empty): both folds of the pieces'
    summaries, and the first pass's packed scan of the whole window, give
    plass_tpu's host loop (ungapped_by_diagonal, mode 2) and the
    case-folded identities over its segment."""
    nucl = data.draw(st.booleans())
    mat = _matrix(nucl)
    letters = np.frombuffer(b"ACGTNacg" if nucl else b"AWIVawX*", np.uint8)
    n = data.draw(st.integers(0, 70))
    draw = lambda: np.array(data.draw(st.lists(
        st.integers(0, len(letters) - 1), min_size=n, max_size=n)), int)
    q, t = letters[draw()], letters[draw()]
    cuts = sorted(data.draw(st.lists(st.integers(0, n), max_size=9)))
    s = mat.ascii_mat[q, t].astype(int).tolist()
    e = ((q & 0xDF) == (t & 0xDF)).astype(int).tolist()
    bounds = [0] + cuts + [n]
    parts = [_scan_piece(s, e, lo, hi) for lo, hi in zip(bounds, bounds[1:])]
    sc, st_, en, _, _ = ungapped_by_diagonal(q, t, 0, mat.ascii_mat, 2)
    want = (sc, st_, en, int(sum(e[st_:en + 1])) if sc > 0 else 0)
    if n == 0:
        want = (0, 0, 0, 0)
    left = parts[0]
    for p in parts[1:]:
        left = _combine(left, p)
    for got in (left, _tree_fold(parts), _scan_piece(s, e, 0, n),
                _scan_short(s, e, n)):
        assert (got["best"], got["start"], got["end"], got["bid"]) == want
