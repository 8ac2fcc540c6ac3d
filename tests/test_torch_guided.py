"""PyTorch port, the guided slice: `penguin guided_nuclassemble` on the CPU
against a live run of the JAX package (backend="jax"), as a whole on the
mini fixtures and module by module on reads made from a numpy seed.
Tolerance: exact everywhere (integers and bytes).

The seeded reads tile random genes (ATG ... TAA, no inner stop codon) with
overlapping 150-nt windows from both strands, so the ORF rows begin or end
with the '*' of --add-orf-stop and the guided extender does grow contigs.
Every amino-acid row here is shorter than 1,024 residues: the JAX matcher
takes its narrow select_kmers branch (p <= 1024); the port has one branch,
whose sort key is total with ignore_multi_kmer."""
import os

import numpy as np
import pytest
import torch

from plass_tpu.assembler import guided_extend as ref_gext
from plass_tpu.data import seqdb as ref_seqdb
from plass_tpu.ops import kmermatch as ref_kmermatch
from plass_tpu.ops import nucl_align as ref_nucl_align
from plass_tpu.ops import orf as ref_orf
from plass_tpu.ops import proteinaln2nucl as ref_p2n
from plass_tpu.ops import translate as ref_tr
from plass_tpu.ops.backend import kmermatcher_jax, rescore_diagonal_jax
from plass_tpu.ops.rescore import RescoreParams as RefRescoreParams
from plass_tpu.workflow import guided as ref_guided
from plass_tpu.workflow import linclust as ref_linclust
from plass_tpu_torch.assembler import guided_extend as port_gext
from plass_tpu_torch.data import seqdb
from plass_tpu_torch.ops import kmermatch as port_kmermatch
from plass_tpu_torch.ops import nucl_align as port_nucl_align
from plass_tpu_torch.ops import proteinaln2nucl as port_p2n
from plass_tpu_torch.ops.backend import (kmermatcher_torch,
                                         rescore_diagonal_torch)
from plass_tpu_torch.ops.hashes import seq_hash_np, xxh64_u64_np
from plass_tpu_torch.ops.rescore import RescoreParams
from plass_tpu_torch.workflow import guided as port_guided
from plass_tpu_torch.workflow import linclust as port_linclust

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.zeros(256, dtype=np.uint8)
COMP[ACGT] = np.frombuffer(b"TGCA", dtype=np.uint8)
AA_MATCH = dict(kmers_per_sequence=60, kmers_per_sequence_scale=0.1,
                hash_shift=67, ignore_multi_kmer=True,
                include_only_extendable=True)
AA_RESCORE = dict(rescore_mode=3, seq_id_thr=0.97, cov_thr=0.0, cov_mode=1,
                  eval_thr=1e-5)


def _port_db(db):
    return seqdb.SeqDB(db.data, db.keys, db.offsets, db.lengths, db.dbtype)


def _assert_db_equal(got, want):
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.offsets, want.offsets)
    assert np.array_equal(got.lengths, want.lengths)
    assert np.asarray(got.data).tobytes() == np.asarray(want.data).tobytes()
    assert got.dbtype == want.dbtype


def _seeded_reads(seed=5, n_genes=5, gene_codons=260):
    """Reads of seeded random genes, as a nucleotide SeqDB."""
    rng = np.random.default_rng(seed)
    codons = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"]
    codons = [c for c in codons if c not in ("TAA", "TAG", "TGA")]
    reads = []
    for _ in range(n_genes):
        gene = "ATG" + "".join(rng.choice(codons, gene_codons)) + "TAA"
        flank = ACGT[rng.integers(0, 4, 90)].tobytes().decode()
        g = np.frombuffer((flank + gene + flank).encode(), dtype=np.uint8)
        for start in range(0, len(g) - 150 + 1, 27):
            r = g[start:start + 150].copy()
            if rng.random() < 0.05:
                r[rng.integers(0, 150)] = ACGT[rng.integers(4)]
            if rng.random() < 0.5:
                r = COMP[r[::-1]]
            reads.append(r.tobytes())
    order = rng.permutation(len(reads))
    return ref_seqdb.SeqDB.from_records([reads[i] for i in order],
                                        dbtype=ref_seqdb.NUCLEOTIDES)


def _orf_dbs(reads):
    """guided's ORF step (LONG then START, translated with the ORF stop)
    on `reads`: (nucl ORFs, aa ORFs), row-aligned."""
    stops = ref_tr.stop_codons(1)
    starts = ref_tr.start_codons(1, False)
    start_db, start_h = ref_orf.extract_orfs(
        reads, min_length=20, max_length=45, max_gaps=0,
        start_mode=ref_orf.START_TO_STOP, contig_start_mode=1,
        contig_end_mode=0, stop_codons=stops, start_codons=starts)
    long_db, long_h = ref_orf.extract_orfs(
        reads, min_length=45, max_length=32734, max_gaps=0,
        start_mode=ref_orf.START_TO_STOP, contig_start_mode=2,
        contig_end_mode=2, stop_codons=stops, start_codons=starts)
    nucl = ref_seqdb.concat(long_db, start_db)
    aa = ref_tr.translate_nucs(nucl, ref_seqdb.concat(long_h, start_h), 1,
                               add_orf_stop=True)
    return nucl, aa


@pytest.fixture(scope="module")
def seeded():
    reads = _seeded_reads()
    nucl, aa = _orf_dbs(reads)
    alns = rescore_diagonal_jax(
        aa, kmermatcher_jax(aa, 14, return_arrays=True, **AA_MATCH),
        RefRescoreParams(add_backtrace=True, **AA_RESCORE), return_flat=True)
    return reads, nucl, aa, alns


def test_seeded_rows_carry_the_orf_stop(seeded):
    _, nucl, aa, alns = seeded
    first = np.array([aa.get_seq_bytes(i)[:1] for i in range(aa.size)])
    last = np.array([aa.get_seq_bytes(i)[-1:] for i in range(aa.size)])
    assert 0 < (first == b"*").sum() < aa.size
    assert 0 < (last == b"*").sum() < aa.size
    assert int(aa.seq_lens().max()) < 1024
    assert len(alns["qk"]) > 2 * aa.size          # hits beyond the self rows
    assert np.array_equal(nucl.keys, aa.keys)


def test_aa_rescore_flat_equals_jax(seeded):
    """The aa loop's matcher and rescore (k 14, the nucleotide k-mer scale,
    seq-id 0.97, cov-mode 1) on rows that begin and end with '*'."""
    _, _, aa, want = seeded
    pdb = _port_db(aa)
    got = rescore_diagonal_torch(
        pdb, kmermatcher_torch(pdb, 14, CPU, **AA_MATCH),
        RescoreParams(**AA_RESCORE), return_flat=True)
    np.testing.assert_array_equal(got["qk"], want["qk"])
    np.testing.assert_array_equal(got["rec"], want["rec"])


def test_protein_aln_to_nucl_flat_equals_jax(seeded):
    _, nucl, aa, alns = seeded
    want = ref_p2n.protein_aln_to_nucl(nucl, aa, alns, 5, 2)
    got = port_p2n.protein_aln_to_nucl(_port_db(nucl), _port_db(aa), alns)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert got[name].dtype == want[name].dtype, name
    # rows with the leading '*' shift by one codon: both kinds are present
    assert (want["qs"] < 0).any() or (want["ts"] < 0).any() or \
        (want["qs"] % 3 == 0).all()
    assert (want["seqid"] < 1.0).any() and (want["seqid"] == 1.0).any()


def test_protein_aln_to_nucl_refuses_other_input(seeded):
    _, nucl, aa, alns = seeded
    with pytest.raises(TypeError, match="flat records"):
        port_p2n.protein_aln_to_nucl(_port_db(nucl), _port_db(aa), {1: []})
    shifted = seqdb.SeqDB(aa.data, aa.keys + 1, aa.offsets, aa.lengths,
                          aa.dbtype)
    with pytest.raises(ValueError, match="row-aligned"):
        port_p2n.protein_aln_to_nucl(_port_db(nucl), shifted, alns)


def test_guided_assemble_three_iterations_equal_jax(seeded):
    """The aa loop as a whole on the seeded reads: each side feeds its own
    matcher, rescore, proteinaln2nucl and extender; after every iteration
    both DBs are byte-equal and stay in lockstep."""
    _, nucl, aa, _ = seeded
    pn, pa = _port_db(nucl), _port_db(aa)
    grown = 0
    for _ in range(3):
        r_alns = rescore_diagonal_jax(
            aa, kmermatcher_jax(aa, 14, return_arrays=True, **AA_MATCH),
            RefRescoreParams(add_backtrace=True, **AA_RESCORE),
            return_flat=True)
        r_next = ref_gext.guided_assemble(
            nucl, aa, ref_p2n.protein_aln_to_nucl(nucl, aa, r_alns, 5, 2),
            seq_id_thr=0.99)
        p_alns = rescore_diagonal_torch(
            pa, kmermatcher_torch(pa, 14, CPU, **AA_MATCH),
            RescoreParams(**AA_RESCORE), return_flat=True)
        p_next = port_gext.guided_assemble(
            pn, pa, port_p2n.protein_aln_to_nucl(pn, pa, p_alns),
            seq_id_thr=0.99)
        _assert_db_equal(p_next[0], r_next[0])
        _assert_db_equal(p_next[1], r_next[1])
        np.testing.assert_array_equal(p_next[2], r_next[2])
        assert np.array_equal(p_next[0].keys, p_next[1].keys)
        grown += int((p_next[2] & 0x20 != 0).sum())
        (nucl, aa), (pn, pa) = r_next[:2], p_next[:2]
    assert grown > 10                      # contigs did grow
    assert int(pn.seq_lens().max()) > 300


def _with_extra_aa_record(aa):
    """aa with one more record, under a key after its last: the two DBs
    of a guided pass are then not row-aligned."""
    recs = [aa.get_seq_bytes(i) for i in range(aa.size)] + [b"MKVLAT*"]
    return ref_seqdb.SeqDB.from_records(
        recs, keys=np.append(aa.keys, aa.keys.max() + 1), dbtype=aa.dbtype)


def test_guided_assemble_refuses_what_the_native_engine_cannot_do(seeded):
    """What the native engine cannot do, the Python pass does, as the JAX
    package's: the HAMMING rescore (mode 0) on the seeded DBs, and DBs
    whose key lists differ (the amino-acid DB holds one record more). On
    row-aligned DBs at END_TO_END the native engine takes the flat records
    only: records as dicts raise TypeError."""
    _, nucl, aa, alns = seeded
    pn, pa = _port_db(nucl), _port_db(aa)
    flat = port_p2n.protein_aln_to_nucl(pn, pa, alns)
    ref_flat = ref_p2n.protein_aln_to_nucl(nucl, aa, alns, 5, 2)
    with pytest.raises(TypeError, match="flat records"):
        port_gext.guided_assemble(pn, pa, {})
    extra = _with_extra_aa_record(aa)
    for r_aa, p_aa, kw in ((aa, pa, dict(rescore_mode=0)),
                           (extra, _port_db(extra), {}),
                           (extra, _port_db(extra), dict(rescore_mode=0))):
        want = ref_gext.guided_assemble(nucl, r_aa, ref_flat,
                                        seq_id_thr=0.99, **kw)
        got = port_gext.guided_assemble(pn, p_aa, flat, seq_id_thr=0.99,
                                        **kw)
        _assert_db_equal(got[0], want[0])
        _assert_db_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert int((got[2] & 0x20 != 0).sum()) > 5     # contigs grew


@pytest.mark.parametrize("aligned", [True, False])
def test_guidedassembleresults_cli_as_the_jax_package(seeded, tmp_path,
                                                      aligned):
    """`penguin guidedassembleresults` through both CLIs on the seeded
    DBs and a nucleotide alignment DB (the JAX package's proteinaln2nucl
    of the amino-acid records): row-aligned (the port's native engine) and
    with the extra amino-acid record (both packages' Python pass)."""
    from plass_tpu.cli import penguin as ref_penguin
    from plass_tpu.cli.app import run_app
    from plass_tpu_torch.cli import penguin as port_penguin
    _, nucl, aa, alns = seeded
    by_query = {}
    for q, rec in zip(alns["qk"], alns["rec"]):
        by_query.setdefault(int(q), []).append(rec)
    d = str(tmp_path)
    nucl.save(f"{d}/nucl")
    (aa if aligned else _with_extra_aa_record(aa)).save(f"{d}/aa")
    ref_p2n.nucl_results_to_db(ref_p2n.protein_aln_to_nucl(
        nucl, aa, by_query, 5, 2)).save(f"{d}/aln")
    outs = {}
    for tag, run in (("ref", lambda a: run_app(
            "penguin", ref_penguin.commands(), a)),
                     ("port", lambda a: port_penguin.run(
                         [*a, "--device", "cpu"]))):
        assert run(["guidedassembleresults", f"{d}/nucl", f"{d}/aa",
                    f"{d}/aln", f"{d}/{tag}_n", f"{d}/{tag}_a"]) == 0
        outs[tag] = [open(f"{d}/{tag}_{x}{ext}", "rb").read()
                     for x in "na" for ext in ("", ".index", ".dbtype")]
    assert outs["port"] == outs["ref"]
    assert len(outs["ref"][0]) > sum(nucl.seq_lens()) // 2


def test_numpy_hashes_equal_jax_package():
    from plass_tpu.ops import hashes as ref_hashes

    rng = np.random.default_rng(3)
    v = rng.integers(0, 2**63, 500, dtype=np.int64).astype(np.uint64) * 2 + 1
    for seed in (0, 67, 68, 2**31):
        np.testing.assert_array_equal(xxh64_u64_np(v, seed),
                                      ref_hashes.xxh64_u64_np(v, seed))
    s = rng.integers(0, 5, 300).astype(np.uint8)
    assert seq_hash_np(s) == ref_hashes.seq_hash_np(s)


def _contig_db(seed=9, n=36):
    """A nucleotide DB for the linclust tail: contig-like sequences with
    near-duplicates, contained fragments (both strands), one with a
    deletion and one that overlaps an end and goes on."""
    rng = np.random.default_rng(seed)
    base = [ACGT[rng.integers(0, 4, int(rng.integers(200, 900)))]
            for _ in range(n // 4)]
    seqs = []
    for b in base:
        seqs.append(b)
        dup = b.copy()
        mut = rng.random(len(dup)) < 0.01
        dup[mut] = ACGT[rng.integers(0, 4, int(mut.sum()))]
        seqs.append(dup)
        lo = int(rng.integers(0, len(b) // 3))
        frag = b[lo:lo + int(len(b) * 0.6)]
        seqs.append(COMP[frag[::-1]] if rng.random() < 0.5 else frag)
        gapped = np.delete(b, int(rng.integers(50, len(b) - 50)))
        seqs.append(gapped[:int(len(gapped) * 0.95)])
        seqs.append(np.concatenate([b[len(b) // 2:],
                                    ACGT[rng.integers(0, 4, 120)]]))
    order = rng.permutation(len(seqs))
    keys = np.sort(rng.choice(4 * len(seqs), len(seqs), replace=False))
    return ref_seqdb.SeqDB.from_records(
        [seqs[i].tobytes() for i in order], keys=keys,
        dbtype=ref_seqdb.NUCLEOTIDES)


@pytest.mark.parametrize("only_ext,cov", [(False, 0.99), (True, 0.0)])
def test_host_kmermatcher_equals_jax_package(only_ext, cov):
    db = _contig_db()
    kw = dict(kmers_per_sequence=60, kmers_per_sequence_scale=0.1,
              hash_shift=67, ignore_multi_kmer=True,
              include_only_extendable=only_ext, cov_thr=cov, cov_mode=1)
    want = ref_kmermatch.kmermatcher(db, 22, **kw)
    got = port_kmermatch.kmermatcher(_port_db(db), 22, **kw)
    assert got == want
    assert sum(len(v) for v in got.values()) > len(got)
    assert any(s < 0 for v in got.values() for _, s, _ in v)   # reverse hits


def test_linclust_nucl_equals_jax_package():
    db = _contig_db()
    r_mid, p_mid, secs = {}, {}, {}
    want = ref_linclust.run_linclust_nucl(db, ref_linclust.LinclustParams(),
                                          r_mid)
    got = port_linclust.run_linclust_nucl(
        _port_db(db), port_linclust.LinclustParams(), p_mid, secs)
    assert got == want
    assert 1 < len(got) < db.size             # something was clustered
    assert set(p_mid) == set(r_mid)
    for name in ("pref", "pre_clust", "pref_filter2", "aln", "clust"):
        assert p_mid[name] == r_mid[name], name
    assert p_mid["rescore2"] is None and r_mid["rescore2"] is None
    _assert_db_equal(p_mid["reps"], r_mid["reps"])
    assert p_mid["pref_rescore1"].keys() == r_mid["pref_rescore1"].keys()
    for key, recs in r_mid["pref_rescore1"].items():
        np.testing.assert_array_equal(p_mid["pref_rescore1"][key], recs)
    assert set(secs) == {"kmermatch", "rescore", "precluster", "align",
                         "cluster"}


def test_linclust_refuses_amino_acids():
    """An amino-acid DB is clustered on the device it names: `cuda`
    without a card is refused, never run on the CPU instead."""
    db = seqdb.SeqDB.from_records([b"MKV" * 20, b"MKV" * 19 + b"MKA"],
                                  dbtype=seqdb.AMINO_ACIDS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_linclust.run_linclust(db)
    assert port_linclust.run_linclust(db, device="cpu") == {0: [0, 1]}


@pytest.mark.parametrize("wrapped", [True, False])
def test_align_nucl_equals_jax_package(wrapped):
    db = _contig_db(seed=10, n=20)
    hits = ref_kmermatch.kmermatcher(
        db, 22, kmers_per_sequence=60, kmers_per_sequence_scale=0.1,
        ignore_multi_kmer=True, include_only_extendable=False)
    kw = dict(seq_id_thr=0.9, cov_thr=0.5, cov_mode=1, eval_thr=1e-3,
              wrapped_scoring=wrapped)
    want = ref_nucl_align.align_nucl(db, hits, **kw)
    got = port_nucl_align.align_nucl(_port_db(db), hits, **kw)
    assert got == want
    assert sum(len(v) for v in got.values()) > len(got)
    assert any(r["alnLength"] != r["qEndPos"] - r["qStartPos"] + 1
               for v in got.values() for r in v)      # gapped alignments


def test_cli_flags_map_to_params():
    from plass_tpu.cli import penguin as ref_cli
    from plass_tpu_torch.cli.penguin import _guided_defaults, guided_params

    def parse(argv):
        space = _guided_defaults()
        assert space.parse_args(argv[1:]) == argv[1:4]
        return space

    from plass_tpu.ops.kmermatch import parse_memory_limit

    def ref_value(space, name):
        # the JAX package's CLI takes --split-memory-limit for guided but
        # its params class does not carry it: read the parsed flag
        if name == "split_memory_limit":
            return parse_memory_limit(space.values[name])
        return getattr(ref_guided.GuidedNuclAssembleParams.from_space(space),
                       name)

    base = ["guided_nuclassemble", "a.fq", "o.fasta", "tmp"]
    p = guided_params(parse(base))
    assert p == port_guided.GuidedNuclAssembleParams(delete_tmp_inc=True)
    space = ref_cli._guided_defaults()
    for name, value in vars(p).items():
        if name != "device":
            assert ref_value(space, name) == value, name

    flags = ["--num-iterations", "aa:2,nucl:3", "-k", "aa:12,nucl:20",
             "--min-seq-id", "aa:0.9,nucl:0.95", "--kmer-per-seq-scale",
             "aa:0.3,nucl:0.2", "--clust-min-seq-id", "0.9",
             "--clust-min-cov", "0.8", "--min-contig-len", "150",
             "--chop-cycle", "0", "--split-memory-limit", "2G"]
    p = guided_params(parse(base + flags + ["--device", "cpu"]))
    space = ref_cli._guided_defaults()
    space.parse_args(flags)
    assert (p.aa_num_iterations, p.nucl_num_iterations) == (2, 3)
    assert (p.aa_kmer_size, p.nucl_kmer_size) == (12, 20)
    assert (p.aa_seq_id, p.nucl_seq_id) == (0.9, 0.95)
    assert p.split_memory_limit == 2 << 30
    assert p.device == "cpu"
    for name, value in vars(p).items():
        if name != "device":
            assert ref_value(space, name) == value, name
    # a bare value sets both parts
    p = guided_params(parse(base + ["--num-iterations", "4"]))
    assert (p.aa_num_iterations, p.nucl_num_iterations) == (4, 4)
    with pytest.raises(ValueError, match="both aa: and nucl:"):
        parse(base + ["--num-iterations", "aa:2"])


def test_fixture_run_equals_live_jax_run(tmp_path):
    """2 + 2 iterations, min-contig-len 150 on the mini fixtures, through
    the port's CLI on the CPU: the FASTA byte-equal to the JAX package's
    run, every per-iteration DB equal by key, the nested run's DB and its
    cycle index equal."""
    from plass_tpu_torch.cli.penguin import run

    want = str(tmp_path / "jax.fasta")
    ref_guided.run_guided_nuclassemble(
        READS, want, str(tmp_path / "jtmp"),
        ref_guided.GuidedNuclAssembleParams(
            aa_num_iterations=2, nucl_num_iterations=2, min_contig_len=150,
            backend="jax"))
    got = str(tmp_path / "port.fasta")
    stats = {}
    rc = run(["guided_nuclassemble", *READS, got, str(tmp_path / "ptmp"),
              "--num-iterations", "2", "--min-contig-len", "150",
              "--delete-tmp-inc", "0", "--device", "cpu"], stats=stats)
    assert rc == 0
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    assert data.count(b">") >= 3 and b" cycle:" in data

    jt, pt = (str(tmp_path / d / "latest") for d in ("jtmp", "ptmp"))
    for name in ("nucl_reads", "nucl_6f_start_long", "aa_6f_start_long",
                 "assembly_nucl_0", "assembly_aa_0", "assembly_nucl_1",
                 "assembly_aa_1", "guided_assembly.merged", "nuclassembly"):
        a = seqdb.SeqDB.open(os.path.join(pt, name))
        b = ref_seqdb.SeqDB.open(os.path.join(jt, name))
        assert np.array_equal(a.keys, b.keys), name
        for i in range(a.size):
            assert a.get_seq_bytes(i) == b.get_seq_bytes(i), (name, i)
    cyc = "nuclassembly_cycle.index"
    assert os.path.exists(os.path.join(pt, cyc)) == \
        os.path.exists(os.path.join(jt, cyc))
    if os.path.exists(os.path.join(pt, cyc)):
        assert open(os.path.join(pt, cyc)).read() == \
            open(os.path.join(jt, cyc)).read()

    assert stats["orfs"] > stats["reads"] > 0
    assert stats["nuclassemble"]["reads"] == \
        stats["reads"] + stats["only_assembled"]
    assert stats["hits"] > 0 and stats["table_entries"] > stats["orfs"]
    assert stats["only_assembled"] > 0
    assert stats["contigs"] == data.count(b">")
    assert set(stats["seconds"]) == {
        "ingest", "orfs", "kmermatch", "rescore", "aln2nucl", "extend",
        "select", "nuclassemble", "linclust", "output"}
    assert set(stats["nuclassemble"]["seconds"]) == {
        "ingest", "kmermatch", "rescore", "extend", "cyclecheck", "output"}
    assert set(stats["linclust_seconds"]) == {
        "kmermatch", "rescore", "precluster", "align", "cluster"}


def test_only_assembled_selection_equals_the_key_join():
    rng = np.random.default_rng(2)
    orig = seqdb.SeqDB.from_records(
        [b"A" * int(n) for n in rng.integers(5, 50, 40)],
        keys=np.arange(40) * 2, dbtype=seqdb.NUCLEOTIDES)
    keys = np.sort(rng.choice(100, 45, replace=False))
    result = seqdb.SeqDB.from_records(
        [b"C" * int(n) for n in rng.integers(5, 50, 45)], keys=keys,
        dbtype=seqdb.NUCLEOTIDES)
    lut = {int(k): i for i, k in enumerate(result.keys)}
    want = [int(k) for i, k in enumerate(orig.keys)
            if int(k) in lut
            and result.lengths[lut[int(k)]] > orig.lengths[i]]
    assert port_guided.select_only_assembled(result, orig) == want
    assert 0 < len(want) < 40


def test_cuda_without_a_card_raises(tmp_path):
    """--device cuda never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_guided.run_guided_nuclassemble(
            READS, str(tmp_path / "x.fasta"), str(tmp_path / "tmp"),
            port_guided.GuidedNuclAssembleParams(device="cuda"))
    assert not (tmp_path / "x.fasta").exists()
