"""PyTorch port, the nucleotide slice as a whole: `penguin nuclassemble` on
the CPU reproduces the committed golden byte for byte, and its default run
(8 iterations) equals the JAX package's output; resume and db_mode work as
there."""
import os
import subprocess
import sys

import pytest
import torch

from plass_tpu.workflow.nuclassemble import NuclAssembleParams as JaxParams
from plass_tpu.workflow.nuclassemble import run_nuclassemble as jax_run
from plass_tpu_torch.data import seqdb
from plass_tpu_torch.data.createdb import merge_reads
from plass_tpu_torch.workflow.nuclassemble import (NuclAssembleParams,
                                                   run_nuclassemble)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
GOLDEN = os.path.join(FIX, "mini_golden_nucl.fasta")


def test_cli_fixture_golden_byte_identical(tmp_path):
    """python -m plass_tpu_torch.cli.penguin nuclassemble ... --device cpu,
    with --num-iterations 2 --min-contig-len 150 as the golden was made."""
    out = tmp_path / "contigs.fasta"
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "plass_tpu_torch.cli.penguin", "nuclassemble",
         *READS, str(out), str(tmp_path / "tmp"), "--num-iterations", "2",
         "--min-contig-len", "150", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert out.read_bytes() == open(GOLDEN, "rb").read()


def test_default_run_equals_jax_and_reports_stats(tmp_path):
    """Default parameters (8 iterations) with --min-contig-len 150."""
    want = str(tmp_path / "jax.fasta")
    jax_run(READS, want, str(tmp_path / "jtmp"),
            JaxParams(min_contig_len=150, backend="jax"))
    got = str(tmp_path / "port.fasta")
    stats = {}
    run_nuclassemble(READS, got, str(tmp_path / "ptmp"),
                     NuclAssembleParams(min_contig_len=150, device="cpu"),
                     stats=stats)
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    assert data.count(b">") >= 3
    assert stats["reads"] > 0 and stats["hits"] > 0
    assert 0 < stats["reverse_hits"] < stats["hits"]
    assert stats["table_entries"] > stats["reads"]
    assert set(stats["seconds"]) == {"ingest", "kmermatch", "rescore",
                                     "extend", "cyclecheck", "output"}


def test_resume_and_db_mode(tmp_path):
    """A second run over the same tmp directory skips every finished
    iteration and writes the same contigs; db_mode reads a sequence DB and
    writes the contigs as a DB."""
    params = dict(num_iterations=2, min_contig_len=150, device="cpu")
    first = tmp_path / "a.fasta"
    run_nuclassemble(READS, str(first), str(tmp_path / "tmp"),
                     NuclAssembleParams(**params))
    again = tmp_path / "b.fasta"
    os.rename(first, again)
    run_nuclassemble(READS, str(first), str(tmp_path / "tmp"),
                     NuclAssembleParams(**params))
    assert first.read_bytes() == again.read_bytes() == \
        open(GOLDEN, "rb").read()

    reads, _ = merge_reads(READS)
    reads.save(str(tmp_path / "reads"))
    _, final = run_nuclassemble(
        [str(tmp_path / "reads")], str(tmp_path / "contigs"),
        str(tmp_path / "dtmp"), NuclAssembleParams(db_mode=True, **params),
        return_db=True)
    saved = seqdb.SeqDB.open(str(tmp_path / "contigs"))
    seqs = [saved.get_seq_bytes(i) for i in range(saved.size)]
    assert seqs == [final.get_seq_bytes(i) for i in range(final.size)]
    golden = open(GOLDEN, "rb").read().split(b"\n")[1::2]
    assert sorted(seqs) == sorted(s for s in golden if s)


def test_cli_flags_map_to_params():
    from plass_tpu_torch.cli.penguin import _nucl_defaults, nuclassemble_params

    def parse(argv):
        space = _nucl_defaults()
        assert space.parse_args(argv) == ["a.fq", "o.fasta", "tmp"]
        return space

    assert nuclassemble_params(parse(["a.fq", "o.fasta", "tmp"])) == \
        NuclAssembleParams(delete_tmp_inc=True)
    p = nuclassemble_params(parse([
        "a.fq", "o.fasta", "tmp", "-k", "aa:14,nucl:20",
        "--min-seq-id", "0.97", "--cycle-check", "0",
        "--split-memory-limit", "3M", "--device", "cpu"]))
    assert (p.kmer_size, p.min_seq_id, p.cycle_check, p.device) == \
        (20, 0.97, False, "cpu")
    assert p.split_memory_limit == 3 << 20


def test_extend_refuses_modes_other_than_end_to_end():
    from plass_tpu_torch.assembler.nucl_extend import nucl_assemble
    from plass_tpu_torch.ops.rescore import RESCORE_SUBSTITUTION

    reads, _ = merge_reads(READS)
    with pytest.raises(NotImplementedError, match="END_TO_END"):
        nucl_assemble(reads, {}, rescore_mode=RESCORE_SUBSTITUTION)


def test_cuda_without_a_card_raises(tmp_path):
    """--device cuda never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_nuclassemble(READS, str(tmp_path / "x.fasta"),
                         str(tmp_path / "tmp"),
                         NuclAssembleParams(device="cuda"))
    assert not (tmp_path / "x.fasta").exists()


def test_rescore_mode_0_equals_jax(tmp_path):
    """--rescore-mode 0 (HAMMING rescore, the Python extender) through the
    port's CLI equals the JAX package's run; every contig is written
    (--contig-output-mode 0, --min-contig-len 1)."""
    from plass_tpu_torch.cli.penguin import run

    want = str(tmp_path / "jax.fasta")
    jax_run(READS, want, str(tmp_path / "jtmp"),
            JaxParams(rescore_mode=0, num_iterations=2, min_contig_len=1,
                      contig_output_mode=0, backend="jax"))
    got = str(tmp_path / "port.fasta")
    assert run(["nuclassemble", *READS, got, str(tmp_path / "ptmp"),
                "--rescore-mode", "0", "--num-iterations", "2",
                "--min-contig-len", "1", "--contig-output-mode", "0",
                "--device", "cpu"]) == 0
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    assert data.count(b">") > 10
