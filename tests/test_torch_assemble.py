"""PyTorch port, the slice as a whole: `plass assemble` (protein) on the
CPU reproduces the committed golden byte for byte, and its default run
(12 iterations, coding filter on) equals the JAX package's output."""
import os
import subprocess
import sys

import pytest
import torch

from plass_tpu.workflow.assemble import AssembleParams as JaxParams
from plass_tpu.workflow.assemble import run_assemble as jax_run_assemble
from plass_tpu_torch.workflow.assemble import AssembleParams, run_assemble

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
GOLDEN = os.path.join(FIX, "mini_golden_protein.fas")


def test_fixture_golden_byte_identical(tmp_path):
    """--num-iterations 2 --filter-proteins 0, as the golden was made."""
    out = str(tmp_path / "assembly.fas")
    stats = {}
    run_assemble(READS, out, str(tmp_path / "tmp"),
                 AssembleParams(num_iterations=2, filter_proteins=0,
                                device="cpu"), stats=stats)
    assert open(out, "rb").read() == open(GOLDEN, "rb").read()
    assert stats["reads"] > 0 and stats["hits"] > 0
    assert set(stats["seconds"]) >= {"ingest", "kmermatch", "rescore",
                                     "extend", "output"}


def test_default_run_equals_jax(tmp_path):
    """Default parameters: 12 iterations, coding filter on."""
    want = str(tmp_path / "jax.fas")
    jax_run_assemble(READS, want, str(tmp_path / "jtmp"),
                     JaxParams(backend="jax"))
    got = str(tmp_path / "port.fas")
    run_assemble(READS, got, str(tmp_path / "ptmp"),
                 AssembleParams(device="cpu"))
    assert open(got, "rb").read() == open(want, "rb").read()


def test_cli_entry_point(tmp_path):
    """python -m plass_tpu_torch.cli.plass assemble ... --device cpu"""
    out = tmp_path / "cli.fas"
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "plass_tpu_torch.cli.plass", "assemble",
         *READS, str(out), str(tmp_path / "tmp"), "--num-iterations", "2",
         "--filter-proteins", "0", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert out.read_bytes() == open(GOLDEN, "rb").read()


def test_cli_flags_map_to_params():
    from plass_tpu_torch.cli import params
    from plass_tpu_torch.cli.plass import assemble_params, plass_defaults

    def parse(argv):
        space = plass_defaults(params.assemble_flags)()
        assert space.parse_args(argv) == ["a.fq", "o.fas", "tmp"]
        return space

    p = assemble_params(parse(["a.fq", "o.fas", "tmp"]))
    assert p == AssembleParams(delete_tmp_inc=True)   # the CLI default is 1
    p = assemble_params(parse([
        "a.fq", "o.fas", "tmp", "-k", "aa:12,nucl:22",
        "--min-seq-id", "0.95", "--include-only-extendable", "0",
        "--split-memory-limit", "1.5K", "--device", "cpu"]))
    assert (p.kmer_size, p.min_seq_id, p.device) == (12, 0.95, "cpu")
    assert p.split_memory_limit == 1536
    assert p.include_only_extendable_set and not p.include_only_extendable


def test_cuda_without_a_card_raises(tmp_path):
    """--device cuda never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_assemble(READS, str(tmp_path / "x.fas"), str(tmp_path / "tmp"),
                     AssembleParams(device="cuda"))
    assert not (tmp_path / "x.fas").exists()


def test_rescore_mode_0_equals_jax(tmp_path):
    """--rescore-mode 0: the HAMMING rescore and the Python extender,
    default parameters otherwise, equal the JAX package's run."""
    want = str(tmp_path / "jax.fas")
    jax_run_assemble(READS, want, str(tmp_path / "jtmp"),
                     JaxParams(backend="jax", rescore_mode=0))
    got = str(tmp_path / "port.fas")
    stats = {}
    run_assemble(READS, got, str(tmp_path / "ptmp"),
                 AssembleParams(device="cpu", rescore_mode=0), stats=stats)
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    assert data.count(b">") >= 1 and stats["hits"] > 0
