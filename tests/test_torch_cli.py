"""PyTorch port: the `plass` and `penguin` CLIs parse every command line
as the JAX package's CLIs do (the same flag registry, cli/params.py), plus
--device; --threads and --backend are accepted and ignored."""
import os

import pytest

from plass_tpu.cli import penguin as ref_penguin
from plass_tpu.cli import plass as ref_plass
from plass_tpu.workflow.guided import GuidedNuclAssembleParams as RefGuided
from plass_tpu.workflow.nuclassemble import NuclAssembleParams as RefNucl
from plass_tpu_torch.cli import penguin as port_penguin
from plass_tpu_torch.cli import plass as port_plass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]

FILES = ["r1.fq", "r2.fq", "out.fas", "tmp"]
ARGVS = {
    "threads": ["assemble", *FILES, "--threads", "4"],
    "roadmap_c2": ["assemble", *FILES, "--threads", "8", "-v", "2",
                   "--compressed", "1", "--force-reuse", "1", "--backend",
                   "jax", "--mask", "1", "--spaced-kmer-mode", "0",
                   "--seq-id-mode", "1", "-a", "1", "--gap-open", "11",
                   "--orf-max-gaps", "3"],
    "bare_bool_last": ["assemble", *FILES, "--use-all-table-starts"],
    "bare_bool_before_positional": ["assemble", "--use-all-table-starts",
                                    *FILES, "--keep-target"],
    "multi_and_bools": ["assemble", *FILES, "-k", "aa:12,nucl:20",
                        "--min-seq-id", "0.95", "--include-only-extendable",
                        "0", "--realign", "--rescore-mode", "0",
                        "--split-memory-limit", "2G", "--remove-tmp-files"],
    "nucl": ["nuclassemble", *FILES, "--threads", "2", "--min-contig-len",
             "150", "--cycle-check", "--chop-cycle", "0", "--db-mode", "-e",
             "0.001", "--cov-mode", "1", "-c", "0.5", "--rescore-mode", "0"],
    "guided": ["guided_nuclassemble", *FILES, "--rescore-mode", "0",
               "--keep-target", "0", "--alph-size", "aa:13,nucl:5",
               "--num-iterations", "aa:2,nucl:3", "--clust-min-seq-id",
               "0.9", "--backend", "numpy", "--use-all-table-starts"],
    "linclust": ["linclust", "db", "clu", "tmp", "--min-seq-id", "0.95",
                 "-k", "15", "--threads", "4", "--cov-mode", "1"],
}
BINARY = {"nucl": "penguin", "guided": "penguin"}


def _plain(values):
    """Parsed values with the two packages' MultiParam classes as
    (aa, nucl) pairs."""
    return {k: (v.aminoacids, v.nucleotides) if hasattr(v, "aminoacids")
            else v for k, v in values.items()}


def _spaces(name):
    """(JAX package's ParamSpace, port's) after parsing ARGVS[name], and
    the two positional lists."""
    argv = ARGVS[name]
    if BINARY.get(name) == "penguin":
        ref_cmds, port_cmds = ref_penguin.commands(), port_penguin.commands()
    else:
        ref_cmds, port_cmds = ref_plass.commands(), port_plass.commands()
    ref = next(c for c in ref_cmds if c.name == argv[0]).params_fn()
    port = next(c for c in port_cmds if c.name == argv[0]).params_fn()
    return ref, port, ref.parse_args(argv[1:]), port.parse_args(argv[1:])


@pytest.mark.parametrize("name", list(ARGVS))
def test_same_parameters_as_jax_cli(name):
    ref, port, ref_pos, port_pos = _spaces(name)
    assert port_pos == ref_pos
    values = _plain(port.values)
    assert values.pop("device") == "cuda"
    assert values == _plain(ref.values)
    assert port.was_set == ref.was_set
    argv = ARGVS[name]
    if argv[0] == "assemble":
        p = port_plass.assemble_params(port)
        # the fields _assemble of the JAX package reads, as it reads them
        v = ref.values
        assert (p.kmer_size, p.min_seq_id, p.use_all_table_starts,
                p.keep_target, p.include_only_extendable,
                p.include_only_extendable_set, p.rescore_mode,
                p.remove_tmp_files) == (
            v["kmer_size"].aminoacids, v["min_seq_id"].aminoacids,
            v["use_all_table_starts"], v["keep_target"],
            v["include_only_extendable"],
            "include_only_extendable" in ref.was_set, v["rescore_mode"],
            v["remove_tmp_files"])
    elif argv[0] in ("nuclassemble", "guided_nuclassemble"):
        p = (port_penguin.nuclassemble_params(port) if argv[0] ==
             "nuclassemble" else port_penguin.guided_params(port))
        want = (RefNucl if argv[0] == "nuclassemble" else RefGuided) \
            .from_space(ref)
        shared = set(vars(p)) & set(vars(want)) - {"backend"}
        assert shared and all(getattr(p, k) == getattr(want, k)
                              for k in shared)


def test_bare_booleans_toggle():
    _, port, _, pos = _spaces("bare_bool_before_positional")
    assert pos == FILES
    assert port.values["use_all_table_starts"] is True
    assert port.values["keep_target"] is False      # default True, toggled


def test_threads_and_backend_are_ignored_and_help_says_so(capsys):
    assert port_plass.run(["assemble", "--help"]) == 0
    text = capsys.readouterr().out
    for flag in ("--threads", "--backend"):
        line = next(x for x in text.splitlines() if x.split()[:1] == [flag])
        assert "ignored" in line
    assert "--device" in text and "--use-all-table-starts" in text
    assert port_penguin.run(["linclust", "-h"]) == 0
    assert "--clust-min-seq-id" in capsys.readouterr().out


def test_unknown_flag_and_bad_value_exit_1(capsys):
    assert port_plass.run(["assemble", *FILES, "--no-such-flag", "1"]) == 1
    assert port_penguin.run(["nuclassemble", *FILES, "--backend",
                             "tpu"]) == 1
    assert "unknown flag" in capsys.readouterr().err


def test_assemble_with_threads_runs(tmp_path):
    """`plass assemble r1 r2 out tmp --threads 4` runs and gives the
    golden (2 iterations, filter 0)."""
    out = str(tmp_path / "assembly.fas")
    assert port_plass.run(["assemble", *READS, out, str(tmp_path / "tmp"),
                           "--threads", "4", "--num-iterations", "2",
                           "--filter-proteins", "0", "--device",
                           "cpu"]) == 0
    assert open(out, "rb").read() == \
        open(os.path.join(FIX, "mini_golden_protein.fas"), "rb").read()
