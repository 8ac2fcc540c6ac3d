"""`penguin` CLI of the port: the `nuclassemble` and `guided_nuclassemble`
workflows.

    python -m plass_tpu_torch.cli.penguin nuclassemble reads_1.fq.gz \\
        reads_2.fq.gz out.fasta tmp [--num-iterations N ... --device cuda]
    python -m plass_tpu_torch.cli.penguin guided_nuclassemble reads_1.fq.gz \\
        reads_2.fq.gz out.fasta tmp [--num-iterations aa:5,nucl:5 ...]

Flag names and defaults follow the JAX package's plass_tpu/cli/params.py
(nuclassemble_flags, guided_flags) for the fields of NuclAssembleParams and
GuidedNuclAssembleParams, with the penguin defaults of
Nuclassembler.cpp:10-32 and GuidedNuclassembler.cpp:10-41. Boolean flags
take an explicit value (0/1/true/false); flags that take `aa:X,nucl:Y`
there accept a bare value (both parts) or that form: `nuclassemble` reads
the nucleotide part, `guided_nuclassemble` keeps both where the workflow
has both (--num-iterations, -k, --min-seq-id).
"""
import argparse
import sys

from ..ops.kmermatch import parse_memory_limit
from ..utils.log import logger
from ..workflow.guided import (GuidedNuclAssembleParams,
                               run_guided_nuclassemble)
from ..workflow.nuclassemble import NuclAssembleParams, run_nuclassemble
from .plass import _bool


def _nucl(conv):
    """Parse a bare value or the `aa:X,nucl:Y` form; keep the nucl part."""
    def parse(text):
        parts = dict(p.partition(":")[::2] for p in text.split(","))
        if set(parts) <= {"aa", "nucl"} and "nucl" in parts:
            return conv(parts["nucl"])
        return conv(text)
    return parse


def _multi(conv):
    """Parse a bare value (both parts) or the `aa:X,nucl:Y` form into
    (aa, nucl), as MultiParam::parse does."""
    def parse(text):
        if ":" not in text and "," not in text:
            return conv(text), conv(text)
        parts = dict(p.partition(":")[::2] for p in text.split(","))
        if set(parts) != {"aa", "nucl"}:
            raise argparse.ArgumentTypeError(
                f"needs both aa: and nucl: in {text!r}")
        return conv(parts["aa"]), conv(parts["nucl"])
    return parse


# (flag, NuclAssembleParams field, parser, default) — defaults of
# plass_tpu.cli.params.nuclassemble_flags as `penguin nuclassemble` sets
# them
FLAGS = [
    ("-k", "kmer_size", _nucl(int), 22),
    ("--alph-size", "alphabet_size", _nucl(int), 5),
    ("--kmer-per-seq", "kmers_per_sequence", int, 60),
    ("--kmer-per-seq-scale", "kmers_per_sequence_scale", _nucl(float), 0.1),
    ("--num-iterations", "num_iterations", _nucl(int), 8),
    ("--min-seq-id", "min_seq_id", _nucl(float), 0.99),
    ("-e", "eval_thr", float, 1e-5),
    ("-c", "cov_thr", float, 0.0),
    ("--cov-mode", "cov_mode", int, 0),
    ("--min-aln-len", "min_aln_len", _nucl(int), 0),
    ("--max-seq-len", "max_seq_len", int, 200000),
    ("--hash-shift", "hash_shift", int, 67),
    ("--ignore-multi-kmer", "ignore_multi_kmer", _bool, True),
    ("--include-only-extendable", "include_only_extendable", _bool, True),
    ("--keep-target", "keep_target", _bool, True),
    ("--rescore-mode", "rescore_mode", int, 3),
    ("--cycle-check", "cycle_check", _bool, True),
    ("--chop-cycle", "chop_cycle", _bool, True),
    ("--min-contig-len", "min_contig_len", int, 1000),
    ("--contig-output-mode", "contig_output_mode", int, 1),
    ("--db-mode", "db_mode", _bool, False),
    ("--remove-tmp-files", "remove_tmp_files", _bool, False),
    ("--delete-tmp-inc", "delete_tmp_inc", int, 1),
    ("--split-memory-limit", "split_memory_limit", parse_memory_limit, 0),
    ("--device", "device", str, "cuda"),
]


# (flag, dest, parser, default) of `penguin guided_nuclassemble`: the
# GuidedNuclAssembleParams fields; a dest of a (aa, nucl) pair fills the
# aa_ and nucl_ fields of that name
GUIDED_FLAGS = [
    ("-k", "kmer_size", _multi(int), (14, 22)),
    ("--num-iterations", "num_iterations", _multi(int), (5, 5)),
    ("--min-seq-id", "seq_id", _multi(float), (0.97, 0.99)),
    ("--kmer-per-seq", "kmers_per_sequence", int, 60),
    ("--kmer-per-seq-scale", "kmers_per_sequence_scale", _nucl(float), 0.1),
    ("--orf-min-length", "orf_min_length", int, 45),
    ("-e", "eval_thr", float, 1e-5),
    ("--max-seq-len", "max_seq_len", int, 200000),
    ("--hash-shift", "hash_shift", int, 67),
    ("--cycle-check", "cycle_check", _bool, True),
    ("--chop-cycle", "chop_cycle", _bool, True),
    ("--min-contig-len", "min_contig_len", int, 1000),
    ("--translation-table", "translation_table", int, 1),
    ("--use-all-table-starts", "use_all_table_starts", _bool, False),
    ("--clust-min-seq-id", "clust_seq_id", float, 0.97),
    ("--clust-min-cov", "clust_cov", float, 0.99),
    ("--remove-tmp-files", "remove_tmp_files", _bool, False),
    ("--delete-tmp-inc", "delete_tmp_inc", int, 1),
    ("--split-memory-limit", "split_memory_limit", parse_memory_limit, 0),
    ("--device", "device", str, "cuda"),
]
_PAIRS = ("kmer_size", "num_iterations", "seq_id")

_FILES_HELP = ("<i:fast[a|q]File[.gz]> | <i:fastqFile1_1[.gz]> "
               "<i:fastqFile1_2[.gz]> ... <o:fastaFile> <tmpDir>")


def parser():
    ap = argparse.ArgumentParser(prog="penguin")
    sub = ap.add_subparsers(dest="command", required=True)
    for name, flags, text in (
            ("nuclassemble", FLAGS, "Iterative greedy nucleotide assembly"),
            ("guided_nuclassemble", GUIDED_FLAGS,
             "Protein-guided nucleotide assembly")):
        cmd = sub.add_parser(name, help=text)
        cmd.add_argument("files", nargs="+", help=_FILES_HELP)
        for flag, dest, conv, default in flags:
            cmd.add_argument(flag, dest=dest, type=conv, default=default)
    return ap


def nuclassemble_params(ns):
    """NuclAssembleParams from parsed flags."""
    kw = {dest: getattr(ns, dest) for _, dest, _, _ in FLAGS}
    kw["delete_tmp_inc"] = bool(kw["delete_tmp_inc"])
    return NuclAssembleParams(**kw)


def guided_params(ns):
    """GuidedNuclAssembleParams from parsed flags."""
    kw = {}
    for _, dest, _, _ in GUIDED_FLAGS:
        value = getattr(ns, dest)
        if dest in _PAIRS:
            kw["aa_" + dest], kw["nucl_" + dest] = value
        else:
            kw[dest] = value
    kw["delete_tmp_inc"] = bool(kw["delete_tmp_inc"])
    return GuidedNuclAssembleParams(**kw)


def run(argv, stats=None):
    """Run the CLI on argv; returns the exit code. `stats` is handed to
    the workflow (run_nuclassemble, run_guided_nuclassemble; see there)."""
    ns = parser().parse_args(argv)
    if len(ns.files) < 3:
        logger.error("usage: penguin %s <in...> <out.fasta> <tmpDir>",
                     ns.command)
        return 1
    inputs, out_file, tmp_dir = ns.files[:-2], ns.files[-2], ns.files[-1]
    if ns.command == "guided_nuclassemble":
        run_guided_nuclassemble(inputs, out_file, tmp_dir, guided_params(ns),
                                stats=stats)
    else:
        run_nuclassemble(inputs, out_file, tmp_dir, nuclassemble_params(ns),
                         stats=stats)
    return 0


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
