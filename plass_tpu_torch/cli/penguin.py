"""`penguin` CLI of the port: the `nuclassemble` workflow only.

    python -m plass_tpu_torch.cli.penguin nuclassemble reads_1.fq.gz \\
        reads_2.fq.gz out.fasta tmp [--num-iterations N ... --device cuda]

Flag names and defaults follow the JAX package's plass_tpu/cli/params.py
(nuclassemble_flags) for the NuclAssembleParams fields, with the penguin
defaults of Nuclassembler.cpp:10-32. Boolean flags take an explicit value
(0/1/true/false); flags that take `aa:X,nucl:Y` there accept a bare value
or that form, and the port reads the nucleotide part.
"""
import argparse
import sys

from ..utils.log import logger
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
    ("--device", "device", str, "cuda"),
]


def parser():
    ap = argparse.ArgumentParser(prog="penguin")
    sub = ap.add_subparsers(dest="command", required=True)
    nuc = sub.add_parser("nuclassemble",
                         help="Iterative greedy nucleotide assembly")
    nuc.add_argument("files", nargs="+",
                     help="<i:fast[a|q]File[.gz]> | <i:fastqFile1_1[.gz]> "
                          "<i:fastqFile1_2[.gz]> ... <o:fastaFile> <tmpDir>")
    for flag, dest, conv, default in FLAGS:
        nuc.add_argument(flag, dest=dest, type=conv, default=default)
    return ap


def nuclassemble_params(ns):
    """NuclAssembleParams from parsed flags."""
    kw = {dest: getattr(ns, dest) for _, dest, _, _ in FLAGS}
    kw["delete_tmp_inc"] = bool(kw["delete_tmp_inc"])
    return NuclAssembleParams(**kw)


def run(argv, stats=None):
    """Run the CLI on argv; returns the exit code. `stats` is handed to
    run_nuclassemble (see there)."""
    ns = parser().parse_args(argv)
    if len(ns.files) < 3:
        logger.error("usage: penguin nuclassemble <in...> <out.fasta> "
                     "<tmpDir>")
        return 1
    inputs, out_file, tmp_dir = ns.files[:-2], ns.files[-2], ns.files[-1]
    run_nuclassemble(inputs, out_file, tmp_dir, nuclassemble_params(ns),
                     stats=stats)
    return 0


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
