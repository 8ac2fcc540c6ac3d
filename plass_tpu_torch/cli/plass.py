"""`plass` CLI of the port: the `assemble` workflow only.

    python -m plass_tpu_torch.cli.plass assemble reads_1.fq.gz reads_2.fq.gz \\
        out.fas tmp [--num-iterations N --filter-proteins 0|1 ... --device cuda]

Flag names and defaults follow the JAX package's plass_tpu/cli/params.py
for the AssembleParams fields, with the plass defaults of
Assembler.cpp:10-27. Boolean flags take an explicit value (0/1/true/false);
flags that take `aa:X,nucl:Y` there accept a bare value or that form, and
the port reads the amino-acid part.
"""
import argparse
import sys

from ..ops.kmermatch import parse_memory_limit
from ..utils.log import logger
from ..workflow.assemble import AssembleParams, run_assemble


def _bool(text):
    if text in ("1", "true", "TRUE"):
        return True
    if text in ("0", "false", "FALSE"):
        return False
    raise argparse.ArgumentTypeError(f"expected 0/1, got {text!r}")


def _aa(conv):
    """Parse a bare value or the `aa:X,nucl:Y` form; keep the aa part."""
    def parse(text):
        parts = dict(p.partition(":")[::2] for p in text.split(","))
        if set(parts) <= {"aa", "nucl"} and "aa" in parts:
            return conv(parts["aa"])
        return conv(text)
    return parse


# (flag, AssembleParams field, parser, default) — defaults of
# plass_tpu.cli.params.assemble_flags as `plass assemble` sets them
FLAGS = [
    ("-k", "kmer_size", _aa(int), 14),
    ("--alph-size", "alphabet_size", _aa(int), 13),
    ("--kmer-per-seq", "kmers_per_sequence", int, 60),
    ("--kmer-per-seq-scale", "kmers_per_sequence_scale", _aa(float), 0.0),
    ("--num-iterations", "num_iterations", _aa(int), 12),
    ("--min-seq-id", "min_seq_id", _aa(float), 0.9),
    ("-e", "eval_thr", float, 1e-5),
    ("-c", "cov_thr", float, 0.0),
    ("--cov-mode", "cov_mode", int, 0),
    ("--min-aln-len", "min_aln_len", _aa(int), 0),
    ("--max-seq-len", "max_seq_len", int, 65535),
    ("--orf-min-length", "orf_min_length", int, 45),
    ("--orf-max-length", "orf_max_length", int, 32734),
    ("--translation-table", "translation_table", int, 1),
    ("--use-all-table-starts", "use_all_table_starts", _bool, False),
    ("--filter-proteins", "filter_proteins", int, 1),
    ("--protein-filter-threshold", "protein_filter_threshold", float, 0.2),
    ("--hash-shift", "hash_shift", int, 67),
    ("--ignore-multi-kmer", "ignore_multi_kmer", _bool, True),
    ("--include-only-extendable", "include_only_extendable", _bool, None),
    ("--keep-target", "keep_target", _bool, True),
    ("--rescore-mode", "rescore_mode", int, 3),
    ("--remove-tmp-files", "remove_tmp_files", _bool, False),
    ("--delete-tmp-inc", "delete_tmp_inc", int, 1),
    # bytes (K/M/G/T suffix) of k-mer table per hash-range split; 0:
    # automatic on a card, monolithic on the CPU
    ("--split-memory-limit", "split_memory_limit", parse_memory_limit, 0),
    ("--device", "device", str, "cuda"),
]


def parser():
    ap = argparse.ArgumentParser(prog="plass")
    sub = ap.add_subparsers(dest="command", required=True)
    asm = sub.add_parser(
        "assemble",
        help="Assemble protein sequences by iterative greedy overlap assembly")
    asm.add_argument("files", nargs="+",
                     help="<i:fast[a|q]File[.gz]> | <i:fastqFile1_1[.gz]> "
                          "<i:fastqFile1_2[.gz]> ... <o:fastaFile> <tmpDir>")
    for flag, dest, conv, default in FLAGS:
        asm.add_argument(flag, dest=dest, type=conv, default=default)
    return ap


def assemble_params(ns):
    """AssembleParams from parsed flags."""
    kw = {dest: getattr(ns, dest) for _, dest, _, _ in FLAGS}
    kw["include_only_extendable_set"] = kw["include_only_extendable"] is not None
    if kw["include_only_extendable"] is None:
        kw["include_only_extendable"] = True
    kw["delete_tmp_inc"] = bool(kw["delete_tmp_inc"])
    return AssembleParams(**kw)


def run(argv, stats=None):
    """Run the CLI on argv; returns the exit code. `stats` is handed to
    run_assemble (see there)."""
    ns = parser().parse_args(argv)
    if len(ns.files) < 3:
        logger.error("Too few input files provided.\n"
                     "For paired-end input provide READSETA_1.fastq READSETA_2.fastq ... OUTPUT.fasta tmpDir\n"
                     "For single input use READSET.fast(q|a) OUTPUT.fasta tmpDir")
        return 1
    inputs, out_file, tmp_dir = ns.files[:-2], ns.files[-2], ns.files[-1]
    if len(inputs) != 1 and len(inputs) % 2 != 0:
        logger.error("Too many input files provided.")
        return 1
    run_assemble(inputs, out_file, tmp_dir, assemble_params(ns), stats=stats)
    return 0


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
