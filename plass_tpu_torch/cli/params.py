"""Typed flag registry (reference: lib/mmseqs/src/commons/Parameters.{h,cpp}).

Flags carry name, type, default, regex validator, and description; commands
declare which flags they expose. MultiParam values hold distinct
nucleotide/amino-acid settings parsed from ``nucl:X,aa:Y`` (MultiParam.cpp),
with a bare value setting both.
"""
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class MultiParam:
    aminoacids: Any
    nucleotides: Any

    @classmethod
    def parse(cls, text, conv):
        if isinstance(text, (int, float)):
            return cls(conv(text), conv(text))
        parts = str(text).split(",")
        if len(parts) == 1 and ":" not in parts[0]:
            v = conv(parts[0])
            return cls(v, v)
        aa = nucl = None
        for part in parts:
            k, _, v = part.partition(":")
            if k == "aa":
                aa = conv(v)
            elif k == "nucl":
                nucl = conv(v)
            else:
                raise ValueError(f"bad MultiParam component {part!r}")
        if aa is None or nucl is None:
            raise ValueError(f"MultiParam needs both aa: and nucl: in {text!r}")
        return cls(aa, nucl)

    def format(self):
        return f"aa:{self.aminoacids},nucl:{self.nucleotides}"


@dataclass
class Flag:
    name: str            # e.g. "--min-seq-id" or "-k"
    attr: str            # python attribute name
    type: type           # int, float, bool, str, or MultiParam
    default: Any
    description: str
    regex: Optional[str] = None
    conv: Optional[Callable] = None  # element converter for MultiParam
    expert: bool = False

    def parse(self, text):
        if self.type is MultiParam:
            return MultiParam.parse(text, self.conv or float)
        if self.type is bool:
            if text in ("1", "true", "TRUE", True, 1):
                return True
            if text in ("0", "false", "FALSE", False, 0):
                return False
            raise ValueError(f"{self.name}: expected 0/1, got {text!r}")
        if self.regex and not re.match(self.regex + r"$", str(text)):
            raise ValueError(f"{self.name}: value {text!r} fails {self.regex}")
        return self.type(text)


class ParamSpace:
    """Holds parsed values + tracks which flags were set by the user."""

    def __init__(self, flags):
        self.flags = {f.name: f for f in flags}
        self.values = {f.attr: f.default for f in flags}
        self.was_set = set()

    def parse_args(self, argv):
        """Consume --flag value pairs; returns remaining positional args."""
        positional = []
        i = 0
        while i < len(argv):
            a = argv[i]
            if a in self.flags:
                f = self.flags[a]
                if f.type is bool and (i + 1 >= len(argv)
                                       or argv[i + 1].startswith("-")):
                    # bare boolean flag TOGGLES the current value
                    # (Parameters.cpp:1670-1677)
                    self.values[f.attr] = not self.values[f.attr]
                    self.was_set.add(f.attr)
                    i += 1
                    continue
                if f.type is bool and argv[i + 1] not in (
                        "0", "1", "true", "false", "TRUE", "FALSE"):
                    self.values[f.attr] = not self.values[f.attr]
                    self.was_set.add(f.attr)
                    i += 1
                    continue
                if i + 1 >= len(argv):
                    raise ValueError(f"missing value for {a}")
                self.values[f.attr] = f.parse(argv[i + 1])
                self.was_set.add(f.attr)
                i += 2
            elif a.startswith("--") and a not in self.flags:
                raise ValueError(f"unknown flag {a}")
            else:
                positional.append(a)
                i += 1
        return positional

    def __getattr__(self, name):
        values = object.__getattribute__(self, "values")
        if name in values:
            return values[name]
        raise AttributeError(name)


INT = r"-?[0-9]+"
FLOAT = r"-?[0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?"
ZERO_ONE = r"0(\.[0-9]+)?|1(\.0+)?"


def common_flags():
    return [
        Flag("--threads", "threads", int, 1, "Number of CPU threads"),
        Flag("-v", "verbosity", int, 3, "Verbosity 0:quiet 1:+err 2:+warn 3:+info"),
        Flag("--compressed", "compressed", int, 0, "Write compressed output"),
        Flag("--max-seq-len", "max_seq_len", int, 65535, "Maximum sequence length"),
        Flag("--remove-tmp-files", "remove_tmp_files", bool, False, "Delete temporary files"),
        Flag("--delete-tmp-inc", "delete_tmp_inc", int, 1, "Delete temporary files incrementally", r"[0-1]"),
        Flag("--force-reuse", "reuse_latest", bool, False, "Reuse tmp dir from previous run"),
        Flag("--backend", "backend", str, "auto",
             "Compute backend for heavy steps: auto, numpy, jax, sharded",
             r"(auto|numpy|jax|sharded)"),
    ]


def kmermatcher_flags():
    return [
        Flag("-k", "kmer_size", MultiParam, MultiParam(14, 22), "k-mer length", conv=int),
        Flag("--alph-size", "alphabet_size", MultiParam, MultiParam(13, 5), "Alphabet size", conv=int),
        Flag("--kmer-per-seq", "kmers_per_sequence", int, 60, "k-mers per sequence"),
        Flag("--kmer-per-seq-scale", "kmers_per_sequence_scale", MultiParam,
             MultiParam(0.0, 0.2), "Scale k-mers per sequence by length", conv=float),
        Flag("--hash-shift", "hash_shift", int, 67, "Shift k-mer hash seed"),
        Flag("--ignore-multi-kmer", "ignore_multi_kmer", bool, True, "Skip repeated k-mers"),
        Flag("--include-only-extendable", "include_only_extendable", bool, True,
             "Include only extendable overlaps"),
        Flag("--mask", "mask_mode", int, 0, "Mask low-complexity regions", r"[0-1]"),
        Flag("--spaced-kmer-mode", "spaced_kmer", int, 0, "Spaced k-mer mode", r"[0-1]"),
        Flag("--split-memory-limit", "split_memory_limit", str, "0", "Memory limit per split"),
    ]


def align_flags():
    return [
        Flag("--min-seq-id", "min_seq_id", MultiParam, MultiParam(0.9, 0.99),
             "Overlap sequence identity threshold [0.0, 1.0]", conv=float),
        Flag("--min-aln-len", "min_aln_len", MultiParam, MultiParam(0, 0),
             "Minimum alignment length", conv=int),
        Flag("-e", "eval_thr", float, 1e-5, "Extend if E-value below"),
        Flag("-c", "cov_thr", float, 0.0, "Coverage threshold"),
        Flag("--cov-mode", "cov_mode", int, 0, "Coverage mode", r"[0-5]"),
        Flag("--seq-id-mode", "seq_id_mode", int, 0, "SeqId denominator mode", r"[0-2]"),
        Flag("--rescore-mode", "rescore_mode", int, 3, "Rescore mode", r"[0-4]"),
        Flag("--sort-results", "sort_results", int, 0, "Sort results", r"[0-1]"),
        Flag("-a", "add_backtrace", bool, False, "Add backtrace"),
        Flag("--realign", "realign", bool, False,
             "Compute more conservative, shorter alignments"),
        Flag("--alignment-output-mode", "alignment_output_mode", int, 0,
             "0: alignment, 1: cluster format", r"[0-5]"),
        Flag("--exhaustive-search", "exhaustive_search", bool, False,
             "Turn on exhaustive (sliced) target-profile search"),
        Flag("--exhaustive-search-filter", "exhaustive_search_filter",
             int, 0, "Filter result during search", r"[0-1]"),
        Flag("--realign-score-bias", "realign_score_bias", float, -0.2,
             "Additional bias when realigning"),
        Flag("--wrapped-scoring", "wrapped_scoring", bool, False,
             "Double query for circular scoring"),
        Flag("--filter-hits", "filter_hits", bool, False, "Filter hits by precision lib"),
        Flag("--gap-open", "gap_open", int, 5, "Gap open cost"),
        Flag("--gap-extend", "gap_extend", int, 2, "Gap extend cost"),
        Flag("--zdrop", "zdrop", int, 200, "Z-drop alignment truncation score"),
    ]


def search_flags():
    """Flags for the sensitive prefilter / search workflow (reference
    defaults from Parameters.cpp; search raises -s to 5.7,
    Search.cpp:23)."""
    return [
        Flag("-s", "sensitivity", float, 4.0, "Sensitivity (1 fast .. 7.5 sensitive)"),
        Flag("-k", "search_kmer_size", int, 0, "k-mer length (0 auto)"),
        Flag("--max-seqs", "max_seqs", int, 300, "Maximum prefilter results per query"),
        Flag("--min-ungapped-score", "min_ungapped_score", int, 15,
             "Accept only matches with ungapped alignment score above"),
        Flag("--comp-bias-corr", "comp_bias_corr", int, 1,
             "Correct for locally biased amino acid composition", r"[0-1]"),
        Flag("--mask", "search_mask", int, 1,
             "Mask low-complexity sequences in the k-mer index", r"[0-1]"),
        Flag("--spaced-kmer-mode", "search_spaced_kmer", int, 1, "Spaced k-mers", r"[0-1]"),
        Flag("--exact-kmer-matching", "exact_kmer_matching", int, 0,
             "Only exact k-mer matches", r"[0-1]"),
        Flag("--start-sens", "start_sens", float, 4.0, "Start sensitivity"),
        Flag("--sens-steps", "sens_steps", int, 1, "Number of search steps from start-sens to -s"),
        Flag("--alignment-mode", "alignment_mode", int, 0,
             "0 auto, 1 score+end, 2 +start+cov, 3 +seq.id", r"[0-5]"),
        Flag("--max-accept", "max_accept", int, 2**31 - 1, "Maximum accepted alignments per query"),
        Flag("--max-rejected", "max_rejected", int, 2**31 - 1, "Maximum rejected alignments before give-up"),
        Flag("--add-self-matches", "add_self_matches", bool, False,
             "Artificially add self matches"),
    ]


def tax_flags():
    return [
        Flag("--lca-ranks", "lca_ranks", str, "", "Comma-separated ranks for the ranks column"),
        Flag("--tax-lineage", "tax_lineage", int, 0, "0 none, 1 named lineage, 2 taxid lineage", r"[0-2]"),
        Flag("--blacklist", "blacklist", str,
             "12908:unclassified sequences,28384:other sequences",
             "Comma-separated blacklisted taxa"),
        Flag("--majority", "majority", float, 0.5, "Majority vote cutoff"),
        Flag("--vote-mode", "vote_mode", int, 1, "0 uniform, 1 minus-log-eval, 2 score"),
        Flag("--taxon-list", "taxon_list", str, "", "Taxonomy expression (! negates)"),
        Flag("--lca-mode", "lca_mode", int, 3, "Taxonomy search mode", r"[1-4]"),
        Flag("--tax-output-mode", "tax_output_mode", int, 0, "0 lca, 1 alignment, 2 both"),
    ]


def orf_flags():
    return [
        Flag("--orf-min-length", "orf_min_length", int, 45, "Min ORF codons"),
        Flag("--orf-max-length", "orf_max_length", int, 32734, "Max ORF codons"),
        Flag("--orf-max-gaps", "orf_max_gaps", int, 2**31 - 1, "Max unknown codons"),
        Flag("--orf-start-mode", "orf_start_mode", int, 1, "ORF start mode", r"[0-2]"),
        Flag("--contig-start-mode", "contig_start_mode", int, 2, "Contig start mode", r"[0-2]"),
        Flag("--contig-end-mode", "contig_end_mode", int, 2, "Contig end mode", r"[0-2]"),
        Flag("--forward-frames", "forward_frames", str, "1,2,3", "Forward frames"),
        Flag("--reverse-frames", "reverse_frames", str, "1,2,3", "Reverse frames"),
        Flag("--translation-table", "translation_table", int, 1, "NCBI translation table"),
        Flag("--use-all-table-starts", "use_all_table_starts", bool, False,
             "Use all table start codons"),
    ]


def assemble_flags():
    return common_flags() + kmermatcher_flags() + align_flags() + orf_flags() + [
        Flag("--num-iterations", "num_iterations", MultiParam, MultiParam(12, 12),
             "Number of assembly iterations [1, inf]", conv=int),
        Flag("--filter-proteins", "filter_proteins", int, 1,
             "Filter proteins by a neural network [0,1]", r"[0-1]"),
        Flag("--protein-filter-threshold", "protein_filter_threshold", float, 0.2,
             "Filter proteins below threshold [0.0,1.0]", ZERO_ONE),
        Flag("--keep-target", "keep_target", bool, True, "Keep target sequences"),
        Flag("--runner", "runner", str, "", "Runner prefix (unused; mesh sharding instead)"),
    ]


def nuclassemble_flags():
    return assemble_flags() + [
        Flag("--min-contig-len", "min_contig_len", int, 1000,
             "Minimum contig length to output"),
        Flag("--contig-output-mode", "contig_output_mode", int, 1,
             "0: all contigs, 1: only extended", r"[0-1]"),
        Flag("--cycle-check", "cycle_check", bool, True, "Check for circular contigs"),
        Flag("--chop-cycle", "chop_cycle", bool, True, "Chop superfluous cycle part"),
        Flag("--db-mode", "db_mode", bool, False, "Input is a database"),
    ]


def guided_flags():
    return nuclassemble_flags() + [
        Flag("--clust-min-seq-id", "clust_min_seq_id", float, 0.97,
             "Clustering seq-id threshold", ZERO_ONE),
        Flag("--clust-min-cov", "clust_min_cov", float, 0.99,
             "Clustering coverage threshold", ZERO_ONE),
    ]
