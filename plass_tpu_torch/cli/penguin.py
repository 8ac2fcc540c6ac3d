"""`penguin` CLI of the port: the `nuclassemble` and `guided_nuclassemble`
workflows, `linclust`, the hidden tools of the assemblies and the base
tools (cli/tools.py).

    python -m plass_tpu_torch.cli.penguin nuclassemble reads_1.fq.gz \\
        reads_2.fq.gz out.fasta tmp [--num-iterations N ... --device cuda]
    python -m plass_tpu_torch.cli.penguin guided_nuclassemble reads_1.fq.gz \\
        reads_2.fq.gz out.fasta tmp [--num-iterations aa:5,nucl:5 ...]
    python -m plass_tpu_torch.cli.penguin linclust seqDB cluDB tmp [...]

Each command takes the flags of the JAX package's command of the same name
(plass_tpu/cli/penguin.py) with the penguin defaults of
Nuclassembler.cpp:10-32 and GuidedNuclassembler.cpp:10-41, plus --device
(cli/app.py). Flags that take `aa:X,nucl:Y` accept a bare value (both
parts) or that form: `nuclassemble` and `linclust` read the nucleotide
part, `guided_nuclassemble` keeps both where the workflow has both
(--num-iterations, -k, --min-seq-id).
"""
import sys

import numpy as np

from ..data import seqdb
from ..ops.kmermatch import parse_memory_limit
from ..utils.log import logger
from . import params as P
from .app import Command, port_space, run_app
from .plass import ASSEMBLE_USAGE, createhdb, mergereads, run_linclust_command
from .tools import (BASE_COMMANDS, load_alignments,
                    load_alignments_with_backtrace)


def _nucl_defaults():
    """Nuclassembler.cpp:10-32 defaults."""
    space = port_space(P.nuclassemble_flags())
    v = space.values
    v["kmer_size"] = P.MultiParam(22, 22)
    v["alphabet_size"] = P.MultiParam(5, 5)
    v["min_seq_id"] = P.MultiParam(0.99, 0.99)
    v["num_iterations"] = P.MultiParam(8, 8)
    v["kmers_per_sequence_scale"] = P.MultiParam(0.1, 0.1)
    v["max_seq_len"] = 200000
    v["rescore_mode"] = 3
    return space


def _guided_defaults():
    """GuidedNuclassembler.cpp:10-41 defaults."""
    space = port_space(P.guided_flags())
    v = space.values
    v["kmer_size"] = P.MultiParam(14, 22)
    v["alphabet_size"] = P.MultiParam(13, 5)
    v["min_seq_id"] = P.MultiParam(0.97, 0.99)
    v["num_iterations"] = P.MultiParam(5, 5)
    v["kmers_per_sequence_scale"] = P.MultiParam(0.1, 0.1)
    v["max_seq_len"] = 200000
    v["rescore_mode"] = 3
    return space


def nuclassemble_params(space):
    """NuclAssembleParams from parsed flags."""
    from ..workflow.nuclassemble import NuclAssembleParams
    v = space.values
    return NuclAssembleParams(
        kmer_size=v["kmer_size"].nucleotides,
        alphabet_size=v["alphabet_size"].nucleotides,
        kmers_per_sequence=v["kmers_per_sequence"],
        kmers_per_sequence_scale=v["kmers_per_sequence_scale"].nucleotides,
        num_iterations=v["num_iterations"].nucleotides,
        min_seq_id=v["min_seq_id"].nucleotides,
        eval_thr=v["eval_thr"], cov_thr=v["cov_thr"], cov_mode=v["cov_mode"],
        min_aln_len=v["min_aln_len"].nucleotides,
        max_seq_len=v["max_seq_len"], hash_shift=v["hash_shift"],
        ignore_multi_kmer=v["ignore_multi_kmer"],
        include_only_extendable=v["include_only_extendable"],
        keep_target=v["keep_target"], rescore_mode=v["rescore_mode"],
        cycle_check=v["cycle_check"], chop_cycle=v["chop_cycle"],
        min_contig_len=v["min_contig_len"],
        contig_output_mode=v["contig_output_mode"], db_mode=v["db_mode"],
        remove_tmp_files=v["remove_tmp_files"],
        delete_tmp_inc=bool(v["delete_tmp_inc"]),
        split_memory_limit=parse_memory_limit(v["split_memory_limit"]),
        device=v["device"])


def guided_params(space):
    """GuidedNuclAssembleParams from parsed flags."""
    from ..workflow.guided import GuidedNuclAssembleParams
    v = space.values
    return GuidedNuclAssembleParams(
        aa_num_iterations=v["num_iterations"].aminoacids,
        nucl_num_iterations=v["num_iterations"].nucleotides,
        aa_kmer_size=v["kmer_size"].aminoacids,
        nucl_kmer_size=v["kmer_size"].nucleotides,
        aa_seq_id=v["min_seq_id"].aminoacids,
        nucl_seq_id=v["min_seq_id"].nucleotides,
        orf_min_length=v["orf_min_length"], eval_thr=v["eval_thr"],
        kmers_per_sequence=v["kmers_per_sequence"],
        kmers_per_sequence_scale=v["kmers_per_sequence_scale"].nucleotides,
        hash_shift=v["hash_shift"], max_seq_len=v["max_seq_len"],
        min_contig_len=v["min_contig_len"],
        cycle_check=v["cycle_check"], chop_cycle=v["chop_cycle"],
        translation_table=v["translation_table"],
        use_all_table_starts=v["use_all_table_starts"],
        clust_seq_id=v["clust_min_seq_id"], clust_cov=v["clust_min_cov"],
        remove_tmp_files=v["remove_tmp_files"],
        delete_tmp_inc=bool(v["delete_tmp_inc"]),
        split_memory_limit=parse_memory_limit(v["split_memory_limit"]),
        device=v["device"])


def _assembly(run_fn, params_fn):
    def command(positional, space, stats):
        if len(positional) < 3:
            logger.error("usage: penguin <command> <in...> <out.fasta> "
                         "<tmpDir>")
            return 1
        run_fn(positional[:-2], positional[-2], positional[-1],
               params_fn(space), stats=stats)
        return 0
    return command


def _nuclassemble(positional, space, stats):
    from ..workflow.nuclassemble import run_nuclassemble
    return _assembly(run_nuclassemble, nuclassemble_params)(
        positional, space, stats)


def _guided(positional, space, stats):
    from ..workflow.guided import run_guided_nuclassemble
    return _assembly(run_guided_nuclassemble, guided_params)(
        positional, space, stats)


def linclust_params(space, db):
    """LinclustParams of `penguin linclust`: the nucleotide part of each
    aa/nucl flag, the guided defaults otherwise."""
    from ..workflow.linclust import LinclustParams
    v = space.values
    return LinclustParams(
        kmer_size=v["kmer_size"].nucleotides,
        kmers_per_sequence=v["kmers_per_sequence"],
        kmers_per_sequence_scale=v["kmers_per_sequence_scale"].nucleotides,
        hash_shift=v["hash_shift"],
        seq_id_thr=v["min_seq_id"].nucleotides, cov_thr=v["cov_thr"],
        cov_mode=v["cov_mode"], max_seq_len=v["max_seq_len"])


def _linclust(positional, space, stats):
    return run_linclust_command(positional, space, stats, linclust_params)


def _nuclassembleresults(positional, space, stats):
    from ..assembler.nucl_extend import nucl_assemble
    if len(positional) != 3:
        raise ValueError("usage: nuclassembleresults <seqDB> <alnDB> <outDB>")
    db = seqdb.SeqDB.open(positional[0])
    alns = load_alignments(positional[1])
    out, _ = nucl_assemble(db, alns,
                           seq_id_thr=space.values["min_seq_id"].nucleotides,
                           max_seq_len=space.values["max_seq_len"],
                           keep_target=space.values["keep_target"])
    out.save(positional[2])
    return 0


def _guidedassembleresults(positional, space, stats):
    from ..assembler.guided_extend import guided_assemble, records_to_flat
    if len(positional) != 5:
        raise ValueError("usage: guidedassembleresults <i:nuclDB> <i:aaDB> "
                         "<i:alnDB> <o:nuclDB> <o:aaDB>")
    nucl_db = seqdb.SeqDB.open(positional[0])
    aa_db = seqdb.SeqDB.open(positional[1])
    alns = load_alignments_with_backtrace(positional[2])
    if np.array_equal(nucl_db.keys, aa_db.keys):
        # the native kernel's input; other DBs take the records as dicts
        alns = records_to_flat(nucl_db, alns)
    nucl_out, aa_out, _ = guided_assemble(
        nucl_db, aa_db, alns,
        seq_id_thr=space.values["min_seq_id"].nucleotides,
        max_seq_len=space.values["max_seq_len"],
        keep_target=space.values["keep_target"])
    nucl_out.save(positional[3])
    aa_out.save(positional[4])
    return 0


def _cyclecheck(positional, space, stats):
    from ..assembler.cyclecheck import cycle_check_db
    from ..utils.device import pick_device
    if len(positional) != 2:
        raise ValueError("usage: cyclecheck <seqDB> <outDB>")
    db = seqdb.SeqDB.open(positional[0])
    cyc, _ = cycle_check_db(db, chop_cycle=space.values["chop_cycle"],
                            max_seq_len=space.values["max_seq_len"],
                            device=pick_device(space.values["device"]))
    cyc.save(positional[1])
    return 0


def commands():
    return [
        Command("guided_nuclassemble", _guided, _guided_defaults,
                ASSEMBLE_USAGE, "Protein-guided nucleotide assembly"),
        Command("nuclassemble", _nuclassemble, _nucl_defaults,
                ASSEMBLE_USAGE, "Iterative greedy nucleotide assembly"),
        Command("nuclassembleresults", _nuclassembleresults,
                _nucl_defaults, "<i:seqDB> <i:alnDB> <o:seqDB>",
                "Extend nucleotide sequences", hidden=True),
        Command("cyclecheck", _cyclecheck, _nucl_defaults,
                "<i:seqDB> <o:seqDB>", "Detect circular contigs",
                hidden=True),
        Command("linclust", _linclust, _guided_defaults,
                "<i:seqDB> <o:cluDB> <tmpDir>", "Linear-time clustering",
                hidden=True),
        Command("guidedassembleresults", _guidedassembleresults,
                _guided_defaults,
                "<i:nuclDB> <i:aaDB> <i:alnDB> <o:nuclDB> <o:aaDB>",
                "Protein-guided nucleotide extension", hidden=True),
        Command("mergereads", mergereads, _nucl_defaults,
                "<i:fastq> <i:fastq> <o:seqDB>", "Merge paired-end reads",
                hidden=True),
        Command("createhdb", createhdb, _nucl_defaults,
                "<i:seqDB> [<i:cycleDB>] <o:hdb>", "Generate header DB",
                hidden=True),
    ] + BASE_COMMANDS


def run(argv, stats=None):
    """Run the CLI on argv; returns the exit code. `stats` is handed to
    the workflow (run_nuclassemble, run_guided_nuclassemble, or linclust's
    stage seconds; see there)."""
    return run_app("penguin", commands(), argv, stats)


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
