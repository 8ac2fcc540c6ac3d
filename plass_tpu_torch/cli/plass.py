"""`plass` CLI of the port: the `assemble` workflow, `linclust`, the
hidden tools of the assembly and the base tools (cli/tools.py).

    python -m plass_tpu_torch.cli.plass assemble reads_1.fq.gz reads_2.fq.gz \\
        out.fas tmp [--num-iterations N --filter-proteins 0|1 ... --device cuda]
    python -m plass_tpu_torch.cli.plass linclust seqDB cluDB tmp \\
        [--min-seq-id 0.9 -c 0.8 ... --device cuda]
    python -m plass_tpu_torch.cli.plass search qDB tDB alnDB tmp [...]
    python -m plass_tpu_torch.cli.plass cluster seqDB cluDB tmp [...]

Each command takes the flags of the JAX package's command of the same name
(plass_tpu/cli/plass.py, cli/tools.py) with the plass defaults of
Assembler.cpp:10-27 where the JAX package sets them, plus --device
(cli/app.py). Flags that take `aa:X,nucl:Y` accept a bare value or that
form; `assemble` reads the amino-acid part, `linclust` the part of its
DB's type.
"""
import sys

from ..data import seqdb
from ..ops.kmermatch import parse_memory_limit
from ..utils.log import logger
from . import params as P
from .app import Command, port_space, run_app
from .tools import BASE_COMMANDS, load_alignments

ASSEMBLE_USAGE = ("<i:fast[a|q]File[.gz]> | <i:fastqFile1_1[.gz]> "
                  "<i:fastqFile1_2[.gz]> ... <o:fastaFile> <tmpDir>")


def plass_defaults(flags_fn):
    """A ParamSpace factory with the plass defaults (Assembler.cpp:10-27)."""
    def make():
        space = port_space(flags_fn())
        space.values["min_seq_id"] = P.MultiParam(0.9, 0.9)
        space.values["rescore_mode"] = 3
        return space
    return make


def assemble_params(space):
    """AssembleParams from parsed flags."""
    from ..workflow.assemble import AssembleParams
    v = space.values
    return AssembleParams(
        kmer_size=v["kmer_size"].aminoacids,
        alphabet_size=v["alphabet_size"].aminoacids,
        kmers_per_sequence=v["kmers_per_sequence"],
        kmers_per_sequence_scale=v["kmers_per_sequence_scale"].aminoacids,
        num_iterations=v["num_iterations"].aminoacids,
        min_seq_id=v["min_seq_id"].aminoacids,
        eval_thr=v["eval_thr"], cov_thr=v["cov_thr"], cov_mode=v["cov_mode"],
        min_aln_len=v["min_aln_len"].aminoacids,
        max_seq_len=v["max_seq_len"],
        orf_min_length=v["orf_min_length"],
        orf_max_length=v["orf_max_length"],
        translation_table=v["translation_table"],
        use_all_table_starts=v["use_all_table_starts"],
        filter_proteins=v["filter_proteins"],
        protein_filter_threshold=v["protein_filter_threshold"],
        hash_shift=v["hash_shift"], ignore_multi_kmer=v["ignore_multi_kmer"],
        include_only_extendable=v["include_only_extendable"],
        include_only_extendable_set="include_only_extendable"
        in space.was_set,
        keep_target=v["keep_target"], rescore_mode=v["rescore_mode"],
        remove_tmp_files=v["remove_tmp_files"],
        delete_tmp_inc=bool(v["delete_tmp_inc"]),
        split_memory_limit=parse_memory_limit(v["split_memory_limit"]),
        device=v["device"])


def _assemble(positional, space, stats):
    from ..workflow.assemble import run_assemble
    if len(positional) < 3:
        logger.error("Too few input files provided.\n"
                     "For paired-end input provide READSETA_1.fastq READSETA_2.fastq ... OUTPUT.fasta tmpDir\n"
                     "For single input use READSET.fast(q|a) OUTPUT.fasta tmpDir")
        return 1
    inputs, out_file, tmp_dir = positional[:-2], positional[-2], positional[-1]
    if len(inputs) != 1 and len(inputs) % 2 != 0:
        logger.error("Too many input files provided.")
        return 1
    run_assemble(inputs, out_file, tmp_dir, assemble_params(space),
                 stats=stats)
    return 0


def linclust_params(space, db):
    """LinclustParams of `plass linclust` on `db`: the linclust defaults
    (cov 0.8, 21 k-mers per sequence, auto k) where the flag was not
    given, the part of each aa/nucl flag of the DB's type."""
    from ..workflow.linclust import LinclustParams
    v = space.values
    if "cov_thr" not in space.was_set:
        v["cov_thr"] = 0.8  # linclust default (Parameters clusterworkflow)
    if "kmers_per_sequence" not in space.was_set:
        v["kmers_per_sequence"] = 21
    if "kmers_per_sequence_scale" not in space.was_set:
        v["kmers_per_sequence_scale"] = P.MultiParam(0.0, 0.2)
    if "ignore_multi_kmer" not in space.was_set:
        v["ignore_multi_kmer"] = False
    if "max_seq_len" not in space.was_set:
        v["max_seq_len"] = 65535
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES
    part = "nucleotides" if is_nucl else "aminoacids"
    return LinclustParams(
        kmer_size=(getattr(v["kmer_size"], part)
                   if "kmer_size" in space.was_set else 0),
        kmers_per_sequence=v["kmers_per_sequence"],
        kmers_per_sequence_scale=getattr(v["kmers_per_sequence_scale"], part),
        hash_shift=v["hash_shift"],
        seq_id_thr=getattr(v["min_seq_id"], part),
        cov_thr=v["cov_thr"], cov_mode=v["cov_mode"],
        eval_thr=0.001, gap_open=5 if is_nucl else 11,
        gap_extend=2 if is_nucl else 1,
        ignore_multi_kmer=bool(v["ignore_multi_kmer"]),
        wrapped_scoring=bool(v["wrapped_scoring"]),
        max_seq_len=v["max_seq_len"])


def run_linclust_command(positional, space, stats, params_fn):
    """`linclust <i:seqDB> <o:cluDB> <tmpDir>`: cluster the DB on
    --device and write the cluster DB. stats receives "sequences",
    "clusters", the stage seconds under "seconds" and the aligner's pair
    counts under "pairs"."""
    from ..assembler.cluster import merged_clusters_to_db
    from ..workflow.linclust import run_linclust
    if len(positional) != 3:
        logger.error("usage: linclust <i:seqDB> <o:cluDB> <tmpDir>")
        return 1
    db = seqdb.SeqDB.open(positional[0])
    clusters = run_linclust(db, params_fn(space, db),
                            seconds=stats.setdefault("seconds", {}),
                            device=space.values["device"],
                            counts=stats.setdefault("pairs", {}))
    merged_clusters_to_db(clusters).save(positional[1])
    stats["sequences"] = db.size
    stats["clusters"] = len(clusters)
    return 0


def _linclust(positional, space, stats):
    return run_linclust_command(positional, space, stats, linclust_params)


def _assembleresults(positional, space, stats):
    from ..assembler.extend import assemble
    if len(positional) != 3:
        raise ValueError("usage: assembleresults <seqDB> <alnDB> <outDB>")
    db = seqdb.SeqDB.open(positional[0])
    alns = load_alignments(positional[1])
    out, _ = assemble(db, alns,
                      seq_id_thr=space.values["min_seq_id"].aminoacids,
                      max_seq_len=space.values["max_seq_len"],
                      keep_target=space.values["keep_target"])
    out.save(positional[2])
    return 0


def _findassemblystart(positional, space, stats):
    from ..assembler.findassemblystart import find_assembly_start
    if len(positional) != 3:
        raise ValueError("usage: findassemblystart <seqDB> <alnDB> <outDB>")
    db = seqdb.SeqDB.open(positional[0])
    alns = load_alignments(positional[1])
    find_assembly_start(db, alns).save(positional[2])
    return 0


def _filternoncoding(positional, space, stats):
    from ..assembler.filternoncoding import filter_noncoding
    from ..utils.device import pick_device
    if len(positional) != 2:
        raise ValueError("usage: filternoncoding <seqDB> <outDB>")
    db = seqdb.SeqDB.open(positional[0])
    filter_noncoding(db, pick_device(space.values["device"]),
                     space.values["protein_filter_threshold"]
                     ).save(positional[1])
    return 0


def mergereads(positional, space, stats):
    """`mergereads <r1.fq> <r2.fq> [...] <outDB>` (both CLIs)."""
    from ..data.createdb import merge_reads
    if len(positional) < 3 or (len(positional) - 1) % 2 != 0:
        raise ValueError("usage: mergereads <r1.fq> <r2.fq> [...] <outDB>")
    sdb, hdb = merge_reads(positional[:-1])
    sdb.save(positional[-1])
    hdb.save(positional[-1] + "_h")
    return 0


def createhdb(positional, space, stats):
    """`createhdb <seqDB> [<cycleDB>] <outDB>` (both CLIs): a header DB of
    "<id> len:<n>[ cycle:<0|1>]" lines."""
    if len(positional) not in (2, 3):
        raise ValueError("usage: createhdb <seqDB> [<cycleDB>] <outDB>")
    db = seqdb.SeqDB.open(positional[0])
    cycle_keys = None
    if len(positional) == 3:
        cycle_keys = set(int(k) for k in seqdb.SeqDB.open(positional[1]).keys)
    w = seqdb.DBWriter(seqdb.GENERIC_DB)
    for i in range(db.size):
        line = f"{i} len:{db.seq_len(i)}"
        if cycle_keys is not None:
            line += f" cycle:{int(int(db.keys[i]) in cycle_keys)}"
        w.write(int(db.keys[i]), line.encode())
    w.finish().save(positional[-1] + "_h")
    return 0


def commands():
    mk = plass_defaults(P.assemble_flags)
    return [
        Command("assemble", _assemble, mk, ASSEMBLE_USAGE,
                "Assemble protein sequences by iterative greedy overlap "
                "assembly"),
        Command("assembleresults", _assembleresults, mk,
                "<i:seqDB> <i:alnDB> <o:seqDB>", "Extend sequences",
                hidden=True),
        Command("findassemblystart", _findassemblystart, mk,
                "<i:seqDB> <i:alnDB> <o:seqDB>", "Correct start codons",
                hidden=True),
        Command("filternoncoding", _filternoncoding, mk,
                "<i:seqDB> <o:seqDB>", "Filter non-coding proteins",
                hidden=True),
        Command("mergereads", mergereads, mk,
                "<i:fastq> <i:fastq> <o:seqDB>", "Merge paired-end reads",
                hidden=True),
        Command("createhdb", createhdb, mk,
                "<i:seqDB> [<i:cycleDB>] <o:hdb>", "Generate header DB",
                hidden=True),
        Command("linclust", _linclust, plass_defaults(
            lambda: P.assemble_flags() + [P.Flag(
                "--min-contig-len", "min_contig_len", int, 1000, "unused")]),
                "<i:seqDB> <o:cluDB> <tmpDir>", "Linear-time clustering",
                hidden=True),
    ] + BASE_COMMANDS


def run(argv, stats=None):
    """Run the CLI on argv; returns the exit code. `stats` is handed to
    the workflow (run_assemble; linclust, search and cluster put their
    stage seconds under "seconds" and the aligner's pair counts under
    "pairs"; see there)."""
    return run_app("plass", commands(), argv, stats)


def main():
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
