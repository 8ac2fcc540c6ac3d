"""`penguin guided_nuclassemble` workflow.

Reference: src/workflow/GuidedNuclassembler.cpp + data/guidedNuclAssemble.sh.

Pipeline: mergereads|createdb -> extractorfs(START+LONG) -> concat (nucl and
headers) -> translatenucs --add-orf-stop -> iterate{kmermatcher(AA k14) ->
rescorediagonal(END_TO_END) -> proteinaln2nucl -> guidedassembleresults
(lockstep nucl+aa contigs)} -> only-assembled selection (key join, grew vs
nucl_6f_start_long) -> concat with reads -> nested nuclassemble (db mode) ->
linclust redundancy reduction -> result2repseq -> cycle-annotated fasta.

The k-mer matchers and the rescores of both loops run on
`GuidedNuclAssembleParams.device`, as does the sort of the cycle check; the
ORF extraction, proteinaln2nucl, both extenders and the linclust tail run on
the host.
"""
import os
from dataclasses import dataclass, asdict

import numpy as np

from ..assembler.cluster import result2repseq, merged_clusters_to_db
from ..assembler.guided_extend import guided_assemble
from ..data import seqdb
from ..data.createdb import create_db, merge_reads
from ..ops import orf as orf_mod
from ..ops import translate as translate_mod
from ..ops.backend import kmermatcher_torch, rescore_diagonal_torch
from ..ops.proteinaln2nucl import protein_aln_to_nucl
from ..ops.rescore import RESCORE_END_TO_END, RescoreParams
from ..utils.device import pick_device, stage_timer
from ..utils.log import logger
from .engine import Workflow, create_tmp_dir, fingerprint
from .linclust import LinclustParams, run_linclust_nucl
from .nuclassemble import NuclAssembleParams, run_nuclassemble


@dataclass
class GuidedNuclAssembleParams:
    """Defaults per setGuidedNuclAssemblerWorkflowDefaults
    (GuidedNuclassembler.cpp:10-41)."""
    aa_num_iterations: int = 5
    nucl_num_iterations: int = 5
    aa_kmer_size: int = 14
    nucl_kmer_size: int = 22
    aa_seq_id: float = 0.97
    nucl_seq_id: float = 0.99
    orf_min_length: int = 45
    eval_thr: float = 1e-5
    kmers_per_sequence: int = 60
    kmers_per_sequence_scale: float = 0.1
    hash_shift: int = 67
    max_seq_len: int = 200000
    min_contig_len: int = 1000
    cycle_check: bool = True
    chop_cycle: bool = True
    translation_table: int = 1
    use_all_table_starts: bool = False
    # redundancy-reduction clustering
    clust_seq_id: float = 0.97
    clust_cov: float = 0.99
    gap_open: int = 5
    gap_extend: int = 2
    zdrop: int = 200
    remove_tmp_files: bool = False
    delete_tmp_inc: bool = False
    # bytes of k-mer table per hash-range split, for the matchers of both
    # loops; 0: automatic on a card
    split_memory_limit: int = 0
    device: str = "cuda"  # cuda | cuda:<i> | cpu


def select_only_assembled(result_db, orig_db):
    """Keys present in both DBs whose record grew against the original ORF
    DB, in the original's order (guidedNuclAssemble.sh:141-143, a key join,
    not line numbers)."""
    lut = result_db.id_lookup_array()
    okeys = orig_db.keys.astype(np.int64)
    known = okeys < len(lut)
    row = lut[np.where(known, okeys, 0)].astype(np.int64)
    known &= row != np.iinfo(np.uint32).max
    grew = known.copy()
    grew[known] = result_db.lengths[row[known]] > orig_db.lengths[known]
    return [int(k) for k in okeys[grew]]


def run_guided_nuclassemble(input_files, out_fasta, tmp_base, params=None,
                            stats=None):
    """Full penguin guided_nuclassemble. Writes out_fasta; returns its path.

    stats: an optional dict that receives the run's counts ("reads", "orfs",
    at aa iteration 0 "table_entries" and "hits", "only_assembled",
    "contigs"), under "ranges" the amino-acid matcher's hash ranges per
    iteration, under "seconds" the wall seconds per stage (ingest, orfs,
    kmermatch, rescore, aln2nucl, extend, select, nuclassemble, linclust,
    output), each read after the device has finished its queued work, on a
    card under "peak_bytes" each stage's peak device memory, under
    "nuclassemble" the nested run's own stats (run_nuclassemble) and under
    "linclust_seconds" the seconds of the linclust stages (run_linclust)."""
    p = params or GuidedNuclAssembleParams()
    device = pick_device(p.device)
    stats = {} if stats is None else stats
    seconds = stats.setdefault("seconds", {})
    peaks = stats.setdefault("peak_bytes", {})
    timed = stage_timer(device, seconds, peaks)

    if os.path.exists(out_fasta):
        raise FileExistsError(f"{out_fasta} exists already!")
    tmp = create_tmp_dir(tmp_base, fingerprint({"in": list(input_files),
                                                "out": out_fasta,
                                                **asdict(p)}))
    wf = Workflow(tmp, remove_tmp=p.remove_tmp_files,
                  delete_tmp_inc=p.delete_tmp_inc)
    paired = len(input_files) >= 2 and len(input_files) % 2 == 0

    def _ingest():
        if paired:
            sdb, hdb = merge_reads(input_files)
        else:
            sdb, hdb = create_db(input_files)
        return {"nucl_reads": sdb, "nucl_reads_h": hdb}

    with timed("ingest"):
        dbs = wf.step("nucl_reads", _ingest, ["nucl_reads", "nucl_reads_h"])
    reads = dbs["nucl_reads"]
    stats["reads"] = reads.size

    stops = translate_mod.stop_codons(p.translation_table)
    starts = translate_mod.start_codons(p.translation_table,
                                        p.use_all_table_starts)

    def _orfs():
        # EXTRACTORFS_START_PAR: contig modes 1/0, len [min(orfMin,20),
        # orfMin]; EXTRACTORFS_LONG_PAR: contig modes 2/2, len [orfMin,
        # 32734] (GuidedNuclassembler.cpp:134-150)
        start_db, start_h = orf_mod.extract_orfs(
            reads, min_length=min(p.orf_min_length, 20),
            max_length=p.orf_min_length, max_gaps=0,
            start_mode=orf_mod.START_TO_STOP,
            contig_start_mode=1, contig_end_mode=0,
            stop_codons=stops, start_codons=starts)
        long_db, long_h = orf_mod.extract_orfs(
            reads, min_length=p.orf_min_length, max_length=32734,
            max_gaps=0, start_mode=orf_mod.START_TO_STOP,
            contig_start_mode=2, contig_end_mode=2,
            stop_codons=stops, start_codons=starts)
        nucl = seqdb.concat(long_db, start_db)
        hdr = seqdb.concat(long_h, start_h)
        aa = translate_mod.translate_nucs(nucl, hdr, p.translation_table,
                                          add_orf_stop=True)
        return {"nucl_6f_start_long": nucl, "nucl_6f_start_long_h": hdr,
                "aa_6f_start_long": aa}

    with timed("orfs"):
        orf_dbs = wf.step("aa_6f_start_long", _orfs,
                          ["nucl_6f_start_long", "nucl_6f_start_long_h",
                           "aa_6f_start_long"])
    orig_nucl = orf_dbs["nucl_6f_start_long"]
    current_nucl = orig_nucl
    current_aa = orf_dbs["aa_6f_start_long"]
    stats["orfs"] = current_aa.size

    for it in range(p.aa_num_iterations):
        logger.info("STEP: %d", it)
        step = f"assembly_nucl_{it}"
        if os.path.exists(wf.done_file(step)):
            current_nucl = seqdb.SeqDB.open(wf.path(step))
            current_aa = seqdb.SeqDB.open(wf.path(f"assembly_aa_{it}"))
            continue
        with timed("kmermatch"):
            # the nucleotide k-mer scale goes to the amino-acid matcher too
            # (GuidedNuclassembler.cpp passes one parameter set)
            hits = kmermatcher_torch(
                current_aa, p.aa_kmer_size, device,
                kmers_per_sequence=p.kmers_per_sequence,
                kmers_per_sequence_scale=p.kmers_per_sequence_scale,
                hash_shift=p.hash_shift, ignore_multi_kmer=True,
                include_only_extendable=True,
                split_memory_limit=p.split_memory_limit)
        stats.setdefault("ranges", []).append(len(hits.ranges))
        if it == 0 and "hits" not in stats:
            stats["table_entries"] = hits.table_entries
            stats["hits"] = len(hits.hit_slots)
        # the records are pure-M: the rescore writes no backtrace column
        # and proteinaln2nucl derives "<alnLength>M" (the reference asks
        # for add_backtrace here and drops it the same way)
        rp = RescoreParams(rescore_mode=RESCORE_END_TO_END,
                           seq_id_thr=p.aa_seq_id, cov_thr=0.0, cov_mode=1,
                           eval_thr=p.eval_thr)
        with timed("rescore"):
            alns = rescore_diagonal_torch(current_aa, hits, rp,
                                          return_flat=True)
        with timed("aln2nucl"):
            nucl_alns = protein_aln_to_nucl(current_nucl, current_aa, alns)
        with timed("extend"):
            current_nucl, current_aa, _ = guided_assemble(
                current_nucl, current_aa, nucl_alns, seq_id_thr=p.nucl_seq_id,
                max_seq_len=p.max_seq_len)

        def _persist(n=current_nucl, a=current_aa, s=step, i=it):
            return {s: n, f"assembly_aa_{i}": a}

        with timed("output"):
            wf.step(step, _persist, [])
            wf.delete_incremental(f"assembly_nucl_{it - 1}" if it > 0 else None)
            wf.delete_incremental(f"assembly_aa_{it - 1}" if it > 0 else None)

    with timed("select"):
        keep = select_only_assembled(current_nucl, orig_nucl)
        only_assembled = seqdb.subdb(current_nucl, keep)
        logger.info("only-assembled: %d of %d", len(keep), current_nucl.size)
        stats["only_assembled"] = len(keep)
        merged = seqdb.concat(only_assembled, reads)
        merged_path = wf.path("guided_assembly.merged")
        merged.save(merged_path)

    nucl_params = NuclAssembleParams(
        num_iterations=p.nucl_num_iterations, kmer_size=p.nucl_kmer_size,
        min_seq_id=p.nucl_seq_id, eval_thr=p.eval_thr,
        kmers_per_sequence=p.kmers_per_sequence,
        kmers_per_sequence_scale=p.kmers_per_sequence_scale,
        hash_shift=p.hash_shift, max_seq_len=p.max_seq_len,
        cycle_check=p.cycle_check, chop_cycle=p.chop_cycle,
        min_contig_len=p.min_contig_len, cov_mode=1, db_mode=True,
        split_memory_limit=p.split_memory_limit, device=p.device)
    nucl_out = wf.path("nuclassembly")
    nested = stats.setdefault("nuclassemble", {})
    with timed("nuclassemble"):
        _, nucl_db = run_nuclassemble(
            [merged_path], nucl_out, wf.path("nuclassembly_tmp"), nucl_params,
            return_db=True, stats=nested)
    if nested.get("peak_bytes"):
        # the nested stages reset the peak as they start: theirs is this one
        peaks["nuclassemble"] = max(nested["peak_bytes"].values())
    cycle_index = nucl_out + "_cycle.index"
    cycle_keys = set()
    has_cycle = os.path.exists(cycle_index)
    if has_cycle:
        with open(cycle_index) as f:
            cycle_keys = {int(line.split()[0]) for line in f if line.strip()}

    with timed("linclust"):
        clusters = run_linclust_nucl(nucl_db, LinclustParams(
            kmer_size=p.nucl_kmer_size,
            kmers_per_sequence=p.kmers_per_sequence,
            kmers_per_sequence_scale=p.kmers_per_sequence_scale,
            hash_shift=p.hash_shift, seq_id_thr=p.clust_seq_id,
            cov_thr=p.clust_cov, gap_open=p.gap_open, gap_extend=p.gap_extend,
            zdrop=p.zdrop, max_seq_len=p.max_seq_len),
            seconds=stats.setdefault("linclust_seconds", {}))

    with timed("output"):
        clu_db = merged_clusters_to_db(clusters)
        rep = result2repseq(nucl_db, clu_db)
        with open(out_fasta, "w") as f:
            for i in range(rep.size):
                key = int(rep.keys[i])
                s = rep.get_seq_bytes(i).decode()
                hdr = f"{i} len:{len(s)}"
                if has_cycle:
                    hdr += f" cycle:{int(key in cycle_keys)}"
                f.write(f">{hdr}\n{s}\n")
    stats["contigs"] = rep.size
    wf.cleanup()
    logger.info("wrote %s (%d contigs)", out_fasta, rep.size)
    return out_fasta
