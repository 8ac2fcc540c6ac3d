"""`penguin nuclassemble` workflow (reference: src/workflow/Nuclassembler.cpp
+ data/nuclassemble.sh).

Pipeline: mergereads|createdb -> iterate{kmermatcher (canonical nucleotide
k-mers) -> rescorediagonal (strand-aware) -> nuclassembleresults (Bayesian
queue) -> cyclecheck (divert circular contigs to an accumulator, drop them
from the active set)} -> concat linear+cyclic -> only-extended + min-length
selection -> fasta (headers annotated with cycle:0/1).

The k-mer matcher, the rescore and the sort of the cycle check run on
`NuclAssembleParams.device`; the extender and the rest run on the host.
With `backend` "sharded" the matcher and its rescore run across the ranks
of a process group, as in the assemble workflow.
"""
import os
from dataclasses import asdict, dataclass

from ..assembler.cyclecheck import cycle_check_db
from ..assembler.nucl_extend import nucl_assemble
from ..data import seqdb
from ..data.createdb import create_db, merge_reads
from ..ops.backend import match_kmers, rescore_diagonal_torch
from ..ops.evalue import EvalueComputer
from ..ops.rescore import RESCORE_END_TO_END, RescoreParams
from ..parallel.distributed import rank_device
from ..utils.device import resolve_backend, stage_timer
from ..utils.log import logger
from .engine import Workflow, create_tmp_dir, fingerprint


@dataclass
class NuclAssembleParams:
    """Defaults per Nuclassembler.cpp:10-32."""
    kmer_size: int = 22
    alphabet_size: int = 5
    kmers_per_sequence: int = 60
    kmers_per_sequence_scale: float = 0.1
    num_iterations: int = 8
    min_seq_id: float = 0.99
    eval_thr: float = 1e-5
    cov_thr: float = 0.0
    cov_mode: int = 0
    min_aln_len: int = 0
    max_seq_len: int = 200000
    hash_shift: int = 67
    ignore_multi_kmer: bool = True
    include_only_extendable: bool = True
    keep_target: bool = True
    rescore_mode: int = RESCORE_END_TO_END
    cycle_check: bool = True
    chop_cycle: bool = True
    min_contig_len: int = 1000
    contig_output_mode: int = 1  # OUTPUT_ONLY_EXTENDED_CONTIGS
    db_mode: bool = False
    remove_tmp_files: bool = False
    delete_tmp_inc: bool = False
    # bytes of k-mer table per hash-range split; 0: automatic on a card
    split_memory_limit: int = 0
    device: str = "cuda"  # cuda | cuda:<i> | cpu
    backend: str = "auto"  # auto | numpy | jax | sharded (resolve_backend)


def run_nuclassemble(input_files, out_file, tmp_base, params=None,
                     return_db=False, stats=None):
    """Full penguin nuclassemble. With db_mode, input_files[0] is a seq DB
    prefix and out_file receives the result DB.

    stats: an optional dict that receives the run's counts ("reads", and at
    iteration 0 "table_entries", "hits" and "reverse_hits"), under "ranges"
    the matcher's hash ranges per iteration, under "seconds" the wall
    seconds per stage (ingest, kmermatch, rescore, extend, cyclecheck,
    output), each read after the device has finished its queued work, on
    a card under "peak_bytes" each stage's peak device memory, and on the
    sharded path "exchange_bytes" and "exchange_seconds" (run_assemble)."""
    p = params or NuclAssembleParams()
    device = rank_device(p.device)
    backend = resolve_backend(p.backend, device, p.rescore_mode)
    stats = {} if stats is None else stats
    seconds = stats.setdefault("seconds", {})

    timed = stage_timer(device, seconds, stats.setdefault("peak_bytes", {}))

    if not p.db_mode and os.path.exists(out_file):
        raise FileExistsError(f"{out_file} exists already!")
    tmp = create_tmp_dir(tmp_base, fingerprint({"in": list(input_files),
                                                "out": out_file, **asdict(p)}))
    wf = Workflow(tmp, remove_tmp=p.remove_tmp_files,
                  delete_tmp_inc=p.delete_tmp_inc)

    with timed("ingest"):
        if p.db_mode:
            reads = seqdb.SeqDB.open(input_files[0])
        else:
            paired = len(input_files) >= 2 and len(input_files) % 2 == 0

            def _ingest():
                if paired:
                    sdb, hdb = merge_reads(input_files)
                else:
                    sdb, hdb = create_db(input_files)
                return {"nucl_reads": sdb, "nucl_reads_h": hdb}

            reads = wf.step("nucl_reads", _ingest,
                            ["nucl_reads", "nucl_reads_h"])["nucl_reads"]
    stats["reads"] = reads.size

    source = reads
    current = last_assembly = reads
    cycle_all = None

    for it in range(p.num_iterations):
        logger.info("STEP: %d", it)
        step_name = f"assembly_{it}"
        cyc_name = f"assembly_{it}_cycle_all"
        if os.path.exists(wf.done_file(step_name)):
            current = seqdb.SeqDB.open(wf.path(step_name + "_active"))
            last_assembly = seqdb.SeqDB.open(wf.path(step_name))
            if os.path.exists(wf.path(cyc_name) + ".dbtype"):
                cycle_all = seqdb.SeqDB.open(wf.path(cyc_name))
            logger.info("skipping iteration %d", it)
            continue

        with timed("kmermatch"):
            hits = match_kmers(
                current, p.kmer_size, device, backend,
                split_memory_limit=p.split_memory_limit, stats=stats,
                kmers_per_sequence=p.kmers_per_sequence,
                kmers_per_sequence_scale=p.kmers_per_sequence_scale,
                hash_shift=p.hash_shift, ignore_multi_kmer=p.ignore_multi_kmer,
                include_only_extendable=p.include_only_extendable,
                cov_thr=p.cov_thr, cov_mode=p.cov_mode)
        stats.setdefault("ranges", []).append(len(hits.ranges))
        if it == 0 and "hits" not in stats:
            stats["table_entries"] = hits.table_entries
            stats["hits"] = len(hits.hit_slots)
            stats["reverse_hits"] = int((hits[2] < 0).sum())
        ev = EvalueComputer.for_matrix("nucleotide_ungapped",
                                       current.total_residues())
        rp = RescoreParams(rescore_mode=p.rescore_mode, seq_id_thr=p.min_seq_id,
                           cov_thr=p.cov_thr, cov_mode=p.cov_mode,
                           eval_thr=p.eval_thr, aln_len_thr=p.min_aln_len)
        with timed("rescore"):
            alns = rescore_diagonal_torch(current, hits, rp, ev,
                                          return_flat=True)

        with timed("extend"):
            assembly, _ = nucl_assemble(current, alns, seq_id_thr=p.min_seq_id,
                                        max_seq_len=p.max_seq_len,
                                        keep_target=p.keep_target,
                                        rescore_mode=p.rescore_mode,
                                        evaluer=ev)

        with timed("cyclecheck"):
            active = assembly
            if p.cycle_check:
                cyc_db, _info = cycle_check_db(assembly,
                                               chop_cycle=p.chop_cycle,
                                               max_seq_len=p.max_seq_len,
                                               k=22, device=device)
                if cyc_db.size:
                    cycle_keys = set(int(k) for k in cyc_db.keys)
                    active_keys = [int(k) for k in assembly.keys
                                   if int(k) not in cycle_keys]
                    active = seqdb.subdb(assembly, active_keys)
                    cycle_all = cyc_db if cycle_all is None \
                        else seqdb.concat_preserve_keys(cycle_all, cyc_db)

        def _persist(asm=assembly, act=active, cyc=cycle_all):
            out = {step_name: asm, step_name + "_active": act}
            if cyc is not None:
                out[cyc_name] = cyc
            return out

        with timed("output"):
            wf.step(step_name, _persist, [])
            wf.delete_incremental(f"assembly_{it - 1}" if it > 0 else None)
        last_assembly = assembly
        current = active

    with timed("output"):
        result = _write_result(p, wf, out_file, source, current, last_assembly,
                               cycle_all)
    return (out_file, result) if return_db else out_file


def _write_result(p, wf, out_file, source, current, last_assembly,
                  cycle_all):
    """Final result: the last active (non-cyclic) contigs plus every
    accumulated cyclic contig (nuclassemble.sh:140-148; RESULT keys
    preserved), only-extended and min-length selection, then a DB
    (db_mode) or a FASTA. Returns the selected DB."""
    if cycle_all is not None:
        result = seqdb.concat_preserve_keys(current, cycle_all)
    else:
        result = last_assembly

    keep = []
    if p.contig_output_mode == 1:
        logger.info("OUTPUT ONLY EXTENDED CONTIGS")
        orig_len = {int(k): int(source.lengths[i])
                    for i, k in enumerate(source.keys)}
        for i in range(result.size):
            key = int(result.keys[i])
            if key in orig_len and int(result.lengths[i]) > orig_len[key]:
                keep.append(key)
    else:
        logger.info("OUTPUT ALL CONTIGS")
        keep = [int(k) for k in result.keys]

    # min-length filter: record length > minContigLen+1 (nuclassemble.sh:166)
    lut = result.id_lookup_array()
    keep = [k for k in keep
            if int(result.lengths[int(lut[k])]) > p.min_contig_len + 1]
    final = seqdb.subdb(result, keep)

    cycle_keys = set(int(k) for k in cycle_all.keys) \
        if cycle_all is not None else set()
    if p.db_mode:
        final.save(out_file)
        if cycle_keys:
            with open(out_file + "_cycle.index", "w") as f:
                for k in sorted(cycle_keys & set(int(x) for x in final.keys)):
                    i = final.key_to_id(k)
                    f.write(f"{k}\t{final.offsets[i]}\t{final.lengths[i]}\n")
        logger.info("wrote %s (%d contigs)", out_file, final.size)
        return final

    with open(out_file, "w") as f:
        for i in range(final.size):
            key = int(final.keys[i])
            s = final.get_seq_bytes(i).decode()
            hdr = f"{i} len:{len(s)}"
            if cycle_all is not None:
                hdr += f" cycle:{int(key in cycle_keys)}"
            f.write(f">{hdr}\n{s}\n")
    wf.cleanup()
    logger.info("wrote %s (%d contigs)", out_file, final.size)
    return final
