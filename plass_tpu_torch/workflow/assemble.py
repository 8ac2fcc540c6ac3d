"""`plass assemble` workflow (reference: src/workflow/Assembler.cpp +
data/assemble.sh).

Pipeline: mergereads|createdb -> extractorfs(START+LONG) -> translatenucs
-> concat -> iterate{kmermatcher -> rescorediagonal -> [iter 0:
findassemblystart -> re-match/rescore] -> assembleresults} ->
filternoncoding -> select-assembled -> fasta output.

The k-mer matcher, the rescore and the coding filter's MLP run on
`AssembleParams.device`; the rest runs on the host. With `backend`
"sharded" (or "auto" in a process group of more than one rank) the
matcher and its rescore run across the ranks (ops/backend.
kmermatcher_sharded_torch): every rank runs the whole workflow and writes
the paths it was given.

Defaults from setAssembleDBWorkflowDefaults (Assembler.cpp:10-27).
"""
import os
from dataclasses import dataclass, asdict

import numpy as np

from ..assembler.extend import assemble as assemble_pass
from ..assembler.filternoncoding import filter_noncoding
from ..assembler.findassemblystart import find_assembly_start
from ..data import seqdb
from ..data.createdb import create_db, merge_reads
from ..ops import orf as orf_mod
from ..ops import translate as translate_mod
from ..ops.backend import match_kmers, rescore_diagonal_torch
from ..ops.evalue import EvalueComputer
from ..ops.rescore import RESCORE_END_TO_END, RescoreParams
from ..parallel.distributed import rank_device
from ..utils.device import resolve_backend, stage_timer
from ..utils.log import logger
from .engine import Workflow, create_tmp_dir, fingerprint


@dataclass
class AssembleParams:
    """Defaults per Assembler.cpp:10-27 + Parameters.cpp."""
    kmer_size: int = 14
    alphabet_size: int = 13
    kmers_per_sequence: int = 60
    kmers_per_sequence_scale: float = 0.0
    num_iterations: int = 12
    min_seq_id: float = 0.9
    eval_thr: float = 1e-5
    cov_thr: float = 0.0
    cov_mode: int = 0
    min_aln_len: int = 0
    max_seq_len: int = 65535
    orf_min_length: int = 45
    orf_max_length: int = 32734
    translation_table: int = 1
    use_all_table_starts: bool = False
    filter_proteins: int = 1
    protein_filter_threshold: float = 0.2
    hash_shift: int = 67
    ignore_multi_kmer: bool = True
    include_only_extendable: bool = True  # off at iteration 0 unless user-set
    include_only_extendable_set: bool = False
    keep_target: bool = True
    rescore_mode: int = RESCORE_END_TO_END
    remove_tmp_files: bool = False
    delete_tmp_inc: bool = False
    # bytes of k-mer table per hash-range split; 0: automatic on a card
    split_memory_limit: int = 0
    device: str = "cuda"  # cuda | cuda:<i> | cpu
    backend: str = "auto"  # auto | numpy | jax | sharded (resolve_backend)


def _iteration_hash_shift(base, iteration):
    """Assembler.cpp:99-110: hashShift accumulates i%2 per iteration."""
    shift = base
    for i in range(iteration + 1):
        shift += i % 2
    return shift


def run_assemble(input_files, out_fasta, tmp_base, params=None, stats=None):
    """Full plass assemble. input_files: 1 file (single-end) or 2N files
    (paired). Writes out_fasta; returns its path.

    stats: an optional dict that receives the run's counts ("reads",
    "orfs", and at iteration 0 "table_entries" and "hits"), under "ranges"
    the matcher's hash ranges per call, under "seconds" the wall seconds
    per stage (ingest, kmermatch, rescore, extend, filter, output), each
    read after the device has finished its queued work, on a card under
    "peak_bytes" each stage's peak device memory, and on the sharded path
    under "exchange_bytes" and "exchange_seconds" the bytes this rank sent
    and the seconds of the matcher's exchanges ("table", "pairs") and of
    its gather ("gather")."""
    p = params or AssembleParams()
    device = rank_device(p.device)
    backend = resolve_backend(p.backend, device)
    stats = {} if stats is None else stats
    seconds = stats.setdefault("seconds", {})

    timed = stage_timer(device, seconds, stats.setdefault("peak_bytes", {}))

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

    stops = translate_mod.stop_codons(p.translation_table)
    starts = translate_mod.start_codons(p.translation_table, p.use_all_table_starts)

    # ORF extraction, LONG set: orf-start-mode 0, max-gaps 0 (Assembler.cpp:117-120)
    def _orfs_long():
        odb, ohdb = orf_mod.extract_orfs(
            reads, min_length=p.orf_min_length, max_length=p.orf_max_length,
            max_gaps=0, start_mode=orf_mod.START_TO_STOP,
            contig_start_mode=2, contig_end_mode=2,
            stop_codons=stops, start_codons=starts)
        return {"nucl_6f_long": odb, "nucl_6f_long_h": ohdb}

    # START set: contig-start-mode 1, contig-end-mode 0, min<=20, max=orfMin
    # (Assembler.cpp:123-130)
    def _orfs_start():
        odb, ohdb = orf_mod.extract_orfs(
            reads, min_length=min(p.orf_min_length, 20),
            max_length=p.orf_min_length, max_gaps=0,
            start_mode=orf_mod.START_TO_STOP,
            contig_start_mode=1, contig_end_mode=0,
            stop_codons=stops, start_codons=starts)
        return {"nucl_6f_start": odb, "nucl_6f_start_h": ohdb}

    def _translate():
        aa_long = translate_mod.translate_nucs(
            long_dbs["nucl_6f_long"], long_dbs["nucl_6f_long_h"],
            p.translation_table, add_orf_stop=True, max_seq_len=p.max_seq_len)
        aa_start = translate_mod.translate_nucs(
            start_dbs["nucl_6f_start"], start_dbs["nucl_6f_start_h"],
            p.translation_table, add_orf_stop=True, max_seq_len=p.max_seq_len)
        # concat renumbers: LONG first, then START (assemble.sh:65-77)
        combined = seqdb.concat(aa_long, aa_start)
        hdr = seqdb.concat(long_dbs["nucl_6f_long_h"], start_dbs["nucl_6f_start_h"])
        return {"aa_6f_start_long": combined, "aa_6f_start_long_h": hdr}

    with timed("ingest"):
        dbs = wf.step("nucl_reads", _ingest, ["nucl_reads", "nucl_reads_h"])
        reads = dbs["nucl_reads"]
        long_dbs = wf.step("nucl_6f_long", _orfs_long,
                           ["nucl_6f_long", "nucl_6f_long_h"])
        start_dbs = wf.step("nucl_6f_start", _orfs_start,
                            ["nucl_6f_start", "nucl_6f_start_h"])
        aa_dbs = wf.step("aa_6f_start_long", _translate,
                         ["aa_6f_start_long", "aa_6f_start_long_h"])
    current = aa_dbs["aa_6f_start_long"]
    stats["reads"] = reads.size
    stats["orfs"] = current.size

    def _match_and_rescore(db, iteration, flat=True):
        shift = _iteration_hash_shift(p.hash_shift, iteration)
        if p.include_only_extendable_set:
            only_ext = p.include_only_extendable
        else:
            only_ext = iteration != 0
        ev = EvalueComputer.for_matrix("blosum62_ungapped", db.total_residues())
        rp = RescoreParams(rescore_mode=p.rescore_mode, seq_id_thr=p.min_seq_id,
                           cov_thr=p.cov_thr, cov_mode=p.cov_mode,
                           eval_thr=p.eval_thr, aln_len_thr=p.min_aln_len)
        with timed("kmermatch"):
            hits = match_kmers(
                db, p.kmer_size, device, backend,
                split_memory_limit=p.split_memory_limit, stats=stats,
                kmers_per_sequence=p.kmers_per_sequence,
                kmers_per_sequence_scale=p.kmers_per_sequence_scale,
                hash_shift=shift, ignore_multi_kmer=p.ignore_multi_kmer,
                include_only_extendable=only_ext, cov_thr=p.cov_thr,
                cov_mode=p.cov_mode)
        stats.setdefault("ranges", []).append(len(hits.ranges))
        if iteration == 0 and "hits" not in stats:
            stats["table_entries"] = hits.table_entries
            stats["hits"] = len(hits.hit_slots)
        with timed("rescore"):
            alns = rescore_diagonal_torch(db, hits, rp, ev, return_flat=flat)
        return alns, ev

    for it in range(p.num_iterations):
        logger.info("STEP: %d", it)
        step_name = f"assembly_{it}"
        if os.path.exists(wf.done_file(step_name)):
            current = seqdb.SeqDB.open(wf.path(step_name))
            logger.info("skipping iteration %d (already done)", it)
            continue

        alns, ev = _match_and_rescore(current, it, flat=(it != 0))

        if it == 0:
            with timed("extend"):
                current = find_assembly_start(current, alns)
            alns, ev = _match_and_rescore(current, it)

        with timed("extend"):
            current, _flags = assemble_pass(
                current, alns, seq_id_thr=p.min_seq_id,
                max_seq_len=p.max_seq_len, keep_target=p.keep_target,
                rescore_mode=p.rescore_mode, evaluer=ev)
            wf.step(step_name, lambda cur=current: {step_name: cur},
                    [step_name])
            wf.delete_incremental(f"assembly_{it - 1}" if it > 0 else None)

    result = current
    if p.filter_proteins:
        with timed("filter"):
            result = wf.step(
                "assembly_filtered",
                lambda: {"assembly_filtered": filter_noncoding(
                    result, device, p.protein_filter_threshold)},
                ["assembly_filtered"])["assembly_filtered"]

    with timed("output"):
        final = select_assembled(result, aa_dbs["aa_6f_start_long"])
        write_fasta(final, out_fasta)
    wf.cleanup()
    logger.info("wrote %s (%d contigs)", out_fasta, final.size)
    return out_fasta


def select_assembled(result_db, orig_db):
    """Select only-assembled sequences (assemble.sh:170-179).

    Two criteria, unioned:
     1. entries whose index length grew vs. the original ORF DB
        (key-based awk join, assemble.sh:173-174)
     2. complete '*...*' proteins — NOTE the reference awk keys these by the
        DATA-FILE LINE NUMBER of the matching record, not by its key
        (assemble.sh:176: ``f[NR-1]=1`` over the data file); with the
        reference's write-order layout line j is not key j, so we replicate
        exactly: the selected key IS the line number.
    The union is processed in lexicographic key order (`sort | uniq`,
    assemble.sh:178), which determines the output data layout.
    """
    # criterion 1: key grew vs original (vectorized key join)
    okeys = orig_db.keys.astype(np.int64)
    oorder = np.argsort(okeys, kind="stable")
    osorted = okeys[oorder]
    rkeys = result_db.keys.astype(np.int64)
    pos = np.searchsorted(osorted, rkeys)
    safe = np.minimum(pos, len(osorted) - 1) if len(osorted) else pos * 0
    in_orig = (len(osorted) > 0) & (pos < len(osorted)) \
        & (osorted[safe] == rkeys)
    grew = np.zeros(result_db.size, dtype=bool)
    if len(osorted):
        olen = orig_db.lengths[oorder][safe]
        grew = in_orig & (result_db.lengths > olen)
    keep = set(int(k) for k in rkeys[grew])
    # criterion 2: '*'-bracketed all-uppercase proteins, matched by LINE
    # NUMBER in data order (awk NR semantics) — per-byte scan replaced by
    # a cumulative uppercase count over the flat data file
    data = result_db.data
    plen = result_db.seq_lens().astype(np.int64)
    offs = result_db.offsets.astype(np.int64)
    upper = ((data >= 65) & (data <= 90)).astype(np.int64)
    cup = np.concatenate([[0], np.cumsum(upper)])
    star = np.uint8(ord("*"))
    nonempty = plen >= 2
    first_off = np.minimum(offs, len(data) - 1) if len(data) else offs * 0
    last_off = np.minimum(offs + np.maximum(plen, 1) - 1,
                          len(data) - 1) if len(data) else offs * 0
    ok = nonempty & (data[first_off] == star) & (data[last_off] == star)
    mid = cup[np.minimum(offs + plen - 1, len(cup) - 1)] - \
        cup[np.minimum(offs + 1, len(cup) - 1)]
    ok &= mid == np.maximum(plen - 2, 0)
    file_order = np.argsort(result_db.offsets, kind="stable")
    line_nos = np.nonzero(ok[file_order])[0]
    rset = np.isin(line_nos, rkeys)
    keep.update(int(x) for x in line_nos[rset])
    return seqdb.subdb(result_db, keep, order="lex")


def write_fasta(db, path, header_fn=None):
    """convert2fasta with createhdb-style headers: '><pos> len:<len>' where
    pos is the key-sorted record position (src/util/createhdb.cpp:46-63)."""
    with open(path, "w") as f:
        for i in range(db.size):
            s = db.get_seq_bytes(i).decode()
            hdr = header_fn(i, len(s)) if header_fn else f"{i} len:{len(s)}"
            f.write(f">{hdr}\n{s}\n")
