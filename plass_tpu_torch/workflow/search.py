"""`search` workflow: sensitive prefilter + gapped alignment.

Reference: lib/mmseqs/src/workflow/Search.cpp (defaults: sensitivity 5.7
at Search.cpp:23, alignment mode forced to SCORE_COV_SEQID at
Search.cpp:181-182) driving lib/mmseqs/data/workflow/blastp.sh (plain
protein-protein path: prefilter -> align, one sensitivity step).
Multi-step sensitivity ramping (--start-sens/--sens-steps,
blastp.sh:25-75) runs prefilter/align per step and merges with mergedbs.

The prefilter runs on the host whatever the device, as in the JAX package;
the aligner scores its candidate pairs on `device` first (kernel B9, see
ops/protein_align.py).
"""
import numpy as np

from ..data import seqdb
from ..utils.device import pick_device, stage_timer
from ..utils.log import logger
from . import engine


class SearchParams:
    def __init__(self, sensitivity=5.7, kmer_size=0, max_seqs=300,
                 min_ungapped_score=15, comp_bias_corr=True, mask=1,
                 spaced_kmer=True, exact_kmer_matching=False,
                 start_sens=4.0, sens_steps=1,
                 # align stage
                 alignment_mode=3, add_backtrace=False, eval_thr=1e-3,
                 seq_id_thr=0.0, cov_thr=0.0, cov_mode=0, aln_len_thr=0,
                 seq_id_mode=0, gap_open=11, gap_extend=1,
                 max_accept=2**31 - 1, max_reject=2**31 - 1,
                 include_identity=False, remove_tmp=False,
                 lca_search=False):
        self.sensitivity = sensitivity
        self.kmer_size = kmer_size
        self.max_seqs = max_seqs
        self.min_ungapped_score = min_ungapped_score
        self.comp_bias_corr = comp_bias_corr
        self.mask = mask
        self.spaced_kmer = spaced_kmer
        self.exact_kmer_matching = exact_kmer_matching
        self.start_sens = start_sens
        self.sens_steps = sens_steps
        self.alignment_mode = alignment_mode
        self.add_backtrace = add_backtrace
        self.eval_thr = eval_thr
        self.seq_id_thr = seq_id_thr
        self.cov_thr = cov_thr
        self.cov_mode = cov_mode
        self.aln_len_thr = aln_len_thr
        self.seq_id_mode = seq_id_mode
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.max_accept = max_accept
        self.max_reject = max_reject
        self.include_identity = include_identity
        self.remove_tmp = remove_tmp
        # ALIGN_MODULE=lcaalign (Search.cpp:307-308, approximate 2bLCA)
        self.lca_search = lca_search


def _sens_schedule(p):
    """Search.cpp:412-432: evenly spaced steps from start_sens to
    sensitivity (single step = just sensitivity)."""
    if p.sens_steps <= 1:
        return [p.sensitivity]
    if p.start_sens > p.sensitivity:
        raise ValueError("--start-sens should not be greater than -s")
    step = (p.sensitivity - p.start_sens) / float(p.sens_steps - 1)
    return [round(p.start_sens + i * step, 1) for i in range(p.sens_steps)]


def run_search(qdb, tdb, out_path, tmp_base, params=None, tdb_path=None,
               device="cuda", seconds=None, counts=None):
    """Search qdb against tdb, writing an alignment DB to out_path.

    qdb/tdb: SeqDB objects or paths. When tdb_path is known, a compatible
    precomputed index (<tdb>.idx from `createindex`/`indexdb`) is used for
    the prefilter stage (PrefilteringIndexReader::searchForIndex).

    device: where the aligner scores its candidate pairs ("cuda",
    "cuda:<i>" or "cpu"); it is not part of the tmp dir's fingerprint, so
    runs on either device resume each other's steps. seconds: an optional
    dict that receives the wall seconds of the stages run here (prefilter,
    align, merge); counts: one that receives align_protein's pair counts.
    """
    from ..cli.tools import load_prefilter
    from ..ops import prefilter as pf
    from ..ops.protein_align import (align_protein, lca_align_protein,
                                     protein_align_results_to_db)

    p = params or SearchParams()
    device = pick_device(device)
    timed = stage_timer(device, {} if seconds is None else seconds)
    if isinstance(qdb, str):
        qdb = seqdb.SeqDB.open(qdb)
    if isinstance(tdb, str):
        tdb_path = tdb_path or tdb
        tdb = seqdb.SeqDB.open(tdb)
    if qdb.dbtype != seqdb.AMINO_ACIDS or tdb.dbtype != seqdb.AMINO_ACIDS:
        raise ValueError("search: only protein-protein search is "
                         "implemented (nucleotide search pending)")
    tmp = engine.create_tmp_dir(tmp_base, engine.fingerprint(vars(p)))
    wf = engine.Workflow(tmp, remove_tmp=p.remove_tmp)

    same_db = qdb is tdb
    # physical record order of the query DB (reference processes and
    # writes queries in data-file order, LINEAR_ACCCESS)
    qorder = [int(qdb.keys[i]) for i in
              np.argsort(qdb.offsets, kind="stable")]
    steps = _sens_schedule(p)
    merged = {}
    for si, sens in enumerate(steps):
        def _pref(sens=sens):
            with timed("prefilter"):
                pr = pf.PrefilterParams(
                    sensitivity=sens, kmer_size=p.kmer_size,
                    max_seqs=p.max_seqs,
                    min_ungapped_score=p.min_ungapped_score,
                    comp_bias_corr=p.comp_bias_corr, mask=p.mask,
                    spaced_kmer=p.spaced_kmer,
                    exact_kmer_matching=p.exact_kmer_matching)
                if tdb_path:
                    k_eff = pr.kmer_size or pf.auto_kmer_size(
                        tdb.total_residues())
                    thr_eff = pf.kmer_threshold(pr.sensitivity, k_eff,
                                                pr.kmer_score)
                    pr.prebuilt_index = pf.load_prefilter_index(
                        tdb_path, k_eff, thr_eff, pr.mask, pr.spaced_kmer,
                        seq_type=tdb.dbtype, comp_bias=pr.comp_bias_corr)
                    if pr.prebuilt_index is not None:
                        logger.info("using precomputed index %s",
                                    pf.index_file_name(tdb_path))
                hits = pf.prefilter(qdb, tdb, pr, same_db=same_db)
                return {f"pref_{si}": pf.prefilter_to_db(hits, qorder)}
        wf.step(f"pref_{si}", _pref, outputs=(f"pref_{si}",))

        def _aln(si=si):
            with timed("align"):
                hits = load_prefilter(wf.path(f"pref_{si}"))
                if p.lca_search:
                    res = lca_align_protein(
                        qdb, hits, tdb=None if same_db else tdb,
                        alignment_mode=p.alignment_mode, cov_thr=p.cov_thr,
                        cov_mode=p.cov_mode, seq_id_thr=p.seq_id_thr,
                        eval_thr=p.eval_thr, aln_len_thr=p.aln_len_thr,
                        gap_open=p.gap_open, gap_extend=p.gap_extend,
                        comp_bias_corr=p.comp_bias_corr,
                        max_accept=p.max_accept, max_reject=p.max_reject,
                        seq_id_mode=p.seq_id_mode,
                        include_identity=p.include_identity)
                    return {f"aln_{si}": protein_align_results_to_db(
                        res, key_order=qorder)}
                res = align_protein(
                    qdb, hits, seq_id_thr=p.seq_id_thr, cov_thr=p.cov_thr,
                    cov_mode=p.cov_mode, eval_thr=p.eval_thr,
                    aln_len_thr=p.aln_len_thr, gap_open=p.gap_open,
                    gap_extend=p.gap_extend, comp_bias_corr=p.comp_bias_corr,
                    tdb=None if same_db else tdb,
                    alignment_mode=p.alignment_mode,
                    add_backtrace=p.add_backtrace,
                    include_identity=p.include_identity,
                    seq_id_mode=p.seq_id_mode, max_accept=p.max_accept,
                    max_reject=p.max_reject, device=device, counts=counts)
                return {f"aln_{si}": protein_align_results_to_db(
                    res, add_backtrace=p.add_backtrace, key_order=qorder)}
        aln = wf.step(f"aln_{si}", _aln, outputs=(f"aln_{si}",))
        merged[si] = aln[f"aln_{si}"]

    with timed("merge"):
        if len(steps) == 1:
            out = merged[0]
        else:
            # mergedbs semantics: concatenate per-key records across steps
            out = _merge_aln_dbs(qdb, [merged[i] for i in range(len(steps))])
        out.save(out_path)
    if p.remove_tmp:
        wf.cleanup()
    return out


def _merge_aln_dbs(qdb, dbs):
    writer = seqdb.DBWriter(seqdb.ALIGNMENT_RES)
    for key in [int(k) for k in qdb.keys]:
        parts = []
        for db in dbs:
            i = db.key_to_id(key)
            if i is not None:
                parts.append(db.get_data(i).tobytes())
        writer.write(key, b"".join(parts), add_newline=False)
    return writer.finish()
