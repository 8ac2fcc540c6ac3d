"""Linear-time clustering workflow (`linclust`) for nucleotide and
amino-acid DBs.

Reference: lib/mmseqs/data/workflow/linclust.sh + src/workflow/Linclust.cpp:
kmermatcher -> HAMMING rescorediagonal (thresholds raised to max(0.5, thr))
-> pre-clustering -> representative sub-DB -> prefilter restriction
(createsubdb + filterdb) -> [AA only: SUBSTITUTION rescore with the
precision-library score-per-column filter] -> gapped `align` -> clustering
-> mergeclusters. Cluster mode: SET_COVER for symmetric coverage,
GREEDY for query/target cov modes (Linclust.cpp:67-76); k-mer length and
alphabet auto-resolve from the identity threshold when k=0
(kmermatcher.cpp setKmerLengthAndAlphabet:1200-1228).

The matcher, the HAMMING rescore and the SUBSTITUTION filter run on the
host whatever the device, as in the JAX package; so does the nucleotide
aligner (per-pair ksw2). The amino-acid aligner (ops/protein_align.py)
scores its candidate pairs on `device` first (ops/device_align.py, kernel
B9) when there are enough of them.
"""
import contextlib
import math
import time
from dataclasses import dataclass

from ..assembler.cluster import (alignment_adjacency,
                                 greedy_incremental_cluster,
                                 merge_clusters, prefilter_adjacency,
                                 set_cover_cluster)
from ..data import seqdb
from ..ops.kmermatch import kmermatcher
from ..ops.nucl_align import align_nucl
from ..ops.protein_align import align_protein
from ..ops.rescore import (RESCORE_HAMMING, RESCORE_SUBSTITUTION,
                           RescoreParams, parse_precision_lib,
                           rescore_diagonal)
from ..utils.device import pick_device
from ..utils.log import logger

CLUSTER_SET_COVER = 0
CLUSTER_GREEDY = 2


@dataclass
class LinclustParams:
    """Guided reduce-redundancy defaults (GuidedNuclassembler.cpp:34-40);
    `plass linclust` itself defaults to kmer_size=0 (auto), kps 21,
    seq_id 0.9, cov 0.8, cov_mode 0."""
    kmer_size: int = 22
    alphabet_size: int = 5
    kmers_per_sequence: int = 60
    kmers_per_sequence_scale: float = 0.1
    hash_shift: int = 67
    seq_id_thr: float = 0.97
    cov_thr: float = 0.99
    cov_mode: int = 1
    eval_thr: float = 0.001
    gap_open: int = 5
    gap_extend: int = 2
    zdrop: int = 200
    max_seq_len: int = 200000
    ignore_multi_kmer: bool = True
    wrapped_scoring: bool = True
    cluster_mode: int = -1  # -1: auto per cov_mode
    comp_bias_corr: bool = True


def resolve_kmer_params(p, db, is_nucl):
    """setKmerLengthAndAlphabet for kmer_size == 0."""
    k = p.kmer_size
    if k:
        return k
    if is_nucl:
        return max(17, int(math.log(float(db.total_residues())) / math.log(4)))
    if (p.seq_id_thr + 0.001) >= 0.9:  # both the 0.99 and 0.9 branches use 14
        return 14
    return max(10, int(math.log(float(db.total_residues())) / math.log(8.7)))


def _cluster(db, adjacency, mode):
    if mode == CLUSTER_SET_COVER:
        return set_cover_cluster(db, adjacency)
    return greedy_incremental_cluster(
        db, {q: [t for (t, _s) in adjacency.get(q, [])] for q in adjacency})


def run_linclust(db, params=None, intermediates=None, seconds=None,
                 device="cuda", counts=None):
    """Cluster a DB; returns {rep_key: [member keys]} in mergeclusters
    layout (rep first in each member list).

    seconds: an optional dict that receives the wall seconds per stage
    (kmermatch, rescore, precluster, filter on an amino-acid DB, align,
    cluster). device: where the amino-acid aligner scores its candidate
    pairs ("cuda", "cuda:<i>" or "cpu"); a nucleotide DB stays on the
    host. counts: an optional dict that receives the amino-acid aligner's
    pair counts (see align_protein)."""
    p = params or LinclustParams()
    is_nucl = db.dbtype == seqdb.NUCLEOTIDES
    seconds = {} if seconds is None else seconds

    @contextlib.contextmanager
    def timed(stage):
        t0 = time.perf_counter()
        yield
        seconds[stage] = seconds.get(stage, 0.0) + time.perf_counter() - t0

    mode = p.cluster_mode
    if mode < 0:
        mode = CLUSTER_GREEDY if p.cov_mode in (1, 2) else CLUSTER_SET_COVER
    k = resolve_kmer_params(p, db, is_nucl)

    logger.info("linclust: kmermatcher (k=%d)", k)
    with timed("kmermatch"):
        pref = kmermatcher(db, k,
                           kmers_per_sequence=p.kmers_per_sequence,
                           kmers_per_sequence_scale=p.kmers_per_sequence_scale,
                           hash_shift=p.hash_shift,
                           ignore_multi_kmer=p.ignore_multi_kmer,
                           include_only_extendable=False,
                           cov_thr=p.cov_thr, cov_mode=p.cov_mode)

    logger.info("linclust: hamming pre-rescore")
    rp = RescoreParams(rescore_mode=RESCORE_HAMMING,
                       seq_id_thr=max(0.5, p.seq_id_thr),
                       cov_thr=max(0.5, p.cov_thr), cov_mode=p.cov_mode,
                       eval_thr=p.eval_thr,
                       wrapped_scoring=p.wrapped_scoring and is_nucl)
    with timed("rescore"):
        rescore1 = rescore_diagonal(db, pref, rp)

    logger.info("linclust: pre-clustering (mode %d)", mode)
    with timed("precluster"):
        pre_clust = _cluster(db, prefilter_adjacency(db, rescore1), mode)
        rep_keys = sorted(pre_clust)
        rep_set = set(rep_keys)
        reps = seqdb.subdb(db, rep_keys)
        pref_filter2 = {k2: [h for h in pref.get(k2, []) if h[0] in rep_set]
                        for k2 in rep_keys}

    result_db = pref_filter2
    rescore2 = None
    if not is_nucl:
        # FILTER stage (linclust.sh step 3, AA only): SUBSTITUTION rescore
        # with the embedded precision calibration
        logger.info("linclust: ungapped alignment filter")
        with timed("filter"):
            spc = parse_precision_lib(p.cov_mode, p.seq_id_thr, p.cov_thr,
                                      0.99)
            rp2 = RescoreParams(rescore_mode=RESCORE_SUBSTITUTION,
                                seq_id_thr=p.seq_id_thr, cov_thr=p.cov_thr,
                                cov_mode=p.cov_mode, eval_thr=p.eval_thr,
                                filter_hits=True, score_per_col_thr=spc)
            rescore2 = rescore_diagonal(reps, result_db, rp2)
        result_db = rescore2

    logger.info("linclust: gapped align on %d representatives", len(rep_keys))
    with timed("align"):
        if is_nucl:
            aln = align_nucl(reps, result_db, seq_id_thr=p.seq_id_thr,
                             cov_thr=p.cov_thr, cov_mode=p.cov_mode,
                             eval_thr=p.eval_thr, gapo=p.gap_open,
                             gape=p.gap_extend, zdrop=p.zdrop,
                             wrapped_scoring=p.wrapped_scoring)
        else:
            aln = align_protein(reps, result_db, seq_id_thr=p.seq_id_thr,
                                cov_thr=p.cov_thr, cov_mode=p.cov_mode,
                                eval_thr=p.eval_thr, gap_open=p.gap_open,
                                gap_extend=p.gap_extend,
                                comp_bias_corr=p.comp_bias_corr,
                                device=pick_device(device), counts=counts)

    logger.info("linclust: clustering (mode %d)", mode)
    with timed("cluster"):
        clust = _cluster(reps, alignment_adjacency(reps, aln), mode)
        merged = merge_clusters(db, [pre_clust, clust])
    if intermediates is not None:
        intermediates.update(pref=pref, pref_rescore1=rescore1,
                             pre_clust=pre_clust, reps=reps,
                             pref_filter2=pref_filter2, rescore2=rescore2,
                             aln=aln, clust=clust)
    logger.info("linclust: %d clusters", len(merged))
    return merged


def run_linclust_nucl(db, params=None, intermediates=None, seconds=None,
                      device="cuda", counts=None):
    return run_linclust(db, params, intermediates, seconds, device, counts)
