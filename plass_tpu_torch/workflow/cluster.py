"""`cluster` workflow: cascaded protein clustering.

Reference: lib/mmseqs/src/workflow/Cluster.cpp driving
lib/mmseqs/data/workflow/cascaded_clustering.sh — linclust redundancy
pre-clustering, then `clusterSteps` rounds of prefilter -> align -> clust
at increasing sensitivity on the shrinking representative set, merged
with mergeclusters. Defaults (Cluster.cpp:14-20): -c 0.8, -e 0.001,
alignment mode SCORE_COV_SEQID, --max-seqs 20; sensitivity and step count
derived from --min-seq-id (setAutomaticThreshold/Iterations,
Cluster.cpp:22-40); --min-seq-id >= 0.7 disables composition bias and
sets --min-ungapped-score 60 (setClusterAutomagicParameters,
Cluster.cpp:63-80). Step 0 runs the prefilter without diagonal scoring
(Cluster.cpp:196-199).

The prefilter, the clustering and linclust's matcher run on the host
whatever the device, as in the JAX package; each aligner call scores its
candidate pairs on `device` first (kernel B9, see ops/protein_align.py).
"""
import numpy as np

from ..data import seqdb
from ..utils.device import pick_device, stage_timer
from ..utils.log import logger
from . import engine

CLUST_LINEAR_DEFAULT_ALPH_SIZE = 13  # Parameters.h:241
CLUST_LINEAR_DEFAULT_K = 0


def automatic_threshold(seq_id):
    """setAutomaticThreshold (Cluster.cpp:22-32)."""
    if seq_id <= 0.3:
        return 6.0
    if seq_id > 0.8:
        return 1.0
    return float(np.float32(1.0) + np.float32(0.7 - seq_id) * 10)


def automatic_iterations(sens):
    """setAutomaticIterations (Cluster.cpp:34-40)."""
    return 1 if sens <= 2.0 else 3


class ClusterParams:
    def __init__(self, seq_id_thr=0.0, cov_thr=0.8, cov_mode=0,
                 eval_thr=1e-3, sensitivity=None, cluster_steps=None,
                 cluster_mode=0, max_seqs=20, comp_bias_corr=None,
                 min_ungapped_score=None, kmers_per_sequence=21,
                 single_step=False, mask=1, remove_tmp=False):
        self.seq_id_thr = seq_id_thr
        self.cov_thr = cov_thr
        self.cov_mode = cov_mode
        self.eval_thr = eval_thr
        self.sensitivity = sensitivity
        self.cluster_steps = cluster_steps
        self.cluster_mode = cluster_mode
        self.max_seqs = max_seqs
        self.comp_bias_corr = comp_bias_corr
        self.min_ungapped_score = min_ungapped_score
        self.kmers_per_sequence = kmers_per_sequence
        self.single_step = single_step
        self.mask = mask
        self.remove_tmp = remove_tmp

    def resolve(self):
        """Cluster.cpp:63-104 automagic parameter derivation."""
        if self.comp_bias_corr is None:
            self.comp_bias_corr = not (self.seq_id_thr >= 0.7)
        if self.min_ungapped_score is None:
            self.min_ungapped_score = 60 if self.seq_id_thr >= 0.7 else 15
        if self.sensitivity is None:
            self.sensitivity = automatic_threshold(self.seq_id_thr)
        if self.cluster_steps is None:
            self.cluster_steps = automatic_iterations(self.sensitivity)
        return self


def run_cluster(db, out_path, tmp_base, params=None, device="cuda",
                seconds=None, counts=None):
    """Cascaded clustering; writes the cluster DB (rep key -> member
    keys, one per line) to out_path and returns {rep: [members]}.

    device: where the aligner scores its candidate pairs ("cuda",
    "cuda:<i>" or "cpu"), in linclust and in every step; it is not part of
    the tmp dir's fingerprint. seconds: an optional dict that receives the
    wall seconds of the stages run here (linclust, prefilter_<i>,
    align_<i>, clust_<i>, merge); counts: one that receives the aligner's
    pair counts summed over its calls (see align_protein)."""
    from ..assembler.cluster import (alignment_adjacency, clusters_to_db,
                                     db_to_clusters,
                                     greedy_incremental_cluster,
                                     merge_clusters, merged_clusters_to_db,
                                     set_cover_cluster)
    from ..ops import prefilter as pf
    from ..ops.protein_align import align_protein
    from .linclust import LinclustParams, run_linclust

    p = (params or ClusterParams()).resolve()
    device = pick_device(device)
    timed = stage_timer(device, {} if seconds is None else seconds)
    if isinstance(db, str):
        db = seqdb.SeqDB.open(db)
    if db.dbtype != seqdb.AMINO_ACIDS:
        raise ValueError("cluster: only protein DBs supported (use "
                         "linclust for nucleotides)")
    tmp = engine.create_tmp_dir(tmp_base, engine.fingerprint(vars(p)))
    wf = engine.Workflow(tmp, remove_tmp=p.remove_tmp)
    logger.info("cluster: sens=%.2f steps=%d", p.sensitivity,
                p.cluster_steps)

    # linclust redundancy reduction (cascaded_clustering.sh:38-41) with
    # alphabet 13 / auto-k and masking off (Cluster.cpp:184-190)
    lp = LinclustParams(kmer_size=CLUST_LINEAR_DEFAULT_K,
                        alphabet_size=CLUST_LINEAR_DEFAULT_ALPH_SIZE,
                        kmers_per_sequence=p.kmers_per_sequence,
                        kmers_per_sequence_scale=0.0,
                        seq_id_thr=p.seq_id_thr, cov_thr=p.cov_thr,
                        cov_mode=p.cov_mode, eval_thr=p.eval_thr,
                        gap_open=11, gap_extend=1, max_seq_len=65535,
                        wrapped_scoring=False, cluster_mode=-1,
                        comp_bias_corr=p.comp_bias_corr)
    steps_dicts = []

    def _linclust():
        with timed("linclust"):
            clu = run_linclust(db, lp, device=device, counts=counts)
            return {"clu_redundancy": merged_clusters_to_db(clu)}
    clu_red = wf.step("clu_redundancy", _linclust,
                      outputs=("clu_redundancy",))["clu_redundancy"]
    steps_dicts.append(db_to_clusters(clu_red))

    current = seqdb.subdb(db, [int(k) for k in clu_red.keys])
    sens_sched = _sens_schedule(p)
    for step, sens in enumerate(sens_sched):
        last = step == len(sens_sched) - 1
        diag_score = not (len(sens_sched) > 1 and step == 0)
        cbc = p.comp_bias_corr and diag_score

        def _step(current=current, sens=sens, diag_score=diag_score,
                  cbc=cbc, step=step):
            pr = pf.PrefilterParams(
                sensitivity=sens, max_seqs=p.max_seqs,
                min_ungapped_score=(p.min_ungapped_score if diag_score
                                    else 0),
                comp_bias_corr=cbc, mask=p.mask, diag_score=diag_score)
            with timed(f"prefilter_{step}"):
                hits = pf.prefilter(current, current, pr, same_db=True)
            with timed(f"align_{step}"):
                res = align_protein(
                    current, hits, seq_id_thr=p.seq_id_thr,
                    cov_thr=p.cov_thr, cov_mode=p.cov_mode,
                    eval_thr=p.eval_thr, gap_open=11, gap_extend=1,
                    alignment_mode=3, comp_bias_corr=p.comp_bias_corr,
                    device=device, counts=counts)
            with timed(f"clust_{step}"):
                if p.cluster_mode == 0:
                    clu = set_cover_cluster(
                        current, alignment_adjacency(current, res))
                else:
                    clu = greedy_incremental_cluster(
                        current, {q: [r["dbKey"] for r in rs]
                                  for q, rs in res.items()})
                return {f"clu_step{step}": clusters_to_db(clu)}
        clu_db = wf.step(f"clu_step{step}", _step,
                         outputs=(f"clu_step{step}",))[f"clu_step{step}"]
        clu = db_to_clusters(clu_db)
        steps_dicts.append(clu)
        if not last:
            current = seqdb.subdb(current, sorted(clu.keys()))

    with timed("merge"):
        merged = merge_clusters(db, steps_dicts)
        merged_clusters_to_db(merged).save(out_path)
    if p.remove_tmp:
        wf.cleanup()
    return merged


def _sens_schedule(p):
    """Cluster.cpp:195-215: step 0 at sensitivity 1 (or the target when
    single-step), then evenly spaced up to the target."""
    if p.cluster_steps <= 1:
        return [p.sensitivity]
    out = [1.0]
    step_size = (p.sensitivity - 1.0) / float(p.cluster_steps - 1)
    for step in range(1, p.cluster_steps):
        out.append(1.0 + step_size * step)
    return out


