"""PyTorch port: cascaded `cluster` (workflow/cluster.py: linclust, then
per step the sensitive prefilter, the amino-acid aligner with kernel B9 as
its plain version on the CPU, and the clustering) against the JAX
package's on the same seeded protein families, byte for byte: at
--min-seq-id 0.9 -c 0.9 (one step at -s 1.0) and at the defaults (three
steps up to -s 6.0), in set-cover (0) and greedy (2) cluster mode."""
import pytest

from plass_tpu.workflow import cluster as ref_cluster
from plass_tpu_torch.workflow import cluster as port_cluster

from test_torch_prefilter import family_dbs

# (label, ClusterParams keywords, families)
CASES = [("min-seq-id 0.9 -c 0.9", dict(seq_id_thr=0.9, cov_thr=0.9), 12),
         ("defaults", {}, 8)]


def _files(path):
    return [open(path + ext, "rb").read() for ext in ("", ".index",
                                                      ".dbtype")]


@pytest.mark.parametrize("cluster_mode", [0, 2])
@pytest.mark.parametrize("label,kw,n_fam", CASES, ids=[c[0] for c in CASES])
def test_run_cluster_equals_jax_package(tmp_path, label, kw, n_fam,
                                        cluster_mode):
    ref_db, port_db = family_dbs(n_fam)
    want_path, got_path = str(tmp_path / "ref_clu"), str(tmp_path / "clu")
    want = ref_cluster.run_cluster(
        ref_db, want_path, str(tmp_path / "ref_tmp"),
        ref_cluster.ClusterParams(cluster_mode=cluster_mode, **kw))
    seconds, counts = {}, {}
    got = port_cluster.run_cluster(
        port_db, got_path, str(tmp_path / "tmp"),
        port_cluster.ClusterParams(cluster_mode=cluster_mode, **kw),
        device="cpu", seconds=seconds, counts=counts)
    assert got == want
    assert _files(got_path) == _files(want_path)
    assert 1 < len(got) < port_db.size
    steps = port_cluster.ClusterParams(**kw).resolve().cluster_steps
    assert steps == (1 if kw else 3)
    assert set(seconds) == {"linclust", "merge"} | {
        f"{stage}_{i}" for stage in ("prefilter", "align", "clust")
        for i in range(steps)}
    assert counts["candidate_pairs"] > 0
