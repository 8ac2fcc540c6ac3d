"""PyTorch port: `linclust` of an amino-acid DB (the SUBSTITUTION filter
and the amino-acid aligner, kernel B9 as its plain version on the CPU)
against the JAX package on CPU jax, stage by stage, and `plass linclust`
/ `penguin linclust` through both packages' CLIs, byte for byte."""
import os

import numpy as np
import pytest

from plass_tpu.cli import app as ref_app
from plass_tpu.cli import penguin as ref_penguin
from plass_tpu.cli import plass as ref_plass
from plass_tpu.workflow import linclust as ref_linclust
from plass_tpu_torch.cli import penguin as port_penguin
from plass_tpu_torch.cli import plass as port_plass
from plass_tpu_torch.data.seqdb import SeqDB as PortSeqDB
from plass_tpu_torch.workflow import linclust as port_linclust

from test_torch_guided import _contig_db
from test_torch_kmer import _synthetic_db

# `plass linclust`'s defaults for an amino-acid DB (plass_tpu/cli/plass.py
# _linclust): auto k, 21 k-mers a sequence, --min-seq-id 0.9, -c 0.8
PLASS_LINCLUST = dict(kmer_size=0, kmers_per_sequence=21,
                      kmers_per_sequence_scale=0.0, seq_id_thr=0.9,
                      cov_thr=0.8, cov_mode=0, eval_thr=0.001, gap_open=11,
                      gap_extend=1, ignore_multi_kmer=False,
                      wrapped_scoring=False, max_seq_len=65535)


def _port(db):
    return PortSeqDB(db.data, db.keys, db.offsets, db.lengths, db.dbtype)


@pytest.mark.parametrize("seq_id", [0.9, 0.95])
def test_linclust_aa_equals_jax_package(seq_id):
    db = _synthetic_db()
    kw = dict(PLASS_LINCLUST, seq_id_thr=seq_id)
    r_mid, p_mid, secs = {}, {}, {}
    want = ref_linclust.run_linclust(db, ref_linclust.LinclustParams(**kw),
                                     r_mid)
    got = port_linclust.run_linclust(
        _port(db), port_linclust.LinclustParams(**kw), p_mid, secs,
        device="cpu")
    assert got == want
    assert 1 < len(got) < db.size
    assert set(p_mid) == set(r_mid)
    for name in ("pref", "pre_clust", "pref_filter2", "aln", "clust"):
        assert p_mid[name] == r_mid[name], name
    for name in ("pref_rescore1", "rescore2"):
        assert p_mid[name].keys() == r_mid[name].keys(), name
        for key, recs in r_mid[name].items():
            np.testing.assert_array_equal(p_mid[name][key], recs)
    assert sum(len(v) for v in p_mid["aln"].values()) > len(p_mid["aln"])
    assert set(secs) == {"kmermatch", "rescore", "precluster", "filter",
                         "align", "cluster"}


def _db_files(prefix):
    return [open(prefix + ext, "rb").read() for ext in ("", ".index",
                                                        ".dbtype")]


@pytest.mark.parametrize("flags", [[], ["--min-seq-id", "0.95", "-c", "0.5"]])
def test_plass_linclust_cli_equals_jax_cli(tmp_path, flags):
    db = _synthetic_db()
    path = str(tmp_path / "seqdb")
    db.save(path)
    want = str(tmp_path / "ref_clu")
    assert ref_app.run_app("plass", ref_plass.commands(),
                           ["linclust", path, want, str(tmp_path / "rt"),
                            *flags]) == 0
    got = str(tmp_path / "port_clu")
    stats = {}
    assert port_plass.run(["linclust", path, got, str(tmp_path / "pt"),
                           *flags, "--device", "cpu"], stats=stats) == 0
    assert _db_files(got) == _db_files(want)
    assert stats["sequences"] == db.size and 1 < stats["clusters"] < db.size
    assert "align" in stats["seconds"]


def test_penguin_linclust_cli_equals_jax_cli(tmp_path):
    db = _contig_db()
    path = str(tmp_path / "nucldb")
    db.save(path)
    want = str(tmp_path / "ref_clu")
    assert ref_app.run_app("penguin", ref_penguin.commands(),
                           ["linclust", path, want, str(tmp_path / "rt")]) == 0
    got = str(tmp_path / "port_clu")
    assert port_penguin.run(["linclust", path, got, str(tmp_path / "pt"),
                             "--device", "cpu"]) == 0
    assert _db_files(got) == _db_files(want)
    assert os.path.getsize(got + ".index") > 0
