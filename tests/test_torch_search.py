"""PyTorch port: `search` (workflow/search.py: the sensitive prefilter,
then the amino-acid aligner with kernel B9 as its plain version on the
CPU) against the JAX package's on the same seeded protein families, byte
for byte: one and two sensitivity steps, with and without backtraces,
and the 2bLCA aligner of --lca-search; the aligner with B9's scores in
front equal to it without them on search's pairs, which include pairs B9
rejects; a card run and a CPU run share the tmp dir's prefilter step."""
import os

import pytest

from plass_tpu.data import seqdb as ref_seqdb
from plass_tpu.ops import prefilter as ref_pf
from plass_tpu.ops import protein_align as ref_pa
from plass_tpu.workflow import search as ref_search
from plass_tpu_torch.data import seqdb as port_seqdb
from plass_tpu_torch.ops import prefilter as port_pf
from plass_tpu_torch.ops import protein_align as port_pa
from plass_tpu_torch.workflow import search as port_search

from test_torch_prefilter import family_dbs, query_subset


@pytest.fixture(scope="module")
def fams():
    ref_db, port_db = family_dbs(12)
    return ((query_subset(ref_db, 3, ref_seqdb), ref_db),
            (query_subset(port_db, 3, port_seqdb), port_db))


def _files(path):
    return [open(path + ext, "rb").read() for ext in ("", ".index",
                                                      ".dbtype")]


def _run_both(fams, tmp_path, **kw):
    """Both packages' run_search on the families; returns (the port's
    alignment DB path, the JAX package's, the port's stage seconds and pair
    counts)."""
    (rq, rt), (pq, pt) = fams
    want = str(tmp_path / "ref_aln")
    ref_search.run_search(rq, rt, want, str(tmp_path / "ref_tmp"),
                          ref_search.SearchParams(**kw))
    got = str(tmp_path / "port_aln")
    seconds, counts = {}, {}
    port_search.run_search(pq, pt, got, str(tmp_path / "port_tmp"),
                           port_search.SearchParams(**kw), device="cpu",
                           seconds=seconds, counts=counts)
    return got, want, seconds, counts


@pytest.mark.parametrize("add_backtrace,sens_steps",
                         [(False, 1), (True, 1), (False, 2), (True, 2)])
def test_run_search_equals_jax_package(fams, tmp_path, add_backtrace,
                                       sens_steps):
    got, want, seconds, counts = _run_both(
        fams, tmp_path, add_backtrace=add_backtrace, sens_steps=sens_steps)
    assert _files(got) == _files(want)
    body = open(got, "rb").read()
    assert body.count(b"\n") > 2 * fams[1][0].size
    assert (b"M" in body) == add_backtrace
    assert set(seconds) == {"prefilter", "align", "merge"}
    assert counts["candidate_pairs"] > body.count(b"\n") // sens_steps // 2
    # on the CPU B9 scores nothing unless asked to
    assert counts["device_pairs"] == counts["device_rejected"] == 0


def test_lca_search_equals_jax_package(fams, tmp_path):
    got, want, _, _ = _run_both(fams, tmp_path, lca_search=True)
    assert _files(got) == _files(want)
    assert open(got, "rb").read().count(b"\n") >= fams[1][0].size


def test_device_scores_in_front_change_nothing(fams):
    """align_protein with B9's scores first (its plain version on the CPU)
    equals it without them and the JAX package's aligner, on the pairs of
    a sensitive search, and rejects pairs on the score alone."""
    (rq, rt), (pq, pt) = fams
    hits = port_pf.prefilter(pq, pt, port_pf.PrefilterParams(
        sensitivity=7.5))
    assert hits == ref_pf.prefilter(rq, rt, ref_pf.PrefilterParams(
        sensitivity=7.5))
    kw = dict(tdb=pt, alignment_mode=2)
    counts = {}
    with_b9 = port_pa.align_protein(pq, hits, device="cpu",
                                    device_prefilter=True, counts=counts,
                                    **kw)
    without = port_pa.align_protein(pq, hits, device="cpu", **kw)
    assert with_b9 == without == ref_pa.align_protein(rq, hits, tdb=rt,
                                                      alignment_mode=2)
    assert counts["device_pairs"] == counts["candidate_pairs"] == len(
        port_pa.candidate_pairs(hits, False, False))
    assert 0 < counts["device_rejected"] < counts["device_pairs"]


def test_card_and_cpu_runs_share_the_prefilter_step(fams, tmp_path):
    """The device is not part of the tmp dir's fingerprint: a second run
    on another device reuses the prefilter step and redoes only what is
    not done."""
    (_, _), (pq, pt) = fams
    tmp = str(tmp_path / "tmp")
    out = str(tmp_path / "aln")
    port_search.run_search(pq, pt, out, tmp, device="cpu")
    first = _files(out)
    os.unlink(os.path.join(tmp, "latest", "aln_0.done"))
    seconds = {}
    port_search.run_search(pq, pt, str(tmp_path / "aln2"), tmp,
                           device="cpu", seconds=seconds)
    assert _files(str(tmp_path / "aln2")) == first
    assert set(seconds) == {"align", "merge"}
