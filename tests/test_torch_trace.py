"""PyTorch port: the program's spans (utils/trace.span) on the profiler's
timeline. Under torch.profiler every sub-step of the k-mer matcher and of
the rescore appears by name inside its own call, the DB's rows are
uploaded twice a step (once per alphabet), and the hits and records are
the same as without a profiler; outside a profiler span() is the one
shared null context and enters no record_function. The sharded matcher's
spans, at world 1 (a process group of this process alone), likewise."""
import os

import numpy as np
import pytest
import torch

from plass_tpu_torch.data.createdb import merge_reads
from plass_tpu_torch.ops import backend, orf, translate
from plass_tpu_torch.ops.evalue import EvalueComputer
from plass_tpu_torch.ops.rescore import RescoreParams
from plass_tpu_torch.utils import trace

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
MATCHER_SPANS = ("kmermatch.budget", "kmermatch.table", "kmermatch.pairs",
                 "kmermatch.hits", "kmermatch.fetch", "kmermatch.self_hits")
RESCORE_SPANS = ("rescore.index", "rescore.self_rows", "rescore.launch",
                 "rescore.fetch", "rescore.finish", "rescore.group")
# the sharded matcher's (parallel/mesh.py, kmermatcher_sharded_torch)
SHARDED_SPANS = ("kmermatch.table", "kmermatch.exchange.table",
                 "kmermatch.pairs", "kmermatch.exchange.pairs",
                 "kmermatch.hits", "kmermatch.rank_rescore",
                 "kmermatch.exchange.gather", "kmermatch.order",
                 "kmermatch.self_hits")


def _proteins():
    reads, _ = merge_reads(READS)
    odb, ohdb = orf.extract_orfs(reads, min_length=20, max_length=32734,
                                 max_gaps=0, start_mode=0)
    return translate.translate_nucs(odb, ohdb, 1, add_orf_stop=True)


def _reads():
    return merge_reads(READS)[0]


# (DB, k, matcher keywords, rescore parameters, E-value matrix), as the
# assembly iterations of plass assemble and penguin nuclassemble run them
CASES = {
    "protein": (_proteins, 14,
                dict(kmers_per_sequence=60, hash_shift=68,
                     ignore_multi_kmer=True, include_only_extendable=True),
                dict(rescore_mode=3, seq_id_thr=0.9, eval_thr=1e-5),
                "blosum62_ungapped"),
    "nucleotide": (_reads, 22,
                   dict(kmers_per_sequence=60, kmers_per_sequence_scale=0.1,
                        hash_shift=67, ignore_multi_kmer=True),
                   dict(rescore_mode=3, seq_id_thr=0.99, eval_thr=1e-5),
                   "nucleotide_ungapped"),
}


def _step(db, case, matcher="single"):
    """The assembly iteration's device step on the CPU, each call inside a
    span of its layer's name; the hits and flat records on the host."""
    _, k, kw, rp, matrix = case
    ev = EvalueComputer.for_matrix(matrix, db.total_residues())
    with trace.span("kmermatch"):
        hits = backend.match_kmers(db, k, torch.device("cpu"), matcher,
                                   **kw)
    with trace.span("rescore"):
        recs = backend.rescore_diagonal_torch(db, hits, RescoreParams(**rp),
                                              ev, return_flat=True)
    return hits, recs


def _traced(case, matcher="single"):
    """(plain hits and records, traced hits and records, the profiler's
    events as (name, start, end)) of one case."""
    db = case[0]()
    plain = _step(db, case, matcher)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = _step(db, case, matcher)
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()]
    return plain, out, events


@pytest.fixture(scope="module", params=list(CASES))
def traced(request):
    return _traced(CASES[request.param])


@pytest.fixture(scope="module")
def one_rank():
    """A process group of this process alone, the sharded matcher's world
    1 (as `--backend sharded` without a coordinator); left as found."""
    import torch.distributed as dist
    from plass_tpu_torch.parallel import distributed

    made = not dist.is_initialized()
    distributed.maybe_initialize(torch.device("cpu"), one_rank=True)
    yield
    if made and dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=list(CASES))
def sharded_traced(request, one_rank):
    return _traced(CASES[request.param], "sharded")


def _spans(events, name):
    return [(t0, t1) for nm, t0, t1 in events if nm == name]


@pytest.mark.parametrize("layer,names", [("kmermatch", MATCHER_SPANS),
                                         ("rescore", RESCORE_SPANS)])
def test_spans_lie_inside_their_layer(traced, layer, names):
    _, _, events = traced
    (outer,) = _spans(events, layer)
    for name in names:
        spans = _spans(events, name)
        assert spans, name
        for t0, t1 in spans:
            assert outer[0] <= t0 <= t1 <= outer[1], name


def test_rows_uploaded_once_per_alphabet(traced):
    _, _, events = traced
    uploads = _spans(events, "upload.rows")
    assert len(uploads) == 2
    (matcher,) = _spans(events, "kmermatch")
    (launch,) = _spans(events, "rescore.launch")
    for (t0, t1), (a, b) in zip(sorted(uploads), (matcher, launch)):
        assert a <= t0 <= t1 <= b


def test_outputs_equal_with_and_without_profiler(traced):
    (hits, recs), (t_hits, t_recs), _ = traced
    for a, b in zip(hits, t_hits):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(hits.hit_slots, t_hits.hit_slots)
    assert len(recs["rec"]) > 0
    for key in ("qk", "rec"):
        np.testing.assert_array_equal(recs[key], t_recs[key])


def test_span_is_null_outside_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    ctx = trace.span("rescore.finish")
    assert ctx is trace.NULL
    with ctx:
        pass


def test_sharded_spans_lie_inside_the_matcher(sharded_traced):
    (hits, recs), (t_hits, t_recs), events = sharded_traced
    (outer,) = _spans(events, "kmermatch")
    for name in SHARDED_SPANS:
        spans = _spans(events, name)
        assert len(spans) == 1, name
        for t0, t1 in spans:
            assert outer[0] <= t0 <= t1 <= outer[1], name
    for name in RESCORE_SPANS + ("rescore.pre",):
        assert _spans(events, name), name
    for a, b in zip(hits, t_hits):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(hits.pre, t_hits.pre):
        np.testing.assert_array_equal(a, b)
    for key in ("qk", "rec"):
        np.testing.assert_array_equal(recs[key], t_recs[key])


def test_sharded_path_records_nothing_outside_a_profiler(one_rank,
                                                         monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    case = CASES["protein"]
    hits, recs = _step(case[0](), case, "sharded")
    assert hits.pre is not None and len(recs["rec"]) > 0
