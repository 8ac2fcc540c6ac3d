"""The readers of the program's own spans (perfbench/metrics/_spans.py and
the five metrics on it), on a hand-made trace.Record: spans inside the
window are summed by name over its steps, spans outside it, other
categories and the benchmark's own spans are not, and each reader returns
None where the run recorded none of its spans."""
import pytest

from perfbench import trace
from perfbench.metrics import (db_uploads, kmermatch_host_ms,
                               rescore_finish_ms, rescore_host_ms,
                               rescore_self_rows_ms)

READERS = (rescore_self_rows_ms, rescore_finish_ms, rescore_host_ms,
           kmermatch_host_ms, db_uploads)


def _record():
    """Two steps in a window from 1,000 to 1,001,000 microseconds."""
    rec = trace.Record(steps=2, spans={"kmermatch": [], "rescore": []})
    rec.window = (1_000.0, 1_001_000.0)
    ua = "user_annotation"
    rec.host = [
        (ua, "window", 1_000, 1_001_000),
        # before the window: the warm-up step
        (ua, "rescore.self_rows", 0, 900),
        (ua, "upload.rows", 100, 200),
        (ua, "kmermatch.self_hits", 300, 400),
    ]
    for base in (2_000, 502_000):
        rec.host += [
            (ua, "kmermatch", base, base + 100_000),
            (ua, "upload.rows", base + 1_000, base + 3_000),
            (ua, "kmermatch.budget", base + 3_000, base + 4_000),
            (ua, "kmermatch.table", base + 4_000, base + 50_000),
            (ua, "kmermatch.fetch", base + 50_000, base + 60_000),
            (ua, "kmermatch.self_hits", base + 60_000, base + 90_000),
            (ua, "rescore", base + 100_000, base + 400_000),
            (ua, "rescore.index", base + 100_000, base + 120_000),
            (ua, "rescore.self_rows", base + 120_000, base + 220_000),
            (ua, "rescore.launch", base + 220_000, base + 250_000),
            (ua, "upload.rows", base + 221_000, base + 223_000),
            (ua, "rescore.fetch", base + 250_000, base + 300_000),
            (ua, "rescore.finish", base + 300_000, base + 380_000),
            (ua, "rescore.group", base + 380_000, base + 390_000),
            # an operator under a span is not a span
            ("cpu_op", "rescore.finish", base + 300_000, base + 380_000),
        ]
    return rec


@pytest.mark.parametrize("reader,want", [
    (rescore_self_rows_ms, 100.0),
    (rescore_finish_ms, 80.0),
    # index 20 + self rows 100 + launch 30 + finish 80 + group 10
    (rescore_host_ms, 240.0),
    # budget 1 + self hits 30
    (kmermatch_host_ms, 31.0),
    (db_uploads, 2.0),
])
def test_reader_sums_its_spans_in_the_window(reader, want):
    assert reader.read(_record()) == pytest.approx(want)


@pytest.mark.parametrize("reader", READERS)
def test_reader_returns_none_without_its_spans(reader):
    rec = _record()
    # the parent's program: the benchmark's spans alone
    rec.host = [e for e in rec.host if "." not in e[1]]
    assert reader.read(rec) is None
    # no profile at all
    assert reader.read(trace.Record(steps=1, spans={})) is None


def test_spans_outside_the_window_are_left_out():
    rec = _record()
    rec.window = (1_000.0, 502_000.0)
    rec.steps = 1
    assert rescore_self_rows_ms.read(rec) == pytest.approx(100.0)
    assert db_uploads.read(rec) == 2.0
