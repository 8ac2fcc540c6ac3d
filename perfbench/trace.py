"""The traced run's record: the benchmark's spans around each layer, spies
on the port's two kernel entry points, and the device timeline of
`torch.profiler`.

Spies (installed for the traced window only):
  K1  `plass_tpu_torch.ops.device_kmer.seg_scan`: each call's elements
      and columns, and CUDA events around it
  K2  `plass_tpu_torch.ops.backend.rescore_e2e`: each launch's hits,
      window residues, DB bytes and sequences, strand flag and alphabet
      (the residues are summed on the device right after the launch),
      and CUDA events around it
The profiler's chrome trace gives every kernel, copy and memset on the
device with its start and length, the host spans ("window", and the
layers inside it) and the host's operators, on one clock.
"""
import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

K1_KERNEL = "scan_lookback"
K2_KERNEL = "rescore_e2e_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Launch:
    """A spied launch: its counts and its CUDA events."""
    counts: dict
    events: tuple = None

    def seconds(self):
        start, end = self.events
        return start.elapsed_time(end) / 1e3


@dataclass
class Record:
    """What the per-layer readers read."""
    steps: int
    spans: dict
    k1: list = field(default_factory=list)
    k2: list = field(default_factory=list)
    device: list = field(default_factory=list)     # (cat, name, t0, t1, args)
    host: list = field(default_factory=list)       # (cat, name, t0, t1)
    window: tuple = None                           # (t0, t1), microseconds


def install_spies(rec):
    """Wraps the K1 and K2 entry points; returns the function that puts
    them back."""
    import torch
    from plass_tpu_torch.ops import backend, device_kmer

    scan, e2e = device_kmer.seg_scan, backend.rescore_e2e

    def timed(fn):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fn()
        ev[1].record()
        return out, ev

    def scan_spy(kind, flag, *vals, reverse=False):
        out, ev = timed(lambda: scan(kind, flag, *vals, reverse=reverse))
        if flag.numel():
            rec.k1.append(Launch({"n": flag.numel(), "ncols": len(vals)}, ev))
        return out

    def e2e_spy(rows, offsets, lengths, code_lut, qrow, trow, diag, sub,
                qrev=None, **kw):
        out, ev = timed(lambda: e2e(rows, offsets, lengths, code_lut, qrow,
                                    trow, diag, sub, qrev=qrev, **kw))
        if qrow.numel():
            ql, tl = lengths[qrow.long()].long(), lengths[trow.long()].long()
            dist = diag.long().abs()
            fwd = diag >= 0
            ov = torch.where(fwd, torch.minimum(tl, ql - dist),
                             torch.minimum(tl - dist, ql)).clamp(min=0)
            rec.k2.append(Launch({
                "hits": qrow.numel(), "window_residues": int(ov.sum()),
                "rows_bytes": rows.numel(), "n_seqs": offsets.numel(),
                "reverse": qrev is not None, "alpha": sub.shape[0]}, ev))
        return out

    device_kmer.seg_scan = scan_spy
    backend.rescore_e2e = e2e_spy

    def remove():
        device_kmer.seg_scan = scan
        backend.rescore_e2e = e2e

    return remove


def read_profile(prof, rec):
    """Fills rec.device, rec.host and rec.window from the profiler's chrome
    trace (written to a temporary file and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, t0 = e.get("cat", ""), float(e["ts"])
        t1 = t0 + float(e["dur"])
        if cat in DEVICE_CATS:
            rec.device.append((cat, e.get("name", ""), t0, t1,
                               e.get("args", {})))
        elif cat in ("user_annotation", "cpu_op"):
            rec.host.append((cat, e.get("name", ""), t0, t1))
            if cat == "user_annotation" and e.get("name") == "window":
                rec.window = (t0, t1)


def busy_intervals(rec):
    """The union of the device's intervals inside the window, merged and
    sorted (microseconds)."""
    w0, w1 = rec.window
    iv = sorted((max(t0, w0), min(t1, w1)) for _, _, t0, t1, _ in rec.device
                if t1 > w0 and t0 < w1)
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(rec):
    return sum(b - a for a, b in busy_intervals(rec)) / 1e6


def window_seconds(rec):
    return (rec.window[1] - rec.window[0]) / 1e6


def kernel_seconds(rec, name):
    """(launches, seconds) of the kernels whose name holds `name` inside
    the window, each with the memset that its launch queued just before
    it on the stream (the scratch reset of K1 and K2)."""
    w0, w1 = rec.window
    by_stream = {}
    for ev in rec.device:
        if w0 <= ev[2] < w1:
            by_stream.setdefault(ev[4].get("stream"), []).append(ev)
    launches, sec = 0, 0.0
    for evs in by_stream.values():
        evs.sort(key=lambda e: e[2])
        for i, (cat, nm, t0, t1, _) in enumerate(evs):
            if cat != "kernel" or name not in nm:
                continue
            sec += (t1 - t0) / 1e6
            prev = evs[i - 1] if i else None
            if prev is None or prev[0] != "kernel" or name not in prev[1]:
                launches += 1
                if prev is not None and prev[0] == "gpu_memset":
                    sec += (prev[3] - prev[2]) / 1e6
    return launches, sec


def _innermost(spans, starts, t, reach=64):
    """Name of the latest-starting span of `spans` (sorted by start; their
    starts in `starts`) that holds time t; spans nest, so it is among the
    last few that start before t."""
    i = bisect.bisect_right(starts, t)
    for nm, t0, t1 in reversed(spans[max(i - reach, 0):i]):
        if t < t1:
            return nm
    return None


def breakdown(rec, top=10):
    """The device operations that took most time and the idle time by
    what the host was doing (its innermost layer span and operator),
    each [name, seconds], longest first."""
    w0, w1 = rec.window
    ops = {}
    for _, nm, t0, t1, _ in rec.device:
        if t1 > w0 and t0 < w1:
            ops[nm] = ops.get(nm, 0.0) + (min(t1, w1) - max(t0, w0)) / 1e6
    gaps = {}
    edge = w0
    layers = sorted(((nm, t0, t1) for c, nm, t0, t1 in rec.host
                     if c == "user_annotation" and nm != "window"),
                    key=lambda x: x[1])
    ops_ = sorted(((nm, t0, t1) for c, nm, t0, t1 in rec.host
                   if c == "cpu_op"), key=lambda x: x[1])
    l_starts = [x[1] for x in layers]
    o_starts = [x[1] for x in ops_]
    for a, b in busy_intervals(rec) + [[w1, w1]]:
        if a > edge:
            mid = (edge + a) / 2
            layer = _innermost(layers, l_starts, mid) or "between"
            op = _innermost(ops_, o_starts, mid) or "host"
            key = f"{layer}:{op}"
            gaps[key] = gaps.get(key, 0.0) + (a - edge) / 1e6
        edge = max(edge, b)

    def best(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": best(ops), "idle_gaps": best(gaps)}
