"""A short traced sub-window and its reduction to what the per-layer
metrics read.

``torch.profiler`` traces the host and the card (CUPTI). The trace is
written as Chrome JSON under ``TMPDIR``, read back and deleted. Device time
is attributed to a span through the launch correlation: a kernel belongs to
the innermost ``record_function`` range (the benchmark's spans, the
autograd engine's) that holds, on the launching thread, the host call that
launched it (``cudaLaunchKernel`` and kin).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["Summary", "profile", "summarize"]

WINDOW = "mvsbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Summary:
    """What a traced sub-window holds: ``window_s`` its length, ``busy_s``
    the union of device activity in it, device seconds by kernel name
    (``kernels``: name -> (seconds, launches)), by span (``spans``: span
    name -> device seconds of the kernels it launched; a kernel counts for
    every span that holds its launch), the ``units`` of work it ran (maps or
    steps), the longest idle ``gaps`` by what the host was doing, and the
    port's launch counters over it (``counters``)."""

    window_s: float
    busy_s: float
    kernels: dict
    spans: dict
    units: int
    gaps: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    launches: int = 0

    def kernel_seconds(self, *needles) -> float:
        return sum(s for name, (s, _) in self.kernels.items() if any(n in name for n in needles))

    def kernel_launches(self, *needles) -> int:
        return sum(n for name, (_, n) in self.kernels.items() if any(x in name for x in needles))


def _union(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def summarize(events: list, units: int, counters: dict | None = None) -> Summary | None:
    """Reduce Chrome trace events (``ts``/``dur`` in microseconds) to a
    :class:`Summary`; None without a ``mvsbench.window`` range."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not win:
        return None
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
              and e["ts"] + e.get("dur", 0) > w0 and e["ts"] < w1]
    clip = [(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)) for e in device]
    busy = _union(clip)
    kernels = defaultdict(lambda: [0.0, 0])
    for e in device:
        if e["cat"] == "kernel":
            k = kernels[e["name"]]
            k[0] += e.get("dur", 0) * 1e-6
            k[1] += 1
    # host ranges by thread: the benchmark's spans and the autograd engine's
    ranges = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("user_annotation", "cpu_op") and (
                e["name"].startswith("mvsbench.") or e["name"].startswith("autograd::engine::evaluate_function")):
            ranges[e.get("tid")].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    launch_at = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_at[e["args"]["correlation"]] = (e.get("tid"), e["ts"])
    spans = defaultdict(float)
    for e in device:
        if e["cat"] != "kernel":
            continue
        at = launch_at.get(e.get("args", {}).get("correlation"))
        if at is None:
            continue
        tid, ts = at
        names = {name for a, b, name in ranges.get(tid, ()) if a <= ts <= b}
        if any(n.startswith("autograd::engine::evaluate_function") for n in names):
            names = {n for n in names if not n.startswith("autograd::")} | {"autograd"}
        for name in names:
            spans[name] += e.get("dur", 0) * 1e-6
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, kernels={k: tuple(v) for k, v in kernels.items()},
                   spans=dict(spans), units=units, gaps=_gaps(events, clip, w0, w1),
                   counters=counters or {}, launches=sum(v[1] for v in kernels.values()))


def _gaps(events, busy, w0, w1, top: int = 10) -> list:
    """The longest idle stretches of the device, summed by the innermost
    host range (a span, an operator) on the main thread at the gap's
    middle: ``[[label, seconds], ...]``."""
    merged = []
    for a, b in sorted(busy):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps, t = [], w0
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    win_tid = next(e.get("tid") for e in events if e.get("name") == WINDOW)
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("tid") == win_tid and e.get("cat") in ("cpu_op", "user_annotation",
                                                                                      "cuda_runtime", "cuda_driver")
                  and e["name"] != WINDOW)
    starts = [h[0] for h in host]
    by = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        label, best = "host: outside any operator", None
        for h in host[: bisect.bisect_right(starts, mid)]:
            if h[1] >= mid and (best is None or h[1] - h[0] < best):
                label, best = h[2], h[1] - h[0]
        by[label] += (b - a) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def profile(run, units: int, counters_fn=None) -> Summary | None:
    """Trace ``run()`` (which ends in a synchronisation of the device) under
    ``torch.profiler`` inside one ``mvsbench.window`` range, and reduce it.
    ``counters_fn()`` reads the port's launch counters (before and after)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    before = counters_fn() if counters_fn else {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(WINDOW):
            run()
    after = counters_fn() if counters_fn else {}
    counters = {k: after[k] - before.get(k, 0) for k in after if after[k] - before.get(k, 0)}
    fd, path = tempfile.mkstemp(suffix=".json", prefix="mvsbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events, units, counters)
