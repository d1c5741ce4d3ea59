"""Depth maps on request: the offline and the interactive traffic.

Parameters (``mvsbench/traffic/<traffic>.json``): ``batch`` maps a forward
(``test_cli --batch_size``), ``in_flight`` batches dispatched ahead (2:
the next batch is enqueued before the oldest's results are waited for, as
``save_depths`` runs one view ahead; 1: a closed loop, issue, wait for the
result on the host, issue the next), ``pool`` distinct scenes made from the
seed (the window cycles through them), ``sample`` maps compared with the
reference, each from another of the window's first ``check_batches``
batches, drawn from the seed, the k-th from batch slot k mod ``batch`` (so
every slot, once ``sample`` reaches ``batch``), ``trace_batches`` the
batches of the traced sub-window.

Each batch's images and cameras are copied from pinned host memory; each
map's depth and confidence of every stage and its refined depth are copied
back into pinned host memory; a map is done when they are on the host.
``maps_per_s`` is every map done over the window's seconds (the window
ends when the last map issued in it is done); ``map_p95_ms`` the 95th
percentile of each request's time from its issue to its results on the
host.
"""

from __future__ import annotations

import random
import time

import torch

from .. import program
from ..harness import Cell, Clock, p95
from ..inputs.synthetic import plane_scenes
from ..reference.compare import MapRecord, eval_numbers, judge
from ..reference.model import Rounding
from ..weights import seeded_state

STAGES = ("stage1", "stage2", "stage3")


class Stream:
    """The pool on the host, the in-flight batches and their results."""

    def __init__(self, cell: Cell, model, pool: dict, dev, capture):
        self.cell, self.model, self.pool, self.dev, self.capture = cell, model, pool, dev, capture
        t = cell.traffic
        self.B, self.in_flight = t["batch"], t["in_flight"]
        self.n_pool = pool["imgs"].shape[0]
        self.issued = 0
        self.pending = []
        self.latencies, self.done = [], 0
        self.keep_batches: set = set()
        self.kept: dict = {}  # batch index -> (rows, host outputs, capture)
        shapes = self._out_shapes()
        self.host = [{k: torch.empty(s, dtype=torch.float32, pin_memory=dev.type == "cuda") for k, s in shapes.items()}
                     for _ in range(self.in_flight)]

    def _out_shapes(self) -> dict:
        cfg = self.cell.config
        H, W = cfg["height"], cfg["width"]
        h, w = (H // 2, W // 2) if cfg["model"]["refine"] else (H, W)
        out = {}
        for i, s in enumerate((4, 2, 1)):
            out[f"{STAGES[i]}.depth"] = (self.B, h // s, w // s)
            out[f"{STAGES[i]}.photometric_confidence"] = (self.B, h // s, w // s)
        out["refined_depth"] = (self.B, H, W)
        return out

    def rows(self, i: int) -> list:
        return [(i * self.B + j) % self.n_pool for j in range(self.B)]

    def issue(self) -> None:
        i = self.issued
        rows = self.rows(i)
        t_issue = time.perf_counter()
        lo = rows[0]
        contiguous = rows == list(range(lo, lo + self.B))
        take = (lambda t: t[lo : lo + self.B]) if contiguous else (lambda t: t[rows])
        imgs = take(self.pool["imgs"]).to(self.dev, non_blocking=True)
        proj = {k: take(v).to(self.dev, non_blocking=True) for k, v in self.pool["proj_matrices"].items()}
        dv = take(self.pool["depth_values"]).to(self.dev, non_blocking=True)
        if self.capture is not None:
            self.capture.active = i in self.keep_batches
        with torch.profiler.record_function("mvsbench.forward"):
            out = self.model(imgs, proj, dv, temperature=self.cell.config["temperature"],
                             compute_dtype=torch.bfloat16, kernels=True)
        host = self.host[i % self.in_flight]
        for k, buf in host.items():
            src = out["refined_depth"] if k == "refined_depth" else out[k.split(".")[0]][k.split(".")[1]]
            buf.copy_(src, non_blocking=True)
        ev = torch.cuda.Event() if self.dev.type == "cuda" else None
        if ev is not None:
            ev.record()
        cap = None
        if self.capture is not None and self.capture.active:
            cap = self.capture.calls.pop()
            self.capture.active = False
        self.pending.append((i, ev, t_issue, rows, cap))
        self.issued += 1

    def complete(self) -> None:
        i, ev, t_issue, rows, cap = self.pending.pop(0)
        if ev is not None:
            ev.synchronize()
        self.latencies.append(time.perf_counter() - t_issue)
        self.done += len(rows)
        if i in self.keep_batches:
            host = self.host[i % self.in_flight]
            self.kept[i] = (rows, {k: v.clone() for k, v in host.items()}, cap)

    def step(self) -> None:
        """Issue one batch; then wait for the oldest once ``in_flight`` are
        out."""
        self.issue()
        if len(self.pending) >= self.in_flight:
            self.complete()

    def drain(self) -> None:
        while self.pending:
            self.complete()


def _pool(cfg: dict, n: int, gen) -> dict:
    """``n`` scenes made on the device, then held in pinned host memory."""
    sc = plane_scenes(n, cfg["views"], cfg["height"], cfg["width"], cfg["numdepth"], cfg["depth_min"],
                      cfg["interval"], cfg["model"]["refine"], gen)
    pin = (lambda t: t.cpu().pin_memory()) if gen.device.type == "cuda" else (lambda t: t.cpu())
    return {"imgs": pin(sc["imgs"]), "proj_matrices": {k: pin(v) for k, v in sc["proj_matrices"].items()},
            "depth_values": pin(sc["depth_values"])}


def _records(stream: Stream, sample: list, dev) -> list:
    """A :class:`MapRecord` per sampled map ``(batch, j)``."""
    V = stream.cell.config["views"]
    B = stream.B
    recs = []
    for i, j in sample:
        rows, host, cap = stream.kept[i]
        r = rows[j]
        idx = [(k * (V - 1) + v) * B + j for k in (0, 1) for v in range(V - 1)]
        blocks = {name: [(x[n : n + 1], None if e is None else e[n : n + 1],
                          tuple(t[n : n + 1] for t in o) if isinstance(o, tuple) else o[n : n + 1])
                         for n in idx] for name, (x, e, o) in cap["blocks"].items()}
        feats = [{s: tuple(t[n : n + 1] for t in cap["features"][s]) for s in STAGES} for n in idx]
        outputs = {s: {q: host[f"{s}.{q}"][j : j + 1].to(dev) for q in ("depth", "photometric_confidence")}
                   for s in STAGES}
        outputs["refined_depth"] = host["refined_depth"][j : j + 1].to(dev)
        refine = None
        if "refine" in cap:
            rf = {k: (a[0][j : j + 1], o[j : j + 1]) for k, (a, o) in cap["refine"].items() if k != "out"}
            rf["deconv"] = (rf["conv2"][1], rf["bn"][0])
            args, out = cap["refine"]["out"]
            rf["out"] = (rf["conv3"][1], out[j : j + 1], args[1][j : j + 1], args[2][j : j + 1], args[3][j : j + 1])
            refine = rf
        recs.append(MapRecord(stream.pool["imgs"][r : r + 1].to(dev),
                              {k: v[r : r + 1].to(dev) for k, v in stream.pool["proj_matrices"].items()},
                              stream.pool["depth_values"][r : r + 1].to(dev), blocks, feats, outputs, refine))
    return recs


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    dev = torch.device(device)
    t = cell.traffic
    cfg = cell.config
    gen = torch.Generator(dev).manual_seed(seed)
    state = seeded_state(program.parameter_shapes(cfg), gen)
    model = program.build_model(cfg, state, dev)
    pool = _pool(cfg, t["pool"], gen)
    capture = program.Capture(model)
    stream = Stream(cell, model, pool, dev, capture)

    # set-up: every shape of the cell, twice round the in-flight ring; then
    # as many batches kept as the check can keep, and let go, so that the
    # allocator holds their memory before the window
    for _ in range(2 * t["in_flight"]):
        stream.step()
    stream.keep_batches = set(range(stream.issued, stream.issued + t["sample"]))
    for _ in range(t["sample"]):
        stream.step()
    stream.drain()
    stream.kept, stream.keep_batches = {}, set()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = Clock.since_start()

    # the sample, drawn from the seed among the first batches of the window:
    # one map a batch, the k-th from batch slot k mod B, so that every slot
    # is compared once the sample holds B maps
    first = stream.issued
    rng = random.Random(seed)
    drawn = rng.sample(range(first, first + t["check_batches"]), t["sample"])
    sample = sorted((i, k % stream.B) for k, i in enumerate(drawn))
    stream.keep_batches = {i for i, _ in sample}
    stream.latencies, stream.done = [], 0

    summary = None
    t0 = time.perf_counter()
    if trace:
        from ..trace import profile

        handles = program.span_hooks(model)

        def traced():
            for _ in range(t["trace_batches"]):
                stream.step()
            stream.drain()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        summary = profile(traced, t["trace_batches"] * stream.B, program.launch_counts)
        for h in handles:
            h.remove()
    while time.perf_counter() - t0 < seconds or stream.issued < first + t["check_batches"]:
        stream.step()
    stream.drain()
    window = time.perf_counter() - t0
    attempted = stream.done
    metrics = {"maps_per_s": {"value": attempted / window, "unit": "maps/s"},
               "map_p95_ms": {"value": p95(stream.latencies) * 1e3, "unit": "ms"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the check, after the window, with the program's state freed
    for h in capture.handles:
        h.remove()
    records = _records(stream, sample, dev)
    del model, capture
    stream.model = None
    stream.kept = {}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    nums = {}
    for rec in records:
        for k, v in eval_numbers(state, cfg, rec, Rounding(torch.bfloat16)).items():
            nums[k] = (min if k == "feat_decided" else max)(nums.get(k, v), v)
    correct, check = judge(nums, cell.limits)
    check_s = time.perf_counter() - t_check
    return {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
            "memory_peak_bytes": peak, "check": check, "summary": summary,
            "extra": {"window_s": window, "requests": len(stream.latencies), "check_s": check_s,
                      "launch_counts": program.launch_counts()}}
