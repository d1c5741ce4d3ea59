"""Training that goes on: the train step stepping from its own state.

Parameters (``mvsbench/traffic/<traffic>.json``): ``pool`` distinct
batches made from the seed (the window cycles through them),
``checked_steps`` (3: the first steps, which the reference follows),
``trace_steps`` the steps of the traced sub-window. One card; data
parallelism is not driven yet (PERF.md, Open questions).

Set-up builds one ``TrainStep`` and drives it through its first steps, on
batches that all differ, through the window's own call and feed; the
window then continues from that state. Each step's batch is copied to the
card from pinned host memory, as the port's loader does. The window runs
whole steps until its seconds are up and then waits for the card:
``train_samples_per_s`` is every sample stepped over that time.
"""

from __future__ import annotations

import math
import time

import torch

from .. import program
from ..harness import Cell, Clock
from ..inputs.synthetic import train_batches
from ..reference.compare import judge, train_numbers
from ..reference.model import Rounding
from ..weights import seeded_state


def _to(batch, dev, non_blocking=True):
    if isinstance(batch, dict):
        return {k: _to(v, dev, non_blocking) for k, v in batch.items()}
    return batch.to(dev, non_blocking=non_blocking)


def _pin(batch):
    if isinstance(batch, dict):
        return {k: _pin(v) for k, v in batch.items()}
    return batch.cpu().pin_memory() if batch.is_cuda else batch.cpu()


def _snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    dev = torch.device(device)
    cfg, t = cell.config, cell.traffic
    tc = cfg["train"]
    B = cfg["batch_size"]
    gen = torch.Generator(dev).manual_seed(seed)
    state = seeded_state(program.parameter_shapes(cfg), gen)
    model = program.build_model(cfg, state, dev)
    step = program.train_step(model, cfg)
    pool = [_pin(b) for b in train_batches(t["pool"], B, cfg["views"], cfg["height"], cfg["width"], cfg["numdepth"],
                                            cfg["depth_min"], cfg["interval"], cfg["model"]["refine"], gen)]
    T, epoch = tc["temperature"], tc["epoch"]

    def one(i):
        return step(_to(pool[i % len(pool)], dev), T, epoch)

    # set-up: the first steps, which the reference follows
    P0 = _snapshot(model)
    losses, P1 = [], None
    for i in range(t["checked_steps"]):
        losses.append(float(one(i)["loss"]))
        if i == 0:
            P1 = _snapshot(model)
    P3 = _snapshot(model)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = Clock.since_start()

    n = t["checked_steps"]
    summary = None
    window_losses = []
    t0 = time.perf_counter()
    if trace:
        from ..trace import profile

        def traced():
            for k in range(t["trace_steps"]):
                window_losses.append(one(n + k)["loss"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        summary = profile(traced, t["trace_steps"], program.launch_counts)
        n += t["trace_steps"]
    steps = 0
    while time.perf_counter() - t0 < seconds:
        window_losses.append(one(n + steps)["loss"])
        steps += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window = time.perf_counter() - t0
    steps += t["trace_steps"] if trace else 0
    failed = sum(1 for x in window_losses if not math.isfinite(float(x)))
    metrics = {"train_samples_per_s": {"value": steps * B / window, "unit": "samples/s"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del step, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    batches = [_to(pool[i], dev, False) for i in range(t["checked_steps"])]
    nums, _ = train_numbers(P0, P1, P3, losses, batches, cfg, Rounding(torch.float32))
    check_s = time.perf_counter() - t_check
    correct, check = judge(nums, cell.limits)
    return {"correct": correct and failed == 0, "attempted": steps, "failed": failed, "metrics": metrics,
            "memory_peak_bytes": peak, "check": check, "summary": summary,
            "extra": {"window_s": window, "losses": losses, "check_s": check_s,
                      "launch_counts": program.launch_counts()}}
