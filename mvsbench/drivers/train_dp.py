"""Data-parallel training that goes on: ``ranks`` processes, one a card,
each stepping its slice of a global batch through the port's ``TrainStep``
under one process group.

Parameters (``mvsbench/traffic/<traffic>.json``): ``ranks`` (processes,
one a card: ``nccl`` on the cards, ``gloo`` on the CPU), ``pool``
distinct global batches made from the seed (the window cycles through
them), ``checked_steps`` (3: the first steps, which the reference
follows), ``trace_steps`` the steps of the traced sub-window (rank 0
traces; the other ranks step with it).

The global batch is ``ranks`` x the configuration's ``batch_size`` (weak
scaling, as an upstream run with that batch a GPU). The ranks are started
by the port's ``parallel/distributed.py::spawn`` with the checkout's root
on their import path; each builds the model from the seed, takes rank 0's
weights (``parallel.replicate``), cuts its slice of every batch
(``parallel.shard_batch``) into pinned host memory, and steps
``TrainStep(group=...)``: global BN statistics, the loss's means over the
global batch, one gradient all-reduce a step. Each rank on a card keeps one
intra-op thread, as ``torchrun`` sets ``OMP_NUM_THREADS=1``. The window's
end is rank 0's to decide, every ``DECIDE_EVERY`` steps, sent to the others
over a ``gloo`` group on the host, so that every rank runs the same steps
and the hosts meet once in that many steps, not in each.
``train_samples_per_s`` is every global sample stepped over rank 0's window
(whole steps, then a wait for the card).

A rank that fails ends the run: ``spawn`` stops the others within its poll
(``parallel.distributed.JOIN_POLL_S``), a rank left waiting in a collective
fails at the process group's ``COLLECTIVE_TIMEOUT_S``, and the whole run is
stopped after the window's seconds and ``SPAWN_GRACE_S``.

The check, after the ranks have ended, in this process: rank 0's first
three steps against the fp32 reference on the global batch, run in a block
a card with the whole batch's BN statistics (``reference/blocks.py``: the
step at 32 does not fit one card), judged as ``drivers/train.py`` judges
(loss, first gradient, the three steps' change and the BN statistics), and ``replicas``: the largest |difference| of any
rank's weights and BN statistics from rank 0's after any checked step (the
ranks apply one update to one state: 0).
"""

from __future__ import annotations

import datetime
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

from .. import program
from ..harness import BENCH_DIR, Cell, Clock
from ..inputs.synthetic import train_batches
from ..reference.compare import judge, train_numbers
from ..reference.model import Rounding
from ..weights import seeded_state

COLLECTIVE_TIMEOUT_S = 120
SPAWN_GRACE_S = 900
DECIDE_EVERY = 4  # window steps between two of rank 0's decisions (about 1.7 s of dtu-train.dp4)


def _to(batch, dev, non_blocking=True):
    if isinstance(batch, dict):
        return {k: _to(v, dev, non_blocking) for k, v in batch.items()}
    return batch.to(dev, non_blocking=non_blocking)


def _pin(batch):
    if isinstance(batch, dict):
        return {k: _pin(v) for k, v in batch.items()}
    return batch.cpu().pin_memory() if batch.is_cuda else batch.cpu().clone()


def _snapshot(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def global_batches(cell: Cell, gen: torch.Generator) -> list:
    """The pool of global batches, drawn from ``gen`` after the weights."""
    cfg, t = cell.config, cell.traffic
    return train_batches(t["pool"], cfg["batch_size"] * t["ranks"], cfg["views"], cfg["height"], cfg["width"],
                         cfg["numdepth"], cfg["depth_min"], cfg["interval"], cfg["model"]["refine"], gen)


def _rank(rank: int, world: int, cell: Cell, seed: int, seconds: float, trace: bool, out_dir: str, started: float,
          plant, device: str, init_method: str) -> None:
    import torch.distributed as dist

    from cds_mvsnet_tpu_torch.parallel import replicate, shard_batch

    cuda = torch.device(device).type == "cuda"
    torch.set_num_threads(1 if cuda else 2)
    if cuda:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    if plant is not None:
        plant(rank)
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout)
    try:
        group = dist.group.WORLD
        host = dist.new_group(backend="gloo", timeout=timeout)
        cfg, t = cell.config, cell.traffic
        tc = cfg["train"]
        gen = torch.Generator(dev).manual_seed(seed)
        state = seeded_state(program.parameter_shapes(cfg), gen)
        model = replicate(program.build_model(cfg, state, dev), group)
        step = program.train_step(model, cfg, group=group)
        pool = [_pin(shard_batch(b, group)) for b in global_batches(cell, gen)]
        T, epoch = tc["temperature"], tc["epoch"]

        def one(i):
            return step(_to(pool[i % len(pool)], dev), T, epoch)

        # set-up: the first steps, which the reference follows
        states = [_snapshot(model)]
        losses = []
        for i in range(t["checked_steps"]):
            losses.append(float(one(i)["loss"]))
            states.append(_snapshot(model))
        if cuda:
            torch.cuda.synchronize(dev)
        dist.barrier(group)
        setup_s = time.time() - started

        n = t["checked_steps"]
        summary = None
        window_losses = []
        flag = torch.zeros(1, dtype=torch.int32)
        t0 = time.perf_counter()
        if trace:
            def traced():
                for k in range(t["trace_steps"]):
                    window_losses.append(one(n + k)["loss"])
                if cuda:
                    torch.cuda.synchronize(dev)

            if rank == 0:
                from ..trace import profile

                summary = profile(traced, t["trace_steps"], program.launch_counts)
            else:
                traced()
            n += t["trace_steps"]
        steps = 0
        while True:
            if steps % DECIDE_EVERY == 0:
                flag[0] = int(time.perf_counter() - t0 < seconds) if rank == 0 else 0
                dist.broadcast(flag, 0, group=host)
                if not flag[0]:
                    break
            window_losses.append(one(n + steps)["loss"])
            steps += 1
        if cuda:
            torch.cuda.synchronize(dev)
        window = time.perf_counter() - t0
        steps += t["trace_steps"] if trace else 0
        out = {"states": states[1:]}
        if rank == 0:
            out.update(P0=states[0], losses=losses, setup_s=setup_s, window=window, steps=steps, summary=summary,
                       failed=sum(1 for x in window_losses if not math.isfinite(float(x))),
                       peak=torch.cuda.max_memory_allocated(dev) if cuda else 0,
                       launch_counts=program.launch_counts())
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
        dist.barrier(group)
    finally:
        dist.destroy_process_group()


def reference_steps(P0: dict, batches: list, cfg: dict, q: Rounding, devices: list) -> tuple:
    """The reference's steps on the global batches, each in blocks, one a
    device (``reference/blocks.py``): ``(state after the last, losses,
    first gradient)``, as ``train_numbers`` takes them."""
    from ..reference.blocks import train_step_blocks

    t = cfg["train"]
    rcfg = dict(cfg["model"], temperature=t["temperature"], lr=t["lr"], weight_decay=t["weight_decay"],
                dlossw=t["dlossw"])
    R, losses, first = P0, [], None
    for b in batches:
        R, loss, g = train_step_blocks(R, b, rcfg, q, devices)
        losses.append(loss)
        first = g if first is None else first
    return R, losses, first


def _largest_gap(a: dict, b: dict) -> float:
    gap = 0.0
    for k, v in a.items():
        if v.is_floating_point():
            d = (v.double() - b[k].double()).abs().max()
            gap = max(gap, float(d) if bool(torch.isfinite(d)) else math.inf)
    return gap


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda", plant=None) -> dict:
    """Run the cell's ranks and check rank 0's first steps. ``plant(rank)``
    (a module-level function, tests and calibration) runs first in each
    rank, to plant a fault."""
    from cds_mvsnet_tpu_torch.parallel.distributed import spawn

    dev = torch.device(device)
    world = cell.traffic["ranks"]
    root = str(BENCH_DIR.parent)
    if root not in os.environ.get("PYTHONPATH", "").split(os.pathsep):
        os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    if root not in sys.path:
        sys.path.insert(0, root)
    if dev.type == "cuda":
        from cds_mvsnet_tpu_torch.ops.kernels import _build

        _build.build_all()  # once here, not in every rank
    started = time.time() - Clock.since_start()
    with tempfile.TemporaryDirectory(prefix="mvsbench_dp_") as out_dir:
        spawn(_rank, world, (cell, seed, seconds, trace, out_dir, started, plant), device,
              timeout=seconds + SPAWN_GRACE_S)
        res = [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False) for r in range(world)]
    r0 = res[0]
    metrics = {"train_samples_per_s": {"value": r0["steps"] * cell.config["batch_size"] * world / r0["window"],
                                       "unit": "samples/s"},
               "setup_s": {"value": r0["setup_s"], "unit": "s"}}

    # the check: the reference on the global batch, in a block a card (reference/blocks.py)
    cdev = torch.device("cuda", 0) if dev.type == "cuda" else dev
    if cdev.type == "cuda":
        from cds_mvsnet_tpu_torch.models.cds_mvsnet import strict_fp32

        strict_fp32()  # as the one-card check runs: TF32 off
    t_check = time.perf_counter()
    gen = torch.Generator(cdev).manual_seed(seed)
    seeded_state(program.parameter_shapes(cell.config), gen)  # the ranks' draws, in order
    k = cell.traffic["checked_steps"]
    batches = [_to(b, cdev, False) for b in global_batches(cell, gen)[:k]]
    P0 = {key: v.to(cdev) for key, v in r0["P0"].items()}
    P1, P3 = ({key: v.to(cdev) for key, v in r0["states"][i].items()} for i in (0, k - 1))
    devices = [torch.device("cuda", r) for r in range(world)] if cdev.type == "cuda" else [cdev] * world
    reference = reference_steps(P0, batches, cell.config, Rounding(torch.float32), devices)
    nums, _ = train_numbers(P0, P1, P3, r0["losses"], batches, cell.config, reference=reference)
    nums["replicas"] = max(_largest_gap(r["states"][i], r0["states"][i]) for r in res[1:] for i in range(k))
    check_s = time.perf_counter() - t_check
    correct, check = judge(nums, cell.limits)
    return {"correct": correct and r0["failed"] == 0, "attempted": r0["steps"], "failed": r0["failed"],
            "metrics": metrics, "memory_peak_bytes": r0["peak"], "check": check, "summary": r0["summary"],
            "extra": {"window_s": r0["window"], "losses": r0["losses"], "check_s": check_s, "ranks": world,
                      "launch_counts": r0["launch_counts"]}}
