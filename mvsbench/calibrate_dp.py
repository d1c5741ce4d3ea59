"""The readings that the limits of a data-parallel training cell are set
from, on its cards (``calibrate.py`` drives one process; this drives the
``train_dp`` driver's ranks).

    python3 -m mvsbench.calibrate_dp --workload dtu-train.dp4 --seeds 3 --controls 2 [--faults 1] [--seconds 2]

In one process: the program's numbers on ``--seeds`` seeds (each a short
run of the cell's driver, its window ``--seconds`` long, with no limits);
the control on ``--controls`` seeds: the plain reference on the global
batch in fp8 (e4m3 values, e5m2 gradients), judged against the fp32
reference as the runs are (both in a block a card,
``reference/blocks.py``); and, on ``--faults`` seeds each, two faults
planted in the ranks (:func:`local_bn`, :func:`one_rank_keeps_its_gradient`).
Prints one JSON line as ``calibrate.py`` does (each number's readings, the
lower, the upper and the limit; ``calibrate.summarize``), the faults
counted with the control, and writes it to ``--out``. ``replicas`` reads 0
on a sound run: its limit is 0 (the ranks apply one update to one state),
not a calibrated one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from mvsbench import program
from mvsbench.calibrate import SEED0, summarize
from mvsbench.harness import cache_env, load_cell, require_cards
from mvsbench.reference.compare import train_numbers
from mvsbench.reference.model import Rounding
from mvsbench.weights import seeded_state

FP8 = Rounding(torch.float8_e4m3fn)


def local_bn(rank: int) -> None:
    """A fault: every BN normalises with its rank's own slice's statistics
    (a ``StatsCollector`` without the process group), as a data-parallel
    step without SyncBN does."""
    from cds_mvsnet_tpu_torch.models import layers

    init = layers.StatsCollector.__init__

    def local(self, group=None):
        init(self, None)

    layers.StatsCollector.__init__ = local


class _KeepsItsGradient:
    """``torch.distributed`` as ``training/train_step.py`` sees it, but the
    gradients' all-reduce leaves this rank's own: the collective still runs
    (on a copy), so the other ranks are not left waiting."""

    def __getattr__(self, name):
        return getattr(torch.distributed, name)

    def all_reduce(self, tensor, *args, **kwargs):
        if tensor.numel() > 2:  # the flat gradient; the two losses are summed as before
            return torch.distributed.all_reduce(tensor.clone(), *args, **kwargs)
        return torch.distributed.all_reduce(tensor, *args, **kwargs)


def one_rank_keeps_its_gradient(rank: int) -> None:
    """A fault: rank 1 steps on its own slice's gradient, not the sum over
    the ranks."""
    if rank == 1:
        from cds_mvsnet_tpu_torch.training import train_step

        train_step.dist = _KeepsItsGradient()


def rank_exits(rank: int) -> None:
    """Not a fault the check judges: rank 1 ends its process at its sixth
    step (the window's third), to show that a rank that dies ends the run
    (``drivers/train_dp.py``) rather than leaving the others waiting."""
    if rank == 1:
        import os

        from cds_mvsnet_tpu_torch.training.train_step import TrainStep

        call, calls = TrainStep.__call__, []

        def dying(self, *args, **kwargs):
            calls.append(None)
            if len(calls) > 5:
                os._exit(1)
            return call(self, *args, **kwargs)

        TrainStep.__call__ = dying


FAULTS = {"local_bn": local_bn, "one_rank_keeps_its_gradient": one_rank_keeps_its_gradient}


def control(cell, seed: int, devices: list) -> dict:
    """The fp8 reference's numbers on the global batches of ``seed``,
    judged against the fp32 reference, both in a block a card."""
    from mvsbench.drivers.train_dp import global_batches, reference_steps
    from mvsbench.reference.blocks import train_step_blocks

    cfg = cell.config
    t = cfg["train"]
    rcfg = dict(cfg["model"], temperature=t["temperature"], lr=t["lr"], weight_decay=t["weight_decay"],
                dlossw=t["dlossw"])
    gen = torch.Generator(devices[0]).manual_seed(seed)
    P0 = seeded_state(program.parameter_shapes(cfg), gen)
    batches = global_batches(cell, gen)[: cell.traffic["checked_steps"]]
    R, losses, P1 = P0, [], None
    for b in batches:
        R, loss, _ = train_step_blocks(R, b, rcfg, FP8, devices)
        losses.append(loss)
        P1 = R if P1 is None else P1
    reference = reference_steps(P0, batches, cfg, Rounding(torch.float32), devices)
    return train_numbers(P0, P1, R, losses, batches, cfg, reference=reference)[0]


def main(argv=None) -> int:
    from mvsbench.drivers import train_dp

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--controls", type=int, default=2)
    p.add_argument("--faults", type=int, default=1)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first", type=int, default=0, help="offset of the first seed")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cache_env()
    cell = load_cell(args.workload)
    require_cards(cell.chips)
    cell.limits = {}
    devices = [torch.device("cuda", r) for r in range(cell.traffic["ranks"])]
    sound = []
    for i in range(args.seeds):
        seed = SEED0 + args.first + i
        res = train_dp.run(cell, seed, args.seconds, False, device="cuda")
        sound.append({k: c["value"] for k, c in res["check"].items()})
        print(json.dumps({"seed": seed, "program": sound[-1], "metrics": res["metrics"],
                          "check_s": res["extra"]["check_s"]}), file=sys.stderr, flush=True)
    cseeds = [SEED0 + 500 + args.first + i for i in range(args.controls)]
    controls = []
    for seed in cseeds:
        controls.append(control(cell, seed, devices))
        print(json.dumps({"control": controls[-1]}), file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    faults = {}
    for name, plant in FAULTS.items():
        for i in range(args.faults):
            res = train_dp.run(cell, SEED0 + 600 + args.first + i, args.seconds, False, device="cuda", plant=plant)
            faults.setdefault(name, []).append({k: c["value"] for k, c in res["check"].items()})
            print(json.dumps({"fault": name, "numbers": faults[name][-1]}), file=sys.stderr, flush=True)
    table = summarize([{k: v for k, v in s.items() if k != "replicas"} for s in sound], controls, [])
    table["replicas"] = {"sound": [s["replicas"] for s in sound], "limit": 0.0}
    line = json.dumps({"workload": args.workload, "seeds": [SEED0 + args.first + i for i in range(args.seeds)],
                       "control_seeds": cseeds, "numbers": table, "faults": faults})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
