"""The readings that the limits of ``correct`` are set from, on the card.

    python3 -m mvsbench.calibrate --workload <cell> --seeds 12 --controls 3 [--seconds 2] [--first 0] [--witness 3]

In one process: the program's numbers on ``--seeds`` seeds (each a short
run of the cell's own driver at the cell's sizes, its window ``--seconds``
long, with no limits), then the control's on ``--controls`` seeds: the
plain reference put in the program's place and computed in fp8 (e4m3
values; e5m2 gradients in training), the precision below the
configuration's bf16, judged by the same comparison (eval: against the
reference with bf16 storage, as the runs are; train: fp32). A training cell also
reads the program with half of each batch left out (the mean over the
rest); a step that returns its state unchanged reads 1 by the change's
measure and is not run. Prints one JSON line: each number's readings, the
lower (the largest sound reading), the upper (the smallest control or
fault reading at least three times the lower; ten times for a fault) and a
limit between them (``lower^0.4 upper^0.6``), and writes it to ``--out``.
With ``--witness n`` a training cell also reads, on n seeds, the
reference with bf16 storage and the program at fp32 against the fp32
reference (``train_witness``); with ``--seeds 0`` that is all it reads.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

from mvsbench import program
from mvsbench.harness import cache_env, load_cell, require_cards
from mvsbench.reference.compare import STAGES, MapRecord, eval_numbers, train_numbers
from mvsbench.reference.model import Rounding, eval_cascade, eval_features
from mvsbench.weights import seeded_state

FP8 = Rounding(torch.float8_e4m3fn)
FP32 = Rounding(torch.float32)
BF16 = Rounding(torch.bfloat16)
SEED0 = 2**31 + 1000


def control_record(P, cfg, imgs, proj, dv) -> MapRecord:
    """The fp8 reference's map in a :class:`MapRecord`, its FeatureNet
    blocks in the program's order."""
    V = imgs.shape[1]
    rec: dict = {}
    pairs = eval_features(P, imgs, proj, cfg["temperature"], cfg["model"], FP8, record=rec)
    order = [2 * v + kind for kind in (0, 1) for v in range(V - 1)]  # program image -> call index
    blocks = {name: [calls[i] for i in order] for name, calls in rec.items()}
    feats = [pairs[i // 2][i % 2] for i in order]
    whole: dict = {}
    out = eval_cascade(P, imgs, proj, dv, cfg["temperature"], cfg["model"], FP8, record=whole)
    refine = whole.get("refine")
    outputs = {s: {k: out[s][k] for k in ("depth", "photometric_confidence")} for s in STAGES}
    outputs["refined_depth"] = out["refined_depth"]
    if refine is not None:
        refine = dict(refine)
        refine["deconv"] = (refine["conv2"][1], refine["bn"][0])
        dvf = dv.float()
        interval = dvf[:, 1] - dvf[:, 0]
        x3, got = refine["out"]
        refine["out"] = (x3, got, out["stage3"]["depth"] / interval[:, None, None], dvf[:, 0] / interval,
                         dvf[:, -1] / interval)
    return MapRecord(imgs, proj, dv, blocks, feats, outputs, refine)


def eval_controls(cell, seeds, dev) -> list:
    from mvsbench.inputs.synthetic import plane_scenes

    cfg = cell.config
    out = []
    for seed in seeds:
        gen = torch.Generator(dev).manual_seed(seed)
        P = seeded_state(program.parameter_shapes(cfg), gen)
        sc = plane_scenes(cell.traffic["sample"], cfg["views"], cfg["height"], cfg["width"], cfg["numdepth"],
                          cfg["depth_min"], cfg["interval"], cfg["model"]["refine"], gen)
        nums = {}
        for m in range(cell.traffic["sample"]):
            rec = control_record(P, cfg, sc["imgs"][m : m + 1], {k: v[m : m + 1] for k, v in sc["proj_matrices"].items()},
                                 sc["depth_values"][m : m + 1])
            for k, v in eval_numbers(P, cfg, rec, BF16).items():
                nums[k] = (min if k == "feat_decided" else max)(nums.get(k, v), v)
            del rec
            torch.cuda.empty_cache()
        out.append(nums)
    return out


def _train_setup(cell, seed, dev):
    from mvsbench.inputs.synthetic import train_batches

    cfg = cell.config
    gen = torch.Generator(dev).manual_seed(seed)
    P0 = seeded_state(program.parameter_shapes(cfg), gen)
    batches = train_batches(cell.traffic["checked_steps"], cfg["batch_size"], cfg["views"], cfg["height"],
                            cfg["width"], cfg["numdepth"], cfg["depth_min"], cfg["interval"], cfg["model"]["refine"],
                            gen)
    return P0, batches


def train_controls(cell, seeds, dev) -> tuple[list, list]:
    """The fp8 reference's readings and the half-batch program's."""
    from mvsbench.reference.train import train_step

    cfg = cell.config
    t = cfg["train"]
    rcfg = dict(cfg["model"], temperature=t["temperature"], lr=t["lr"], weight_decay=t["weight_decay"],
                dlossw=t["dlossw"])
    controls, halves = [], []
    for seed in seeds:
        P0, batches = _train_setup(cell, seed, dev)
        ref = None
        # the control: the reference in fp8
        R, losses, P1 = P0, [], None
        for b in batches:
            R, loss, _ = train_step(R, b, rcfg, FP8)
            losses.append(loss)
            P1 = P1 if P1 is not None else R
        nums, ref = train_numbers(P0, P1, R, losses, batches, cfg, FP32)
        controls.append(nums)
        # the program with half of each batch left out
        model = program.build_model(cfg, P0, dev)
        step = program.train_step(model, cfg)
        half = cfg["batch_size"] // 2
        losses, P1 = [], None
        for b in batches:
            cut = {k: ({s: x[:half] for s, x in v.items()} if isinstance(v, dict) else v[:half]) for k, v in b.items()}
            losses.append(float(step(cut, t["temperature"], t["epoch"])["loss"]))
            P1 = P1 if P1 is not None else {k: v.detach().clone() for k, v in model.state_dict().items()}
        P3 = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del step, model
        torch.cuda.empty_cache()
        halves.append(train_numbers(P0, P1, P3, losses, batches, cfg, FP32, reference=ref)[0])
    return controls, halves


def train_witness(cell, seeds, dev) -> list:
    """Where the train numbers' gaps come from: per seed, the reference
    with bf16 storage (values and gradients, as ``Rounding`` holds them),
    the fp32 reference from a state whose every weight is scaled by
    1 + 1e-6 N(0, 1), and the program at fp32 (``compute_dtype`` fp32), each judged
    against the fp32 reference as the runs are, with the three leaves of
    the largest gradient and change gaps."""
    import copy

    from mvsbench.reference.compare import leaf_gaps
    from mvsbench.reference.train import train_step, trainable_keys

    cfg = cell.config
    t = cfg["train"]
    rcfg = dict(cfg["model"], temperature=t["temperature"], lr=t["lr"], weight_decay=t["weight_decay"],
                dlossw=t["dlossw"])
    cfg32 = copy.deepcopy(cfg)
    cfg32["train"]["compute_dtype"] = "fp32"

    def top(gaps):
        return sorted(((v, k) for k, v in gaps.items()), reverse=True)[:3]

    out = []
    for seed in seeds:
        P0, batches = _train_setup(cell, seed, dev)
        runs = {}
        R, losses, P1 = P0, [], None
        for b in batches:
            R, loss, _ = train_step(R, b, rcfg, BF16)
            losses.append(loss)
            P1 = P1 if P1 is not None else R
        runs["reference_bf16"] = (P1, R, losses)
        g = torch.Generator(dev).manual_seed(seed)
        keys = set(trainable_keys(P0))
        R = {k: v * (1 + 1e-6 * torch.randn(v.shape, generator=g, device=dev)) if k in keys else v for k, v in P0.items()}
        losses, P1 = [], None
        for b in batches:
            R, loss, _ = train_step(R, b, rcfg, FP32)
            losses.append(loss)
            P1 = P1 if P1 is not None else R
        runs["reference_fp32_perturbed"] = (P1, R, losses)
        model = program.build_model(cfg32, P0, dev)
        step = program.train_step(model, cfg32)
        losses, P1 = [], None
        for b in batches:
            losses.append(float(step(b, t["temperature"], t["epoch"])["loss"]))
            P1 = P1 if P1 is not None else {k: v.detach().clone() for k, v in model.state_dict().items()}
        runs["program_fp32"] = (P1, {k: v.detach().clone() for k, v in model.state_dict().items()}, losses)
        del step, model
        torch.cuda.empty_cache()
        ref = None
        row = {"seed": seed}
        for name, (P1, P3, losses) in runs.items():
            nums, ref = train_numbers(P0, P1, P3, losses, batches, cfg, FP32, reference=ref)
            grad, change = leaf_gaps(P0, P1, P3, ref, cfg)
            row[name] = {"numbers": nums, "grad_top": top(grad), "change_top": top(change)}
        out.append(row)
    return out


def summarize(sound: list, controls: list, faults: list) -> dict:
    out = {}
    for name in sound[0]:
        lower = max(s[name] for s in sound)
        ctl = [c[name] for c in controls]
        flt = [f[name] for f in faults]
        cands = [min(ctl)] if ctl and min(ctl) >= 3 * lower else []
        if flt and min(flt) >= 10 * lower:
            cands.append(min(flt))
        upper = min(cands) if cands else None
        limit = lower ** 0.4 * upper ** 0.6 if upper is not None and lower > 0 and math.isfinite(upper) else None
        out[name] = {"sound": [s[name] for s in sound], "control": ctl, "fault": flt, "lower": lower,
                     "upper": upper, "limit": limit}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first", type=int, default=0, help="offset of the first seed")
    p.add_argument("--witness", type=int, default=0, help="train: seeds of train_witness")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cache_env()
    cell = load_cell(args.workload)
    require_cards(cell.chips)
    cell.limits = {}
    dev = torch.device("cuda")
    driver = __import__(f"mvsbench.drivers.{cell.traffic['driver']}", fromlist=["run"])
    sound = []
    for i in range(args.seeds):
        seed = SEED0 + args.first + i
        res = driver.run(cell, seed, args.seconds, False, device="cuda")
        sound.append({k: c["value"] for k, c in res["check"].items()})
        print(json.dumps({"seed": seed, "program": sound[-1], "metrics": res["metrics"],
                          "check_s": res["extra"]["check_s"]}), file=sys.stderr, flush=True)
        del res
        torch.cuda.empty_cache()
    if args.witness:
        wseeds = [SEED0 + 700 + args.first + i for i in range(args.witness)]
        for row in train_witness(cell, wseeds, dev):
            print(json.dumps({"witness": row}), flush=True)
    if not sound:
        return 0
    cseeds = [SEED0 + 500 + args.first + i for i in range(args.controls)]
    if cell.traffic["driver"] == "eval":
        controls, faults = eval_controls(cell, cseeds, dev), []
    else:
        controls, faults = train_controls(cell, cseeds, dev)
    for c in controls:
        print(json.dumps({"control": c}), file=sys.stderr, flush=True)
    for f in faults:
        print(json.dumps({"half_batch": f}), file=sys.stderr, flush=True)
    table = summarize(sound, controls, faults)
    line = json.dumps({"workload": args.workload, "seeds": [SEED0 + args.first + i for i in range(args.seeds)],
                       "control_seeds": cseeds, "numbers": table})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
