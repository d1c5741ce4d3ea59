"""The comparison that decides ``correct``: the numbers compared, worked
out from what the timed path produced and from the plain reference.

The eval check takes the reference at the configuration's precision
(activations held in bf16, the arithmetic in fp32; ``Rounding``): against
an fp32 reference, a channel whose mean is large beside its spread loses
its spread to bf16's rounding before the InstanceNorm, and a seed in
twenty read 10x the rest. The train check takes it in fp32.

Eval (a map of the window, ``MapRecord``): at random weights the
FeatureNet's branch softmax at temperature 0.01 turns rounding into other
branches at some pixels, and a near-uniform cost distribution turns that
into other depths: end to end, bf16 and fp8 read alike. So the check
follows the program step by step from its own state, and checks each step
by itself, and then the stages chained from the program's features on: every FeatureNet block on the input the program gave it, the
heads' outputs from the program's head convs, each stage on the program's
features and its previous stage's depth, the refinement on the program's
stage-3 depth. Numbers (each the largest over the sampled maps):

- ``feat_med``: per FeatureNet block (and per head), the median
  |program - reference| of each output over the reference's RMS, taken at
  the median over the map's images; the largest over the blocks. A
  dynamic conv is compared at the pixels whose branch is decided (its
  reference branch logits' top two at least ``DECIDED`` apart over the
  temperature): where they are nearly tied, as over a whole stretch of
  weak curvature, one rounding flips the branch, and one image's block
  read ten times the rest; an image's block counts where at least
  ``MIN_DECIDED`` of its pixels are decided. ``feat_decided`` (reported)
  is the smallest share of decided pixels over the blocks and images;
- ``feat_p99``: the same at the 99th percentile of each output;
- ``depth_p99.s<i>``: stage i's 99th-percentile |depth gap| in planes of
  the configuration's base interval;
- ``conf_p99``: the largest over the stages of the 99th-percentile |gap|
  of the photometric confidence;
- the chain, from the program's features on: stage 1 on them, each later
  stage on the reference's own previous depth, the refinement on its own
  stage-3 depth, so that what is handed from stage to stage is checked
  too. ``chain_med.s<i>``, ``chain_p99.s<i>`` (stages 2 and 3): the median
  and 99th-percentile |depth gap| in planes; ``chain_conf_p99`` the
  confidence's, as ``conf_p99``; ``chain_refined_med``,
  ``chain_refined_p99`` the refined depth's, in planes;
- ``refine_med``, ``refine_p99``: per refinement piece on the program's
  input (each ConvBnReLU, the transposed conv, its BN), the median and the
  99th-percentile gap over the reference's RMS; and the last conv with the
  upsampled depth, its gap over the RMS of the reference's residual; the
  largest over the pieces. (End to end from stage 3's depth, the refined
  depth read 0.007-0.068 of the residual in sound runs and 0.071 in a
  control run: no limit fits.)

Train (the first three steps of the window's own train step): each step's
loss, the first gradient (from the parameters' change after one SGD step)
and the change after three steps, leaf by leaf: the gap between the
program's norm and the reference's over the larger of the reference's
norm and the median leaf's; and the BN running statistics after three
steps. Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the change.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass

import torch

from .model import (FEATURE_BLOCKS, Rounding, eval_chain, eval_feature_block, eval_feature_heads, eval_refine_block, eval_stage,
                    stage_hypotheses)
from .train import train_step, trainable_keys

__all__ = ["MapRecord", "eval_numbers", "judge", "leaf_gaps", "train_numbers"]

STAGES = ("stage1", "stage2", "stage3")
# a dynamic conv's pixel is compared where its reference branch logits'
# top two lie this far apart over the temperature: a branch that bf16's
# rounding cannot flip (it moves a logit by about 1e-3, 0.1 over T = 0.01)
DECIDED = 2.0
# and an image's block counts where at least this share of its pixels is
# decided: a median over a few hundred pixels swings from seed to seed
MIN_DECIDED = 0.05
HEAD_CURVATURES = {"stage1": ("conv20", "conv21", "out1"), "stage2": ("conv10", "conv11", "out2"),
                   "stage3": ("conv00", "conv01", "out3")}


@dataclass
class MapRecord:
    """One map as the timed path made it. ``imgs (1,V,H,W,3)``, ``proj``,
    ``depth_values (1,D)``: its inputs. ``blocks[name]``: per FeatureNet
    image of the map, in the program's order (the reference image once for
    each source view, then each source view: 2(V-1) images), ``(input,
    epipole or None, output)``; ``features``: per call,
    ``{stage: (feat, nc_sum, |nc|)}``; ``outputs``: per stage ``depth`` and
    ``photometric_confidence`` ``(1,h,w)``, and ``refined_depth``;
    ``refine``: each refinement piece's ``(input, output)`` (``conv0`` ..
    ``conv3``, ``deconv`` from conv2's output to the BN's input, ``bn``),
    and ``out``: ``(conv3's output, the refined depth in plane intervals,
    stage 3's depth, the range's ends, in plane intervals)``."""

    imgs: torch.Tensor
    proj: dict
    depth_values: torch.Tensor
    blocks: dict
    features: list
    outputs: dict
    refine: dict | None = None


def _quantile(x: torch.Tensor, q: float) -> float:
    x = x.flatten().float()
    if not bool(torch.isfinite(x).all()):
        return math.inf
    k = max(1, min(x.numel(), int(math.ceil(q * x.numel()))))
    return float(torch.kthvalue(x, k).values)


def _rel(got, want, q):
    want = want.float()
    rms = float(want.pow(2).mean().sqrt())
    return _quantile((got.float() - want).abs(), q) / max(rms, 1e-30)


def _outs(o):
    return o if isinstance(o, tuple) else (o,)


def eval_numbers(P: dict, cfg: dict, rec: MapRecord, q: Rounding = Rounding(torch.bfloat16)) -> dict:
    """The eval numbers of one map (module note)."""
    T = cfg["temperature"]
    per = {}  # (block, output) -> [(median, p99) per image]
    decided = 1.0
    for name in FEATURE_BLOCKS:
        for x, e, out in rec.blocks[name]:
            want, margin = eval_feature_block(P, name, x, e, T, q)
            keep = None if margin is None else margin >= DECIDED
            if keep is not None:
                decided = min(decided, float(keep.float().mean()))
                if int(keep.sum()) < MIN_DECIDED * keep.numel():
                    continue
            for k, (g, w) in enumerate(zip(_outs(out), _outs(want))):
                if keep is not None:
                    m = keep if g.ndim == 3 else keep[:, None].expand(g.shape)
                    g, w = g.float()[m], w.float()[m]
                per.setdefault((name, k), []).append((_rel(g, w, 0.5), _rel(g, w, 0.99)))
    for i, feats in enumerate(rec.features):
        heads = tuple(rec.blocks[f"out{k}"][i][2][0] for k in (1, 2, 3))
        curv = {s: tuple(_outs(rec.blocks[n][i][2])[1] for n in HEAD_CURVATURES[s]) for s in STAGES}
        want = eval_feature_heads(heads, curv, q)
        for s in STAGES:
            for k, (g, w) in enumerate(zip(feats[s], want[s])):
                per.setdefault((f"head.{s}", k), []).append((_rel(g, w, 0.5), _rel(g, w, 0.99)))
    nums = {"feat_med": max(statistics.median(m for m, _ in v) for v in per.values() if v),
            "feat_p99": max(statistics.median(p for _, p in v) for v in per.values() if v),
            "feat_decided": decided}

    V = rec.imgs.shape[1]
    H, W = rec.imgs.shape[2:4]
    work = (H // 2, W // 2) if cfg["model"]["refine"] else (H, W)
    interval = cfg["interval"]
    prev, conf = None, 0.0
    for s, name in enumerate(STAGES):
        hyp = stage_hypotheses(rec.depth_values, prev, s, cfg["model"], work)
        pairs = [tuple(tuple(t.float() for t in rec.features[k * (V - 1) + v][name]) for k in (0, 1))
                 for v in range(V - 1)]
        want = eval_stage(P, s, pairs, rec.proj[name], hyp, q)
        got = rec.outputs[name]
        nums[f"depth_p99.s{s + 1}"] = _quantile((got["depth"].float() - want["depth"]).abs() / interval, 0.99)
        conf = max(conf, _quantile((got["photometric_confidence"].float() - want["photometric_confidence"]).abs(),
                                   0.99))
        prev = got["depth"].float()
    nums["conf_p99"] = conf
    # the chain: from the program's features on, on the reference's own depths
    pairs = [tuple({s: tuple(t.float() for t in rec.features[k * (V - 1) + v][s]) for s in STAGES} for k in (0, 1))
             for v in range(V - 1)]
    chain = eval_chain(P, pairs, rec.imgs, rec.proj, rec.depth_values, cfg["model"], q)
    conf = 0.0
    for s, name in enumerate(STAGES[1:], 2):
        gap = (rec.outputs[name]["depth"].float() - chain[name]["depth"]).abs() / interval
        nums[f"chain_med.s{s}"], nums[f"chain_p99.s{s}"] = _quantile(gap, 0.5), _quantile(gap, 0.99)
        conf = max(conf, _quantile((rec.outputs[name]["photometric_confidence"].float()
                                    - chain[name]["photometric_confidence"]).abs(), 0.99))
    nums["chain_conf_p99"] = conf
    gap = (rec.outputs["refined_depth"].float() - chain["refined_depth"]).abs() / interval
    nums["chain_refined_med"], nums["chain_refined_p99"] = _quantile(gap, 0.5), _quantile(gap, 0.99)
    if rec.refine is not None:
        med = p99 = 0.0
        for name, piece in rec.refine.items():
            if name != "out":
                want = eval_refine_block(P, name, piece[0], q)
                med, p99 = max(med, _rel(piece[1], want, 0.5)), max(p99, _rel(piece[1], want, 0.99))
        x3, got, depth, dmin, dmax = rec.refine["out"]
        want = eval_refine_block(P, "out", x3, q, depth, dmin, dmax, got.shape[-2:])
        base = eval_refine_block({"refine_network.res.weight": torch.zeros_like(P["refine_network.res.weight"])},
                                 "out", x3, q, depth, dmin, dmax, got.shape[-2:])
        residual = max(float((want - base).pow(2).mean().sqrt()), 1e-30)
        gap = (got.float() - want).abs()
        nums["refine_med"] = max(med, _quantile(gap, 0.5) / residual)
        nums["refine_p99"] = max(p99, _quantile(gap, 0.99) / residual)
    return nums


def train_numbers(P0: dict, P1: dict, P3: dict, losses: list, batches: list, cfg: dict,
                  q: Rounding = Rounding(torch.float32), reference: tuple | None = None) -> tuple[dict, tuple]:
    """The train numbers of the program's first three steps from ``P0``:
    ``P1`` and ``P3`` its state after one and three steps, ``losses`` its
    three losses, ``batches`` the three batches it stepped on. Returns the
    numbers and the reference's run (``(R3, losses, first gradient)``),
    which ``reference`` passes in again to judge a second program."""
    t = cfg["train"]
    rcfg = dict(cfg["model"], temperature=t["temperature"], lr=t["lr"], weight_decay=t["weight_decay"],
                dlossw=t["dlossw"])
    if reference is None:
        R, rl, rg = P0, [], None
        for b in batches:
            R, loss, g = train_step(R, b, rcfg, q)
            rl.append(loss)
            rg = rg if rg is not None else g
        reference = (R, rl, rg)
    R3, rl, _ = reference
    nums = {"loss": max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf for a, b in zip(losses, rl)),
            "loss1": abs(losses[0] - rl[0]) / abs(rl[0]) if math.isfinite(losses[0]) else math.inf}
    grad, change = leaf_gaps(P0, P1, P3, reference, cfg)
    gaps = sorted(grad.values())
    nums["grad_worst"], nums["grad_med"], nums["grad_p90"] = gaps[-1], gaps[len(gaps) // 2], gaps[int(0.9 * len(gaps))]
    gaps = sorted(change.values())
    nums["change_worst"], nums["change_med"] = gaps[-1], gaps[len(gaps) // 2]
    bn = [k for k in P0 if k.endswith(("running_mean", "running_var"))]
    b_prog = {k: float((P3[k] - P0[k]).norm()) for k in bn}
    b_ref = {k: float((R3[k] - P0[k]).norm()) for k in bn}
    gaps = sorted(_leafwise(b_prog, b_ref).values())
    nums["bn_worst"], nums["bn_med"] = gaps[-1], gaps[len(gaps) // 2]
    return nums, reference


def _leafwise(got: dict, want: dict, only=None) -> dict:
    """Per leaf, the gap between the program's norm and the reference's over
    the larger of the reference's and the median leaf's."""
    med = sorted(want.values())[len(want) // 2]
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) if math.isfinite(got[k]) else math.inf
            for k in (only or want)}


def leaf_gaps(P0: dict, P1: dict, P3: dict, reference: tuple, cfg: dict) -> tuple[dict, dict]:
    """Per trainable leaf, the gap of the first gradient's norm, and of the
    three steps' change where the reference's gradient is at least a
    thousandth of the median leaf's (:func:`train_numbers`)."""
    R3, _, rg = reference
    keys = trainable_keys(P0)
    lr, wd = cfg["train"]["lr"], cfg["train"]["weight_decay"]
    g_prog = {k: float(((P0[k] - P1[k]) / lr - wd * P0[k]).norm()) for k in keys}
    g_ref = {k: float(rg[k].norm()) for k in keys}
    med_g = sorted(g_ref.values())[len(g_ref) // 2]
    moved = [k for k in keys if g_ref[k] >= 1e-3 * med_g]
    c_prog = {k: float((P3[k] - P0[k]).norm()) for k in keys}
    c_ref = {k: float((R3[k] - P0[k]).norm()) for k in keys}
    return _leafwise(g_prog, g_ref), _leafwise(c_prog, c_ref, moved)


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, check)``: each number that ``limits`` holds is at most
    its limit (a number that is not finite fails); ``check`` gives every
    number with its limit (None: reported, not compared)."""
    table = limits.get("limits", {})
    ok = bool(table)
    check = {}
    for name, value in nums.items():
        limit = table.get(name, {}).get("limit") if isinstance(table.get(name), dict) else table.get(name)
        check[name] = {"value": value, "limit": limit}
        if limit is not None and not (value <= limit):
            ok = False
    for name in table:
        if name not in nums:
            ok = False
            check[name] = {"value": None, "limit": table[name]}
    return ok, check
