"""The plain reference of one training step: loss, backward, SGD, BN.

The loss is the published one (per stage: masked smooth-L1 on
interval-normalised depth, 0.1 x the masked mean curvature and 5 x a
class-balanced BCE on the feature similarity against its target, weighted
by ``dlossw``; plus 2 x the refined depth's smooth-L1 at full resolution).
The step is plain SGD with weight decay on every trainable leaf (a leaf the
loss does not reach still decays), then the BatchNorm running statistics
move one EMA step (momentum 0.1, unbiased variance) per BN call, in call
order, as ``torch.nn.BatchNorm`` does in an upstream forward.
"""

from __future__ import annotations

import torch

from .model import Rounding, train_cascade

__all__ = ["final_loss", "train_step", "trainable_keys"]

BN_MOMENTUM = 0.1


def _smooth_l1(x):
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp(min=1.0)


def _bce(logits, target, pos_weight):
    log_sig = torch.nn.functional.logsigmoid(logits)
    log_not = torch.nn.functional.logsigmoid(-logits)
    return -(pos_weight * target * log_sig + (1 - target) * log_not)


def final_loss(out: dict, depth_gt: dict, mask: dict, dlossw, interval) -> torch.Tensor:
    di = interval[:, None, None]
    total = torch.zeros((), dtype=torch.float32, device=di.device)
    for s, key in enumerate(("stage1", "stage2", "stage3")):
        st = out[key]
        m = mask[key] > 0.5
        depth = _masked_mean(_smooth_l1((st["depth"] - depth_gt[key]) / di), m)
        curv = _masked_mean(st["norm_curv"].float(), m)
        target = st["feat_target"]
        mm = m[:, None].expand(target.shape).float()
        pos, count = (target * mm).sum(), mm.sum()
        feat = _masked_mean(_bce(st["feat_distance"], target, (count - pos) / pos.clamp(min=1.0)), mm)
        total = total + dlossw[s] * (depth + 5.0 * feat + 0.1 * curv)
    if "stage4" in depth_gt:
        m4 = mask["stage4"] > 0.5
        total = total + 2.0 * _masked_mean(_smooth_l1((out["refined_depth"] - depth_gt["stage4"]) / di), m4)
    return total


def trainable_keys(P: dict) -> list:
    """The trainable leaves: every key but the BN running statistics."""
    return [k for k in P if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]


def train_step(P: dict, batch: dict, cfg: dict, q: Rounding) -> tuple[dict, float, dict]:
    """One step from ``P`` (fp32 tensors on the device, left untouched):
    ``(new P, loss, gradients)``; ``cfg`` holds ``temperature``, ``lr``,
    ``weight_decay``, ``dlossw`` and the model's ``refine``, ``ndepths`` and
    ``depth_intervals_ratio``."""
    keys = trainable_keys(P)
    leaves = {k: P[k].detach().clone().requires_grad_(True) for k in keys}
    params = {**P, **leaves}
    out, bn_calls = train_cascade(params, batch, cfg["temperature"], cfg, q)
    dv = batch["depth_values"].float()
    loss = final_loss(out, batch["depth"], batch["mask"], cfg["dlossw"], dv[:, 1] - dv[:, 0])
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)
    new, gdict = dict(P), {}
    with torch.no_grad():
        for k, g in zip(keys, grads):
            g = torch.zeros_like(P[k]) if g is None else g
            gdict[k] = g
            new[k] = P[k] - cfg["lr"] * (g + cfg["weight_decay"] * P[k])
        for prefix, mean, var in bn_calls:
            rm, rv = prefix + ".running_mean", prefix + ".running_var"
            new[rm] = (1 - BN_MOMENTUM) * new[rm] + BN_MOMENTUM * mean
            new[rv] = (1 - BN_MOMENTUM) * new[rv] + BN_MOMENTUM * var
    return new, float(loss.detach()), gdict
