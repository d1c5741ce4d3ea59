"""Multi-stage training loss.

Counterpart of ``cds_mvsnet_tpu/training/loss.py::final_loss``. Per stage:
masked smooth-L1 on interval-normalised depth + 0.1 x masked mean curvature +
5 x class-balanced BCE-with-logits on the per-plane feature similarity, each
scaled by ``dlossw[stage]``; plus 2 x smooth-L1 of the refined depth against
the stage-4 ground truth. Masked means are where-sums over fixed shapes, as
in the JAX package. The loss is taken in fp32 whatever the compute dtype.

Under a process group (data-parallel training, one batch slice a rank),
every masked mean is global, as the JAX package's data-parallel step on the
global batch has it: each rank's term is its own masked sum over the
count of all ranks (``global_count``), and the BCE's positive weight comes
from all ranks' counts, so the ranks' losses sum to the one-process loss of
the global batch. The mean of the ranks' own means is another loss
wherever their masks count different pixels.
"""

from __future__ import annotations

import torch

from ..models.layers import global_sum

__all__ = ["final_loss", "global_count", "smooth_l1", "masked_mean"]


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def global_count(t: torch.Tensor, group) -> torch.Tensor:
    """A count (no gradient) summed over the ranks of ``group``; itself
    without one."""
    return t if group is None else global_sum(t.detach(), group)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """``Σ x·mask / Σ mask``; under ``group`` this rank's share of the
    global mean (its own sum over every rank's count)."""
    m = mask.to(x.dtype)
    return (x * m).sum() / global_count(m.sum(), group).clamp(min=1.0)


def _bce_with_logits(logits, target, pos_weight):
    zero = torch.zeros_like(logits)
    log_sig = -torch.logaddexp(zero, -logits)  # log σ(x)
    log_one_minus = -torch.logaddexp(zero, logits)  # log(1 − σ(x))
    return -(pos_weight * target * log_sig + (1 - target) * log_one_minus)


def final_loss(outputs: dict, depth_gt_ms: dict, mask_ms: dict, dlossw, depth_interval: torch.Tensor, group=None):
    """``(total_loss, depth_loss)``: the depth loss of the last term added
    (the refined depth's where there is one). ``depth_interval (B,)``.
    ``group``: each rank's share of the global loss (the module's
    docstring)."""
    di = depth_interval[:, None, None]
    total = torch.zeros((), dtype=torch.float32, device=di.device)
    depth_loss = total
    for s, key in enumerate(("stage1", "stage2", "stage3")):
        stage = outputs[key]
        mask = mask_ms[key] > 0.5
        depth_loss = masked_mean(smooth_l1((stage["depth"] - depth_gt_ms[key]) / di), mask, group)
        curv = masked_mean(stage["norm_curv"].float(), mask, group)
        feat = 0.0
        if "feat_distance" in stage:
            target = stage["feat_target"]
            m = mask[:, None].expand(target.shape).float()
            pos, count = global_count(torch.stack([(target * m).sum(), m.sum()]), group)
            weight = (count - pos) / pos.clamp(min=1.0)
            feat = masked_mean(_bce_with_logits(stage["feat_distance"], target, weight), m, group)
        w = dlossw[s] if dlossw is not None else 1.0
        total = total + w * (depth_loss + 5.0 * feat + 0.1 * curv)

    if "refined_depth" in outputs and "stage4" in depth_gt_ms:
        mask4 = mask_ms["stage4"] > 0.5
        depth_loss = masked_mean(smooth_l1((outputs["refined_depth"] - depth_gt_ms["stage4"]) / di), mask4, group)
        total = total + 2.0 * depth_loss
    return total, depth_loss
