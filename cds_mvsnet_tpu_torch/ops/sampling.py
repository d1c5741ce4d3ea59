"""Depth hypotheses and probability-volume regression.

Counterpart of ``cds_mvsnet_tpu/ops/sampling.py``. Depth-plane tensors are
``(B, D)`` or ``(B, D, H, W)``; probability volumes ``(B, D, H, W)``.
"""

from __future__ import annotations

import torch

from .resize import resize_linear

__all__ = [
    "initial_depth_hypotheses",
    "refined_depth_hypotheses",
    "depth_regression",
    "confidence_regression",
    "softmax_entropy",
]


def initial_depth_hypotheses(depth_values: torch.Tensor, ndepth: int) -> torch.Tensor:
    """Uniformly respan ``(B, Dfull)`` depth values to ``(B, ndepth)``."""
    lo = depth_values[:, 0]
    hi = depth_values[:, -1]
    step = (hi - lo) / (ndepth - 1)
    steps = torch.arange(ndepth, dtype=depth_values.dtype, device=depth_values.device)
    return lo[:, None] + steps[None, :] * step[:, None]


def refined_depth_hypotheses(
    cur_depth: torch.Tensor,
    ndepth: int,
    depth_interval_pixel: torch.Tensor,
    min_depth: torch.Tensor,
    max_depth: torch.Tensor,
    out_hw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Per-pixel windows of ``ndepth`` planes around ``cur_depth (B,H,W)``.

    Each sample is clamped to ``[min_depth, max_depth]`` on its own, so
    windows at the range edges flatten and are not affine in the plane index.
    ``out_hw`` bilinearly (align_corners=False) resamples the window volume
    to the stage resolution. Returns ``(B, ndepth, h, w)``.
    """
    B, H, W = cur_depth.shape
    nl = (ndepth - 1) // 2
    lo = cur_depth - nl * depth_interval_pixel
    steps = torch.arange(ndepth, dtype=cur_depth.dtype, device=cur_depth.device)
    samples = lo[:, None] + steps.reshape(1, ndepth, 1, 1) * depth_interval_pixel[:, None]
    samples = min_depth + torch.clamp_min(samples - min_depth, 0)
    samples = max_depth + torch.clamp_max(samples - max_depth, 0)
    if out_hw is not None and tuple(out_hw) != (H, W):
        samples = resize_linear(samples, out_hw, dims=(-2, -1), align_corners=False)
    return samples


def depth_regression(prob: torch.Tensor, depth_values: torch.Tensor) -> torch.Tensor:
    """Soft-argmin: ``(B,D,h,w) x (B,D[,h,w]) -> (B,h,w)``."""
    if depth_values.ndim <= 2:
        depth_values = depth_values[:, :, None, None]
    return torch.sum(prob * depth_values, dim=1)


def confidence_regression(prob: torch.Tensor, n: int = 4) -> torch.Tensor:
    """Probability mass in the window ``[idx-1, idx+2]`` around the regressed
    plane index, where ``idx`` truncates (does not round) the expectation."""
    B, D, h, w = prob.shape
    pad = torch.nn.functional.pad(prob, (0, 0, 0, 0, n // 2 - 1, n // 2))
    win = sum(pad[:, i : i + D] for i in range(n))
    planes = torch.arange(D, dtype=prob.dtype, device=prob.device)[None]
    idx_f = depth_regression(prob, planes)
    idx = idx_f.to(torch.int64).clamp(0, D - 1)
    return torch.gather(win, 1, idx[:, None])[:, 0]


def softmax_entropy(sim: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Entropy of ``softmax(sim)`` along ``dim``, keepdim; no gradient flows
    back into ``sim``, as in the JAX package."""
    p = torch.softmax(sim.detach(), dim=dim)
    return -torch.sum(p * torch.log(p), dim=dim, keepdim=True)
