"""Curvature-guided dynamic-scale convolution.

Counterpart of ``cds_mvsnet_tpu/models/dynamic_conv.py``. Per candidate kernel
size k, a conv and a 3-channel curvature-coefficient conv share the input and
run as one conv over concatenated weights; the directional curvature along
the epipolar direction ``(u, v)`` is ``coeffs · (u², 2uv, v²)``, and a 1x1
MLP with BN and a temperature softmax (fp32) mixes the branches per pixel.
At eval all branches can run as one launch of K4 (``ops/kernels/dynconv.py``);
training runs one ``F.conv2d`` per branch, as the JAX package trains through
its plain form (K4 has no backward).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import BatchNorm, conv2d

__all__ = ["DynamicConv", "epipolar_direction_quadratic", "epipolar_norm", "epipolar_offsets"]


def epipolar_offsets(epipole: torch.Tensor, height: int, width: int):
    """``(u, v)``: each pixel minus the epipole, fp32 ``(N, H, W)`` each."""
    e = epipole.float()
    xs = torch.arange(width, dtype=torch.float32, device=e.device)
    ys = torch.arange(height, dtype=torch.float32, device=e.device)
    N = e.shape[0]
    u = (xs[None, None, :] - e[:, 0, None, None]).expand(N, height, width)
    v = (ys[None, :, None] - e[:, 1, None, None]).expand(N, height, width)
    return u, v


def epipolar_norm(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``sqrt(u*u + v*v)`` in fp32, correctly rounded, the same bits in
    every process. On the card that is ``torch.sqrt`` (IEEE ``sqrtf``). On
    the CPU it is numpy's root (the hardware's IEEE square root): the CPU's
    fp32 ``torch.sqrt`` is one ulp off at some elements, and in a few fresh
    processes its first call is further off at half of them; taken in fp64
    and rounded once, it still differs at that first call
    (``tools/cpu_sqrt_repeat.py --root fp32``, ``--root fp64``)."""
    n2 = u * u + v * v
    if n2.device.type == "cpu":
        return torch.from_numpy(np.sqrt(n2.numpy()))
    return torch.sqrt(n2)


def epipolar_direction_quadratic(epipole: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``(u², 2uv, v²)`` of the unit epipolar direction per pixel, in fp32:
    ``epipole (N, 2)`` pixels -> ``(N, 3, H, W)``."""
    u, v = epipolar_offsets(epipole, height, width)
    norm = epipolar_norm(u, v)
    u = u / (norm + 1e-6)
    v = v / (norm + 1e-6)
    return torch.stack([u * u, 2 * u * v, v * v], dim=1)


class DynamicConv(nn.Module):
    def __init__(self, in_c: int, out_c: int, size_kernels: tuple[int, ...], bias: bool = True,
                 hidden_dim: int = 4):
        super().__init__()
        self.size_kernels = tuple(size_kernels)
        self.att_convs = nn.ModuleList(nn.Conv2d(in_c, 3, k, bias=False) for k in size_kernels)
        self.convs = nn.ModuleList(nn.Conv2d(in_c, out_c, k, bias=bias) for k in size_kernels)
        nk = len(size_kernels)
        self.att_weights = nn.Sequential(
            nn.Conv2d(nk, hidden_dim, 1, bias=False),
            BatchNorm(hidden_dim),
            nn.ReLU(),
            nn.Conv2d(hidden_dim, nk, 1, bias=False),
        )

    def forward(self, x, epipole, temperature: float, branches=None, stats=None, groups: int = 1,
                order=None):
        """``x (N,I,H,W)``, ``epipole (N,2)`` -> ``(out (N,O,H,W), norm_curv (N,H,W))``.

        ``branches``: None runs one conv per branch; else a function of
        ``(x, weights)`` that runs them all at once (K4's wrapper or its plain
        version). ``stats``: train the attention BN on batch statistics, per
        group of ``N / groups`` images (``layers.BatchNorm``).
        """
        N, _, H, W = x.shape
        quad = epipolar_direction_quadratic(epipole, H, W).to(x.dtype)
        fused = [torch.cat([c.weight, a.weight], 0) for c, a in zip(self.convs, self.att_convs)]
        if branches is None:
            ys = [conv2d(x, w) for w in fused]
        else:
            ys = branches(x, [w.contiguous() for w in fused]).split(fused[0].shape[0], dim=1)

        curvs, results = [], []
        for conv, y in zip(self.convs, ys):
            out_c = conv.weight.shape[0]
            res, coef = y[:, :out_c], y[:, out_c:]
            if conv.bias is not None:
                res = res + conv.bias.to(res.dtype)[None, :, None, None]
            curvs.append((coef * quad).sum(1, keepdim=True))
            results.append(res)
        curvs = torch.cat(curvs, 1)  # (N, K, H, W)
        att = self.att_weights
        w = conv2d(curvs, att[0].weight)
        w = torch.relu(att[1](w, stats, groups, order))
        w = conv2d(w, att[3].weight)
        # temperature softmax in fp32: at T=0.01 the logits scale by 100
        w = torch.softmax(w.float() / temperature, dim=1).to(x.dtype)
        out = sum(results[i] * w[:, i : i + 1] for i in range(len(results)))
        norm_curv = (curvs * w).sum(1)
        return out, norm_curv
