"""Resizing with PyTorch ``F.interpolate`` index semantics.

Counterpart of ``cds_mvsnet_tpu/ops/resize.py``. Sampling indices and weights
are computed on the host in float64 (the same arithmetic as the JAX package),
so both packages pick the same source pixels:

- ``nearest``: ``src = floor(i * float32(in/out))``;
- ``linear`` (align_corners=False, the default): ``src = max((i + 0.5) *
  in/out - 0.5, 0)`` with clamp-to-edge;
- ``linear`` with ``align_corners=True``: ``src = i * (in-1)/(out-1)``.

Linear interpolation is separable and applied one axis at a time.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize_nearest", "resize_linear", "upsample2x_nearest"]


@functools.lru_cache(maxsize=None)
def _nearest_indices(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    scale = np.float32(in_size / out_size)
    idx = np.floor(np.arange(out_size, dtype=np.float32) * scale).astype(np.int64)
    return torch.as_tensor(np.clip(idx, 0, in_size - 1), device=device)


@functools.lru_cache(maxsize=None)
def _linear_weights(in_size: int, out_size: int, align_corners: bool, device: torch.device):
    """``(lo, hi, t)`` on ``device``, cached: a host-to-device copy from
    pageable memory would wait for the stream on every call."""
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = np.zeros_like(i) if out_size == 1 else i * (in_size - 1) / (out_size - 1)
    else:
        src = np.maximum((i + 0.5) * in_size / out_size - 0.5, 0.0)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    t = (src - lo).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (lo, hi, t))


def _resize_dim(x: torch.Tensor, out_size: int, dim: int, mode: str) -> torch.Tensor:
    in_size = x.shape[dim]
    if in_size == out_size:
        return x
    if mode == "nearest":
        return torch.index_select(x, dim, _nearest_indices(in_size, out_size, x.device))
    lo, hi, t = _linear_weights(in_size, out_size, mode == "linear_ac", x.device)
    shape = [1] * x.ndim
    shape[dim] = out_size
    tw = t.reshape(shape).to(x.dtype)
    return torch.index_select(x, dim, lo) * (1 - tw) + torch.index_select(x, dim, hi) * tw


def _resize(x, out_shape, dims, mode):
    for size, dim in zip(out_shape, dims):
        x = _resize_dim(x, size, dim % x.ndim, mode)
    return x


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int], dims=(-2, -1)) -> torch.Tensor:
    """Nearest-neighbour resize along ``dims`` (default: the NCHW spatial dims)."""
    return _resize(x, out_hw, dims, "nearest")


def resize_linear(x: torch.Tensor, out_shape, dims, align_corners: bool = False) -> torch.Tensor:
    """(Bi/tri)linear resize along ``dims``; align_corners=False by default."""
    return _resize(x, out_shape, dims, "linear_ac" if align_corners else "linear")


def upsample2x_nearest(x: torch.Tensor, dims=(-2, -1)) -> torch.Tensor:
    """2x nearest upsample along ``dims`` (a repeat)."""
    for d in dims:
        x = torch.repeat_interleave(x, 2, dim=d % x.ndim)
    return x
