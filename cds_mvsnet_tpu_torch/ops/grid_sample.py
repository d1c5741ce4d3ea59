"""Bilinear sampling at pixel coordinates with zeros padding.

Counterpart of ``cds_mvsnet_tpu/ops/grid_sample.py::grid_sample_pixel``:
``F.grid_sample(mode="bilinear", padding_mode="zeros", align_corners=True)``
written directly in pixel coordinates, with one in-bounds mask per corner.
A corner out of bounds gets the weight 0 through ``torch.where``, not a
multiply by the mask: a far-off projection can give non-finite coordinates
(``tx = inf - inf``), and ``NaN * 0`` would carry NaN into the result and
into autograd's backward. Bounds are tested on the float corners, as the
kernels test them: the int conversion of a NaN or huge coordinate is left
to the device (x86 gives the most negative int), so only the clamped gather
index is taken from it. The corners are rows of the flattened source, taken
by ``ops.index.index_select``, whose gradient repeats on the card
(autograd's ``gather`` backward adds with atomics there).
"""

from __future__ import annotations

import torch

from .index import index_select

__all__ = ["grid_sample_pixel"]


def grid_sample_pixel(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample ``src (B,H,W,C)`` at pixel coordinates ``x, y (B,*S)``.

    Returns ``(B,*S,C)``; a corner outside the image contributes zero.
    """
    B, H, W, C = src.shape
    sample_shape = x.shape[1:]
    x = x.reshape(B, -1)
    y = y.reshape(B, -1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = (x - x0).to(src.dtype)
    ty = (y - y0).to(src.dtype)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    src_rows = src.reshape(B * H * W, C)
    base = torch.arange(B, device=src.device)[:, None] * (H * W)

    def corner(dx, dy, w):
        xf, yf = x0 + dx, y0 + dy
        inb = (xf >= 0) & (xf <= W - 1) & (yf >= 0) & (yf <= H - 1)
        idx = (y0i + dy).clamp(0, H - 1) * W + (x0i + dx).clamp(0, W - 1)
        vals = index_select(src_rows, 0, (idx + base).reshape(-1)).reshape(B, -1, C)
        return vals * torch.where(inb, w, torch.zeros_like(w))[:, :, None]

    out = (
        corner(0, 0, (1 - tx) * (1 - ty))
        + corner(1, 0, tx * (1 - ty))
        + corner(0, 1, (1 - tx) * ty)
        + corner(1, 1, tx * ty)
    )
    return out.reshape(B, *sample_shape, C)
