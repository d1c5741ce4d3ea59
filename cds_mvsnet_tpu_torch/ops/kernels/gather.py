"""K9: the plane-sweep gather, ``warp_gather(src, px, py)``.

Replaces the JAX package's gather-only warp kernels, which share one
contract: ``cds_mvsnet_tpu/ops/pallas/warp.py::warp_pallas_v3`` (:1608 →
``pallas_call`` :1644; the fp32 eval route at C ≤ 8, ``models/stage_net.py``
:427, :476-484) and its bf16 form ``warp_pallas_v6`` (:1525 → :1552), and the
archive that ``warp_pallas_padded`` (:1572-1605) dispatches:
``warp_archive.py::warp_pallas`` (:153 → :183), ``_v2`` (:302 → :328),
``_v4`` (:465 → :490), ``_v7`` (:616 → :645) and ``_v5`` (:781 → :809).
Kernel source: ``csrc/gather.cu``.

The value is the bilinear sample of the channels-last source at the pixel
coordinates ``(px, py)`` on the ``align_corners=True`` grid, zeros padding: a
corner outside the image contributes nothing, so the ``-1e6`` columns that
``warp_pallas_padded`` pads with come out 0, and so do non-finite
coordinates (bounds are tested on floats before any int conversion).

Bound on the H100: memory. The ``(C, D, h, w)`` output write dominates; at
the DTU protocol point (the cascade at 576x768 under refinement) one fp32
launch moves about 184 / 262 / 156 MB at stages 1/2/3 (C·D = 32·48 / 16·32 /
8·8; 55 / 78 / 46 µs at 3.35 TB/s), bf16 about half of the output and the
source. Design, first and simple: one thread per output ``(d, y, x)``
computes the four corners and weights once (``footprint`` in
``csrc/warp.cuh``, rounded op by op as the plain version), reads each corner
as one contiguous C-vector in 16-byte loads (the source map is at most 14 MB
and stays in L2) and writes its C values strided by ``D·h·w``, so a warp's
stores are consecutive. It sums the corners op by op in fp32, as the plain
version does, and rounds once at the store. The TPU's band windows, 2x2
channel packing (``pack_src_for_warp``), lane gathers and x-pair bit packing
are Mosaic mechanics and are not carried over.
"""

from __future__ import annotations

import torch

from ..grid_sample import grid_sample_pixel
from . import _build
from ._launch import I, L, P, entry, on_card, ptr, require, stream

__all__ = ["warp_gather", "warp_gather_plain"]

CHANNELS = (8, 16, 32)
DTYPES = (torch.float32, torch.bfloat16)


def warp_gather_plain(src: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Plain version: ``grid_sample_pixel`` on the fp32 source (fp32 weights
    in both modes), rounded to ``src``'s dtype at the end."""
    warped = grid_sample_pixel(src.float()[None], px[None], py[None])[0]  # (D, h, w, C)
    return warped.to(src.dtype).permute(3, 0, 1, 2).contiguous()


def warp_gather(src: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Sample ``src (H, W, C)`` (fp32 or bf16, C in 8/16/32) at ``px, py
    (D, h, w)`` fp32 source-pixel coordinates -> ``(C, D, h, w)`` in
    ``src``'s dtype."""
    require(src.ndim == 3 and src.shape[2] in CHANNELS, f"warp_gather: src {tuple(src.shape)}")
    require(px.ndim == 3 and px.shape == py.shape, f"warp_gather: px {tuple(px.shape)}, py {tuple(py.shape)}")
    require(src.dtype in DTYPES, "warp_gather: src must be fp32 or bf16")
    require(px.dtype == py.dtype == torch.float32, "warp_gather: px and py must be fp32")
    require(all(t.is_contiguous() for t in (src, px, py)), "warp_gather: inputs must be contiguous")
    if not on_card("warp_gather", src, px, py):
        return warp_gather_plain(src, px, py)
    require(src.data_ptr() % 16 == 0, "warp_gather: src must be 16-byte aligned")
    H, W, C = src.shape
    D, h, w = px.shape
    out = torch.empty((C, D, h, w), dtype=src.dtype, device=src.device)
    lib, fn = entry("gather", "warp_gather_launch", [P, P, P, P, I, I, I, I, L, P])
    err = fn(ptr(src), ptr(px), ptr(py), ptr(out), int(src.dtype == torch.float32), C, H, W, D * h * w,
             stream(src.device))
    _build.check(lib, err, "warp_gather")
    warp_gather.launches += 1
    return out


warp_gather.launches = 0
