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
source. The source map is at most 14 MB and stays in L2, so what the
kernel's loads cost is L1 and L2 traffic: a corner is one contiguous
C-vector of up to 128 bytes, and one thread per pixel reading all of its
corners in 16-byte pieces would make each warp-wide load touch up to 32
cache lines where 4 hold the bytes it uses.

Design: lane groups for wide pixels. Where a pixel's C-vector is wider
than 32 bytes (fp32 at C = 32 and 16, bf16 at C = 32: the fp32 route's
stages 1 and 2), ``G = C·sizeof(T)/32`` lanes take one output pixel (4 / 2 /
2) and each loads two 16-byte pieces of each corner, so a group reads each
corner vector whole and a warp's load touches one line per corner and
pixel. Every lane of the group computes the same footprint (``footprint``
in ``csrc/warp.cuh``, rounded op by op as the plain version), issues its
eight loads from addresses clamped into the image before it sums any, then
sums its channels over the in-bounds corners in corner order, op by op in
fp32 (``fetch_pieces``, ``sum_pieces``), and rounds once: ``gather<C,
true>``'s arithmetic, channel by channel, so the output equals the plain
version bit for bit. A pixel of at most 32 bytes (fp32 at C = 8, bf16 at C
= 16 and 8) is taken by one thread, as ``gather<C, true>`` does, each
corner in one or two 16-byte loads. Coordinates are read and outputs
written with evict-first hints (``__ldcs``, ``__stcs``), so the source
stays in L2 while the output streams past it. Stores go straight from
registers: consecutive lanes of the same piece store consecutive pixels,
runs of 32 to 128 bytes per channel. Other forms were timed on the card
against this one (``tools/time_gather_dynconv.py``; PERF.md §6): one
16-byte piece a lane (G = 8 at fp32 C = 32) needs its results staged
through shared memory to store runs of consecutive pixels, and staging
(per block or per warp) cost more than it saved everywhere but fp32 C =
32, where it only equalled this form; lane groups at 32 bytes a pixel or
less, and two pixels a thread stored in pairs, lost to the thread per
pixel. The TPU's band windows, 2x2 channel packing (``pack_src_for_warp``),
lane gathers and x-pair bit packing are Mosaic mechanics and are not
carried over.
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
