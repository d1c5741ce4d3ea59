"""K6: cost-regularisation conv0 and the stride-2 conv1 in one pass.

``conv3d_front_fused(vol, w0, b0, w1, b1) -> (out0, out1)``: ``out0 =
relu(conv3d(vol, w0) + b0)`` at ``(8, D, h, w)`` and ``out1 =
relu(conv3d(out0, w1, stride 2) + b1)`` at ``(16, D/2, h/2, w/2)``, both
with eval BN folded into the weights and padding 1, in vol's dtype (bf16 or
fp32). conv1 reads conv0 as stored, that is rounded to vol's dtype, with
conv0's zero padding. D, h and w must be even. The ``pallasf``/``pallasf3``
fronts of ``models/cost_reg.py`` run it.

Replaces ``cds_mvsnet_tpu/ops/pallas/conv3d.py::conv3d_front_fused`` (:392,
``pallas_call`` :457, body ``_conv3d_fused_kernel`` :233). Kernel source:
``csrc/conv3d_fused.cu``.

Bound on the H100: memory, at the bf16 tensor-core rate: it reads the
volume and writes out0 and out1, about 250 / 414 / 287 MB per launch at
stages 1/2/3 of the 1152x864 main path (75 / 124 / 86 µs at 3.35 TB/s), for
41 / 55 / 28 GFLOP of conv0 and 2.6 / 6.9 / 6.9 of conv1. Design, first and
simple: one block of 256 threads owns a 4x4x16 tile of conv1 outputs. It
computes the 9x9x33 conv0 values that tile reads (2t+1 per axis; the
low-side halo, which the neighbouring tile owns, is recomputed: 1.3x conv0's
operations) as K2 does, one voxel per thread at a time with fp32 FMAs,
rounds each to the output type after bias and ReLU into shared memory, and
stores to out0 only the 8x8x32 voxels the tile owns, so each voxel of out0
is written once. Outside the volume the shared tile holds 0: conv1's zero
padding at index -1 (the high side is never read by a valid output, as D, h
and w are even). Then each thread computes one conv1 output, all 16
channels, from shared memory. Both weight sets sit in shared memory (at
most 41 KB); the fp32 FMAs, not memory, limit this version, as they do K2.
The TPU kernel's lane rolls, x-parity double buffer and one-hot decimation
matmuls (``dec0``/``dec1``) are Mosaic mechanics and are not carried over.
"""

from __future__ import annotations

import torch

from . import _build
from ._launch import I, P, entry, on_card, ptr, require, stream
from .conv3d import check_conv, conv3d_bn_relu_plain, conv3d_down_plain

__all__ = ["conv3d_front_fused", "conv3d_front_fused_plain"]


def conv3d_front_fused_plain(vol, w0, b0, w1, b1):
    """Plain version: K2's plain conv0, then K7's plain conv1 on conv0 as
    rounded to vol's dtype."""
    out0 = conv3d_bn_relu_plain(vol, w0, b0)
    return out0, conv3d_down_plain(out0, w1, b1)


def conv3d_front_fused(vol: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                       b1: torch.Tensor):
    """``vol (C, D, h, w)`` bf16 or fp32, D, h, w even; ``w0 (8, C, 3, 3,
    3)``, ``b0 (8,)``, ``w1 (16, 8, 3, 3, 3)``, ``b1 (16,)`` fp32 with BN
    folded -> ``(out0 (8, D, h, w), out1 (16, D/2, h/2, w/2))`` in vol's
    dtype."""
    check_conv("conv3d_front_fused", vol, w0, b0, out_channels=(8,))
    require(tuple(w1.shape) == (16, 8, 3, 3, 3) and tuple(b1.shape) == (16,),
            f"conv3d_front_fused: w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}")
    require(w1.dtype == b1.dtype == torch.float32, "conv3d_front_fused: w1 and b1 must be fp32")
    require(w1.is_contiguous() and b1.is_contiguous(), "conv3d_front_fused: inputs must be contiguous")
    C, D, h, w = vol.shape
    require(D % 2 == 0 and h % 2 == 0 and w % 2 == 0, f"conv3d_front_fused: D, h, w {(D, h, w)} must be even")
    if not on_card("conv3d_front_fused", vol, w0, b0, w1, b1):
        return conv3d_front_fused_plain(vol, w0, b0, w1, b1)
    out0 = torch.empty((8, D, h, w), dtype=vol.dtype, device=vol.device)
    out1 = torch.empty((16, D // 2, h // 2, w // 2), dtype=vol.dtype, device=vol.device)
    lib, fn = entry("conv3d_fused", "conv3d_front_fused_launch", [P, P, P, P, P, P, P, I, I, I, I, I, P])
    err = fn(ptr(vol), ptr(w0), ptr(b0), ptr(w1), ptr(b1), ptr(out0), ptr(out1), int(vol.dtype == torch.float32),
             C, D, h, w, stream(vol.device))
    _build.check(lib, err, "conv3d_front_fused")
    conv3d_front_fused.launches += 1
    return out0, out1


conv3d_front_fused.launches = 0
