"""K6: cost-regularisation conv0 and the stride-2 conv1 in one pass.

``conv3d_front_fused(vol, w0, b0, w1, b1) -> (out0, out1)``: ``out0 =
relu(conv3d(vol, w0) + b0)`` at ``(8, D, h, w)`` and ``out1 =
relu(conv3d(out0, w1, stride 2) + b1)`` at ``(16, D/2, h/2, w/2)``, both
with eval BN folded into the weights and padding 1, in vol's dtype (bf16 or
fp32). conv1 reads conv0 as stored, that is rounded to vol's dtype, with
conv0's zero padding. D, h and w must be even. The ``pallasf``/``pallasf3``
fronts of ``models/cost_reg.py`` run it.

Replaces ``cds_mvsnet_tpu/ops/pallas/conv3d.py::conv3d_front_fused`` (:392,
``pallas_call`` :457, body ``_conv3d_fused_kernel`` :233). Kernel sources:
``csrc/conv3d_fused.cu``, ``csrc/conv3d_mma.cuh`` and
``csrc/conv3d_tf32.cuh``.

Bound on the H100: memory in bf16: it reads the volume and writes out0 and
out1, about 250 / 414 / 287 MB per launch at stages 1/2/3 of the 1152x864
main path (75 / 124 / 86 µs at 3.35 TB/s), for 41 / 55 / 28 GFLOP of conv0
and 2.6 / 6.9 / 6.9 of conv1. In fp32 its three TF32 products bound it
(0.118 / 0.167 / 0.093 ms at the DTU protocol's stages, ``chip_smoke.py``).

bf16 (``conv3d_fused_mma_kernel``): a block of 8 warps owns a 2x4x16 tile
of conv1 outputs at a time, stays resident and walks the tiles. Phase 1
computes the 5x9x33 conv0 values the tile reads (2t+1 per axis; the
low-side halo, which the tile before owns, is recomputed: 1.45x conv0's
operations) with K2's tensor-core body (``csrc/conv3d_mma.cuh``: the same
chunks, K-steps, hi/lo weight split and epilogue), so out0 equals K2's
output bit for bit. It takes the region in two passes along z (planes 0-2,
then 3-4), so that a warp's accumulators (7 M-tiles at most) stay in
registers at two blocks per SM; each pass stages its own input halo (5 or
4 planes of 11x36 voxels) 8 channels at a time, channel-innermost, the
next one's loads in flight during the current MMAs: 9 input planes per
chunk for the 7 a single pass would stage. The voxels of a pass, flattened,
are M-tiles of 16 rows; ldmatrix takes each row's address, so no row is
spent on padding along x. Each conv0 value, after bias, ReLU and rounding
to bf16, goes to a shared conv0 tile ``[8][R]``, 0 outside the volume
(conv1's zero padding at index -1; the high side is never read by a valid
output, as D, h and w are even), and the 4x8x32 voxels the tile owns go to
out0 from there, two along x per store, each once. Phase 2 computes conv1
from the shared tile on K7-fp32's 3xTF32 step (``down_step`` in
``csrc/conv3d_tf32.cuh``), each warp one output row of 16 x, its A
fragments gathered from the tile (a bf16 value is exact in fp32 and its lo
part 0), so out1 equals K7-fp32 on ``out0.float()``, rounded to bf16, bit
for bit (K7 in bf16 runs on the tensor cores and keeps one bf16 ulp).
Shared memory at C = 32: 28.0 KB of conv0 weight fragments, 30.9 KB of
halo, 27.0 KB of conv1 fragments, 23.2 KB of conv0 tile, 109.1 KB in all:
two blocks per SM. The fusion saves only the bytes of writing and reading
out0 once (0.03-0.08 ms at the serve stages) against the 1.45x recompute
and the larger halo, so K6 is slower than K2 and K7 apart (``PERF.md``); it
beats cuDNN's two calls. The TPU kernel's lane rolls, x-parity double
buffer and one-hot decimation matmuls (``dec0``/``dec1``) are Mosaic
mechanics and are not carried over; it rounds its weights and an fp32
volume to bf16 (``conv3d.py:186-187,428``), the port splits them
(``conv3d.py``'s note).

fp32 (``conv3d_fused_tf32_kernel``): K6-bf16's tile and walk with conv0 in
3xTF32, K2-fp32's arithmetic in its order (``csrc/conv3d_tf32.cuh``), so
out0 equals K2-fp32's output bit for bit, and conv1 as in bf16 on an fp32
conv0 tile, so out1 equals K7-fp32 on out0 bit for bit. conv0 takes
K2-fp32's walk as well: a region plane's 9x33 voxels, flattened, are 19
M-tiles of 16 rows, and a column stacks M-tile p of the 5 planes along z,
so that each A fragment of an input plane is loaded and split once for the
three depth taps (12 warps, one or two columns a warp). One pass a chunk over a
7x11x35-voxel halo, fp32, kept as two half-halos of 16 bytes a voxel
(channels 0-3 and 4-7), so that an ``ldmatrix`` phase's 8 consecutive
voxels meet no bank twice; the next chunk's halo is staged in registers
during the MMAs. Shared memory at C = 32: 54 KB of conv0 fragments, 84.2
KB of halo, 27 KB of conv1 fragments, 46.4 KB of conv0 tile, 211.6 KB: one
block an SM. C is at most 40 (five chunks of fragments).
"""

from __future__ import annotations

import torch

from . import _build
from ._launch import I, P, entry, on_card, ptr, require, stream
from .conv3d import check_conv, conv3d_bn_relu_plain, conv3d_down_plain

__all__ = ["conv3d_front_fused", "conv3d_front_fused_plain", "FP32_MAX_C"]

FP32_MAX_C = 40  # K6-fp32: five chunks of conv0 fragments beside the halo and the conv0 tile


def conv3d_front_fused_plain(vol, w0, b0, w1, b1):
    """Plain version: K2's plain conv0, then K7's plain conv1 on conv0 as
    rounded to vol's dtype."""
    out0 = conv3d_bn_relu_plain(vol, w0, b0)
    return out0, conv3d_down_plain(out0, w1, b1)


def conv3d_front_fused(vol: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                       b1: torch.Tensor):
    """``vol (C, D, h, w)`` bf16 or fp32, D, h, w even, C a multiple of 8 in
    bf16 and at most 40 in fp32; ``w0 (8, C, 3, 3, 3)``, ``b0 (8,)``, ``w1
    (16, 8, 3, 3, 3)``, ``b1 (16,)`` fp32 with BN folded -> ``(out0 (8, D,
    h, w), out1 (16, D/2, h/2, w/2))`` in vol's dtype."""
    check_conv("conv3d_front_fused", vol, w0, b0, out_channels=(8,), tensor_cores=True)
    require(tuple(w1.shape) == (16, 8, 3, 3, 3) and tuple(b1.shape) == (16,),
            f"conv3d_front_fused: w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}")
    require(w1.dtype == b1.dtype == torch.float32, "conv3d_front_fused: w1 and b1 must be fp32")
    require(w1.is_contiguous() and b1.is_contiguous(), "conv3d_front_fused: inputs must be contiguous")
    C, D, h, w = vol.shape
    require(D % 2 == 0 and h % 2 == 0 and w % 2 == 0, f"conv3d_front_fused: D, h, w {(D, h, w)} must be even")
    require(vol.dtype == torch.bfloat16 or C <= FP32_MAX_C,
            f"conv3d_front_fused: fp32 takes C <= {FP32_MAX_C} (its weight fragments in shared memory), got C={C}")
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
