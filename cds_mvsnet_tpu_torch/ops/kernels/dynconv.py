"""K4: every branch of one DynamicConv layer in one launch.

Replaces ``cds_mvsnet_tpu/ops/pallas/s2d_sparse.py::sparse_s2d_conv`` (:239,
body ``_sparse_kernel`` :181, with ``plan_sparse_layer`` :97 and
``pack_tiles`` :156). Kernel source: ``csrc/dynconv.cu``.

Each branch is a bias-free ``k x k`` conv whose weight is the layer's conv
weight concatenated with its 3-channel curvature-coefficient weight
(``OA = O + 3`` outputs). All branches read one input; the output stacks the
branches' ``OA`` channels in order. The curvature mixture stays in torch.

Bound on the H100: memory. At conv01 of the 1152x864 main path (8 images of
8x864x1152 in, 3 x 11 channels out) it moves about 653 MB for 116 GFLOP
(about 195 µs at 3.35 TB/s, 118 µs at the bf16 tensor rate). Design, first
and simple: a block stages one 32x8 output tile's input, with the halo of the
widest branch (``max(k)//2``, the 7x7 union of taps for conv01), and all
branch weights in shared memory as fp32; each thread computes every output
channel of every branch at its pixel with fp32 FMAs, so the input is read
from device memory about once. The CUDA cores' fp32 rate limits this
version. The TPU kernel's space-to-depth rescatter and its block-sparse
tile plan are Mosaic mechanics and are not carried over.

Contract: bit for bit with the plain version. Each output is one fp32 FMA
chain in the order ``(c, ky, kx)`` from 0, as the plain version's fp32 conv
sums it, rounded once to bf16. One bf16 ulp is not enough: the FeatureNet
mixes the branches with a softmax of the curvature at temperature 0.001,
so a few outputs rounded the other way give another depth map. A
tensor-core form (bf16 MMAs on a hi/lo split of the weights) stays within
one ulp and still fails the cascade (``tests/test_torch_dynconv_split.py``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from ._launch import I, P, entry, on_card, ptr, require, stream

__all__ = ["dynconv_branches", "dynconv_branches_plain", "shared_bytes"]

OUT_WIDTHS = (11, 19, 35)  # O + 3 for the FeatureNet's O = 8, 16, 32
MAX_BRANCHES = 4
TILE = (8, 32)  # output rows x cols per block, as csrc/dynconv.cu
SMEM_LIMIT = 227 * 1024


def shared_bytes(I_: int, ks, OA: int) -> int:
    """Shared memory one block of the kernel needs."""
    r = max(ks) // 2
    tile = I_ * (TILE[0] + 2 * r) * (TILE[1] + 2 * r)
    return 4 * (tile + sum(I_ * k * k * OA for k in ks))


def dynconv_branches_plain(x: torch.Tensor, ws) -> torch.Tensor:
    """Plain version: one fp32 conv per branch, concatenated, in x's dtype."""
    xf = x.float()
    outs = [F.conv2d(xf, w.float(), padding=w.shape[-1] // 2) for w in ws]
    return torch.cat(outs, 1).to(x.dtype)


def dynconv_branches(x: torch.Tensor, ws) -> torch.Tensor:
    """``x (N, I, H, W)`` bf16 and branch weights ``ws[b] (OA, I, k_b, k_b)``
    fp32 (odd ``k_b``) -> ``(N, len(ws)·OA, H, W)`` bf16."""
    require(x.ndim == 4, f"dynconv_branches: x {tuple(x.shape)}")
    N, I_, H, W = x.shape
    require(1 <= len(ws) <= MAX_BRANCHES, f"dynconv_branches: {len(ws)} branches")
    OA = ws[0].shape[0]
    ks = [w.shape[-1] for w in ws]
    for w, k in zip(ws, ks):
        require(tuple(w.shape) == (OA, I_, k, k) and k % 2 == 1,
                f"dynconv_branches: weight {tuple(w.shape)} for I={I_}, OA={OA}")
        require(w.dtype == torch.float32 and w.is_contiguous(), "dynconv_branches: weights must be contiguous fp32")
    require(OA in OUT_WIDTHS, f"dynconv_branches: OA={OA} not in {OUT_WIDTHS}")
    require(x.dtype == torch.bfloat16 and x.is_contiguous(), "dynconv_branches: x must be contiguous bf16")
    require(shared_bytes(I_, ks, OA) <= SMEM_LIMIT, "dynconv_branches: layer exceeds shared memory")
    if not on_card("dynconv_branches", x, *ws):
        return dynconv_branches_plain(x, ws)
    # weights as [c][ky][kx][o] per branch, back to back
    packed = torch.cat([w.permute(1, 2, 3, 0).reshape(-1) for w in ws]).contiguous()
    out = torch.empty((N, len(ws) * OA, H, W), dtype=torch.bfloat16, device=x.device)
    kbuf = (ctypes.c_int * MAX_BRANCHES)(*ks)
    lib, fn = entry("dynconv", "dynconv_branches_launch", [P, P, P, I, I, I, I, I, I, P, P])
    err = fn(ptr(x), ptr(packed), ptr(out), N, I_, H, W, OA, len(ws),
             ctypes.cast(kbuf, ctypes.c_void_p), stream(x.device))
    _build.check(lib, err, "dynconv_branches")
    dynconv_branches.launches += 1
    return out


dynconv_branches.launches = 0
