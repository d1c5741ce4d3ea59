"""K4: every branch of one FeatureNet conv in one launch.

Replaces ``cds_mvsnet_tpu/ops/pallas/s2d_sparse.py::sparse_s2d_conv`` (:239,
body ``_sparse_kernel`` :181, with ``plan_sparse_layer`` :97 and
``pack_tiles`` :156). Kernel source: ``csrc/dynconv.cu``.

Each branch is a bias-free ``k x k`` conv. In a DynamicConv layer its weight
is the layer's conv weight concatenated with its 3-channel
curvature-coefficient weight (``OA = O + 3`` outputs: 11, 19, 35); a plain
conv (downsample1/2, inner1/2) is one branch of ``OA = O`` (8, 16, 32). All
branches read one input; the output stacks the branches' ``OA`` channels in
order. The curvature mixture and a head's bias stay in torch. The route
(``models/warp_routes.py``, ``Routes.feature``) sends any of the 13
FeatureNet convs here: ``k`` is 1, 3, 5, 7 or 11 (conv00's branches are 3,
7, 11) at stride 1, or one 3 x 3 branch at stride 2 with padding 1 (the
downsample layers).

Bound on the H100: the CUDA cores. At conv01 of the 1152x864 main path (8
images of 8x864x1152 in, 3 x 11 channels out) it moves about 653 MB (195 µs
at 3.35 TB/s) for 58.2 G fp32 FMAs; the contract below rules out the tensor
cores, so its floor is the fp32 rate, 1.73 ms at 67 TFLOP/s; all 13 convs
of a map take 183.8 G FMAs, a 5.49 ms floor. Design: a block stages the
input tile of 32 output columns x 32 output rows (16 or 8 where a wide
layer's shared memory asks it), with the halo of the widest branch
(``max(k)//2``) and, at stride 2, the ``(2·rows + 1) x 65`` input box, as
fp32 converted exactly from 16-byte bf16 loads where ``W % 8 == 0``, and
lays every branch's weights out in shared memory as
``[c][ky][kx][group][12]``, read in place from the caller's ``(OA, I, k,
k)`` tensors. A thread computes 4 adjacent pixels of one row for a group of
at most 12 output channels (all 11 at OA = 11; 8 at OA = 8; 10 + 9 at OA =
19; 8 + 8 at OA = 16; 12 + 12 + 11 at OA = 35; 11 + 11 + 10 at OA = 32):
per ``(c, ky)`` it loads the row's ``(4 - 1)·stride + k`` inputs into
registers once, and per ``kx`` three warp-uniform 16-byte weight vectors,
each weight feeding 4 FMAs. ``k`` and the stride are template parameters,
so the row and the ``kx`` loop unroll. Two blocks share an SM where shared
memory allows; a block of 16 or 8 rows (wide layers) splits its channel
groups over up to 256 threads, so more warps share its tile. The TPU
kernel's space-to-depth rescatter and its block-sparse tile plan are Mosaic
mechanics and are not carried over.

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

__all__ = ["dynconv_branches", "dynconv_branches_plain", "shared_bytes", "tile_rows"]

# O + 3 of the FeatureNet's DynamicConv layers (O = 8, 16, 32), and O of its
# one-branch plain convs
OUT_WIDTHS = (8, 11, 16, 19, 32, 35)
KERNEL_SIZES = (1, 3, 5, 7, 11)  # the kernel's instantiations of k at stride 1
STRIDES = (1, 2)  # stride 2: one 3 x 3 branch, padding 1
MAX_BRANCHES = 4
TILE_W = 32  # output columns per block, as csrc/dynconv.cu
GROUP_W = 12  # weight slots per (c, ky, kx) and channel group
SMEM_LIMIT = 227 * 1024


def _bytes(I_: int, ks, OA: int, rows: int, stride: int = 1) -> int:
    r = max(ks) // 2
    th = stride * (rows - 1) + 2 * r + 1
    tws = (stride * (TILE_W - 1) + 2 * r + 1) | 1  # odd: a warp's rows fall in other banks
    tile = (I_ * th * tws + 3) // 4 * 4
    slots = -(-OA // GROUP_W) * GROUP_W
    return 4 * (tile + sum(I_ * k * k * slots for k in ks))


def tile_rows(I_: int, ks, OA: int, stride: int = 1) -> int:
    """Output rows per block as ``csrc/dynconv.cu``'s ``pick_rows`` chooses
    them: the most of 32, 16, 8 at which two blocks share an SM, else the
    most that fit one block (8 if none fits)."""
    for limit in (SMEM_LIMIT // 2 - 1024, SMEM_LIMIT):
        for rows in (32, 16, 8):
            if _bytes(I_, ks, OA, rows, stride) <= limit:
                return rows
    return 8


def shared_bytes(I_: int, ks, OA: int, stride: int = 1) -> int:
    """Shared memory one block of the kernel takes: the fp32 input tile at
    :func:`tile_rows` rows and every branch's weights."""
    return _bytes(I_, ks, OA, tile_rows(I_, ks, OA, stride), stride)


def dynconv_branches_plain(x: torch.Tensor, ws, stride: int = 1) -> torch.Tensor:
    """Plain version: one fp32 conv per branch (padding ``k // 2``),
    concatenated, in x's dtype."""
    xf = x.float()
    outs = [F.conv2d(xf, w.float(), stride=stride, padding=w.shape[-1] // 2) for w in ws]
    return torch.cat(outs, 1).to(x.dtype)


def dynconv_branches(x: torch.Tensor, ws, stride: int = 1) -> torch.Tensor:
    """``x (N, I, H, W)`` bf16 and branch weights ``ws[b] (OA, I, k_b, k_b)``
    fp32 (``k_b`` in 1, 3, 5, 7, 11; at ``stride`` 2 one branch of k = 3)
    -> ``(N, len(ws)·OA, Ho, Wo)`` bf16, ``Ho = (H - 1) // stride + 1``.
    The kernel reads each ``ws[b]`` where it lies."""
    require(x.ndim == 4, f"dynconv_branches: x {tuple(x.shape)}")
    N, I_, H, W = x.shape
    require(1 <= len(ws) <= MAX_BRANCHES, f"dynconv_branches: {len(ws)} branches")
    OA = ws[0].shape[0]
    ks = [w.shape[-1] for w in ws]
    for w, k in zip(ws, ks):
        require(tuple(w.shape) == (OA, I_, k, k) and k in KERNEL_SIZES,
                f"dynconv_branches: weight {tuple(w.shape)} for I={I_}, OA={OA}, k in {KERNEL_SIZES}")
        require(w.dtype == torch.float32 and w.is_contiguous(), "dynconv_branches: weights must be contiguous fp32")
    require(OA in OUT_WIDTHS, f"dynconv_branches: OA={OA} not in {OUT_WIDTHS}")
    require(stride in STRIDES and (stride == 1 or ks == [3]),
            f"dynconv_branches: stride {stride} with k {ks}; stride 2 takes one 3 x 3 branch")
    require(x.dtype == torch.bfloat16 and x.is_contiguous(), "dynconv_branches: x must be contiguous bf16")
    require(shared_bytes(I_, ks, OA, stride) <= SMEM_LIMIT, "dynconv_branches: layer exceeds shared memory")
    if not on_card("dynconv_branches", x, *ws):
        return dynconv_branches_plain(x, ws, stride)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    out = torch.empty((N, len(ws) * OA, Ho, Wo), dtype=torch.bfloat16, device=x.device)
    kbuf = (ctypes.c_int * MAX_BRANCHES)(*ks)
    wbuf = (ctypes.c_void_p * MAX_BRANCHES)(*(w.data_ptr() for w in ws))
    lib, fn = entry("dynconv", "dynconv_launch", [P, P, P, I, I, I, I, I, I, P, I, P])
    err = fn(ptr(x), ctypes.cast(wbuf, ctypes.c_void_p), ptr(out), N, I_, H, W, OA, len(ws),
             ctypes.cast(kbuf, ctypes.c_void_p), stride, stream(x.device))
    _build.check(lib, err, "dynconv_branches")
    dynconv_branches.launches += 1
    return out


dynconv_branches.launches = 0
