"""K2: cost-regularisation conv0, ``relu(conv3d_3x3x3(vol) + b)`` with eval
BatchNorm folded into ``(w, b)``, on a bf16 volume (the bf16 route) or an
fp32 one (the fp32 route); the output has the volume's dtype.

Replaces ``cds_mvsnet_tpu/ops/pallas/conv3d.py::conv3d_front`` (:159, body
``_conv3d_kernel`` :68). Kernel source: ``csrc/conv3d.cu``.

Bound on the H100: memory, at the bf16 tensor-core rate. It reads the
``(C, D, h, w)`` volume and writes ``(8, D, h, w)``: about 239 / 382 / 255 MB
per launch at stages 1/2/3 of the 1152x864 main path (71 / 114 / 76 µs at
3.35 TB/s) for 41 / 55 / 28 GFLOP. Design, first and simple: one thread per
output voxel computes all 8 outputs with fp32 FMAs; the 27·C·8 folded
weights (27 KB at C=32) sit in shared memory in ``[c][tap][o]`` order, so the
8 weights of a tap are one broadcast read; neighbouring threads read
neighbouring voxels along w, and the 27-fold reuse of each input voxel is left
to the L1 cache. The CUDA cores' fp32 rate, not memory, limits this version;
a ``wgmma`` form over shared-memory tiles is later work. The TPU kernel's
three pre-shifted volume copies and 8-row DMA windows are Mosaic mechanics and
are not carried over. The fp32 instantiation is the same body on fp32
loads and stores (twice the bytes). The TPU kernel rounds an fp32 volume to
bf16 for its matrix unit (``conv3d.py:186-187,198``); that is an input
format of the TPU, not the function, so the port's fp32 route stays fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._launch import I, P, entry, on_card, ptr, require, stream

__all__ = ["conv3d_bn_relu", "conv3d_bn_relu_plain", "fold_bn_into_conv3d"]

O = 8


def fold_bn_into_conv3d(weight, bn_weight, bn_bias, running_mean, running_var, eps: float = 1e-5):
    """Fold eval BatchNorm into a bias-free conv: ``(w (O,C,3,3,3), b (O,))``
    in fp32."""
    inv = bn_weight.float() / torch.sqrt(running_var.float() + eps)
    w = weight.float() * inv[:, None, None, None, None]
    b = bn_bias.float() - running_mean.float() * inv
    return w.contiguous(), b.contiguous()


def conv3d_bn_relu_plain(vol: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 conv of the volume, bias, ReLU, back to its dtype."""
    y = F.conv3d(vol.float()[None], w.float(), padding=1)[0] + b.float()[:, None, None, None]
    return torch.relu(y).to(vol.dtype)


def conv3d_bn_relu(vol: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``vol (C, D, h, w)`` bf16 or fp32 -> ``(8, D, h, w)`` in vol's dtype;
    ``w (8, C, 3, 3, 3)`` and ``b (8,)`` fp32 with BN folded
    (:func:`fold_bn_into_conv3d`)."""
    require(vol.ndim == 4, f"conv3d_bn_relu: vol {tuple(vol.shape)}")
    C, D, h, wd = vol.shape
    require(tuple(w.shape) == (O, C, 3, 3, 3), f"conv3d_bn_relu: w {tuple(w.shape)} for C={C}")
    require(tuple(b.shape) == (O,), f"conv3d_bn_relu: b {tuple(b.shape)}")
    require(C * 27 * O * 4 <= 48 * 1024, f"conv3d_bn_relu: C={C} weights exceed shared memory")
    require(vol.dtype in (torch.bfloat16, torch.float32), "conv3d_bn_relu: vol must be bf16 or fp32")
    require(w.dtype == b.dtype == torch.float32, "conv3d_bn_relu: w and b must be fp32")
    require(all(t.is_contiguous() for t in (vol, w, b)), "conv3d_bn_relu: inputs must be contiguous")
    if not on_card("conv3d_bn_relu", vol, w, b):
        return conv3d_bn_relu_plain(vol, w, b)
    out = torch.empty((O, D, h, wd), dtype=vol.dtype, device=vol.device)
    name = "conv3d_bn_relu_f32_launch" if vol.dtype == torch.float32 else "conv3d_bn_relu_launch"
    lib, fn = entry("conv3d", name, [P, P, P, P, I, I, I, I, P])
    err = fn(ptr(vol), ptr(w), ptr(b), ptr(out), C, D, h, wd, stream(vol.device))
    _build.check(lib, err, "conv3d_bn_relu")
    conv3d_bn_relu.launches += 1
    return out


conv3d_bn_relu.launches = 0
