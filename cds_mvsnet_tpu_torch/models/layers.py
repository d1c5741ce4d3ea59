"""Eval-mode layers: convolutions, normalisation, activations (NCHW/NCDHW).

Counterpart of ``cds_mvsnet_tpu/models/layers.py``. Parameters stay fp32;
a convolution casts its weight to the activation dtype, as the JAX package
does, so one module runs the fp32 and the bf16 path. Module and parameter
names follow the upstream ``state_dict`` paths, which the JAX param tree
also uses, so ``models.convert`` maps leaves one to one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "conv2d",
    "conv3d",
    "deconv3d",
    "instance_norm",
    "batch_norm",
    "leaky_relu",
    "BatchNorm",
    "ConvBnReLU2d",
    "ConvBnReLU3d",
    "DeconvBnReLU3d",
    "reset_parameters",
]


def conv2d(x, weight, bias=None, stride: int = 1, padding: int | None = None):
    """2-D conv, ``weight (O, I, kh, kw)``; "same" padding by default."""
    if padding is None:
        padding = (weight.shape[-1] - 1) // 2
    b = None if bias is None else bias.to(x.dtype)
    return F.conv2d(x, weight.to(x.dtype), b, stride=stride, padding=padding)


def conv3d(x, weight, stride: int = 1, padding: int = 1):
    """3-D conv, ``weight (O, I, kd, kh, kw)``, no bias."""
    return F.conv3d(x, weight.to(x.dtype), stride=stride, padding=padding)


def deconv3d(x, weight):
    """Transposed 3-D conv, ``weight (I, O, 3, 3, 3)``: stride 2, padding 1,
    output_padding 1 (doubles D, H, W)."""
    return F.conv_transpose3d(x, weight.to(x.dtype), stride=2, padding=1, output_padding=1)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free InstanceNorm: per-sample, per-channel statistics over the
    spatial dims (at eval too), computed in fp32."""
    dims = tuple(range(2, x.ndim))
    xf = x.float()
    mean = xf.mean(dims, keepdim=True)
    var = xf.var(dims, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def batch_norm(x, weight, bias, running_mean, running_var, eps: float = 1e-5):
    """Eval BatchNorm on running statistics over channel dim 1."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    scale = torch.rsqrt(running_var.float() + eps).to(x.dtype).reshape(shape)
    out = (x - running_mean.to(x.dtype).reshape(shape)) * scale
    return out * weight.to(x.dtype).reshape(shape) + bias.to(x.dtype).reshape(shape)


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


class BatchNorm(nn.Module):
    """Eval BatchNorm holding exactly the four leaves the param tree has."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var)


class ConvBnReLU2d(nn.Module):
    """Bias-free 2-D conv + eval BN + ReLU."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return torch.relu(self.bn(conv2d(x, self.conv.weight)))


class ConvBnReLU3d(nn.Module):
    """Bias-free 3x3x3 conv (stride 1 or 2) + eval BN + ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv3d(cin, cout, 3, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return torch.relu(self.bn(conv3d(x, self.conv.weight, stride=self.stride)))


class DeconvBnReLU3d(nn.Module):
    """2x transposed 3x3x3 conv + eval BN + ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.ConvTranspose3d(cin, cout, 3, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return torch.relu(self.bn(deconv3d(x, self.conv.weight)))


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the JAX package's rules: conv weights and biases
    ``U(±1/sqrt(fan_in))`` (fan_in of a transposed conv counts its outputs),
    BN at identity, curvature-coefficient convs ``N(0, 0.1)``."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
            w = m.weight
            receptive = math.prod(w.shape[2:])
            # (O, I, k...) for a conv, (I, O, k...) for a transposed conv
            fan_in = w.shape[1] * receptive
            bound = 1.0 / math.sqrt(fan_in)
            with torch.no_grad():
                if ".att_convs." in f".{name}":
                    w.copy_(0.1 * torch.randn(w.shape, generator=generator))
                else:
                    w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * bound)
                if m.bias is not None:
                    m.bias.copy_((torch.rand(m.bias.shape, generator=generator) * 2 - 1) * bound)
        elif isinstance(m, BatchNorm):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
