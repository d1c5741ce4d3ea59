"""Layers: convolutions, normalisation, activations (NCHW/NCDHW).

Counterpart of ``cds_mvsnet_tpu/models/layers.py``. Parameters stay fp32;
a convolution casts its weight to the activation dtype, as the JAX package
does, so one module runs the fp32 and the bf16 path. Module and parameter
names follow the upstream ``state_dict`` paths, which the JAX param tree
also uses, so ``models.convert`` maps leaves one to one.

BatchNorm runs in eval mode on its running statistics unless it is given a
:class:`StatsCollector`; then it normalises with the batch statistics
(biased variance) and records them, and the collector moves the running
statistics (unbiased variance, momentum 0.1) once, when the train step
calls :meth:`StatsCollector.apply` after the optimizer step. Nothing is
written in place during the forward, so a forward that runs twice (the
FeatureNet under ``torch.utils.checkpoint``) cannot move a statistic twice.

A collector made with a process group (data-parallel training, one batch
slice a rank) makes the batch statistics global, as the JAX package's
``batch_norm`` with ``axis_name`` does: the sums and the count are taken
over every rank's slice, per stack group, and the gradient flows through
them (:func:`global_sum`). Without one, ``F.batch_norm`` runs as before.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

__all__ = [
    "conv2d",
    "conv3d",
    "deconv2d",
    "deconv3d",
    "instance_norm",
    "batch_norm",
    "batch_norm_train",
    "global_sum",
    "leaky_relu",
    "StatsCollector",
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


def deconv2d(x, weight):
    """Transposed 2-D conv, ``weight (I, O, 3, 3)``: stride 2, padding 1,
    output_padding 1 (doubles H, W)."""
    return F.conv_transpose2d(x, weight.to(x.dtype), stride=2, padding=1, output_padding=1)


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


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, differentiably: the
    gradient that reaches each rank's ``t`` is the sum of every rank's
    gradient of the result, so that each rank's backward of its own loss
    share gives its part of the gradient of the total."""
    return _GlobalSum.apply(t, group)


def _batch_norm_global(xg, weight, bias, eps: float, group):
    """Train BatchNorm of ``xg (N, C, ...)`` on the statistics of every
    rank's slice: the mean from the global sum and count, then the biased
    variance from the global sum of squared deviations (two passes, as
    ``F.batch_norm`` is accurate where E[x²] − E[x]² cancels)."""
    dims = (0, *range(2, xg.ndim))
    shape = (1, -1) + (1,) * (xg.ndim - 2)
    xf = xg.float()
    n = xf.numel() // xf.shape[1] * dist.get_world_size(group)
    mean = global_sum(xf.sum(dims), group) / n
    dev = xf - mean.reshape(shape)
    var = global_sum(dev.square().sum(dims), group) / n
    out = dev * torch.rsqrt(var + eps).reshape(shape) * weight.float().reshape(shape) + bias.float().reshape(shape)
    return out.to(xg.dtype), mean.detach(), (var * (n / max(n - 1, 1))).detach()


def batch_norm_train(x, weight, bias, groups: int = 1, eps: float = 1e-5, group=None):
    """Train BatchNorm over every dim but channel 1, on batch statistics.

    ``groups > 1`` splits the leading dim into that many equal groups, each
    with statistics of its own (one group per upstream module call that the
    stacked batch folds together). Returns ``(out, mean (G, C), var (G, C))``
    with the unbiased batch variance, for the running-statistics update.
    ``group``: a process group over whose ranks' slices the statistics are
    taken (:func:`_batch_norm_global`).
    """
    N, C = x.shape[:2]
    G = groups
    rest = x.shape[2:]
    if G > 1:  # fold the groups into channels: (n, G·C, ...)
        xg = x.reshape(G, N // G, C, *rest).transpose(0, 1).reshape(N // G, G * C, *rest)
        weight, bias = weight.repeat(G), bias.repeat(G)
    else:
        xg = x
    if group is not None:
        out, mean, var = _batch_norm_global(xg, weight, bias, eps, group)
    else:
        # F.batch_norm with momentum 1 leaves the batch mean and the unbiased
        # batch variance in these fresh buffers; the model's buffers stay as
        # they are
        mean = torch.zeros(G * C, dtype=torch.float32, device=x.device)
        var = torch.ones(G * C, dtype=torch.float32, device=x.device)
        out = F.batch_norm(xg, mean, var, weight.float(), bias.float(), training=True, momentum=1.0, eps=eps)
    if G > 1:
        out = out.reshape(N // G, G, C, *rest).transpose(0, 1).reshape(x.shape)
    return out, mean.reshape(G, C), var.reshape(G, C)


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


class StatsCollector:
    """Batch statistics of train-mode BatchNorm calls, in call order.

    Each call records ``(module, mean (G, C), var (G, C), order)``;
    ``order[g]`` is the upstream call index of stack group g.
    :meth:`apply` moves each module's running statistics by one EMA step per
    upstream call, in call order, as torch's BatchNorm does per forward.
    ``group``: the process group whose ranks' slices the statistics span
    (None: this process's batch alone).
    """

    def __init__(self, group=None):
        self.calls: list = []
        self.group = group

    def add(self, bn: "BatchNorm", mean, var, order=None) -> None:
        G = mean.shape[0]
        self.calls.append((bn, mean, var, tuple(range(G)) if order is None else tuple(order)))

    @torch.no_grad()
    def apply(self, momentum: float = 0.1) -> None:
        """``r <- (1-m)^G r + sum_g m (1-m)^(G-1-order[g]) batch_g`` per call:
        the closed form of G sequential updates."""
        for bn, mean, var, order in self.calls:
            G = len(order)
            w = torch.tensor([momentum * (1 - momentum) ** (G - 1 - k) for k in order],
                             dtype=torch.float32, device=mean.device)
            decay = (1 - momentum) ** G
            bn.running_mean.copy_(decay * bn.running_mean + w @ mean)
            bn.running_var.copy_(decay * bn.running_var + w @ var)


class BatchNorm(nn.Module):
    """BatchNorm holding exactly the four leaves the param tree has: eval on
    running statistics, or train on batch statistics when ``stats`` is
    given (``groups``/``order`` as :func:`batch_norm_train` and
    :class:`StatsCollector`)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, stats: StatsCollector | None = None, groups: int = 1, order=None):
        if stats is None:
            return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var)
        out, mean, var = batch_norm_train(x, self.weight, self.bias, groups, group=stats.group)
        stats.add(self, mean, var, order)
        return out


class ConvBnReLU2d(nn.Module):
    """Bias-free 2-D conv + BN + ReLU."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x, stats=None):
        return torch.relu(self.bn(conv2d(x, self.conv.weight), stats))


class ConvBnReLU3d(nn.Module):
    """Bias-free 3x3x3 conv (stride 1 or 2) + BN + ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv3d(cin, cout, 3, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x, stats=None):
        return torch.relu(self.bn(conv3d(x, self.conv.weight, stride=self.stride), stats))


class DeconvBnReLU3d(nn.Module):
    """2x transposed 3x3x3 conv + BN + ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.ConvTranspose3d(cin, cout, 3, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x, stats=None):
        return torch.relu(self.bn(deconv3d(x, self.conv.weight), stats))


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the JAX package's rules: conv weights and biases
    ``U(±1/sqrt(fan_in))`` (fan_in of a transposed conv counts its outputs),
    BN at identity, curvature-coefficient convs ``N(0, 0.1)``."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)):
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
