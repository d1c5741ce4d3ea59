"""3-D cost-volume regularisation UNet.

Counterpart of ``cds_mvsnet_tpu/models/cost_reg.py::cost_reg_net``: three
stride-2 downsamples, three transposed-conv upsamples with skip sums, and a
bias-free 1-channel prob conv. At eval, conv0 runs with its BN folded into
the weights (``fold_bn_into_conv3d``), through K2's wrapper or its plain
version; conv1 ... conv11 and the skip sums run on
``F.conv3d``/``F.conv_transpose3d`` (the JAX package left them to XLA), and
the prob conv and the softmax tail are K3's (``models/stage_net.py``).
The front (``models/warp_routes.py``; ``cost_reg_net_s2d``'s
``CDS_COSTREG_FRONT`` ladder, ``cds_mvsnet_tpu/models/cost_reg.py:151-252``)
moves conv1, and conv2, onto kernels as well: ``pallasf``/``pallasf3`` run
conv0 and conv1 on K6 where D, h and w are even (else conv0 alone on K2, as
the JAX package falls back), ``pallas2``/``pallas3`` conv0 on K2 and conv1
on K7 where they are even, the ``3`` forms also conv2 on K2 at 16 output
channels, and ``s2d`` conv0 on cuDNN. Their outputs re-enter the cuDNN UNet
where the JAX package's re-enter its s2d UNet.
Training (:meth:`CostRegNet.train_logits`) trains every BN, conv0's too, on
batch statistics, so K2, which folds eval BN, stays eval-only; the prob conv
is a plain ``F.conv3d``, as in the JAX train step.

The UNet runs channels-last (``torch.channels_last_3d``): in NCDHW bf16,
cuDNN runs conv11's 16 -> 8 transposed conv3d with a slow direct kernel on
the H100, channels-last with an implicit GEMM (``PERF.md``, from the profile
phase of ``chip_smoke.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import kernels as K
from ..ops.kernels import fold_bn_into_conv3d
from .layers import ConvBnReLU3d, DeconvBnReLU3d, conv3d

__all__ = ["CostRegNet"]


class CostRegNet(nn.Module):
    def __init__(self, in_channels: int, base_channels: int = 8):
        super().__init__()
        b = base_channels
        self.conv0 = ConvBnReLU3d(in_channels, b)
        self.conv1 = ConvBnReLU3d(b, 2 * b, stride=2)
        self.conv2 = ConvBnReLU3d(2 * b, 2 * b)
        self.conv3 = ConvBnReLU3d(2 * b, 4 * b, stride=2)
        self.conv4 = ConvBnReLU3d(4 * b, 4 * b)
        self.conv5 = ConvBnReLU3d(4 * b, 8 * b, stride=2)
        self.conv6 = ConvBnReLU3d(8 * b, 8 * b)
        self.conv7 = DeconvBnReLU3d(8 * b, 4 * b)
        self.conv9 = DeconvBnReLU3d(4 * b, 2 * b)
        self.conv11 = DeconvBnReLU3d(2 * b, b)
        self.prob = nn.Conv3d(b, 1, 3, bias=False)

    def folded(self, name: str = "conv0"):
        """The ``(w, b)`` of a ConvBnReLU3d layer with its eval BN folded in,
        fp32."""
        layer = getattr(self, name)
        bn = layer.bn
        return fold_bn_into_conv3d(layer.conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)

    def front(self, vol, conv0, front: str = "pallas"):
        """The UNet's first layers under ``front``: ``(conv0, conv2)``, each
        ``(1, O, D', h', w')`` channels-last."""
        _, D, h, w = vol.shape
        even = D % 2 == 0 and h % 2 == 0 and w % 2 == 0
        y1 = y2 = None
        if front == "s2d":
            x = self.conv0(vol[None].to(memory_format=torch.channels_last_3d))
        else:
            if front.startswith("pallasf") and even:
                x, y1 = K.conv3d_front_fused(vol, *self.folded("conv0"), *self.folded("conv1"))
            else:
                x = conv0(vol, *self.folded("conv0"))
            if y1 is None and front in ("pallas2", "pallas3") and even:
                y1 = K.conv3d_down(x, *self.folded("conv1"))
            if y1 is not None and front.endswith("3"):
                y2 = K.conv3d_bn_relu(y1, *self.folded("conv2"))
            x = x[None].to(memory_format=torch.channels_last_3d)
        if y2 is not None:
            return x, y2[None].to(memory_format=torch.channels_last_3d)
        y1 = self.conv1(x) if y1 is None else y1[None].to(memory_format=torch.channels_last_3d)
        return x, self.conv2(y1)

    def forward(self, vol, conv0, front: str = "pallas"):
        """UNet exit, the conv0 + deconv11 skip sum: ``vol (C, D, h, w)`` ->
        ``(b, D, h, w)``. ``conv0(vol, w, b)`` is K2's wrapper or its plain
        version; ``front`` names the first layers' kernels (module note)."""
        x, conv2 = self.front(vol, conv0, front)
        conv4 = self.conv4(self.conv3(conv2))
        y = self.conv6(self.conv5(conv4))
        y = conv4 + self.conv7(y)
        y = conv2 + self.conv9(y)
        y = x + self.conv11(y)
        return y[0].contiguous()

    def train_logits(self, vol, stats):
        """Train form: ``vol (B, C, D, h, w)`` -> prob-conv logits
        ``(B, D, h, w)`` in vol's dtype; every BN records into ``stats``."""
        x = self.conv0(vol.to(memory_format=torch.channels_last_3d), stats)
        conv2 = self.conv2(self.conv1(x, stats), stats)
        conv4 = self.conv4(self.conv3(conv2, stats), stats)
        y = self.conv6(self.conv5(conv4, stats), stats)
        y = conv4 + self.conv7(y, stats)
        y = conv2 + self.conv9(y, stats)
        y = x + self.conv11(y, stats)
        return conv3d(y, self.prob.weight)[:, 0]
