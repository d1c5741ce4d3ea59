"""3-D cost-volume regularisation UNet.

Counterpart of ``cds_mvsnet_tpu/models/cost_reg.py::cost_reg_net``: three
stride-2 downsamples, three transposed-conv upsamples with skip sums, and a
bias-free 1-channel prob conv. At eval, conv0 runs with its BN folded into
the weights (``fold_bn_into_conv3d``), through K2's wrapper or its plain
version; conv1 ... conv11 and the skip sums run on
``F.conv3d``/``F.conv_transpose3d`` (the JAX package left them to XLA), and
the prob conv and the softmax tail are K3's (``models/stage_net.py``).
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

    def folded_conv0(self):
        """conv0's ``(w, b)`` with its eval BN folded in, fp32."""
        bn = self.conv0.bn
        return fold_bn_into_conv3d(
            self.conv0.conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var
        )

    def forward(self, vol, conv0):
        """UNet exit, the conv0 + deconv11 skip sum: ``vol (C, D, h, w)`` ->
        ``(b, D, h, w)``. ``conv0(vol, w, b)`` is K2's wrapper or its plain
        version."""
        x = conv0(vol, *self.folded_conv0())[None].to(memory_format=torch.channels_last_3d)
        conv2 = self.conv2(self.conv1(x))
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
