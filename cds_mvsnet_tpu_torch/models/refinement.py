"""Image-conditioned depth refinement: 2x upsample plus a learned residual.

Counterpart of ``cds_mvsnet_tpu/models/refinement.py::refinement`` (:40-70).
Depth is normalised to [0, 10] by the scene range; conv0 runs on the
full-resolution reference image, conv1/conv2 on the half-resolution depth,
and a 2x transposed conv with BN+ReLU brings the depth branch up to the
image; the two concatenated give a residual that is added to a bilinear
(``align_corners=True``) 2x upsample of the normalised depth.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import resize_linear
from .layers import BatchNorm, ConvBnReLU2d, conv2d, deconv2d

__all__ = ["RefineNet"]


class RefineNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU2d(3, 8)
        self.conv1 = ConvBnReLU2d(1, 8)
        self.conv2 = ConvBnReLU2d(8, 8)
        self.deconv = nn.ConvTranspose2d(8, 8, 3, bias=False)
        self.bn = BatchNorm(8)
        self.conv3 = ConvBnReLU2d(16, 8)
        self.res = nn.Conv2d(8, 1, 3, bias=False)

    def forward(self, img, depth, depth_min, depth_max, stats=None):
        """``img (B,3,H,W)`` in the compute dtype, ``depth (B,H/2,W/2)`` and
        the range ``(B,)`` fp32 -> refined depth ``(B,H,W)`` fp32. ``stats``
        trains every BN on batch statistics."""
        H, W = img.shape[-2:]
        rng = (depth_max - depth_min)[:, None, None, None]
        d = (depth[:, None] - depth_min[:, None, None, None]) / rng * 10

        conv0 = self.conv0(img, stats)
        y = self.conv2(self.conv1(d.to(img.dtype), stats), stats)
        y = torch.relu(self.bn(deconv2d(y, self.deconv.weight), stats))
        res = conv2d(self.conv3(torch.cat([y, conv0], 1), stats), self.res.weight)

        up = resize_linear(d, (H, W), dims=(2, 3), align_corners=True)
        d = (up + res.to(d.dtype)) / 10
        return (d * rng + depth_min[:, None, None, None])[:, 0]
