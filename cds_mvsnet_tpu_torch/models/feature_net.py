"""Dynamic-scale FPN feature extractor.

Counterpart of ``cds_mvsnet_tpu/models/feature_net.py``: six dynamic convs over
three scales, strided plain convs for downsampling, 1x1 lateral merges and a
DynamicConv + InstanceNorm + tanh head per stage. Per stage it returns
``(features, mean squared curvature, |curvature|)`` with 32/16/8 channels at
1/4, 1/2 and 1/1 of the input resolution.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import upsample2x_nearest
from ..utils.profiling import span
from .dynamic_conv import DynamicConv
from .layers import conv2d, instance_norm, leaky_relu

__all__ = ["FeatureNet", "FEATURE_OUT_CHANNELS", "k4_forms"]

BASE_CHANNELS = 8
FEATURE_OUT_CHANNELS = (BASE_CHANNELS * 4, BASE_CHANNELS * 2, BASE_CHANNELS)

# kernel sizes of each dynamic conv
DYN_KERNELS = {
    "conv00": (3, 7, 11),
    "conv01": (3, 5, 7),
    "conv10": (3, 5),
    "conv11": (3, 5),
    "conv20": (1, 3),
    "conv21": (1, 3),
    "out1": (1, 3),
    "out2": (1, 3),
    "out3": (1, 3),
}


def k4_forms(height: int, width: int) -> list[tuple]:
    """Each of the 13 convs as the feature route sends it to K4, for an
    input of ``height x width``: ``(layer, I, OA, branch kernel sizes,
    stride, input h, input w)``; ``OA`` is ``O + 3`` for a DynamicConv
    (conv || curvature coefficients) and ``O`` for a plain conv."""
    b = BASE_CHANNELS
    forms = [  # (layer, I, OA, ks, stride, input scale)
        ("conv00", 3, b + 3, DYN_KERNELS["conv00"], 1, 1), ("conv01", b, b + 3, DYN_KERNELS["conv01"], 1, 1),
        ("downsample1", b, 2 * b, (3,), 2, 1),
        ("conv10", 2 * b, 2 * b + 3, DYN_KERNELS["conv10"], 1, 2),
        ("conv11", 2 * b, 2 * b + 3, DYN_KERNELS["conv11"], 1, 2),
        ("downsample2", 2 * b, 4 * b, (3,), 2, 2),
        ("conv20", 4 * b, 4 * b + 3, DYN_KERNELS["conv20"], 1, 4),
        ("conv21", 4 * b, 4 * b + 3, DYN_KERNELS["conv21"], 1, 4),
        ("out1", 4 * b, 4 * b + 3, DYN_KERNELS["out1"], 1, 4),
        ("inner1", 6 * b, 2 * b, (1,), 1, 2), ("out2", 2 * b, 2 * b + 3, DYN_KERNELS["out2"], 1, 2),
        ("inner2", 3 * b, b, (1,), 1, 1), ("out3", b, b + 3, DYN_KERNELS["out3"], 1, 1),
    ]
    return [(name, i, oa, ks, stride, height // sc, width // sc) for name, i, oa, ks, stride, sc in forms]


class PlainBlock(nn.Module):
    """Bias-free conv + InstanceNorm + leaky_relu(0.1). ``branches``: None
    runs the conv in ``x``'s dtype; else a function of ``(x, [weight],
    stride=)`` (K4's wrapper or its plain version) runs it as one branch."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(cin, cout, k, bias=False)

    def forward(self, x, branches=None):
        if branches is None:
            y = conv2d(x, self.conv.weight, stride=self.stride)
        else:
            y = branches(x, [self.conv.weight.contiguous()], stride=self.stride)
        return leaky_relu(instance_norm(y))


class DynBlock(nn.Module):
    """Bias-free DynamicConv + InstanceNorm + leaky_relu(0.1)."""

    def __init__(self, cin: int, cout: int, name: str):
        super().__init__()
        self.conv = DynamicConv(cin, cout, DYN_KERNELS[name], bias=False)

    def forward(self, x, epipole, temperature, branches=None, **bn):
        y, nc = self.conv(x, epipole, temperature, branches, **bn)
        return leaky_relu(instance_norm(y)), nc


class FeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        b = BASE_CHANNELS
        self.conv00 = DynBlock(3, b, "conv00")
        self.conv01 = DynBlock(b, b, "conv01")
        self.downsample1 = PlainBlock(b, 2 * b, 3, stride=2)
        self.conv10 = DynBlock(2 * b, 2 * b, "conv10")
        self.conv11 = DynBlock(2 * b, 2 * b, "conv11")
        self.downsample2 = PlainBlock(2 * b, 4 * b, 3, stride=2)
        self.conv20 = DynBlock(4 * b, 4 * b, "conv20")
        self.conv21 = DynBlock(4 * b, 4 * b, "conv21")
        self.out1 = DynamicConv(4 * b, 4 * b, DYN_KERNELS["out1"], bias=True)
        self.inner1 = PlainBlock(6 * b, 2 * b, 1)
        self.out2 = DynamicConv(2 * b, 2 * b, DYN_KERNELS["out2"], bias=True)
        self.inner2 = PlainBlock(3 * b, b, 1)
        self.out3 = DynamicConv(b, b, DYN_KERNELS["out3"], bias=True)

    def forward(self, x, epipole, temperature: float, branches=None, stats=None, bn_groups: int = 1,
                bn_order=None):
        """``x (N,3,H,W)``, ``epipole (N,2)`` -> ``{stage: (feat, nc_sum, |nc|)}``.

        ``branches``: layer name (``warp_routes.FEATURE_LAYERS``) -> the
        function that runs that conv's branches in one call (K4's wrapper
        or its plain version); a layer not named runs one conv per branch.
        ``stats`` trains every attention BN, with statistics per group of
        ``N / bn_groups`` images (``layers.BatchNorm``). Under
        ``torch.profiler`` each block's call is the span
        ``cds.feature.<block>`` (``utils.profiling.span``).
        """
        route = (branches or {}).get
        bn = {"stats": stats, "groups": bn_groups, "order": bn_order}

        def dyn(name, x, epi):
            with span(f"cds.feature.{name}"):
                return getattr(self, name)(x, epi, temperature, route(name), **bn)

        def plain(name, x):
            with span(f"cds.feature.{name}"):
                return getattr(self, name)(x, route(name))

        def head(name, x, epi):
            with span(f"cds.feature.{name}"):
                out, nc = getattr(self, name)(x, epi, temperature, route(name), **bn)
            return torch.tanh(instance_norm(out)), nc

        conv00, nc00 = dyn("conv00", x, epipole)
        conv01, nc01 = dyn("conv01", conv00, epipole)
        epi0 = epipole / 2
        conv10, nc10 = dyn("conv10", plain("downsample1", conv01), epi0)
        conv11, nc11 = dyn("conv11", conv10, epi0)
        epi1 = epipole / 4
        conv20, nc20 = dyn("conv20", plain("downsample2", conv11), epi1)
        conv21, nc21 = dyn("conv21", conv20, epi1)

        outputs = {}
        intra = conv21
        out, nc22 = head("out1", intra, epi1)
        outputs["stage1"] = (out, (nc20**2 + nc21**2 + nc22**2) / 3, nc22.abs())

        intra = plain("inner1", torch.cat([upsample2x_nearest(intra), conv11], 1))
        out, nc12 = head("out2", intra, epi0)
        outputs["stage2"] = (out, (nc10**2 + nc11**2 + nc12**2) / 3, nc12.abs())

        intra = plain("inner2", torch.cat([upsample2x_nearest(out), conv01], 1))
        out, nc02 = head("out3", intra, epipole)
        outputs["stage3"] = (out, (nc00**2 + nc01**2 + nc02**2) / 3, nc02.abs())
        return outputs
