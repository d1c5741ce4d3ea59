"""The numerical design of K2 in fp32 on the tensor cores, on the CPU.

K2's fp32 form (``conv3d_tf32_kernel`` in ``csrc/conv3d.cu``) runs the conv
as 3xTF32: each fp32 operand x, activation and weight, is split into ``hi =
tf32(x)`` and ``lo = tf32(x - hi)`` (``cvt.rna.tf32.f32``: 10 mantissa bits,
ties away from zero), and every K-step adds hi·hi, hi·lo and lo·hi into one
fp32 sum. A TF32 x TF32 product is exact in fp32, so ``tensor_core_model``
below, three fp32 convs of the split operands, is that arithmetic in plain
PyTorch up to the order of the sums. It must stay within the fp32 route's
card tolerance of ``conv3d_bn_relu_plain`` (``|d| <= 1e-5 sum|terms| +
1e-7``, ``chip_smoke.py`` and ``tests/test_torch_cuda.py``); one TF32 product
(hi·hi) and two (hi·hi + hi·lo) must not, which is why the kernel runs three.
The fp32 cascade with the model at conv0 must pass the serve gate against
the plain fp32 path. K7 in fp32 (``conv3d_down_tf32_kernel``) and K6's
conv1 run the same three products at stride 2 (``down_step`` in
``csrc/conv3d_tf32.cuh``): the model at stride 2 holds K2-fp32's tolerance
against ``conv3d_down_plain`` and one or two products miss it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.models import build_model, to_tensors
from cds_mvsnet_tpu_torch.models.stage_net import FP32_OPS, PLAIN_OPS
from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

torch.set_num_threads(2)

SHAPE = (6, 12, 37)  # D, h, w: no multiple of the kernel's 4x4x32 tile


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on finite fp32 values: add half of the 13 dropped
    bits' weight to the magnitude, then clear them (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split: hi = tf32(x), lo = tf32(x - hi), as fp32."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tensor_core_model(vol, w, b, products=("hh", "hl", "lh"), stride: int = 1) -> torch.Tensor:
    """K2-fp32's arithmetic (K7-fp32's at ``stride=2``): the chosen TF32
    products (``h``: hi, ``l``: lo; activation first, weight second) summed
    in fp32; bias, ReLU."""
    xs, ws = split(vol.float()), split(w)
    part = {"h": 0, "l": 1}
    y = sum(F.conv3d(xs[part[a]][None], ws[part[k]], stride=stride, padding=1)[0] for a, k in products)
    return torch.relu(y + b[:, None, None, None])


def excess_over_tolerance(got, vol, w, b, stride: int = 1) -> float:
    """max(|d| - (1e-5 sum|terms| + 1e-7)) against the plain version: <= 0
    within K2-fp32's tolerance."""
    want = K.conv3d_bn_relu_plain(vol, w, b, stride=stride)
    terms = F.conv3d(vol.abs()[None], w.abs(), stride=stride, padding=1)[0] + b.abs()[:, None, None, None]
    return float(((got - want).abs() - (1e-5 * terms + 1e-7)).max())


def rig(seed: int, C: int, O: int = 8):
    """An fp32 volume in [-1, 1) and folded weights as the card checks draw
    them: bound (27C)^-1/2, bias in +-0.1."""
    rng = np.random.default_rng(seed)
    vol = torch.from_numpy(rng.uniform(-1, 1, (C, *SHAPE)).astype(np.float32))
    bound = (27 * C) ** -0.5
    w = torch.from_numpy(rng.uniform(-bound, bound, (O, C, 3, 3, 3)).astype(np.float32))
    return vol, w, torch.from_numpy(rng.uniform(-0.1, 0.1, O).astype(np.float32))


def test_rna_rounds_ties_away_from_zero():
    one_ulp = 2.0 ** -10  # a TF32 ulp at 1
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 2 - 2 ** -23, 1 + 1.5 * one_ulp,
                      3.0, 0.0, -2.0 ** -130])
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp, 3.0, 0.0, -2.0 ** -130])
    assert torch.equal(tf32_rna(x), want)


def test_split_keeps_22_bits():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1 << 14).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert bool((part.view(torch.int32) & 0x1FFF == 0).all())  # TF32 values: 13 low bits clear
    assert bool(((x - hi).abs() <= 2 ** -11 * x.abs()).all())
    assert bool(((x - hi - lo).abs() <= 2 ** -22 * x.abs()).all())


@pytest.mark.parametrize("O", [8, 16])
@pytest.mark.parametrize("C", [8, 16, 32, 12])
def test_three_products_meet_the_tolerance(C, O):
    vol, w, b = rig(C + O, C, O)
    assert excess_over_tolerance(tensor_core_model(vol, w, b), vol, w, b) <= 0


@pytest.mark.parametrize("products", [("hh",), ("hh", "hl")])
@pytest.mark.parametrize("C", [8, 32])
def test_fewer_products_miss_the_tolerance(C, products):
    """Why the kernel runs three MMAs a K-step: one TF32 product, or hi·hi +
    hi·lo (the activation's rounding left in), errs by 2^-12 of a term."""
    vol, w, b = rig(C, C)
    assert excess_over_tolerance(tensor_core_model(vol, w, b, products), vol, w, b) > 0
    assert excess_over_tolerance(tensor_core_model(vol, w, b), vol, w, b) <= 0


@pytest.mark.parametrize("C,O", [(8, 16), (16, 8), (12, 16)])
def test_stride_two_three_products_meet_the_tolerance(C, O):
    """K7-fp32's arithmetic: the three products at stride 2 within K2-fp32's
    tolerance of ``conv3d_down_plain``, on an input of even D, h, w."""
    vol, w, b = rig(C + O + 1, C, O)
    vol = vol[:, :, :, :36].contiguous()
    assert excess_over_tolerance(tensor_core_model(vol, w, b, stride=2), vol, w, b, stride=2) <= 0


@pytest.mark.parametrize("products", [("hh",), ("hh", "hl")])
def test_stride_two_fewer_products_miss_the_tolerance(products):
    """One TF32 product, or two, miss K7-fp32's tolerance where outputs near
    0 come from large terms of both signs (inputs spanning 2^8, weights at
    4x the usual bound, no bias); the three products hold it."""
    vol, w, _ = rig(5, 8, 16)
    vol = (vol[:, :, :, :36] * torch.exp2(torch.from_numpy(
        np.random.default_rng(6).integers(-4, 5, (8, 6, 12, 36)).astype(np.float32)))).contiguous()
    w = w * 4
    b = torch.zeros(16)
    assert excess_over_tolerance(tensor_core_model(vol, w, b, products, stride=2), vol, w, b, stride=2) > 0
    assert excess_over_tolerance(tensor_core_model(vol, w, b, stride=2), vol, w, b, stride=2) <= 0


def test_fp32_cascade_with_the_model_passes_the_serve_gate():
    """The fp32 route's cascade (K9's and K3's sites on their plain
    versions) with conv0 on the 3xTF32 model against the plain fp32 path:
    stage-3 depth within 1 % (median) and 25 % (p99) of the plane interval,
    confidence within 1e-3 and 0.05."""
    model = build_model(ModelConfig(refine=False, ndepths=(48, 32, 8)), seed=0, device="cpu")
    b = to_tensors(textured_plane_batch(V=3, H=96, W=128, D=192, seed=0), "cpu")
    interval = float(b["depth_values"][0, 1] - b["depth_values"][0, 0])
    calls = []

    def conv0(vol, w, bias):
        calls.append(tuple(vol.shape))
        return tensor_core_model(vol, w, bias)

    def stage3(ops):
        with torch.no_grad():
            return model._cascade(b["imgs"], b["proj_matrices"], b["depth_values"], 0.001, torch.float32,
                                  ops=ops)["stage3"]

    got = stage3(dataclasses.replace(FP32_OPS, conv0=conv0))
    want = stage3(PLAIN_OPS)
    assert len(calls) == 3  # conv0 once per stage
    d = (got["depth"] - want["depth"]).abs().flatten() / interval
    c = (got["photometric_confidence"] - want["photometric_confidence"]).abs().flatten()
    assert float(d.median()) <= 0.01 and float(torch.quantile(d, 0.99)) <= 0.25
    assert float(c.median()) <= 1e-3 and float(torch.quantile(c, 0.99)) <= 0.05
