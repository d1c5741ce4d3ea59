"""K5's fixed-point ``d_src`` (``csrc/warp_vjp.cu``), modelled in plain
PyTorch on the CPU, as ``tests/test_torch_conv3d_split.py`` models K2.

The kernel adds each flushed fp32 corner sum as ``llrint(sum·2^S)`` with
64-bit integer atomics, ``S`` the largest with ``B·2^S < 2^62`` for ``B =
D·h·w·(max|g_in_prod| + max|g_sim|)·max|ref|``, and turns each int64 total
into fp32, then bf16 (``fixed_point_shift``, ``to_fixed`` and
``from_fixed`` below mirror ``k5::fixed_point``, ``add_fixed`` and the
finishing kernel). Here every term is its own flush, the finest split the
kernel can make: the model sums each source value's terms as integers, in
any order.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from cds_mvsnet_tpu_torch.ops.kernels.warp import _chunk, project
from cds_mvsnet_tpu_torch.ops.kernels.warp_vjp import warp_sim_backward_plain


def fixed_point_shift(max_g_in_prod: float, max_g_sim: float, max_ref: float, D: int, hw: int) -> int | None:
    """``S`` of K5's fixed-point ``d_src`` (``k5::fixed_point``): the
    largest with ``B·2^S < 2^62``, ``B = D·hw·(max_g_in_prod +
    max_g_sim)·max_ref`` in float64; 0 where ``B`` is 0 and None where it
    is not finite (then ``d_src`` is NaN)."""
    b = float(D) * float(hw) * (float(max_g_in_prod) + float(max_g_sim)) * float(max_ref)
    if not math.isfinite(b):
        return None
    return 62 - math.frexp(b)[1] if b > 0 else 0  # frexp's exponent is ilogb + 1


def to_fixed(sums: torch.Tensor, shift: int) -> torch.Tensor:
    """The int64 addends of fp32 ``sums``: ``llrint(sums·2^shift)`` in
    float64 (round half to even), as a flush adds them."""
    return torch.round(sums.double() * 2.0 ** shift).to(torch.int64)


def from_fixed(total: torch.Tensor, shift: int) -> torch.Tensor:
    """bf16 of int64 ``total·2^-shift``: int64 to fp32, the exact scaling in
    float64, then bf16, as the finishing kernel rounds."""
    return (total.float().double() * 2.0 ** -shift).float().to(torch.bfloat16)


RT = (1.01, 0.02, -1.5, -0.015, 0.99, 2.0, 1e-4, -2e-4, 1.0, 8.0, -4.0, 0.05)
BF16_MAX = float(torch.finfo(torch.bfloat16).max)
BF16_TINY = float(torch.finfo(torch.bfloat16).smallest_normal)


def rig(seed: int, C: int = 8, D: int = 7, per_pixel: bool = True):
    """The card tests' warp: a 23x41 source, a 19x37 reference, a homography
    that pushes some samples out of view; seeded bf16 features and
    cotangents."""
    rng = np.random.default_rng(seed)
    H, W, h, w = 23, 41, 19, 37

    def bf16(*shape):
        return torch.as_tensor(rng.uniform(-1, 1, shape), dtype=torch.float32).to(torch.bfloat16)

    depth = torch.linspace(2.0, 40.0, D)
    if per_pixel:
        depth = (depth[:, None, None] * torch.as_tensor(rng.uniform(0.8, 1.2, (1, h, w)), dtype=torch.float32))
    g_sim = torch.as_tensor(rng.uniform(-1, 1, (D, h, w)), dtype=torch.float32)
    return bf16(H, W, C), bf16(C, h, w), depth.contiguous(), torch.tensor(RT), bf16(C, D, h, w), g_sim


def terms(src, ref, depth, rt, g_in_prod, g_sim):
    """Every ``(source row, fp32 term)`` of ``d_src``, as the plain backward
    forms them: ``w_k·(g_in_prod + g_sim)·ref`` for each pixel, plane and
    corner in bounds."""
    H, W, C = src.shape
    _, h, w = ref.shape
    D = depth.shape[0]
    ref_t = ref.float().permute(1, 2, 0)
    rows, vals = [], []
    step = _chunk(D, h, w, C)
    for d0 in range(0, D, step):
        px, py = project(rt, depth[d0 : d0 + step], h, w)
        n = px.numel()
        x0, y0 = torch.floor(px), torch.floor(py)
        tx, ty = px - x0, py - y0
        g = (g_in_prod[:, d0 : d0 + step].float() + g_sim[None, d0 : d0 + step].float()).permute(1, 2, 3, 0)
        gw = (g * ref_t).reshape(n, C)
        for ox, oy, wk in ((0, 0, (1 - tx) * (1 - ty)), (1, 0, tx * (1 - ty)),
                           (0, 1, (1 - tx) * ty), (1, 1, tx * ty)):
            xi, yi = x0 + ox, y0 + oy
            inb = ((xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)).reshape(n)
            rows.append((yi * W + xi).reshape(n)[inb].to(torch.int64))
            vals.append((gw * wk.reshape(n)[:, None])[inb])
    return torch.cat(rows), torch.cat(vals)


def shift_of(src, ref, depth, g_in_prod, g_sim) -> int:
    """The kernel's S, from the maxima its first pass reduces."""
    _, h, w = ref.shape
    return fixed_point_shift(float(g_in_prod.float().abs().max()), float(g_sim.abs().max()),
                             float(ref.float().abs().max()), depth.shape[0], h * w)


def fixed_sum(rows, vals, n_rows: int, shift: int, order=None) -> torch.Tensor:
    """The int64 totals of ``vals`` by row, the addends taken in ``order``."""
    if order is not None:
        rows, vals = rows[order], vals[order]
    return torch.zeros((n_rows, vals.shape[1]), dtype=torch.int64).index_add_(0, rows, to_fixed(vals, shift))


@pytest.mark.parametrize("C,per_pixel", [(8, True), (32, False)])
def test_fixed_point_sum_is_the_same_in_every_order(C, per_pixel):
    """The integer sums of one seeded backward's terms have the same bits
    under 20 random permutations of the terms; the fp32 sums the kernel made
    before do not."""
    src, ref, depth, rt, g_ip, g_sim = rig(1, C=C, per_pixel=per_pixel)
    rows, vals = terms(src, ref, depth, rt, g_ip, g_sim)
    n_rows = src.shape[0] * src.shape[1]
    S = shift_of(src, ref, depth, g_ip, g_sim)
    first = fixed_sum(rows, vals, n_rows, S)
    gen = torch.Generator().manual_seed(0)
    fp32_first = torch.zeros((n_rows, C)).index_add_(0, rows, vals)
    fp32_differs = False
    for _ in range(20):
        order = torch.randperm(rows.numel(), generator=gen)
        assert torch.equal(fixed_sum(rows, vals, n_rows, S, order), first)
        fp32 = torch.zeros((n_rows, C)).index_add_(0, rows[order], vals[order])
        fp32_differs |= not torch.equal(fp32, fp32_first)
    assert fp32_differs


@pytest.mark.parametrize("seed,C,per_pixel", [(2, 8, True), (3, 16, False), (4, 32, True)])
def test_fixed_point_d_src_within_k5_tolerance(seed, C, per_pixel):
    """bf16 of the fixed-point totals against the plain backward's fp32
    ``index_add_`` sums, within the card tests' tolerance of K5's backward
    (2^-7 of |plain| + the sum of |terms|, + 1e-6), and within 2^-30 of the
    sum of |terms| of the exact (fp64) sum before the bf16 rounding."""
    src, ref, depth, rt, g_ip, g_sim = rig(seed, C=C, per_pixel=per_pixel)
    H, W, _ = src.shape
    rows, vals = terms(src, ref, depth, rt, g_ip, g_sim)
    S = shift_of(src, ref, depth, g_ip, g_sim)
    total = fixed_sum(rows, vals, H * W, S)
    got = from_fixed(total, S).reshape(H, W, C)
    want = warp_sim_backward_plain(src, ref, depth, rt, g_ip, g_sim)[0]
    scale = warp_sim_backward_plain(src.abs(), ref.abs(), depth, rt, g_ip.abs(), g_sim.abs())[0]
    assert bool(((got.float() - want.float()).abs() <= 2 ** -7 * (want.float().abs() + scale.float()) + 1e-6).all())
    exact = torch.zeros((H * W, C), dtype=torch.float64).index_add_(0, rows, vals.double())
    abs_sum = torch.zeros((H * W, C), dtype=torch.float64).index_add_(0, rows, vals.double().abs())
    assert bool(((total.double() * 2.0 ** -S - exact).abs() <= 2 ** -30 * abs_sum + 2.0 ** -S * rows.numel()).all())
    assert int((got != 0).sum()) > C * 100


def worst_case(max_g_in_prod: float, max_g_sim: float, max_ref: float, D: int, hw: int):
    """S, and the largest total that D·hw terms of the largest magnitude
    the maxima allow (every bilinear weight 1, every term into one source
    value) can reach in fixed point, exactly (Python integers)."""
    S = fixed_point_shift(max_g_in_prod, max_g_sim, max_ref, D, hw)
    t = np.float32(np.float32(np.float32(max_g_in_prod) + np.float32(max_g_sim)) * np.float32(max_ref))
    if not math.isfinite(float(t)):
        return S, None
    addend = round(Fraction(float(t)) * Fraction(2) ** S)  # llrint: half to even
    return S, D * hw * addend


@pytest.mark.parametrize("max_g_in_prod,max_g_sim,max_ref", [
    (1.0, 1.0, 1.0),  # the card tests' uniform draws
    (BF16_MAX, 0.0, 1.0),  # the largest bf16 cotangent
    (BF16_MAX / 2, 3e38 / 2, 1.0),  # both cotangents near the top, their fp32 sum finite
    (1.0, 0.0, BF16_MAX),  # the largest bf16 feature
    (BF16_TINY, 0.0, BF16_TINY),  # bf16's smallest normals: the product underflows
    (2.0 ** -126, 2.0 ** -140, 1.0),  # fp32's smallest normal cotangent, a subnormal g_sim
    (3.0e-5, 0.0, 2.0 ** -100),
])
def test_scale_cannot_overflow_at_the_largest_train_shape(max_g_in_prod, max_g_sim, max_ref):
    """At the largest train shape (stage 1 of the 512x640 crop without
    refinement: D = 48, 128 x 160, C = 32), S keeps the largest total D·h·w
    terms could reach below 2^62, so no int64 sum overflows; S is the
    largest such (one more doubles past 2^62); the scale and its inverse are
    float64 powers of two (|S| <= 1000)."""
    D, hw = 48, 128 * 160
    S, top = worst_case(max_g_in_prod, max_g_sim, max_ref, D, hw)
    assert S is not None and abs(S) <= 1000
    b = Fraction(D * hw) * (Fraction(max_g_in_prod) + Fraction(max_g_sim)) * Fraction(max_ref)
    assert b * Fraction(2) ** S < 2 ** 62 <= b * Fraction(2) ** (S + 1)
    if top is not None:
        assert abs(top) + D * hw < 2 ** 63  # each addend's rounding adds at most 1/2
    assert math.isfinite(2.0 ** S) and 2.0 ** -S > 0


def test_non_finite_maxima_have_no_scale():
    """An infinite or NaN cotangent or feature leaves no scale: the kernel
    then writes NaN into d_src."""
    for args in ((math.inf, 0.0, 1.0), (1.0, math.nan, 1.0), (1.0, 0.0, math.inf)):
        assert fixed_point_shift(*args, 48, 20480) is None
    assert fixed_point_shift(0.0, 0.0, 1.0, 48, 20480) == 0  # no term: any scale


def test_round_trip_is_one_rounding():
    """to_fixed is llrint(x·2^S) in float64; from_fixed is int64 -> fp32 (one
    rounding) times 2^-S, then bf16: a value that the scale makes an integer
    comes back as its own bf16."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randint(-2 ** 20, 2 ** 20, (4096,), generator=gen).float() * 2.0 ** -10  # exact in fp32
    for S in (-5, 0, 10, 40):
        total = to_fixed(x, S)
        assert torch.equal(total, torch.round(x.double() * 2.0 ** S).to(torch.int64))
        if S >= 10:
            assert torch.equal(from_fixed(total, S), x.to(torch.bfloat16))
