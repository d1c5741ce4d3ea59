"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip elsewhere.
They import neither JAX nor the repository's ``conftest.py`` (which does), so
on the card they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes are small and deliberately ragged (widths that are no multiple of a
block, sources smaller and larger than the reference) so that every border
and tail path of each kernel runs; ``chip_smoke.py`` checks the main-path
shapes. Tolerances: both sides sum the same fp32 terms in another order and
round once to bf16, so they agree to one bf16 ulp of the result.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cds_mvsnet_tpu_torch.models.feature_net import k4_forms
from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.ops.kernels.regress import MAX_D

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def uniform(gen, shape, lo=-1.0, hi=1.0, dtype=torch.bfloat16):
    return (torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo).to(dtype).contiguous()


def within_one_ulp(got, want, atol=1e-3):
    return bool(((got.float() - want.float()).abs() <= 2 ** -7 * want.float().abs() + atol).all())


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_warp_entropy_matches_plain(gen, C, per_pixel):
    H, W, h, w, D = 23, 41, 19, 37, 7
    src, ref = uniform(gen, (H, W, C)), uniform(gen, (C, h, w))
    # a small rotation and a translation that pushes some samples out of view
    rt = torch.tensor([1.01, 0.02, -1.5, -0.015, 0.99, 2.0, 1e-4, -2e-4, 1.0, 8.0, -4.0, 0.05],
                      device="cuda")
    depth = torch.linspace(2.0, 40.0, D, device="cuda")
    if per_pixel:
        depth = (depth[:, None, None] * uniform(gen, (1, h, w), 0.8, 1.2, torch.float32)).contiguous()
    before = K.warp_entropy.launches
    ip, ent = K.warp_entropy(src, ref, depth, rt)
    torch.cuda.synchronize()
    assert K.warp_entropy.launches == before + 1
    ip_p, ent_p = K.warp_entropy_plain(src, ref, depth, rt)
    # one bf16 ulp of the warped value times |ref| <= 1, plus the product's rounding
    assert within_one_ulp(ip, ip_p, 2 ** -8)
    assert float((ent - ent_p).abs().max()) <= 1e-2


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("h,w", [(19, 37), (3, 7), (5, 288), (9, 288), (12, 288)])
def test_warp_entropy_tiles(gen, C, per_pixel, h, w):
    """K1's blocks of P consecutive pixels (128 at C = 32, else 256): hw no
    multiple of P (scalar stores where hw % 8 != 0, 16-byte stores and a
    ragged tail otherwise), hw below P, and w = 288 as serve stage 1; the
    source larger than the reference."""
    H, W, D = h + 5, w + 9, 9
    src, ref = uniform(gen, (H, W, C)), uniform(gen, (C, h, w))
    rt = torch.tensor([1.01, 0.02, -1.5, -0.015, 0.99, 2.0, 1e-4, -2e-4, 1.0, 8.0, -4.0, 0.05],
                      device="cuda")
    depth = torch.linspace(2.0, 40.0, D, device="cuda")
    if per_pixel:
        depth = (depth[:, None, None] * uniform(gen, (1, h, w), 0.8, 1.2, torch.float32)).contiguous()
    before = K.warp_entropy.launches
    ip, ent = K.warp_entropy(src, ref, depth, rt)
    torch.cuda.synchronize()
    assert K.warp_entropy.launches == before + 1
    ip_p, ent_p = K.warp_entropy_plain(src, ref, depth, rt)
    assert within_one_ulp(ip, ip_p, 2 ** -8)
    assert float((ent - ent_p).abs().max()) <= 1e-2


@pytest.mark.parametrize("C", [8, 16, 32])
def test_warp_entropy_plan_matches_launcher(gen, C):
    """The launcher's plan on the card is ``launch_plan``'s."""
    from cds_mvsnet_tpu_torch.ops.kernels.warp import launch_plan, warp_entropy_card_plan

    for h, w in [(216, 288), (19, 37), (3, 7)]:
        card, plan = warp_entropy_card_plan(C, h, w), launch_plan(C, h, w)
        keys = ("lanes", "pixels", "shared_bytes", "blocks")
        assert {k: card[k] for k in keys} == {k: plan[k] for k in keys}
        assert card["blocks_per_sm"] >= 1 and card["registers"] > 0


@pytest.mark.parametrize("C", [8, 16, 32])
def test_conv3d_bn_relu_matches_plain(gen, C):
    vol = uniform(gen, (C, 5, 11, 45))
    w = uniform(gen, (8, C, 3, 3, 3), -(27 * C) ** -0.5, (27 * C) ** -0.5, torch.float32)
    b = uniform(gen, (8,), -0.1, 0.1, torch.float32)
    assert within_one_ulp(K.conv3d_bn_relu(vol, w, b), K.conv3d_bn_relu_plain(vol, w, b))


@pytest.mark.parametrize("shape", [(5, 11, 45), (7, 13, 37), (128, 7, 35)])
@pytest.mark.parametrize("C,O", [(8, 8), (16, 8), (32, 8), (8, 16), (16, 16)])
def test_conv3d_bn_relu_tensor_cores_on_ragged_shapes(gen, C, O, shape):
    """K2 in bf16 (the tensor-core body) on shapes its 4x4x32 output tile
    does not divide, D = 128 as the stream's stage 1 included; C = 32 at
    O = 16 exceeds the weights' shared memory and is refused by check_conv."""
    vol, w, b = conv_rig(gen, C, O, torch.bfloat16, shape)
    before = K.conv3d_bn_relu.launches
    got = K.conv3d_bn_relu(vol, w, b)
    torch.cuda.synchronize()
    assert K.conv3d_bn_relu.launches == before + 1
    assert within_one_ulp(got, K.conv3d_bn_relu_plain(vol, w, b))


@pytest.mark.parametrize("C,O", [(8, 8), (32, 8), (16, 16)])
def test_conv3d_bn_relu_tensor_cores_cancellation(gen, C, O):
    """Mixed-sign weights at 4x the usual bound and no bias: many outputs sit
    near 0, where bf16 weights alone miss the tolerance by several 1e-3
    (tests/test_torch_conv3d_split.py); the kernel's hi/lo split holds it."""
    vol = uniform(gen, (C, 6, 12, 37))
    bound = 4 * (27 * C) ** -0.5
    w = uniform(gen, (O, C, 3, 3, 3), -bound, bound, torch.float32)
    b = torch.zeros(O, device="cuda")
    got = K.conv3d_bn_relu(vol, w, b)
    want = K.conv3d_bn_relu_plain(vol, w, b)
    assert within_one_ulp(got, want)
    hi = w.to(torch.bfloat16)  # bf16 weights alone, summed in fp32
    bf16_only = torch.relu(torch.nn.functional.conv3d(vol.float()[None], hi.float(), padding=1)[0]).to(torch.bfloat16)
    assert not within_one_ulp(bf16_only, want)


def test_conv3d_bn_relu_tensor_cores_refuse_ragged_channels(gen):
    vol = uniform(gen, (12, 4, 6, 10))
    w = uniform(gen, (8, 12, 3, 3, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="multiples of 8"):
        K.conv3d_bn_relu(vol, w, torch.zeros(8, device="cuda"))
    with pytest.raises(ValueError, match="multiples of 8"):
        K.conv3d_front_fused(vol, w, torch.zeros(8, device="cuda"), *conv_rig(gen, 8, 16, torch.bfloat16)[1:])
    assert K.conv3d_bn_relu(vol.float(), w, torch.zeros(8, device="cuda")).dtype == torch.float32  # fp32: any C


@pytest.mark.parametrize("per_pixel", [False, True])
def test_exit_softargmin_matches_plain(gen, per_pixel):
    D, h, w = 9, 13, 37
    y = uniform(gen, (8, D, h, w), -2.0, 2.0)
    wp = uniform(gen, (1, 8, 3, 3, 3), -0.3, 0.3, torch.float32)
    hyp = torch.linspace(400.0, 900.0, D, device="cuda")
    if per_pixel:
        hyp = (hyp[:, None, None] + uniform(gen, (1, h, w), -50.0, 50.0, torch.float32)).contiguous()
    depth, conf = K.exit_softargmin(y, wp, hyp)
    depth_p, conf_p = K.exit_softargmin_plain(y, wp, hyp)
    # fp32 logits summed in another order: depth to fp32 rounding of a
    # ~600 mm expectation; the confidence window can move only where the
    # expected index sits on an integer, which these inputs do not hit
    assert float((depth - depth_p).abs().max()) <= 1e-2
    assert float((conf - conf_p).abs().max()) <= 1e-4


def exit_rig(gen, D, h, w, per_pixel, peak=None):
    """K3's inputs: y and the prob weights as the kernels phase draws them,
    or, with ``peak``, logits peaked at that plane (y high there, low
    elsewhere, positive weights); planes 400-900, or per-pixel windows."""
    if peak is None:
        y = uniform(gen, (8, D, h, w), -2.0, 2.0)
        wp = uniform(gen, (1, 8, 3, 3, 3), -0.3, 0.3, torch.float32)
    else:
        y = uniform(gen, (8, D, h, w), -1.5, -1.0)
        y[:, peak] = 2.0
        wp = uniform(gen, (1, 8, 3, 3, 3), 0.05, 0.3, torch.float32)
    hyp = torch.linspace(400.0, 900.0, D, device="cuda")
    if per_pixel:
        hyp = (hyp[:, None, None] + uniform(gen, (1, h, w), -50.0, 50.0, torch.float32)).contiguous()
    return y, wp, hyp


def exit_within_tolerance(y, wp, hyp, depth, conf):
    """chip_smoke.py's K3 check: depth within 1e-2 mm everywhere, confidence
    within 1e-4 where the expected plane index is no closer than 1e-3 to an
    integer (elsewhere the truncated index may flip and move the window)."""
    depth_p, conf_p = K.exit_softargmin_plain(y, wp, hyp)
    D = y.shape[1]
    logits = torch.nn.functional.conv3d(y.float()[None], wp, padding=1)[0, 0]
    idx = (torch.softmax(logits, 0) * torch.arange(D, device="cuda", dtype=torch.float32)[:, None, None]).sum(0)
    frac = idx - idx.floor()
    safe = (frac > 1e-3) & (frac < 1 - 1e-3)
    return (float((depth - depth_p).abs().max()) <= 1e-2
            and float(((conf - conf_p).abs() * safe).max()) <= 1e-4)


@pytest.mark.parametrize("shape", [(13, 37), (3, 70), (9, 33), (6, 40), (5, 136)])
@pytest.mark.parametrize("D", [8, 9, 48, 128, 200])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_exit_softargmin_tiles(gen, D, shape, per_pixel):
    """Every tile the kernel picks by D (64 x 4 pixels at D = 8 and 9, 64 x 2
    at 48, 32 x 1 at 128 and 200), chunks of planes that D does not fill
    (9, 200), ragged h x w (widths that take the 16-byte staging and widths
    that do not)."""
    y, wp, hyp = exit_rig(gen, D, *shape, per_pixel)
    before = K.exit_softargmin.launches
    depth, conf = K.exit_softargmin(y, wp, hyp)
    torch.cuda.synchronize()
    assert K.exit_softargmin.launches == before + 1
    assert exit_within_tolerance(y, wp, hyp, depth, conf)


@pytest.mark.parametrize("D", [8, 48, 128])
@pytest.mark.parametrize("at_end", [False, True])
def test_exit_softargmin_window_clamps(gen, D, at_end):
    """Logits peaked at plane 0 or D - 1: the confidence window [idx-1,
    idx+2] is cut by the volume's ends."""
    y, wp, hyp = exit_rig(gen, D, 11, 37, False, peak=D - 1 if at_end else 0)
    depth, conf = K.exit_softargmin(y, wp, hyp)
    assert exit_within_tolerance(y, wp, hyp, depth, conf)
    assert float(conf.min()) > 0.5  # the mass sits in the clamped window


def test_exit_softargmin_max_planes(gen):
    """The most planes the wrapper takes run (one row of 32 pixels a
    block); more are refused, on the card too."""
    D = MAX_D
    y, wp, hyp = exit_rig(gen, D, 5, 7, True)
    depth, conf = K.exit_softargmin(y, wp, hyp)
    assert exit_within_tolerance(y, wp, hyp, depth, conf)
    y, wp, hyp = exit_rig(gen, D + 8, 2, 3, False)
    with pytest.raises(ValueError, match="MAX_D"):
        K.exit_softargmin(y, wp, hyp)


@pytest.mark.parametrize("ks,OA", [((3, 5, 7), 11), ((1, 3), 19), ((1, 3), 35)])
def test_dynconv_branches_matches_plain(gen, ks, OA):
    I_ = 8 if OA == 11 else OA - 3
    x = uniform(gen, (3, I_, 21, 70))
    ws = [uniform(gen, (OA, I_, k, k), -(I_ * k * k) ** -0.5, (I_ * k * k) ** -0.5, torch.float32) for k in ks]
    # bit for bit: the bf16 cascade needs the plain version's rounding (PERF.md §6)
    assert torch.equal(K.dynconv_branches(x, ws), K.dynconv_branches_plain(x, ws))


def dynconv_rig(gen, N, I_, OA, ks, shape, scale=1.0):
    x = uniform(gen, (N, I_, *shape))
    ws = [uniform(gen, (OA, I_, k, k), -scale * (I_ * k * k) ** -0.5, scale * (I_ * k * k) ** -0.5, torch.float32)
          for k in ks]
    return x, ws


@pytest.mark.parametrize("shape", [(13, 37), (9, 131), (21, 70)])
@pytest.mark.parametrize("N", [1, 3])
@pytest.mark.parametrize("I_,OA,ks", [(8, 11, (3, 5, 7)), (8, 11, (1, 3, 5, 7)), (16, 19, (5, 1)), (32, 35, (1, 5))])
def test_dynconv_branches_on_ragged_shapes(gen, I_, OA, ks, N, shape):
    """K4 on shapes its 8 x 32 output tile does not divide, odd and even W,
    with conv01's geometry, kernel sizes 1 to 7 and input widths 8, 16, 32.
    Bit for bit: the kernel sums each output in the plain version's order,
    (c, ky, kx) from 0, which the bf16 cascade needs (PERF.md §6)."""
    x, ws = dynconv_rig(gen, N, I_, OA, ks, shape)
    before = K.dynconv_branches.launches
    got = K.dynconv_branches(x, ws)
    torch.cuda.synchronize()
    assert K.dynconv_branches.launches == before + 1
    assert got.shape == (N, len(ks) * OA, *shape)
    assert torch.equal(got, K.dynconv_branches_plain(x, ws))


@pytest.mark.parametrize("shape", [(5, 3), (7, 1), (11, 40), (6, 44), (9, 37)])
@pytest.mark.parametrize("I_,OA,ks", [(8, 11, (3, 5, 7)), (8, 11, (1,)), (16, 19, (1, 3, 5)), (32, 35, (1, 5)),
                                      (32, 35, (3,))])
def test_dynconv_branches_register_tile_tails(gen, I_, OA, ks, shape):
    """N = 1 on widths where the 4-pixel register tile's tails run: W < 4
    and W = 1, W % 8 == 0 but no multiple of the 32-column block (the
    16-byte staging), W % 4 == 0 but not % 8 (scalar staging, vector
    stores) and an odd W; OA = 19 and 35 in their channel groups (10 + 9,
    12 + 12 + 11), k = 1 alone, and blocks of 32, 16 and 8 rows. Bit for
    bit."""
    x, ws = dynconv_rig(gen, 1, I_, OA, ks, shape)
    got = K.dynconv_branches(x, ws)
    torch.cuda.synchronize()
    assert torch.equal(got, K.dynconv_branches_plain(x, ws))


@pytest.mark.parametrize("I_,OA,ks", [(8, 11, (3, 5, 7)), (16, 19, (1, 3, 5)), (32, 35, (3,))])
def test_dynconv_branches_cancellation(gen, I_, OA, ks):
    """Mixed-sign weights at 4x the usual bound: many outputs sit near 0,
    where bf16 weights alone miss one ulp; the kernel's fp32 chain still
    rounds as the plain version does."""
    x, ws = dynconv_rig(gen, 3, I_, OA, ks, (21, 70), scale=4.0)
    want = K.dynconv_branches_plain(x, ws)
    assert torch.equal(K.dynconv_branches(x, ws), want)
    bf16_only = K.dynconv_branches_plain(x, [w.to(torch.bfloat16).float() for w in ws])
    assert not within_one_ulp(bf16_only, want)


# the FeatureNet's convs as the feature route sends them to K4, layers of
# one form named once: (I, OA, branch kernel sizes, stride)
FEATURE_FORMS = {name: form[:4] for name, *form in k4_forms(1, 1) if name not in ("conv11", "conv21", "out1")}


@pytest.mark.parametrize("shape", [(13, 37), (9, 131), (21, 70), (22, 64)])
@pytest.mark.parametrize("layer", list(FEATURE_FORMS))
def test_dynconv_feature_forms_on_ragged_shapes(gen, layer, shape):
    """K4 at every form of the feature route (k = 11 with I = 3, stride 2,
    one-branch 1x1 convs at I = 48 and 24, OA = 8 and 16 and 32) on shapes
    its blocks do not divide, odd H and W at stride 2 among them, and on the
    16-byte staging (W % 8 == 0). Bit for bit, one launch."""
    I_, OA, ks, stride = FEATURE_FORMS[layer]
    x, ws = dynconv_rig(gen, 2, I_, OA, ks, shape)
    before = K.dynconv_branches.launches
    got = K.dynconv_branches(x, ws, stride=stride)
    torch.cuda.synchronize()
    assert K.dynconv_branches.launches == before + 1
    assert got.shape == (2, len(ks) * OA, (shape[0] - 1) // stride + 1, (shape[1] - 1) // stride + 1)
    assert torch.equal(got, K.dynconv_branches_plain(x, ws, stride))


@pytest.mark.parametrize("shape", [(5, 3), (7, 1), (11, 40), (6, 44), (9, 37), (1, 2)])
@pytest.mark.parametrize("layer", ["conv00", "downsample1", "downsample2", "inner1", "inner2"])
def test_dynconv_feature_forms_register_tile_tails(gen, layer, shape):
    """N = 1 where the 4-pixel register tile's tails run (W < 4, W = 1, W %
    8 == 0 off the block, odd W) at the new forms; at stride 2 the outputs
    are 3x2, 4x1, 6x20, 3x22, 5x19 and 1x1. Bit for bit."""
    I_, OA, ks, stride = FEATURE_FORMS[layer]
    x, ws = dynconv_rig(gen, 1, I_, OA, ks, shape)
    got = K.dynconv_branches(x, ws, stride=stride)
    torch.cuda.synchronize()
    assert torch.equal(got, K.dynconv_branches_plain(x, ws, stride))


@pytest.mark.parametrize("layer", ["conv00", "downsample2", "inner1", "inner2", "out3"])
def test_dynconv_feature_forms_cancellation(gen, layer):
    """The cancellation case at the new forms: weights at 4x the usual bound,
    where bf16 weights alone miss one ulp; K4 still rounds as the plain
    version does."""
    I_, OA, ks, stride = FEATURE_FORMS[layer]
    x, ws = dynconv_rig(gen, 3, I_, OA, ks, (21, 70), scale=4.0)
    want = K.dynconv_branches_plain(x, ws, stride)
    assert torch.equal(K.dynconv_branches(x, ws, stride=stride), want)
    bf16_only = K.dynconv_branches_plain(x, [w.to(torch.bfloat16).float() for w in ws], stride)
    assert not within_one_ulp(bf16_only, want)


def test_feature_route_all_runs_k4_on_every_conv(gen):
    """``Routes(feature="all")``: 13 K4 launches a forward at B = 1 (every
    other launch as the default route's), and the FeatureNet's outputs bit
    for bit those of the same convs on K4's plain version."""
    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.models import Routes, build_model, to_tensors
    from cds_mvsnet_tpu_torch.models.warp_routes import FEATURE_LAYERS
    from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

    model = build_model(ModelConfig(refine=False, ndepths=(16, 8, 8)), seed=0, device="cuda")
    b = to_tensors(textured_plane_batch(V=3, H=64, W=128, D=32), "cuda")
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    kernels = (*K.KERNELS, *K.ROUTE_KERNELS)
    counts = []
    for feature in ("conv01", "all"):
        before = [k.launches for k in kernels]
        out = model(*args, compute_dtype=torch.bfloat16, routes=Routes(feature=feature))
        torch.cuda.synchronize()
        counts.append({k.__name__: k.launches - c for k, c in zip(kernels, before) if k.launches != c})
        assert bool(torch.isfinite(out["stage3"]["depth"]).all())
    assert counts[0]["dynconv_branches"] == 1 and counts[1] == {**counts[0], "dynconv_branches": 13}

    x = uniform(gen, (4, 3, 64, 128))
    epi = torch.tensor([[30.0, 40.0], [-500.0, 90.0], [2000.0, -300.0], [64.0, 32.0]], device="cuda")
    with torch.no_grad():
        got = model.feature(x, epi, 0.001, branches=dict.fromkeys(FEATURE_LAYERS, K.dynconv_branches))
        want = model.feature(x, epi, 0.001, branches=dict.fromkeys(FEATURE_LAYERS, K.dynconv_branches_plain))
    for s in want:
        for a, w in zip(got[s], want[s]):
            assert torch.equal(a, w), s


@pytest.mark.parametrize("shape", [(864, 1152), (432, 576), (216, 288)])
def test_epipolar_norm_on_the_card_is_the_fp32_root(gen, shape):
    """The repaired root equals the fp32 ``torch.sqrt`` form the port took
    before, bit for bit, at the serve point's three FeatureNet scales, and
    is correctly rounded (the fp64 root rounded once)."""
    from cds_mvsnet_tpu_torch.models.dynamic_conv import (epipolar_direction_quadratic, epipolar_norm,
                                                          epipolar_offsets)

    H, W = shape
    epi = (torch.rand((8, 2), generator=gen, device="cuda") * 6000.0 - 2000.0) * (H / 864)
    epi[:2] = torch.tensor([[W / 3 + 0.25, H / 2 - 0.5], [W - 1.0, 0.0]], device="cuda")  # in frame, on a pixel
    u, v = epipolar_offsets(epi, H, W)
    root = epipolar_norm(u, v)
    old = torch.sqrt(u * u + v * v)
    assert torch.equal(root, old)
    assert torch.equal(root, torch.sqrt((u * u + v * v).double()).float())
    un, vn = u / (old + 1e-6), v / (old + 1e-6)
    assert torch.equal(epipolar_direction_quadratic(epi, H, W), torch.stack([un * un, 2 * un * vn, vn * vn], 1))


RT = (1.01, 0.02, -1.5, -0.015, 0.99, 2.0, 1e-4, -2e-4, 1.0, 8.0, -4.0, 0.05)


def warp_rig(gen, C, per_pixel, D=7):
    """K5's inputs: a source smaller than the reference in one axis and
    larger in the other, a homography that pushes some samples out of view."""
    H, W, h, w = 23, 41, 19, 37
    src, ref = uniform(gen, (H, W, C)), uniform(gen, (C, h, w))
    rt = torch.tensor(RT, device="cuda")
    depth = torch.linspace(2.0, 40.0, D, device="cuda")
    if per_pixel:
        depth = (depth[:, None, None] * uniform(gen, (1, h, w), 0.8, 1.2, torch.float32)).contiguous()
    return src, ref, depth, rt


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_warp_sim_matches_plain(gen, C, per_pixel):
    src, ref, depth, rt = warp_rig(gen, C, per_pixel)
    before = K.warp_sim.launches
    ip, sim = K.warp_sim(src, ref, depth, rt)
    torch.cuda.synchronize()
    assert K.warp_sim.launches == before + 1
    ip_p, sim_p = K.warp_sim_plain(src, ref, depth, rt)
    assert within_one_ulp(ip, ip_p, 2 ** -8)
    # sim sums C fp32 products of the same bf16 values, but a warped value
    # may sit one bf16 ulp away: at most 2^-8 of each |term|
    assert bool(((sim - sim_p).abs() <= 2 ** -7 * ip_p.float().abs().sum(0) + 1e-5).all())


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_warp_sim_backward_matches_plain(gen, C, per_pixel):
    src, ref, depth, rt = warp_rig(gen, C, per_pixel)
    D, (_, h, w) = depth.shape[0], ref.shape
    g_ip = uniform(gen, (C, D, h, w))
    g_sim = uniform(gen, (D, h, w), dtype=torch.float32)
    before = K.warp_sim_backward.launches
    d_src, d_ref = K.warp_sim_backward(src, ref, depth, rt, g_ip, g_sim)
    torch.cuda.synchronize()
    assert K.warp_sim_backward.launches == before + 1
    want = K.warp_sim_backward_plain(src, ref, depth, rt, g_ip, g_sim)
    # the plain version on |inputs| is the sum of |terms| behind each element
    # (the bilinear weights are >= 0); fp32 sums in another order (atomics on
    # the card) and one-ulp flips of a bf16 warped value stay within 2^-8 of
    # it, and each side rounds once to bf16
    scale = K.warp_sim_backward_plain(src.abs(), ref.abs(), depth, rt, g_ip.abs(), g_sim.abs())
    for got, want_, s in zip((d_src, d_ref), want, scale):
        assert got.dtype == torch.bfloat16
        assert bool(((got.float() - want_.float()).abs() <= 2 ** -7 * (want_.float().abs() + s.float())
                     + 1e-6).all())


@pytest.mark.parametrize("C", [8, 32])
def test_fused_warp_train_gradients_match_plain_autograd(gen, C):
    """K5's Function against autograd of the plain forward, on a loss linear
    in (in_prod, sim)."""
    src, ref, depth, rt = warp_rig(gen, C, True)
    w_ip, w_sim = uniform(gen, (C, depth.shape[0], *ref.shape[1:])), uniform(gen, depth.shape, dtype=torch.float32)
    grads = []
    for fn in (K.fused_warp_train, K.warp_sim_plain):
        s, r = src.clone().requires_grad_(), ref.clone().requires_grad_()
        ip, sim = fn(s, r, depth, rt)
        ((ip.float() * w_ip.float()).sum() + (sim * w_sim).sum()).backward()
        grads.append((s.grad.float(), r.grad.float()))
    for got, want in zip(*grads):
        assert float((got - want).norm() / want.norm()) <= 1e-2


def backward_within_tolerance(src, ref, depth, rt, g_ip, g_sim, d_src, d_ref) -> bool:
    """K5's backward against the plain one, as in
    test_warp_sim_backward_matches_plain."""
    want = K.warp_sim_backward_plain(src, ref, depth, rt, g_ip, g_sim)
    scale = K.warp_sim_backward_plain(src.abs(), ref.abs(), depth, rt, g_ip.abs(), g_sim.abs())
    return all(bool(((got.float() - w.float()).abs() <= 2 ** -7 * (w.float().abs() + s.float()) + 1e-6).all())
               for got, w, s in zip((d_src, d_ref), want, scale))


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("D", [7, 1])
def test_warp_sim_in_prod_equals_plain(gen, C, per_pixel, D):
    """K5's forward projects, weights, gathers and rounds op by op as the
    plain version: in_prod bit for bit, at a sweep and at the train step's
    one-plane GT warp."""
    src, ref, depth, rt = warp_rig(gen, C, per_pixel, D)
    ip, sim = K.warp_sim(src, ref, depth, rt)
    torch.cuda.synchronize()
    ip_p, sim_p = K.warp_sim_plain(src, ref, depth, rt)
    assert torch.equal(ip, ip_p)
    assert bool(((sim - sim_p).abs() <= 2 ** -7 * ip_p.float().abs().sum(0) + 1e-5).all())


# (h, w, D): hw no multiple of a tile's pixels and not of 8 (2-byte rows),
# below a tile, one plane; at 61x83, 64x80 and 29x131 several planes a chunk
# with a ragged last chunk (ops/kernels/warp_vjp.py::launch_plan)
K5_RAGGED = [(19, 37, 13), (3, 7, 1), (5, 288, 9), (61, 83, 50), (64, 80, 50), (29, 131, 100)]


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("h,w,D", K5_RAGGED)
def test_warp_sim_backward_is_deterministic(gen, C, per_pixel, h, w, D):
    """d_ref sums each plane chunk in registers and the chunks in order, and
    d_src adds in fixed point with 64-bit integer atomics, whose order does
    not change the sum: two runs give the same bits of both, within the
    plain version's tolerance."""
    H, W = h + 5, w + 9
    src, ref = uniform(gen, (H, W, C)), uniform(gen, (C, h, w))
    rt = torch.tensor(RT, device="cuda")
    depth = torch.linspace(2.0, 40.0, D, device="cuda")
    if per_pixel:
        depth = (depth[:, None, None] * uniform(gen, (1, h, w), 0.8, 1.2, torch.float32)).contiguous()
    g_ip, g_sim = uniform(gen, (C, D, h, w)), uniform(gen, (D, h, w), dtype=torch.float32)
    first = K.warp_sim_backward(src, ref, depth, rt, g_ip, g_sim)
    second = K.warp_sim_backward(src, ref, depth, rt, g_ip, g_sim)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert backward_within_tolerance(src, ref, depth, rt, g_ip, g_sim, *first)


@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("k", [-60, 60])
def test_warp_sim_backward_fixed_point_follows_the_scale(gen, C, k):
    """The fixed point's scale 2^S follows the cotangents' magnitude: times
    2^k, d_src is 2^k times the same bits (S moves by -k), far below and far
    above 1."""
    src, ref, depth, rt = warp_rig(gen, C, True, D=9)
    D, (_, h, w) = depth.shape[0], ref.shape
    g_ip, g_sim = uniform(gen, (C, D, h, w)), uniform(gen, (D, h, w), dtype=torch.float32)
    d_src = K.warp_sim_backward(src, ref, depth, rt, g_ip, g_sim)[0]
    scaled = K.warp_sim_backward(src, ref, depth, rt, (g_ip.float() * 2.0 ** k).to(torch.bfloat16),
                                 g_sim * 2.0 ** k)[0]
    assert torch.equal(scaled, (d_src.float() * 2.0 ** k).to(torch.bfloat16))
    assert int((d_src != 0).sum()) > 0


def test_warp_sim_backward_non_finite_cotangent_gives_nan(gen):
    """An infinite cotangent leaves no finite fixed point: d_src is NaN."""
    src, ref, depth, rt = warp_rig(gen, 8, False, D=5)
    D, (_, h, w) = depth.shape[0], ref.shape
    g_ip, g_sim = uniform(gen, (8, D, h, w)), uniform(gen, (D, h, w), dtype=torch.float32)
    g_sim[2, 3, 4] = float("inf")
    d_src = K.warp_sim_backward(src, ref, depth, rt, g_ip, g_sim)[0]
    assert bool(torch.isnan(d_src).all())


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("h,w,D", K5_RAGGED)
def test_warp_sim_tiles_and_chunks(gen, C, per_pixel, h, w, D):
    """K5 over ragged pixel tiles and plane chunks, the source larger than
    the reference: the forward bit for bit, the backward within the
    tolerance of test_warp_sim_backward_matches_plain and d_ref the same in
    two runs."""
    H, W = h + 5, w + 9
    src, ref = uniform(gen, (H, W, C)), uniform(gen, (C, h, w))
    rt = torch.tensor(RT, device="cuda")
    depth = torch.linspace(2.0, 40.0, D, device="cuda")
    if per_pixel:
        depth = (depth[:, None, None] * uniform(gen, (1, h, w), 0.8, 1.2, torch.float32)).contiguous()
    ip, sim = K.warp_sim(src, ref, depth, rt)
    torch.cuda.synchronize()
    ip_p, sim_p = K.warp_sim_plain(src, ref, depth, rt)
    assert torch.equal(ip, ip_p)
    assert bool(((sim - sim_p).abs() <= 2 ** -7 * ip_p.float().abs().sum(0) + 1e-5).all())
    g_ip, g_sim = uniform(gen, (C, D, h, w)), uniform(gen, (D, h, w), dtype=torch.float32)
    d_src, d_ref = K.warp_sim_backward(src, ref, depth, rt, g_ip, g_sim)
    again = K.warp_sim_backward(src, ref, depth, rt, g_ip, g_sim)[1]
    torch.cuda.synchronize()
    assert backward_within_tolerance(src, ref, depth, rt, g_ip, g_sim, d_src, d_ref)
    assert torch.equal(d_ref, again)


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("D", [1, 5])
def test_warp_sim_backward_wide_footprint(gen, C, D):
    """A homography that magnifies 6x: neighbouring pixels' corner cells sit
    6 source pixels apart, so no lane hands its corners to the pixel on its
    right (csrc/warp_vjp.cu), and most of the source gets no gradient;
    within the same tolerance."""
    h, w = 19, 37
    src, ref = uniform(gen, (6 * h + 2, 6 * w + 2, C)), uniform(gen, (C, h, w))
    rt = torch.tensor([6.0, 0.02, 0.5, -0.01, 6.0, 0.5, 0.0, 0.0, 1.0, 0.3, -0.2, 0.0], device="cuda")
    depth = torch.linspace(2.0, 40.0, D, device="cuda")
    g_ip, g_sim = uniform(gen, (C, D, h, w)), uniform(gen, (D, h, w), dtype=torch.float32)
    d_src, d_ref = K.warp_sim_backward(src, ref, depth, rt, g_ip, g_sim)
    torch.cuda.synchronize()
    assert backward_within_tolerance(src, ref, depth, rt, g_ip, g_sim, d_src, d_ref)
    assert int((d_src != 0).sum()) > C * h * w  # the corners reached the source


@pytest.mark.parametrize("C", [8, 16, 32])
def test_warp_sim_plans_match_launchers(gen, C):
    """The launchers' plans on the card are ``launch_plan``'s."""
    from cds_mvsnet_tpu_torch.ops.kernels.warp_vjp import card_plan, launch_plan

    for D, h, w in [(48, 64, 80), (1, 64, 80), (48, 216, 288), (50, 61, 83), (7, 3, 7)]:
        for kernel in ("forward", "backward"):
            plan, card = launch_plan(C, D, h, w, kernel), card_plan(kernel, C, D, h, w)
            keys = ("lanes", "pixels", "chunk", "chunks", "blocks", "shared_bytes")
            assert {k: card[k] for k in keys} == {k: plan[k] for k in keys}
            assert card.get("scratch_bytes", 0) == plan["scratch_bytes"]
            assert card["blocks_per_sm"] >= 1 and card["registers"] > 0


def gather_rig(gen, C, dtype, D=5, h=19, w=37):
    """K9's inputs: a source smaller than the output grid in one axis and
    larger in the other, coordinates that leave the image, the ``-1e6``
    padding of ``warp_pallas_padded`` in the last columns, and z near 0:
    huge and non-finite coordinates."""
    H, W = 23, 41
    src = uniform(gen, (H, W, C), dtype=dtype)
    px = uniform(gen, (D, h, w), -3.0, W + 2.0, torch.float32)
    py = uniform(gen, (D, h, w), -3.0, H + 2.0, torch.float32)
    px[:, :, -3:] = -1e6
    py[:, :, -3:] = -1e6
    px[0, 0, :4] = torch.tensor([1e30, -1e30, float("inf"), float("nan")])
    py[0, 1, :4] = torch.tensor([3e9, float("-inf"), float("nan"), 0.0])
    px[1, 2, :3] = torch.tensor([0.0, W - 1.0, W - 1.0 + 2 ** -10])  # on the edges
    return src, px.contiguous(), py.contiguous()


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_gather_matches_plain(gen, C, dtype):
    src, px, py = gather_rig(gen, C, dtype)
    before = K.warp_gather.launches
    out = K.warp_gather(src, px, py)
    torch.cuda.synchronize()
    assert K.warp_gather.launches == before + 1
    want = K.warp_gather_plain(src, px, py)
    # same corners, same fp32 weights, the same op-by-op sum, one rounding:
    # equal bit for bit
    assert out.dtype == dtype
    assert torch.equal(out, want)
    assert bool((out[:, :, :, -3:] == 0).all())


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 7, 61), (2, 9, 33), (2, 5, 517)])
def test_warp_gather_lane_group_tails(gen, C, dtype, shape):
    """K9 on output counts n = D·h·w that leave the last block partly full,
    down to one pixel of a lane group: n = 1281 (one pixel in the last
    block of 64 pixels of the fp32 C = 32 lane groups), 594 and 5170;
    gather_rig's non-finite, far-off and edge coordinates included. Bit
    for bit."""
    src, px, py = gather_rig(gen, C, dtype, *shape)
    before = K.warp_gather.launches
    out = K.warp_gather(src, px, py)
    torch.cuda.synchronize()
    assert K.warp_gather.launches == before + 1
    want = K.warp_gather_plain(src, px, py)
    assert out.dtype == dtype and out.shape == (C, *shape)
    assert torch.equal(out, want)
    assert bool((out[:, :, :, -3:] == 0).all())


@pytest.mark.parametrize("C", [8, 32])
def test_conv3d_bn_relu_fp32_matches_plain(gen, C):
    vol = uniform(gen, (C, 5, 11, 45), dtype=torch.float32)
    w = uniform(gen, (8, C, 3, 3, 3), -(27 * C) ** -0.5, (27 * C) ** -0.5, torch.float32)
    b = uniform(gen, (8,), -0.1, 0.1, torch.float32)
    got = K.conv3d_bn_relu(vol, w, b)
    assert got.dtype == torch.float32
    want = K.conv3d_bn_relu_plain(vol, w, b)
    # fp32 sums of 27·C terms in another order (TF32 off): 1e-5 of the sum of
    # |terms| behind each output
    terms = torch.nn.functional.conv3d(vol.abs()[None], w.abs(), padding=1)[0] + b.abs()[:, None, None, None]
    assert bool(((got - want).abs() <= 1e-5 * terms + 1e-7).all())


def tf32(x):
    """``cvt.rna.tf32.f32`` on finite values (tests/test_torch_conv3d_tf32.py)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("shape", [(5, 11, 45), (7, 13, 37), (128, 7, 35), (1, 1, 1), (3, 4, 33)])
@pytest.mark.parametrize("C,O", [(8, 8), (16, 8), (32, 8), (12, 8), (3, 8), (8, 16), (16, 16), (12, 16)])
def test_conv3d_bn_relu_fp32_tensor_cores_on_ragged_shapes(gen, C, O, shape):
    """K2 in fp32 (3xTF32) on shapes its 4x4x32 output tile does not divide,
    D = 128 as the stream's stage 1 included, and at any C: a ragged chunk
    of channels is padded with zeros."""
    vol, w, b = conv_rig(gen, C, O, torch.float32, shape)
    before = K.conv3d_bn_relu.launches
    got = K.conv3d_bn_relu(vol, w, b)
    torch.cuda.synchronize()
    assert K.conv3d_bn_relu.launches == before + 1
    assert conv_close(got, K.conv3d_bn_relu_plain(vol, w, b), vol, w, b)


@pytest.mark.parametrize("C,O", [(8, 8), (32, 8), (16, 16), (12, 16)])
def test_conv3d_bn_relu_fp32_tensor_cores_cancellation(gen, C, O):
    """Mixed-sign weights at 4x the usual bound, inputs spanning 2^8 in
    magnitude and no bias: outputs near 0 from large terms. The kernel's
    three TF32 products hold the fp32 tolerance; one TF32 product does not."""
    vol = uniform(gen, (C, 6, 12, 37), dtype=torch.float32) * torch.exp2(
        torch.randint(-4, 5, (C, 6, 12, 37), generator=gen, device="cuda").float())
    bound = 4 * (27 * C) ** -0.5
    w = uniform(gen, (O, C, 3, 3, 3), -bound, bound, torch.float32)
    b = torch.zeros(O, device="cuda")
    want = K.conv3d_bn_relu_plain(vol, w, b)
    assert conv_close(K.conv3d_bn_relu(vol, w, b), want, vol, w, b)
    one_tf32 = torch.relu(torch.nn.functional.conv3d(tf32(vol)[None], tf32(w), padding=1)[0])
    assert not conv_close(one_tf32, want, vol, w, b)


def test_fused_warp_train_raises_rather_than_fall_back(gen):
    src, ref, depth, rt = warp_rig(gen, 8, False)
    with pytest.raises(ValueError, match="bf16"):
        K.fused_warp_train(src.float(), ref.float(), depth, rt)
    with pytest.raises(ValueError, match="devices"):
        K.fused_warp_train(src, ref.cpu(), depth, rt)
    ip, sim = K.warp_sim(src, ref, depth, rt)
    g_sim = torch.zeros_like(sim)
    with pytest.raises(ValueError, match="devices"):
        K.warp_sim_backward(src, ref, depth, rt, ip, g_sim.cpu())
    with pytest.raises(ValueError, match="g_in_prod"):
        K.warp_sim_backward(src, ref, depth, rt, ip.float(), g_sim)


def test_wrappers_raise_rather_than_fall_back(gen):
    vol = uniform(gen, (8, 4, 6, 6), dtype=torch.float32)
    w = uniform(gen, (8, 8, 3, 3, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        K.conv3d_bn_relu(vol.half(), w, torch.zeros(8, device="cuda"))
    with pytest.raises(ValueError, match="devices"):
        K.conv3d_bn_relu(vol.bfloat16(), w.cpu(), torch.zeros(8))
    src = uniform(gen, (6, 7, 8), dtype=torch.float32)
    px = torch.zeros(2, 3, 4, device="cuda")
    with pytest.raises(ValueError, match="fp32 or bf16"):
        K.warp_gather(src.half(), px, px)
    with pytest.raises(ValueError, match="devices"):
        K.warp_gather(src, px.cpu(), px)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_eval_forward_makes_no_host_sync(gen, dtype):
    """After its warm-up a forward queues its work without waiting for the
    card, as ``save_depths`` needs to queue the next view before the last
    one's outputs cross to the host; the epipoles of F = 0 included."""
    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.models import build_model, to_tensors
    from cds_mvsnet_tpu_torch.ops.geometry import epipole_from_fundamental
    from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

    model = build_model(ModelConfig(refine=True, ndepths=(8, 8, 8)), seed=0, device="cuda")
    b = to_tensors(textured_plane_batch(V=3, H=64, W=64, D=16, refine=True), "cuda")
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    zero = torch.zeros(2, 3, 3, device="cuda")
    model(*args, compute_dtype=dtype)  # warm-up: the resize index tensors are cached per shape
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = model(*args, compute_dtype=dtype)
        epi = epipole_from_fundamental(zero)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out["refined_depth"]).all())
    assert torch.equal(epi, torch.zeros_like(epi))


def conv_rig(gen, C, O, dtype, shape=(6, 10, 46)):
    vol = uniform(gen, (C, *shape), dtype=dtype)
    w = uniform(gen, (O, C, 3, 3, 3), -(27 * C) ** -0.5, (27 * C) ** -0.5, torch.float32)
    return vol, w, uniform(gen, (O,), -0.1, 0.1, torch.float32)


def conv_close(got, want, vol, w, b, stride=1):
    """bf16: one ulp of the result; fp32: 1e-5 of the sum of |terms|."""
    assert got.dtype == want.dtype == vol.dtype and got.shape == want.shape
    if vol.dtype == torch.bfloat16:
        return within_one_ulp(got, want)
    terms = torch.nn.functional.conv3d(vol.abs()[None], w.abs(), stride=stride, padding=1)[0]
    return bool(((got - want).abs() <= 1e-5 * (terms + b.abs()[:, None, None, None]) + 1e-7).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3d_bn_relu_o16_matches_plain(gen, dtype):
    """K2 at 16 output channels: conv2 of the ``3`` fronts (16 -> 16)."""
    vol, w, b = conv_rig(gen, 16, 16, dtype)
    before = K.conv3d_bn_relu.launches
    got = K.conv3d_bn_relu(vol, w, b)
    torch.cuda.synchronize()
    assert K.conv3d_bn_relu.launches == before + 1
    assert conv_close(got, K.conv3d_bn_relu_plain(vol, w, b), vol, w, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,O", [(8, 16), (16, 8)])
def test_conv3d_down_matches_plain(gen, dtype, C, O):
    vol, w, b = conv_rig(gen, C, O, dtype)
    before = K.conv3d_down.launches
    got = K.conv3d_down(vol, w, b)
    torch.cuda.synchronize()
    assert K.conv3d_down.launches == before + 1
    assert tuple(got.shape) == (O, 3, 5, 23)
    assert conv_close(got, K.conv3d_down_plain(vol, w, b), vol, w, b, stride=2)


@pytest.mark.parametrize("C,O", [(8, 16), (16, 16), (16, 8)])
@pytest.mark.parametrize("shape", [(6, 18, 72), (4, 10, 136), (2, 2, 8), (8, 12, 50), (10, 20, 258), (2, 4, 6)])
def test_conv3d_down_tiles(gen, C, O, shape):
    """K7 in bf16 on its 2x4x32 output tiles: w a multiple of 8 (16-byte
    loads) with partial tiles along every axis, w not a multiple of 8
    (two-byte loads), volumes smaller than a tile; within one bf16 ulp of
    the plain version, and two runs identical."""
    vol, w, b = conv_rig(gen, C, O, torch.bfloat16, shape)
    got = K.conv3d_down(vol, w, b)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (O, *(n // 2 for n in shape))
    assert conv_close(got, K.conv3d_down_plain(vol, w, b), vol, w, b, stride=2)
    assert torch.equal(got, K.conv3d_down(vol, w, b))


@pytest.mark.parametrize("shape", [(8, 48, 216, 288), (8, 32, 432, 576), (8, 8, 864, 1152), (16, 6, 10, 46)])
def test_conv3d_down_plan_matches_card(gen, shape):
    """The launcher's plan (``conv3d_down_plan``) against the CPU mirror
    (``ops/kernels/conv3d.py::launch_plan``); the route shapes at two
    blocks an SM."""
    import ctypes

    from cds_mvsnet_tpu_torch.ops.kernels import _build
    from cds_mvsnet_tpu_torch.ops.kernels import conv3d as k7
    from cds_mvsnet_tpu_torch.ops.kernels._launch import I, P, entry

    C, D, h, w = shape
    out = (ctypes.c_int * 8)()
    lib, fn = entry("conv3d", "conv3d_down_plan", [I] * 5 + [P])
    _build.check(lib, fn(16, C, D, h, w, ctypes.cast(out, P)), "conv3d_down_plan")
    plan = k7.launch_plan(C, D, h, w)
    assert tuple(out[:3]) == plan["tile"] and out[3] == plan["tiles"] and out[7] == plan["shared_bytes"]
    assert out[4] == min(plan["tiles"], out[6] * torch.cuda.get_device_properties(0).multi_processor_count)
    if C == 8:
        assert out[6] == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,shape", [(8, (6, 10, 46)), (32, (10, 18, 70)), (16, (4, 14, 30)), (32, (8, 26, 38))])
def test_conv3d_front_fused_matches_plain(gen, dtype, C, shape):
    """K6 on shapes no tile divides: out0 against K2's plain version, out1
    against K7's plain version on the kernel's own out0 (so a flipped ulp of
    out0 does not propagate); and K6's out1 is exactly K7-fp32 (whose 3xTF32
    step K6's conv1 runs) on out0's values, rounded to out0's dtype, and out0
    exactly what K2 computes in that dtype (their shared bodies,
    conv3d_mma.cuh in bf16, conv3d_tf32.cuh in fp32), so every voxel of out0
    is stored once, by the block that owns it."""
    vol, w0, b0 = conv_rig(gen, C, 8, dtype, shape)
    w1 = uniform(gen, (16, 8, 3, 3, 3), -(27 * 8) ** -0.5, (27 * 8) ** -0.5, torch.float32)
    b1 = uniform(gen, (16,), -0.1, 0.1, torch.float32)
    before = K.conv3d_front_fused.launches
    out0, out1 = K.conv3d_front_fused(vol, w0, b0, w1, b1)
    torch.cuda.synchronize()
    assert K.conv3d_front_fused.launches == before + 1
    assert conv_close(out0, K.conv3d_bn_relu_plain(vol, w0, b0), vol, w0, b0)
    assert conv_close(out1, K.conv3d_down_plain(out0, w1, b1), out0, w1, b1, stride=2)
    assert torch.equal(out1, K.conv3d_down(out0.float(), w1, b1).to(dtype))
    assert torch.equal(out0, K.conv3d_bn_relu(vol, w0, b0))


@pytest.mark.parametrize("C,shape", [(12, (6, 10, 46)), (3, (4, 6, 34)), (40, (2, 8, 32)), (8, (2, 2, 2)),
                                     (8, (12, 20, 66))])
def test_conv3d_front_fused_fp32_any_channels(gen, C, shape):
    """K6 in fp32 at a ragged chunk of channels (padded with zeros, as
    K2-fp32 pads them), at its largest C (40: five chunks of fragments), on
    a volume smaller than a tile and on one of several tiles a block: out0
    equal to K2-fp32, out1 to K7-fp32 on out0, and two runs identical."""
    vol, w0, b0 = conv_rig(gen, C, 8, torch.float32, shape)
    w1, b1 = conv_rig(gen, 8, 16, torch.float32)[1:]
    out0, out1 = K.conv3d_front_fused(vol, w0, b0, w1, b1)
    torch.cuda.synchronize()
    assert conv_close(out0, K.conv3d_bn_relu_plain(vol, w0, b0), vol, w0, b0)
    assert torch.equal(out0, K.conv3d_bn_relu(vol, w0, b0))
    assert torch.equal(out1, K.conv3d_down(out0, w1, b1))
    again = K.conv3d_front_fused(vol, w0, b0, w1, b1)
    assert torch.equal(out0, again[0]) and torch.equal(out1, again[1])


def test_conv3d_front_fused_fp32_refuses_wide_volumes(gen):
    vol, w0, b0 = conv_rig(gen, 48, 8, torch.float32, (2, 4, 4))
    w1, b1 = conv_rig(gen, 8, 16, torch.float32)[1:]
    with pytest.raises(ValueError, match="C <= 40"):
        K.conv3d_front_fused(vol, w0, b0, w1, b1)


@pytest.mark.parametrize("C,O", [(8, 16), (16, 16), (16, 8), (12, 16), (3, 16), (28, 16), (8, 8)])
@pytest.mark.parametrize("shape", [(6, 18, 72), (4, 10, 136), (2, 2, 8), (8, 12, 50), (10, 20, 258), (2, 4, 6),
                                   (6, 10, 46)])
def test_conv3d_down_fp32_tiles(gen, C, O, shape):
    """K7 in fp32 (3xTF32) on its 2x4x32 output tiles (2x2x32 where its
    fragments exceed two chunk-n-tiles: C > 8 at O = 16): w a multiple of 4
    (16-byte loads) with partial tiles along every axis, w not a multiple
    of 4 (four-byte loads), volumes smaller than a tile, a ragged chunk of
    channels; within K2-fp32's tolerance of the plain version, and two runs
    identical."""
    vol, w, b = conv_rig(gen, C, O, torch.float32, shape)
    before = K.conv3d_down.launches
    got = K.conv3d_down(vol, w, b)
    torch.cuda.synchronize()
    assert K.conv3d_down.launches == before + 1
    assert tuple(got.shape) == (O, *(n // 2 for n in shape))
    assert conv_close(got, K.conv3d_down_plain(vol, w, b), vol, w, b, stride=2)
    assert torch.equal(got, K.conv3d_down(vol, w, b))


@pytest.mark.parametrize("C,O", [(8, 16), (16, 8), (12, 16)])
def test_conv3d_down_fp32_cancellation(gen, C, O):
    """K7-fp32 where outputs near 0 come from large terms of both signs
    (inputs spanning 2^8, weights at 4x the usual bound, no bias): the three
    TF32 products hold the tolerance, one TF32 product does not."""
    vol = uniform(gen, (C, 6, 12, 40), dtype=torch.float32) * torch.exp2(
        torch.randint(-4, 5, (C, 6, 12, 40), generator=gen, device="cuda").float())
    bound = 4 * (27 * C) ** -0.5
    w = uniform(gen, (O, C, 3, 3, 3), -bound, bound, torch.float32)
    b = torch.zeros(O, device="cuda")
    want = K.conv3d_down_plain(vol, w, b)
    assert conv_close(K.conv3d_down(vol, w, b), want, vol, w, b, stride=2)
    one_tf32 = torch.relu(torch.nn.functional.conv3d(tf32(vol)[None], tf32(w), stride=2, padding=1)[0])
    assert not conv_close(one_tf32, want, vol, w, b, stride=2)


@pytest.mark.parametrize("O,C,shape", [(16, 8, (48, 216, 288)), (16, 8, (32, 432, 576)), (16, 8, (8, 864, 1152)),
                                       (16, 8, (48, 144, 192)), (16, 12, (6, 10, 46)), (8, 16, (6, 10, 46))])
def test_conv3d_down_tf32_plan_matches_card(gen, O, C, shape):
    """K7-fp32's launcher plan (``conv3d_down_tf32_plan``) against the CPU
    mirror (``ops/kernels/conv3d.py::launch_plan_fp32``): the mixed path's
    serve shapes and the protocol's stage 1 at one block an SM."""
    import ctypes

    from cds_mvsnet_tpu_torch.ops.kernels import _build
    from cds_mvsnet_tpu_torch.ops.kernels import conv3d as k7
    from cds_mvsnet_tpu_torch.ops.kernels._launch import I, P, entry

    D, h, w = shape
    out = (ctypes.c_int * 8)()
    lib, fn = entry("conv3d", "conv3d_down_tf32_plan", [I] * 5 + [P])
    _build.check(lib, fn(O, C, D, h, w, ctypes.cast(out, P)), "conv3d_down_tf32_plan")
    plan = k7.launch_plan_fp32(C, D, h, w, O)
    assert tuple(out[:3]) == plan["tile"] and out[3] == plan["tiles"] and out[7] == plan["shared_bytes"]
    assert out[6] == 1 and out[4] == min(plan["tiles"], torch.cuda.get_device_properties(0).multi_processor_count)


@pytest.mark.parametrize("C", [8, 16, 32])
def test_warp_sim_coords_matches_plain(gen, C):
    """K8 per view on K9's coordinates (off the image, on its edges, the
    ``-1e6`` padding, huge and non-finite): in_prod bit for bit (the same
    corners, weights and op-by-op sums as K9's plain version, the same
    product), sim to 1e-5 of its sum of |terms| (C products summed in
    another order)."""
    src, px, py = gather_rig(gen, C, torch.bfloat16)
    ref = uniform(gen, (C, *px.shape[1:]))
    before = K.warp_sim_coords.launches
    ip, sim = K.warp_sim_coords(src, ref, px, py)
    torch.cuda.synchronize()
    assert K.warp_sim_coords.launches == before + 1
    ip_p, sim_p = K.warp_sim_coords_plain(src, ref, px, py)
    assert ip.dtype == torch.bfloat16 and sim.dtype == torch.float32
    assert torch.equal(ip, ip_p)
    assert bool(((sim - sim_p).abs() <= 1e-5 * ip_p.float().abs().sum(0) + 1e-30).all())
    assert bool((ip[:, :, :, -3:] == 0).all()) and bool((sim[:, :, -3:] == 0).all())


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("D,h,w", [(1, 19, 37), (1, 16, 32), (3, 7, 13), (9, 1, 1), (4, 33, 65)])
def test_warp_sim_coords_ragged_and_one_plane(gen, C, D, h, w):
    """K8 at D = 1 and on grids no block divides (hw odd, below a block,
    a single pixel), in_prod bit for bit with the plain version; nothing is
    written past the last pixel (the outputs' tail stays as filled); two
    runs identical."""
    H, W = 23, 41
    src, ref = uniform(gen, (H, W, C)), uniform(gen, (C, h, w))
    px = uniform(gen, (D, h, w), -3.0, W + 2.0, torch.float32)
    py = uniform(gen, (D, h, w), -3.0, H + 2.0, torch.float32)
    ip, sim = K.warp_sim_coords(src, ref, px, py)
    ip2, sim2 = K.warp_sim_coords(src, ref, px, py)
    torch.cuda.synchronize()
    ip_p, sim_p = K.warp_sim_coords_plain(src, ref, px, py)
    assert torch.equal(ip, ip_p) and torch.equal(ip, ip2) and torch.equal(sim, sim2)
    assert bool(((sim - sim_p).abs() <= 1e-5 * ip_p.float().abs().sum(0) + 1e-30).all())
    # the batched call's views sit back to back: a view's tail must not spill into the next
    ipb, simb = K.warp_sim_coords_batched(*(torch.stack([t, t]) for t in (src, ref, px, py)))
    assert torch.equal(ipb[0], ip) and torch.equal(ipb[1], ip) and torch.equal(simb[1], sim)


@pytest.mark.parametrize("V", [1, 4])
@pytest.mark.parametrize("shape", [(32, 48, 216, 288), (16, 32, 432, 576), (8, 8, 864, 1152), (8, 1, 19, 37)])
def test_warp_sim_coords_plan_matches_card(gen, V, shape):
    """The launcher's plan (``warp_sim_coords_plan``) against the CPU
    mirror (``ops/kernels/warp_coords.py::launch_plan``)."""
    from cds_mvsnet_tpu_torch.ops.kernels.warp_coords import card_plan, launch_plan

    card, plan = card_plan(V, *shape), launch_plan(V, *shape)
    assert {k: card[k] for k in ("pixels", "chunk", "chunks", "blocks")} == {
        k: plan[k] for k in ("pixels", "chunk", "chunks", "blocks")}
    assert card["blocks_per_sm"] >= 4 and card["registers"] <= 128


@pytest.mark.parametrize("C", [8, 16, 32])
def test_warp_sim_coords_batched_matches_per_view(gen, C):
    rigs = [gather_rig(gen, C, torch.bfloat16) for _ in range(4)]
    src = torch.stack([r[0] for r in rigs])
    px, py = torch.stack([r[1] for r in rigs]), torch.stack([r[2] for r in rigs])
    ref = uniform(gen, (4, C, *px.shape[2:]))
    before = K.warp_sim_coords_batched.launches
    ip, sim = K.warp_sim_coords_batched(src, ref, px, py)
    torch.cuda.synchronize()
    assert K.warp_sim_coords_batched.launches == before + 1
    for v in range(4):  # the same body, view by view: bit for bit
        ip_v, sim_v = K.warp_sim_coords(src[v], ref[v], px[v], py[v])
        assert torch.equal(ip[v], ip_v) and torch.equal(sim[v], sim_v)
    ip_p, _ = K.warp_sim_coords_batched_plain(src, ref, px, py)
    assert torch.equal(ip, ip_p)


def test_route_wrappers_raise_rather_than_fall_back(gen):
    vol, w0, b0 = conv_rig(gen, 8, 8, torch.bfloat16)
    w16, b16 = conv_rig(gen, 8, 16, torch.bfloat16)[1:]
    for bad in ((8, 5, 10, 46), (8, 6, 9, 46), (8, 6, 10, 45)):  # odd D, h or w
        with pytest.raises(ValueError, match="even"):
            K.conv3d_down(uniform(gen, bad), w16, b16)
        with pytest.raises(ValueError, match="even"):
            K.conv3d_front_fused(uniform(gen, bad), w0, b0, w16, b16)
    with pytest.raises(ValueError, match="devices"):
        K.conv3d_down(vol, w16.cpu(), b16.cpu())
    src, px, py = gather_rig(gen, 8, torch.bfloat16)
    src12 = uniform(gen, (*src.shape[:2], 12))
    with pytest.raises(ValueError, match="C in"):
        K.warp_sim_coords(src12, uniform(gen, (12, *px.shape[1:])), px, py)
    with pytest.raises(ValueError, match="C in"):
        K.warp_sim_coords_batched(src12[None], uniform(gen, (1, 12, *px.shape[1:])), px[None], py[None])
    with pytest.raises(ValueError, match="devices"):
        K.warp_sim_coords(src, uniform(gen, (8, *px.shape[1:])), px.cpu(), py.cpu())


def test_routed_forward_makes_no_host_sync(gen):
    """A forward under the routes that run K6, K2 at O = 16, K8 (per view and
    batched) and K5's forward queues its work without waiting for the card."""
    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.models import Routes, build_model, to_tensors
    from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

    model = build_model(ModelConfig(refine=True, ndepths=(8, 8, 8)), seed=0, device="cuda")
    b = to_tensors(textured_plane_batch(V=3, H=64, W=64, D=16, refine=True), "cuda")
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    routes = Routes({1: "v6s", 2: "v6sb", 3: "v7m"}, front="pallasf3")
    model(*args, compute_dtype=torch.bfloat16, routes=routes)  # warm-up
    torch.cuda.synchronize()
    counts = [k.launches for k in (K.conv3d_front_fused, K.warp_sim_coords, K.warp_sim_coords_batched, K.warp_sim)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = model(*args, compute_dtype=torch.bfloat16, routes=routes)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out["refined_depth"]).all())
    after = [k.launches for k in (K.conv3d_front_fused, K.warp_sim_coords, K.warp_sim_coords_batched, K.warp_sim)]
    assert [a - c for a, c in zip(after, counts)] == [3, 2, 1, 2]


# the mixed cascade's launches a request at V = 3 beside K1's 6 and K4's 1
MIXED_FRONTS = {"pallas": {"conv3d_bn_relu": 3}, "pallasf": {"conv3d_front_fused": 3},
                "pallasf3": {"conv3d_front_fused": 3, "conv3d_bn_relu": 3},
                "pallas2": {"conv3d_bn_relu": 3, "conv3d_down": 3},
                "pallas3": {"conv3d_bn_relu": 6, "conv3d_down": 3}, "s2d": {}}


@pytest.mark.parametrize("front", list(MIXED_FRONTS))
def test_mixed_cascade_under_each_front(gen, front):
    """bf16 with ``cost_dtype=torch.float32`` under each front: K1 and K4 in
    bf16, the front's kernels in fp32 (K2, K6, K7), K3 not at all (an fp32
    volume takes the plain tail); stage 3 within the serve gate of its plain
    twin (``kernels=False``, the same cost dtype): depth median 1 % and p99
    25 % of the plane interval, confidence median 1e-3 and p99 0.05."""
    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.models import Routes, build_model, to_tensors
    from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

    model = build_model(ModelConfig(refine=False, ndepths=(16, 8, 8)), seed=0, device="cuda")
    b = to_tensors(textured_plane_batch(V=3, H=128, W=160, D=32, seed=0), "cuda")
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    routes = Routes({}, front)
    kernels = {k.__name__: k for k in (*K.KERNELS, *K.FP32_KERNELS, *K.ROUTE_KERNELS)}
    before = {name: k.launches for name, k in kernels.items()}
    got = model(*args, compute_dtype=torch.bfloat16, cost_dtype=torch.float32, routes=routes)["stage3"]
    torch.cuda.synchronize()
    launches = {name: k.launches - before[name] for name, k in kernels.items()}
    want = {"warp_entropy": 6, "dynconv_branches": 1, **MIXED_FRONTS[front]}
    assert launches == {name: want.get(name, 0) for name in kernels}
    plain = model(*args, compute_dtype=torch.bfloat16, cost_dtype=torch.float32, kernels=False)["stage3"]
    interval = float(b["depth_values"][0, 1] - b["depth_values"][0, 0])
    d = (got["depth"] - plain["depth"]).abs().flatten() / interval
    c = (got["photometric_confidence"] - plain["photometric_confidence"]).abs().flatten()
    assert float(d.median()) <= 0.01 and float(torch.quantile(d, 0.99)) <= 0.25
    assert float(c.median()) <= 1e-3 and float(torch.quantile(c, 0.99)) <= 0.05
    assert got["depth"].dtype == torch.float32 and bool(torch.isfinite(got["depth"]).all())


def test_fp32_routes_on_the_card(gen):
    """An fp32 request under ``v6`` warps and the ``pallasf3`` front: K9 at
    every stage and view, K6 and K2 at O = 16 in fp32, no K4; the serve gate
    against the fp32 default request. A fused warp raises."""
    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.models import Routes, build_model, to_tensors
    from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

    model = build_model(ModelConfig(refine=True, ndepths=(16, 8, 8)), seed=0, device="cuda")
    b = to_tensors(textured_plane_batch(V=3, H=256, W=320, D=32, refine=True, seed=0), "cuda")
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    kernels = {k.__name__: k for k in (*K.KERNELS, *K.FP32_KERNELS, *K.ROUTE_KERNELS)}
    base = model(*args, compute_dtype=torch.float32)["stage3"]
    before = {name: k.launches for name, k in kernels.items()}
    got = model(*args, compute_dtype=torch.float32, routes=Routes({1: "v6", 2: "v6", 3: "v6"}, "pallasf3"))["stage3"]
    torch.cuda.synchronize()
    launches = {name: k.launches - before[name] for name, k in kernels.items()}
    want = {"warp_gather": 6, "conv3d_front_fused": 3, "conv3d_bn_relu": 3}
    assert launches == {name: want.get(name, 0) for name in kernels}
    interval = float(b["depth_values"][0, 1] - b["depth_values"][0, 0])
    d = (got["depth"] - base["depth"]).abs().flatten() / interval
    c = (got["photometric_confidence"] - base["photometric_confidence"]).abs().flatten()
    assert float(d.median()) <= 0.01 and float(torch.quantile(d, 0.99)) <= 0.25
    assert float(c.median()) <= 1e-3 and float(torch.quantile(c, 0.99)) <= 0.05
    with pytest.raises(ValueError, match="1592-1600"):
        model(*args, compute_dtype=torch.float32, routes=Routes({1: "v8"}))


def bits(t):
    """The fp32 values as int32 bit patterns: equal NaNs compare equal."""
    return t.contiguous().view(torch.int32)


def lane_inputs(gen, rows, nseg, case):
    """P1's band and offsets: the probe's input, or seeded values at
    data-given offsets, some repeated (``repeated``), some outside the band
    (``outside``, clamped), or the band 4 bytes into its buffer
    (``unaligned``: no 16-byte alignment)."""
    if case == "probe":
        x = torch.arange(8 * 128 * nseg, dtype=torch.float32, device="cuda").reshape(8, -1)
        return x, torch.arange(nseg, dtype=torch.int32, device="cuda") * 128
    x = uniform(gen, (rows, 128 * nseg), dtype=torch.float32)
    if case == "unaligned":
        x = uniform(gen, (rows * 128 * nseg + 1,), dtype=torch.float32)[1:].view(rows, 128 * nseg)
        assert x.data_ptr() % 16 == 4
    offs = (torch.rand(nseg, generator=gen, device="cuda") * 128 * nseg).to(torch.int32)
    if case == "outside":
        offs[:3] = torch.tensor([-5, 128 * nseg + 7, -1000], dtype=torch.int32)
    if case == "repeated":
        offs[: nseg // 2] = offs[nseg - 1]
    return x, offs


@pytest.mark.parametrize("case,rows,nseg", [
    ("probe", 8, 4), ("unaligned", 8, 48), ("outside", 8, 6), ("rows", 3, 5),
    *[(case, rows, nseg) for case in ("repeated", "unaligned", "outside") for rows in (8, 3) for nseg in (57, 64, 512)],
])
def test_lane_slice_sum_matches_plain(gen, case, rows, nseg):
    """P1 bit for bit: the probe's input; a 192 KB band (nseg 48) at
    unaligned data-given offsets; offsets outside the band (clamped); fewer
    rows than the probe's 8; and bands past one block's shared memory (nseg
    57, 64 and 512, the last 2 MB at 8 rows) with repeated, unaligned and
    out-of-band starts at 8 and 3 rows, one launch a call."""
    x, offs = lane_inputs(gen, rows, nseg, case)
    before = K.lane_slice_sum.launches
    got = K.lane_slice_sum(x, offs)
    torch.cuda.synchronize()
    assert K.lane_slice_sum.launches == before + 1
    assert torch.equal(got, K.lane_slice_sum_plain(x, offs))


# P2's shapes: the probe's, ragged rows (1001 lanes: no 16-byte staging),
# rows past 48 KB in either value type (fp32 values at 16384 and 65536
# lanes: 64 and 256 KB, the latter past shared memory; bf16 values at 65536
# and 120000: 128 and 240 KB)
GATHER_SHAPES = ((64, 128), (5, 1000), (5, 1001), (3, 16384), (2, 65536), (2, 120000))


def gather_inputs(gen, R, n, src_dtype):
    """Seeded values and indices, with indices from the row's end, outside
    [-L, L) (NaN) and wrapping in int16."""
    src = uniform(gen, (R, n), -4.0, 4.0, src_dtype)
    idx = (torch.rand((R, n), generator=gen, device="cuda") * n).to(torch.int32)
    idx[0, :6] = torch.tensor([-1, -n, n, 10 * n, -n - 1, 65536 + 3], dtype=torch.int32)
    return src, idx


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int16])
@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16])
def test_row_gather_matches_plain(gen, value_dtype, index_dtype, src_dtype):
    """P2's gather bit for bit, with indices from the row's end, outside
    [-L, L) (NaN) and wrapping in int16, at GATHER_SHAPES: rows staged in
    shared memory below and above 48 KB, and rows gathered from device
    memory past it; one launch a call."""
    for R, n in GATHER_SHAPES:
        src, idx = gather_inputs(gen, R, n, src_dtype)
        before = K.row_gather.launches
        got = K.row_gather(src, idx, value_dtype, index_dtype)
        torch.cuda.synchronize()
        assert K.row_gather.launches == before + 1
        assert torch.equal(bits(got), bits(K.row_gather_plain(src, idx, value_dtype, index_dtype))), (R, n)
        if index_dtype == torch.int32 or n <= 32767:
            assert bool(torch.isnan(got[0, 2]))


@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16])
def test_row_gather_unaligned_source(gen, src_dtype):
    """A source 2 or 4 bytes into its buffer (no 16-byte staging loads) in
    each form, bit for bit."""
    for R, n in ((4, 4096), (2, 65536)):
        src = uniform(gen, (R * n + 1,), -4.0, 4.0, src_dtype)[1:].view(R, n)
        idx = (torch.rand((R, n), generator=gen, device="cuda") * 2 * n - n).to(torch.int32)
        assert src.data_ptr() % 16 != 0
        for v, i in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16), (torch.bfloat16, torch.int32)):
            got = K.row_gather(src, idx, v, i)
            assert torch.equal(bits(got), bits(K.row_gather_plain(src, idx, v, i))), (R, n, v, i)


@pytest.mark.parametrize("shape", [(64, 128), (3, 40000)])
def test_int16_arith_matches_plain(gen, shape):
    src = uniform(gen, shape, dtype=torch.float32)
    before = K.int16_arith.launches
    got = K.int16_arith(src)
    torch.cuda.synchronize()
    assert K.int16_arith.launches == before + 1
    assert torch.equal(got, K.int16_arith_plain(src))


def test_current_stream_is_torch_s(gen):
    """The light launch path's raw stream handle (``_launch.current_stream``,
    a private torch function) is ``torch.cuda.current_stream().cuda_stream``,
    outside and inside a ``torch.cuda.stream(side)`` block."""
    from cds_mvsnet_tpu_torch.ops.kernels._launch import current_stream

    assert current_stream(0) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert current_stream(0) == torch.cuda.current_stream().cuda_stream == side.cuda_stream
    assert current_stream(0) == torch.cuda.current_stream().cuda_stream != side.cuda_stream


def probe_calls(gen):
    """Each probe kernel at a shape past the parent's caps: ``(kernel, fn,
    inputs)``, the call being ``fn(*inputs)``: P1 on a 2 MB band, P2 in each
    form on 64 KB and 256 KB rows, the int16 arithmetic."""
    calls = [(K.lane_slice_sum, K.lane_slice_sum, lane_inputs(gen, 8, 512, "repeated"))]
    for R, n in ((3, 16384), (2, 65536)):
        src, idx = gather_inputs(gen, R, n, torch.float32)
        for v, i in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16), (torch.bfloat16, torch.int32)):
            calls.append((K.row_gather, lambda src, idx, v=v, i=i: K.row_gather(src, idx, v, i), (src, idx)))
    calls.append((K.int16_arith, K.int16_arith, (uniform(gen, (3, 40000), dtype=torch.float32),)))
    return calls


def test_probe_kernels_on_a_side_stream(gen):
    """P1 and P2 called under ``torch.cuda.stream(side)`` launch on that
    stream: their inputs are written there, behind a long sleep, from zeros
    to the real values, and the result equals the eager call on the default
    stream bit for bit (a launch on another stream would read the zeros)."""
    for kernel, fn, inputs in probe_calls(gen):
        want = fn(*inputs)
        late = [torch.zeros_like(t) for t in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            torch.cuda._sleep(1_000_000)
            for dst, src in zip(late, inputs):
                dst.copy_(src)
            before = kernel.launches
            got = fn(*late)
            assert kernel.launches == before + 1
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        assert torch.equal(bits(got), bits(want))


def test_probe_kernels_replay_in_a_cuda_graph(gen):
    """P1 and P2 captured in a ``torch.cuda.CUDAGraph`` and replayed equal
    the eager call bit for bit, on the captured inputs and on new values
    copied into them; capture counts one launch a call, replay none."""
    for kernel, fn, inputs in probe_calls(gen):
        want = fn(*inputs)
        static = [t.clone() for t in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*static)  # warm-up on a side stream, as torch's capture wants
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = kernel.launches
        with torch.cuda.graph(graph):
            got = fn(*static)
        assert kernel.launches == before + 1
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(bits(got), bits(want))
        fresh = [t.flip(-1).contiguous() for t in inputs]
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(bits(got), bits(fn(*fresh)))


def test_probe_wrappers_raise_rather_than_fall_back(gen):
    """Tensors on two devices or of a wrong type raise on the card; a band
    4 bytes into its buffer, which the bulk copy once refused, now runs."""
    x = uniform(gen, (8, 129 * 4), dtype=torch.float32)
    offs = torch.zeros(4, dtype=torch.int32, device="cuda")
    view = x.view(-1)[1:1 + 512 * 8].view(8, 512)
    assert torch.equal(K.lane_slice_sum(view, offs), K.lane_slice_sum_plain(view, offs))
    with pytest.raises(ValueError, match="devices"):
        K.lane_slice_sum(x[:, :512].contiguous(), offs.cpu())
    with pytest.raises(ValueError, match="devices"):
        K.row_gather(x, torch.zeros(x.shape, dtype=torch.int32))
    with pytest.raises(ValueError, match="int16_arith"):
        K.int16_arith(x.half())


def test_stream_push_runs_the_kernels(gen):
    """One bf16 push of a filled window runs KERNEL_OPS: K1 once per source
    view and stage, K2 and K3 once per stage, K4 once, nothing else."""
    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.eval.streaming import StreamingConfig, StreamingReconstructor
    from cds_mvsnet_tpu_torch.utils.synthetic import sphere_scene

    scene = sphere_scene(V=3, H=64, W=128)
    rec = StreamingReconstructor(None, StreamingConfig(window=3, ndepths_full=64, height=64, width=128,
                                                       depth_min=425.0, depth_max=937.0),
                                 model_cfg=ModelConfig(refine=False, ndepths=(16, 8, 8)))
    kernels = (*K.KERNELS, *K.FP32_KERNELS, *K.TRAIN_KERNELS, *K.ROUTE_KERNELS, *K.PROBE_KERNELS)
    assert rec.push(scene["imgs"][0], scene["cams"][0]) is None
    assert rec.push(scene["imgs"][1], scene["cams"][1]) is None
    before = {k.__name__: k.launches for k in kernels}
    depth, conf = rec.push(scene["imgs"][2], scene["cams"][2])
    ran = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    assert {n: c for n, c in ran.items() if c} == {"warp_entropy": 6, "conv3d_bn_relu": 3, "exit_softargmin": 3,
                                                    "dynconv_branches": 1}
    assert depth.shape == conf.shape == (64, 128) and np.isfinite(depth).all() and np.isfinite(conf).all()
    assert depth.min() >= 425.0 - 1e-3 and depth.max() <= 937.0 + 1e-3


def test_train_cli_runs_the_kernels(gen, tmp_path):
    """The train CLI on the card, one epoch in bf16 on a tiny DTU training
    scan (3 views, one ref view: 7 samples, 3 steps of 2, no validation
    list): K5's forward and backward launch B·3·(V−1)·2 times a step and the
    losses are finite."""
    import json
    import math
    from pathlib import Path

    from cds_mvsnet_tpu_torch.cli.train_cli import main
    from cds_mvsnet_tpu_torch.utils.synthetic import write_dtu_train_scan

    write_dtu_train_scan(tmp_path / "dtu", views=3, refs=(0,))
    (tmp_path / "dtu" / "train.txt").write_text("scan1\n")
    raw = json.loads((Path(__file__).resolve().parents[1] / "configs" / "config_dtu.json").read_text())
    raw["data"][0].update(datapath=str(tmp_path / "dtu"), listfile=str(tmp_path / "dtu" / "train.txt"), nviews=3)
    raw["train"]["compute_dtype"] = "bf16"
    raw["save_dir"] = str(tmp_path / "saved")
    (tmp_path / "config.json").write_text(json.dumps(raw))
    for k in K.TRAIN_KERNELS:
        k.launches = 0
    trainer = main(["-c", str(tmp_path / "config.json"), "--epochs", "1", "--bs", "2"])
    steps = len(trainer.timings)
    assert steps == 7 // 2
    assert [k.launches for k in K.TRAIN_KERNELS] == [2 * 3 * 2 * 2 * steps] * 2
    assert all(math.isfinite(v) for v in trainer.history[0].values())
    assert all(p.is_cuda for p in trainer.model.parameters())


def test_default_fp32_and_bf16_requests_repeat(gen):
    """With cuDNN left at PyTorch's defaults by the caller, build_model holds
    it to deterministic algorithms: two default requests in fp32, and two in
    bf16, are bit for bit."""
    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.models import build_model, to_tensors
    from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
    model = build_model(ModelConfig(refine=False, ndepths=(48, 32, 8)), seed=0, device="cuda")
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    b = to_tensors(textured_plane_batch(V=5, H=192, W=256, D=192, seed=0), "cuda")
    for dtype in (torch.float32, torch.bfloat16):
        first, again = (model(b["imgs"], b["proj_matrices"], b["depth_values"], compute_dtype=dtype)["stage3"]
                        for _ in range(2))
        for key in ("depth", "photometric_confidence"):
            assert torch.equal(first[key], again[key]), (dtype, key)


@pytest.mark.parametrize("dtype,kernels", [("bf16", True), ("bf16", False), ("fp32", True)])
def test_train_steps_repeat(gen, dtype, kernels):
    """Two train steps from the same weights and batch, each with a fresh
    optimizer: the loss, every gradient and the update (the weights and the
    BN statistics after the step) bit for bit; the kernel path (K5's
    fixed-point d_src), the plain bf16 path and the fp32 step (the plain
    warp's and the resizes' gathers differentiated in a fixed order)."""
    from cds_mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from cds_mvsnet_tpu_torch.models import build_model, to_tensors
    from cds_mvsnet_tpu_torch.training import TrainStep
    from cds_mvsnet_tpu_torch.utils.synthetic import synthetic_batch

    torch.backends.cudnn.deterministic = False
    model = build_model(ModelConfig(refine=True, ndepths=(48, 32, 8)), seed=0, device="cuda")
    batch = to_tensors(synthetic_batch(B=2, V=3, H=256, W=320, D=192, refine=True, with_gt=True, seed=0), "cuda")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for _ in range(2):
        model.load_state_dict(start)
        step = TrainStep(model, TrainConfig(compute_dtype=dtype, remat_features=True), kernels=kernels)
        loss = step(batch, 0.01)["loss"]
        runs.append((loss.clone(), [p.grad.clone() for p in step.params],
                     {k: v.clone() for k, v in model.state_dict().items()}))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert bool(torch.isfinite(l0)) and torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert any(not torch.equal(s0[k], start[k]) for k in s0)  # the step moved the weights


def test_index_select_gradient_repeats(gen):
    """ops.index.index_select's backward (index_put_ with accumulate, which
    PyTorch sorts) sums heavily repeated rows in the same order every run,
    within fp32 rounding of an fp64 sum; autograd's own index_add_ is the
    form it replaces."""
    from cds_mvsnet_tpu_torch.ops.index import index_select

    src = uniform(gen, (64, 32), dtype=torch.float32).requires_grad_()
    idx = (torch.rand(200_000, generator=gen, device="cuda") * 64).long()
    g = uniform(gen, (200_000, 32), dtype=torch.float32)
    grads = [torch.autograd.grad(index_select(src, 0, idx), src, g)[0] for _ in range(3)]
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])
    assert torch.equal(index_select(src, 0, idx), torch.index_select(src, 0, idx))
    want = torch.zeros(64, 32, dtype=torch.float64, device="cuda").index_add_(0, idx, g.double())
    terms = torch.zeros(64, 32, dtype=torch.float64, device="cuda").index_add_(0, idx, g.double().abs())
    assert bool(((grads[0].double() - want).abs() <= 2 ** -20 * terms).all())


# T&T stage shapes (C, D, h, w): the Family bucket's three stages (1088x1920)
# and stage 1 of the 896x1600 and 544x960 buckets, whose widths 400 and 240
# are no multiple of the kernels' 32-wide tiles
TT_STAGES = [(32, 48, 272, 480), (16, 32, 544, 960), (8, 8, 1088, 1920), (32, 48, 224, 400), (32, 48, 136, 240)]


@pytest.mark.parametrize("C,D,h,w", TT_STAGES)
def test_tt_stage_kernels_match_plain(gen, C, D, h, w):
    """K1, K2 and K3 at the T&T stage shapes, against their plain versions
    under chip_smoke.py's contracts: K1's in_prod within one bf16 ulp of the
    warped value and its entropy within 1e-2, K2 within one bf16 ulp, K3's
    depth within 1e-2 and its confidence within 1e-4 off truncation
    boundaries."""
    from cds_mvsnet_tpu_torch.models import to_tensors
    from cds_mvsnet_tpu_torch.ops.geometry import relative_warp_transform
    from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

    stage = {32: 1, 16: 2, 8: 3}[C]
    H, W = h * 2 ** (3 - stage), w * 2 ** (3 - stage)
    cams = to_tensors(textured_plane_batch(V=2, H=H, W=W, D=256, seed=0), "cuda")["proj_matrices"][f"stage{stage}"]
    rot, trans = relative_warp_transform(cams[:, 0], cams[:, 1])
    rt = torch.cat([rot.reshape(9), trans.reshape(3)]).float().contiguous()
    if stage == 1:
        hyp = torch.linspace(425.0, 937.0, D, device="cuda")
    else:
        centre = uniform(gen, (h, w), 560.0, 640.0, torch.float32)
        steps = torch.arange(D, device="cuda", dtype=torch.float32) - (D - 1) // 2
        hyp = (centre[None] + steps[:, None, None] * (2.0, 1.0)[stage - 2] * 2.0).contiguous()
    src, ref = uniform(gen, (h, w, C)), uniform(gen, (C, h, w))
    ip, ent = K.warp_entropy(src, ref, hyp, rt)
    ip_p, ent_p = K.warp_entropy_plain(src, ref, hyp, rt)
    assert within_one_ulp(ip, ip_p, 2 ** -8)
    assert float((ent - ent_p).abs().max()) <= 1e-2
    del ip, ip_p, ent, ent_p
    vol, wk, bk = conv_rig(gen, C, 8, torch.bfloat16, (D, h, w))
    assert within_one_ulp(K.conv3d_bn_relu(vol, wk, bk), K.conv3d_bn_relu_plain(vol, wk, bk))
    del vol
    y = uniform(gen, (8, D, h, w), -2.0, 2.0)
    wp = uniform(gen, (1, 8, 3, 3, 3), -0.3, 0.3, torch.float32)
    depth, conf = K.exit_softargmin(y, wp, hyp)
    assert exit_within_tolerance(y, wp, hyp, depth, conf)


@pytest.mark.parametrize("H,W", [(1088, 1920), (896, 1600), (544, 960)])
def test_tt_conv01_matches_plain(gen, H, W):
    """K4 on conv01 over the 2(V-1) = 18 images of a T&T request at each
    bucket (18 x 8 x 1088 x 1920 in), bit for bit."""
    x, ws = dynconv_rig(gen, 18, 8, 11, (3, 5, 7), (H, W))
    assert torch.equal(K.dynconv_branches(x, ws), K.dynconv_branches_plain(x, ws))


def smoke_gates(name: str, argv: list[str], report: dict) -> list[str]:
    """``chip_smoke.tool_problems``: the gates the smoke's tools phase holds
    a tool's run to."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke.tool_problems(name, argv, report)


def test_profile_stages_tool_on_the_card(gen, monkeypatch, capsys):
    """``tools/profile_stages.py`` at 128x256 (its point's constants patched):
    each prefix-n request launches K1 4n, K2 n, K3 n, K4 once and nothing
    else, prefix n's stages equal the full cascade's bit for bit, the line's
    keys are the JAX tool's and K1's; ``--marginals`` gives the four split
    values (the smoke's gates)."""
    from cds_mvsnet_tpu_torch.tools import profile_stages

    monkeypatch.setattr(profile_stages, "H", 128)
    monkeypatch.setattr(profile_stages, "W", 256)
    report = profile_stages.main(["--reps", "1"])
    assert report["device"] == "cuda" and smoke_gates("profile_stages", ["--reps", "1"], report) == []
    assert report["launches"]["prefix2"] == {"warp_entropy": 8, "conv3d_bn_relu": 2, "exit_softargmin": 2,
                                             "dynconv_branches": 1}
    monkeypatch.setattr(profile_stages, "MARGINAL_REPS", 1)
    marginals = profile_stages.main(["--marginals"])
    assert smoke_gates("profile_stages", ["--marginals"], marginals) == []
    split = marginals["line"]
    assert {k for k in split if k.startswith("stage")} == {"stage2_per_src_view_ms", "stage2_fixed_ms",
                                                            "stage3_per_src_view_ms", "stage3_fixed_ms"}


def test_bench_scan_tool_on_the_card(gen, tmp_path, capsys):
    """``tools/bench_scan.py`` on a 3-view scan at 128x256 in bf16: each
    leg launches the product's bf16 counts a map, each ``.ply``'s vertices
    equal the line's points, every rate finite (the smoke's gates)."""
    from cds_mvsnet_tpu_torch.tools import bench_scan

    argv = ["--views", "3", "--h", "128", "--w", "256", "--out", str(tmp_path)]
    report = bench_scan.main(argv)
    assert report["line"]["backend"] == "cuda" and smoke_gates("bench_scan", argv, report) == []
    assert report["launches"]["depth"] == {"warp_entropy": 36, "conv3d_bn_relu": 9, "exit_softargmin": 9,
                                           "dynconv_branches": 3}
    assert report["line"]["points_jit"] > 0


def test_bench_train_tool_on_the_card(gen, monkeypatch, capsys):
    """``tools/bench_train.py`` at 128x128, B=2: finite losses in fp32 and
    bf16, K5 48 times forward and 48 backward in a bf16 step, no kernel in
    an fp32 step (the smoke's gates)."""
    from cds_mvsnet_tpu_torch.tools import bench_train

    monkeypatch.setattr(bench_train, "H", 128)
    monkeypatch.setattr(bench_train, "W", 128)
    report = bench_train.main(["--bs", "2", "--reps", "1"])
    assert smoke_gates("bench_train", ["--bs", "2", "--reps", "1"], report) == []
    assert report["launches"] == {"fp32": {}, "bf16": {"warp_sim": 48, "warp_sim_backward": 48}}


def test_train_convergence_tool_on_the_card(gen, monkeypatch, capsys):
    """``tools/train_convergence.py`` at its defaults (10 epochs x 5 steps,
    64x64, D=48) on the card: the loss decreases."""
    from cds_mvsnet_tpu_torch.tools import train_convergence

    for k in (*train_convergence.DEFAULTS, "CONV_PLATFORM"):
        monkeypatch.delenv(k, raising=False)
    line = train_convergence.main([])
    assert smoke_gates("train_convergence", [], line) == []
    assert line["steps_total"] == 50 and len(line["curve"]) == 10
    assert line["loss_decreased"], (line["loss_first_epoch"], line["loss_last_epoch"])


def test_convert_checkpoint_and_profiling_on_the_card(gen, tmp_path, capsys):
    """``tools/convert_checkpoint.py`` with no device asked for (the card)
    round-trips a seeded model's ``.pth``; ``utils/profiling``'s trace holds
    the card's kernels and ``sync`` waits on a CUDA tensor."""
    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.models import build_model
    from cds_mvsnet_tpu_torch.tools import convert_checkpoint
    from cds_mvsnet_tpu_torch.utils.profiling import SectionTimer, device_trace, sync

    model = build_model(ModelConfig(refine=False), seed=1, device="cuda")
    torch.save({"state_dict": model.state_dict()}, tmp_path / "m.pth")
    convert_checkpoint.main([str(tmp_path / "m.pth"), str(tmp_path / "m.npz")])
    again = build_model(ModelConfig(refine=False), params=str(tmp_path / "m.npz"), device="cuda")
    assert all(torch.equal(again.state_dict()[k], v) for k, v in model.state_dict().items())
    src, ref = uniform(gen, (40, 64, 8)), uniform(gen, (8, 32, 64))
    rt = torch.tensor([1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0, 1.0, 0, 0], device="cuda")
    timer = SectionTimer()
    with device_trace(str(tmp_path / "trace")):
        with timer.section("warp", result=None):
            out = K.warp_entropy(src, ref, torch.linspace(2.0, 9.0, 8, device="cuda"), rt)
            sync({"out": list(out)})
    (trace,) = (tmp_path / "trace").glob("*.pt.trace.json")
    assert "warp_entropy_kernel" in trace.read_text()
    assert timer.summary()["warp"]["n"] == 1
