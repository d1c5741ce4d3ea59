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

import pytest
import torch

from cds_mvsnet_tpu_torch.ops import kernels as K

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
def test_conv3d_bn_relu_matches_plain(gen, C):
    vol = uniform(gen, (C, 5, 11, 45))
    w = uniform(gen, (8, C, 3, 3, 3), -(27 * C) ** -0.5, (27 * C) ** -0.5, torch.float32)
    b = uniform(gen, (8,), -0.1, 0.1, torch.float32)
    assert within_one_ulp(K.conv3d_bn_relu(vol, w, b), K.conv3d_bn_relu_plain(vol, w, b))


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


@pytest.mark.parametrize("ks,OA", [((3, 5, 7), 11), ((1, 3), 19), ((1, 3), 35)])
def test_dynconv_branches_matches_plain(gen, ks, OA):
    I_ = 8 if OA == 11 else OA - 3
    x = uniform(gen, (3, I_, 21, 70))
    ws = [uniform(gen, (OA, I_, k, k), -(I_ * k * k) ** -0.5, (I_ * k * k) ** -0.5, torch.float32) for k in ks]
    assert within_one_ulp(K.dynconv_branches(x, ws), K.dynconv_branches_plain(x, ws))


def test_wrappers_raise_rather_than_fall_back(gen):
    vol = uniform(gen, (8, 4, 6, 6), dtype=torch.float32)
    w = uniform(gen, (8, 8, 3, 3, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        K.conv3d_bn_relu(vol, w, torch.zeros(8, device="cuda"))
    with pytest.raises(ValueError, match="devices"):
        K.conv3d_bn_relu(vol.bfloat16(), w.cpu(), torch.zeros(8))
