"""Cost regularisation, K2 (conv0) and K3 (exit: prob conv + soft-argmin) vs
the JAX package."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.models.cost_reg import cost_reg_net, init_cost_reg_net
from cds_mvsnet_tpu.models.layers import conv3d as jax_conv3d
from cds_mvsnet_tpu.ops.pallas.conv3d import conv3d_front, fold_bn_into_conv3d
from cds_mvsnet_tpu.ops.pallas.regress import exit_softargmin as jax_exit_softargmin
from cds_mvsnet_tpu.ops.sampling import confidence_regression, depth_regression
from cds_mvsnet_tpu_torch.models.cost_reg import CostRegNet
from cds_mvsnet_tpu_torch.ops.kernels import (
    conv3d_bn_relu,
    conv3d_bn_relu_plain,
    exit_softargmin,
    exit_softargmin_plain,
)
from test_torch_ops import N, T, jax_highest, load_module, numpy_params

torch.set_num_threads(2)


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("C,D", [(32, 8), (8, 16)])
def test_cost_reg_matches_jax_fp32(C, D):
    rng = np.random.default_rng(C)
    h, w = 16, 24
    p = numpy_params(init_cost_reg_net, C, 8, seed=C)
    vol = rng.standard_normal((1, D, h, w, C)).astype(np.float32)
    with jax_highest():
        want = cost_reg_net(p, jnp.asarray(vol))[0, ..., 0]  # (D, h, w)
    net = CostRegNet(C, 8)
    load_module(net, p, "cost_regularization.0")
    y = net(T(vol[0]).permute(3, 0, 1, 2).contiguous(), conv3d_bn_relu_plain)
    got = torch.nn.functional.conv3d(y[None], net.prob.weight, padding=1)[0, 0]
    # fp32 UNet, conv0 with BN folded into the weights: sums in other orders
    # through 11 conv layers, ~1e-5 relative of O(1) logits
    np.testing.assert_allclose(N(got), N(want), rtol=1e-4, atol=1e-4)


def test_fold_bn_matches_jax():
    p = numpy_params(init_cost_reg_net, 16, 8, seed=1)
    wj, bj = fold_bn_into_conv3d(p["conv0"]["conv"], p["conv0"]["bn"])
    net = CostRegNet(16, 8)
    load_module(net, p, "cost_regularization.0")
    wt, bt = net.folded("conv0")
    np.testing.assert_allclose(N(wt), np.transpose(N(wj), (4, 3, 0, 1, 2)), rtol=1e-6)  # same fp32 ops
    np.testing.assert_allclose(N(bt), N(bj), rtol=1e-6, atol=1e-7)


def test_k2_plain_matches_conv3d_front():
    """K2's plain version against the TPU conv0 kernel in interpret mode."""
    rng = np.random.default_rng(3)
    C, D, h, w = 16, 4, 16, 40
    vol = _bf16(rng.standard_normal((C, D, h, w)))
    wj = (rng.standard_normal((3, 3, 3, C, 8)) / np.sqrt(27 * C)).astype(np.float32)
    bj = (0.1 * rng.standard_normal(8)).astype(np.float32)
    want = conv3d_front(jnp.asarray(vol).astype(jnp.bfloat16), jnp.asarray(wj), jnp.asarray(bj),
                        kd=4, tr=8, interpret=True)
    want = N(want.astype(jnp.float32))[:, :, :h, :w]
    vt = T(vol).to(torch.bfloat16)
    wt = T(np.transpose(wj, (4, 3, 0, 1, 2))).contiguous()
    got = conv3d_bn_relu_plain(vt, wt, T(bj))
    assert got.dtype == torch.bfloat16 and got.shape == (8, D, h, w)
    # both round one fp32 sum to bf16 (2^-7 relative covers one ulp); the TPU
    # kernel also rounds its weights to bf16: 2^-9 of sum|w||x| (~0.05 here)
    np.testing.assert_allclose(N(got), want, rtol=2 ** -7, atol=2e-2)
    assert torch.equal(conv3d_bn_relu(vt, wt, T(bj)), got)  # CPU: the plain version


def _s2d_exit(y, b=4):
    """(C, D, h, w) -> the TPU kernel's (D, h/b, w/b, b*b*C) layout."""
    C, D, h, w = y.shape
    v = y.transpose(1, 2, 3, 0).reshape(D, h // b, b, w // b, b, C)
    return v.transpose(0, 1, 3, 2, 4, 5).reshape(D, h // b, w // b, b * b * C)


def test_k3_plain_matches_exit_softargmin_dvol():
    """K3's plain version against the TPU exit kernel in its exact ``dvol``
    mode (interpret), on refined-stage-like per-pixel hypotheses."""
    rng = np.random.default_rng(4)
    D, h, w = 8, 16, 24
    y = _bf16(0.5 * rng.standard_normal((8, D, h, w)))
    wp = (0.3 * rng.standard_normal((1, 8, 3, 3, 3))).astype(np.float32)
    dvol = (600 + 30 * rng.standard_normal((1, h, w)) + 5.0 * np.arange(D)[:, None, None]).astype(np.float32)
    dj, cj = jax_exit_softargmin(
        jnp.asarray(_s2d_exit(y)).astype(jnp.bfloat16), jnp.asarray(np.transpose(wp[0], (1, 2, 3, 0))[..., None]),
        dvol=jnp.asarray(dvol), interpret=True,
    )
    yt = T(y).to(torch.bfloat16)
    dt, ct = exit_softargmin_plain(yt, T(wp), T(dvol))
    # the TPU kernel multiplies bf16-rounded weights: each logit moves by up
    # to 2^-9·Σ|w·y| (~0.04 here), the expectation over a ~35 mm window by
    # at most span·max|d logit| / 2 (~0.7 mm); typically far less
    np.testing.assert_allclose(N(dt), N(dj), atol=0.25)
    # confidence: same window wherever both truncate idx to the same plane
    idx_t = (torch.softmax(torch.nn.functional.conv3d(yt.float()[None], T(wp), padding=1)[0, 0], 0)
             * torch.arange(D)[:, None, None]).sum(0)
    frac = N(idx_t) % 1
    safe = (frac > 0.02) & (frac < 0.98)
    assert safe.mean() > 0.9
    np.testing.assert_allclose(N(ct)[safe], N(cj)[safe], atol=1e-2)
    got = exit_softargmin(yt, T(wp), T(dvol))
    assert torch.equal(got[0], dt) and torch.equal(got[1], ct)  # CPU: the plain version


@pytest.mark.parametrize("per_pixel", [False, True])
def test_k3_plain_matches_xla_tail_fp32(per_pixel):
    """In fp32, K3's plain version is the JAX XLA tail: prob conv, softmax
    over D, depth_regression over the hypotheses, confidence_regression."""
    rng = np.random.default_rng(5)
    D, h, w = 12, 10, 14
    y = rng.standard_normal((8, D, h, w)).astype(np.float32)
    wp = (0.3 * rng.standard_normal((1, 8, 3, 3, 3))).astype(np.float32)
    if per_pixel:
        hyp = (500 + 50 * rng.standard_normal((1, h, w)) + 4.0 * np.arange(D)[:, None, None]).astype(np.float32)
    else:
        hyp = np.linspace(425, 905, D, dtype=np.float32)
    with jax_highest():
        cost = jax_conv3d(jnp.asarray(y.transpose(1, 2, 3, 0))[None], {"weight": jnp.asarray(np.transpose(wp[0], (1, 2, 3, 0))[..., None])})
        prob = jax.nn.softmax(cost[..., 0], axis=1)
        dj = depth_regression(prob, jnp.asarray(hyp)[None])[0]
        cj = confidence_regression(prob)[0]
    dt, ct = exit_softargmin_plain(T(y), T(wp), T(hyp))
    # fp32 on both sides; depth is a ~600 mm expectation: 1e-6 relative
    np.testing.assert_allclose(N(dt), N(dj), rtol=2e-6, atol=1e-3)
    np.testing.assert_allclose(N(ct), N(cj), atol=1e-5)


def test_k2_k3_wrappers_check_their_inputs():
    vol = torch.zeros(8, 4, 8, 8, dtype=torch.bfloat16)
    w = torch.zeros(8, 8, 3, 3, 3)
    b = torch.zeros(8)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        conv3d_bn_relu(vol.half(), w, b)
    # both eval routes: the output keeps the volume's dtype
    assert conv3d_bn_relu(vol.float(), w, b).dtype == torch.float32
    assert conv3d_bn_relu(vol, w, b).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="w "):
        conv3d_bn_relu(vol, torch.zeros(4, 8, 3, 3, 3), b)
    with pytest.raises(ValueError, match="shared memory"):
        conv3d_bn_relu(torch.zeros(64, 4, 8, 8, dtype=torch.bfloat16), torch.zeros(8, 64, 3, 3, 3), b)
    wp = torch.zeros(1, 8, 3, 3, 3)
    with pytest.raises(ValueError, match="hyp"):
        exit_softargmin(vol, wp, torch.zeros(5))
    with pytest.raises(ValueError, match="y "):
        exit_softargmin(torch.zeros(4, 4, 8, 8, dtype=torch.bfloat16), wp, torch.zeros(4))
    with pytest.raises(ValueError, match="fp32"):
        exit_softargmin(vol, wp.double(), torch.zeros(4))
