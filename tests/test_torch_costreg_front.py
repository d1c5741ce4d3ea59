"""The cost-regularisation fronts: K7 (``conv3d_down``), K2 at 16 output
channels and K6 (``conv3d_front_fused``) against the JAX package's kernels in
interpret mode and against ``lax.conv_general_dilated``, and ``CostRegNet``
under each front against ``cost_reg_net_s2d(..., cfirst=True)`` under
``CDS_COSTREG_FRONT=<front>_interp``. On the CPU every wrapper takes its
plain version."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.models.cost_reg import cost_reg_net_s2d, init_cost_reg_net
from cds_mvsnet_tpu.ops.pallas.conv3d import conv3d_down, conv3d_front, conv3d_front_fused
from cds_mvsnet_tpu_torch.models.cost_reg import CostRegNet
from cds_mvsnet_tpu_torch.models.warp_routes import FRONTS
from cds_mvsnet_tpu_torch.ops import kernels as K
from test_torch_ops import N, T, load_module, numpy_params

torch.set_num_threads(2)


def _lax(vol, w, b, stride):
    """fp32 ``relu(conv3d(vol) + b)``, (C, D, h, w) in and out, DHWIO weights."""
    x = jnp.transpose(jnp.asarray(vol, jnp.float32), (1, 2, 3, 0))[None]
    y = jax.lax.conv_general_dilated(x, jnp.asarray(w), (stride,) * 3, [(1, 1)] * 3,
                                     dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
                                     precision=jax.lax.Precision.HIGHEST)
    return np.asarray(jnp.transpose(jax.nn.relu(y + b)[0], (3, 0, 1, 2)))


def _conv_inputs(rng, C, O, D, h, w):
    vol = rng.standard_normal((C, D, h, w)).astype(np.float32)
    wj = (rng.standard_normal((3, 3, 3, C, O)) * 0.2).astype(np.float32)  # (kd, ky, kx, in, out)
    bj = rng.standard_normal(O).astype(np.float32)
    return vol, wj, bj


def _torch_w(wj):
    return T(np.transpose(wj, (4, 3, 0, 1, 2))).contiguous()  # (O, C, 3, 3, 3)


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("kernel", ["k7", "k2_o16"])
def test_plain_matches_tpu_kernel_and_lax(kernel):
    """K7 (8 -> 16, stride 2) and K2 at O = 16 (16 -> 16, conv2's shape)."""
    rng = np.random.default_rng(4 if kernel == "k7" else 5)
    C, stride = (8, 2) if kernel == "k7" else (16, 1)
    D, h, w = 4, 20, 44
    vol, wj, bj = _conv_inputs(rng, C, 16, D, h, w)
    vol16 = _bf16(vol)
    if kernel == "k7":
        want = conv3d_down(jnp.asarray(vol16).astype(jnp.bfloat16), jnp.asarray(wj), jnp.asarray(bj), kd=2, tr=8,
                           interpret=True)
        fn, plain = K.conv3d_down, K.conv3d_down_plain
    else:
        want = conv3d_front(jnp.asarray(vol16).astype(jnp.bfloat16), jnp.asarray(wj), jnp.asarray(bj), kd=4,
                            tr=8, interpret=True)
        fn, plain = K.conv3d_bn_relu, K.conv3d_bn_relu_plain
    got = plain(T(vol16).to(torch.bfloat16), _torch_w(wj), T(bj))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (16, D // stride, h // stride, w // stride)
    # the JAX kernels' tests' tolerance (tests/test_s2d_3d.py:92,138): the TPU
    # kernel rounds its weights to bf16 for the matrix unit
    np.testing.assert_allclose(N(got), N(want), atol=0.15, rtol=0.05)
    # fp32: the same function as lax's convolution
    got32 = plain(T(vol), _torch_w(wj), T(bj))
    np.testing.assert_allclose(N(got32), _lax(vol, wj, bj, stride), rtol=1e-5, atol=1e-5)
    assert torch.equal(fn(T(vol), _torch_w(wj), T(bj)), got32)  # CPU: the wrapper takes the plain version


def test_k6_plain_matches_conv3d_front_fused():
    """K6 at a width above 128 (two of the TPU kernel's x tiles, its ring
    carry) and a height the TPU tile does not divide."""
    rng = np.random.default_rng(6)
    C, D, h, w = 8, 4, 20, 136
    vol, w0, b0 = _conv_inputs(rng, C, 8, D, h, w)
    w1 = (rng.standard_normal((3, 3, 3, 8, 16)) * 0.2).astype(np.float32)
    b1 = rng.standard_normal(16).astype(np.float32)
    vol16 = _bf16(vol)
    want0, want1 = conv3d_front_fused(jnp.asarray(vol16).astype(jnp.bfloat16), jnp.asarray(w0), jnp.asarray(b0),
                                      jnp.asarray(w1), jnp.asarray(b1), kd=2, tr=16, interpret=True)
    args = (_torch_w(w0), T(b0), _torch_w(w1), T(b1))
    got0, got1 = K.conv3d_front_fused_plain(T(vol16).to(torch.bfloat16), *args)
    assert got0.dtype == got1.dtype == torch.bfloat16
    assert tuple(got0.shape) == (8, D, h, w) and tuple(got1.shape) == (16, D // 2, h // 2, w // 2)
    # tests/test_s2d_3d.py:182-185: bf16 weights on the TPU, and conv1 sees
    # conv0's bf16 values, so the two sides' conv0 flips propagate
    np.testing.assert_allclose(N(got0), N(want0), atol=0.15, rtol=0.05)
    np.testing.assert_allclose(N(got1), N(want1), atol=0.3, rtol=0.05)
    # conv1 reads conv0 rounded to bf16: lax's fp32 conv1 on the port's own
    # bf16 conv0, rounded once more, is the port's conv1
    ref1 = _lax(N(got0), w1, b1, 2)
    assert np.all(np.abs(N(got1) - ref1) <= 2 ** -8 * np.abs(ref1) + 1e-4)
    # in fp32 the whole pair is lax's conv0, then lax's stride-2 conv1
    g0, g1 = K.conv3d_front_fused(T(vol), *args)
    ref0 = _lax(vol, w0, b0, 1)
    np.testing.assert_allclose(N(g0), ref0, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(g1), _lax(ref0, w1, b1, 2), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("front,tol", [("pallasf", 6e-3), ("pallasf3", 8e-3), ("pallas2", 4e-3), ("pallas3", 6e-3)])
def test_cost_reg_front_matches_jax(monkeypatch, front, tol):
    """``CostRegNet`` under a front (plain versions, bridged weights) against
    the JAX s2d UNet under the same front in interpret mode, at the JAX
    package's own tolerances for these fronts (tests/test_s2d_3d.py:54-205)."""
    p = numpy_params(init_cost_reg_net, 16, 8, seed=11)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((16, 8, 16, 16)).astype(np.float32)  # (C, D, h, w)
    monkeypatch.setenv("CDS_COSTREG_FRONT", f"{front}_interp")
    want = cost_reg_net_s2d(p, jnp.asarray(x), b=4, cfirst=True)[0, ..., 0]  # (D, h, w)
    net = CostRegNet(16, 8)
    load_module(net, p, "cost_regularization.0")
    y = net(T(x), K.conv3d_bn_relu, front)
    got = torch.nn.functional.conv3d(y[None], net.prob.weight, padding=1)[0, 0]
    np.testing.assert_allclose(N(got), N(want), rtol=tol, atol=tol)


# the wrappers each front calls, in order (models/cost_reg.py); the rest of
# the UNet is cuDNN's
FRONT_KERNELS = {
    "pallas": ("conv3d_bn_relu",),
    "pallasf": ("conv3d_front_fused",),
    "pallasf3": ("conv3d_front_fused", "conv3d_bn_relu"),
    "pallas2": ("conv3d_bn_relu", "conv3d_down"),
    "pallas3": ("conv3d_bn_relu", "conv3d_down", "conv3d_bn_relu"),
    "s2d": (),
}


@pytest.mark.parametrize("front", FRONTS)
@pytest.mark.parametrize("even", [True, False])
def test_front_runs_its_kernels(monkeypatch, front, even):
    """Each front calls the wrappers ``FRONT_KERNELS`` names, in order, and
    with an odd D, h or w the ``pallasf``/``pallas2`` forms fall back to K2 alone,
    as the JAX ladder does; every front computes the same UNet (which needs
    D, h, w divisible by 8, so the odd case runs the front alone)."""
    calls = []
    for name in ("conv3d_bn_relu", "conv3d_down", "conv3d_front_fused"):
        fn = getattr(K, name)

        def spy(*args, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*args)

        monkeypatch.setattr(K, name, spy)
    p = numpy_params(init_cost_reg_net, 8, 8, seed=3)
    net = CostRegNet(8, 8)
    load_module(net, p, "cost_regularization.0")
    x = T(np.random.default_rng(2).standard_normal((8, 8, 16, 24 if even else 21)))
    if not even:
        conv0, conv2 = net.front(x, K.conv3d_bn_relu, front)
        assert tuple(calls) == (() if front == "s2d" else ("conv3d_bn_relu",))
        assert tuple(conv0.shape) == (1, 8, 8, 16, 21) and tuple(conv2.shape) == (1, 16, 4, 8, 11)
        return
    y = net(x, K.conv3d_bn_relu, front)
    assert tuple(calls) == FRONT_KERNELS[front]
    # the plain paths agree with the default front to fp32 rounding
    np.testing.assert_allclose(N(y), N(net(x, K.conv3d_bn_relu_plain)), rtol=1e-4, atol=1e-4)


def test_wrappers_check_their_inputs():
    vol = torch.zeros(8, 4, 6, 10, dtype=torch.bfloat16)
    w16, b16 = torch.zeros(16, 8, 3, 3, 3), torch.zeros(16)
    w0, b0 = torch.zeros(8, 8, 3, 3, 3), torch.zeros(8)
    with pytest.raises(ValueError, match="even"):
        K.conv3d_down(torch.zeros(8, 5, 6, 10, dtype=torch.bfloat16), w16, b16)
    with pytest.raises(ValueError, match="even"):
        K.conv3d_down(torch.zeros(8, 4, 6, 9, dtype=torch.bfloat16), w16, b16)
    with pytest.raises(ValueError, match="even"):
        K.conv3d_front_fused(torch.zeros(8, 4, 7, 10, dtype=torch.bfloat16), w0, b0, w16, b16)
    with pytest.raises(ValueError, match="O in"):
        K.conv3d_bn_relu(vol, torch.zeros(4, 8, 3, 3, 3), torch.zeros(4))
    with pytest.raises(ValueError, match="w1"):
        K.conv3d_front_fused(vol, w0, b0, torch.zeros(16, 4, 3, 3, 3), b16)
    with pytest.raises(ValueError, match="shared memory"):
        K.conv3d_bn_relu(torch.zeros(32, 4, 6, 10), torch.zeros(16, 32, 3, 3, 3), b16)
    before = [k.launches for k in K.ROUTE_KERNELS]
    out0, out1 = K.conv3d_front_fused(vol, w0, b0, w16, b16)
    assert tuple(out1.shape) == (16, 2, 3, 5) and [k.launches for k in K.ROUTE_KERNELS] == before
