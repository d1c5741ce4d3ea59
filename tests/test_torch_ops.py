"""PyTorch port vs the JAX package: geometry, sampling, resize and the shared
helpers of the ``test_torch_*`` files.

Inputs come from seeded numpy and go through both packages on the CPU. fp32
comparisons run JAX at Precision.HIGHEST; tolerances are stated with their
reason beside each assertion.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.models import layers as jlayers
from cds_mvsnet_tpu.ops import geometry as jgeo
from cds_mvsnet_tpu.ops import grid_sample as jgs
from cds_mvsnet_tpu.ops import resize as jresize
from cds_mvsnet_tpu.ops import sampling as jsamp
from cds_mvsnet_tpu_torch.ops import geometry as tgeo
from cds_mvsnet_tpu_torch.ops import grid_sample as tgs
from cds_mvsnet_tpu_torch.ops import resize as tresize
from cds_mvsnet_tpu_torch.ops import sampling as tsamp

# the suite runs several xdist workers on a few cores
torch.set_num_threads(2)


@contextlib.contextmanager
def jax_highest():
    """Run JAX convolutions and products at fp32 accuracy; the precision is
    process-global, so the previous value comes back afterwards."""
    old = jlayers.default_precision()
    jlayers.set_default_precision(jax.lax.Precision.HIGHEST)
    try:
        yield
    finally:
        jlayers.set_default_precision(old)


def T(a, dtype=torch.float32) -> torch.Tensor:
    """numpy/JAX array -> CPU tensor (copied)."""
    return torch.tensor(np.asarray(a, dtype=np.float32)).to(dtype)


def N(t) -> np.ndarray:
    """tensor or JAX array -> fp32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, dtype=np.float32)


def random_cams(rng, B: int, H: int, W: int, tz: float = 0.3) -> np.ndarray:
    """Packed ``(B, 2, 4, 4)`` cameras with small random rotations and a
    translation with a z component (finite epipoles)."""
    cams = np.zeros((B, 2, 4, 4), np.float32)
    for b in range(B):
        a = 0.1 * rng.standard_normal(3)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        R = np.eye(3) + np.sin(np.linalg.norm(a)) * K / max(np.linalg.norm(a), 1e-9)
        U, _, Vt = np.linalg.svd(R)
        cams[b, 0, :3, :3] = U @ Vt
        cams[b, 0, :3, 3] = rng.uniform(-1, 1, 3) * np.array([30.0, 10.0, 30.0 * tz])
        cams[b, 0, 3, 3] = 1.0
        f = 1.1 * W
        cams[b, 1, :3, :3] = [[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]
        cams[b, 1, 3, 3] = 1.0
    return cams


def test_fundamental_and_epipoles_match():
    rng = np.random.default_rng(0)
    c1, c2 = random_cams(rng, 4, 48, 64), random_cams(rng, 4, 48, 64)
    Fj = jgeo.fundamental_matrix(jnp.asarray(c1), jnp.asarray(c2))
    Ft = tgeo.fundamental_matrix(T(c1), T(c2))
    # fp32 products of ~1e3-scale intrinsics: relative 1e-5 of the largest entry
    scale = np.abs(N(Fj)).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(N(Ft) / scale, N(Fj) / scale, atol=1e-5)
    ej = jgeo.epipole_from_fundamental(Fj)
    et = tgeo.epipole_from_fundamental(Ft)
    # the 2x2 solve amplifies F's fp32 rounding by its conditioning; finite
    # epipoles here lie within ~1e4 px: 1e-3 relative
    np.testing.assert_allclose(N(et), N(ej), rtol=1e-3, atol=1e-2)


def test_epipole_at_infinity_takes_the_svd_branch():
    """The default textured-plane rig translates only in x/y: every epipole is
    at infinity, the 2x2 solve is singular and both packages take the SVD
    null vector. Its sign is free and its scale is clamped, so compare the
    epipolar line direction, which is what DynamicConv uses."""
    from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

    cams = textured_plane_batch(V=3, H=32, W=48, D=8)["proj_matrices"]["stage3"][0]
    ref = np.broadcast_to(cams[:1], (2, 2, 4, 4)).copy()
    src = cams[1:]
    et = tgeo.epipole_from_fundamental(tgeo.fundamental_matrix(T(ref), T(src)))
    ej = jgeo.epipole_from_fundamental(jgeo.fundamental_matrix(jnp.asarray(ref), jnp.asarray(src)))
    assert np.isfinite(N(et)).all()
    dt = N(et) / np.linalg.norm(N(et), axis=1, keepdims=True)
    dj = N(ej) / np.linalg.norm(N(ej), axis=1, keepdims=True)
    # directions of ~1e8-px points: |cos| = 1 to fp32 rounding
    np.testing.assert_allclose(np.abs((dt * dj).sum(1)), 1.0, atol=1e-5)


@pytest.mark.parametrize("det_eps", [1e-12, 1e30])
def test_epipole_det_eps_switch(det_eps):
    """det_eps=1e30 forces the SVD branch on a regular pair: both packages
    switch together, and both branches give the same epipole."""
    rng = np.random.default_rng(1)
    c1, c2 = random_cams(rng, 3, 48, 64), random_cams(rng, 3, 48, 64)
    Fj = jgeo.fundamental_matrix(jnp.asarray(c1), jnp.asarray(c2))
    Ft = tgeo.fundamental_matrix(T(c1), T(c2))
    et = tgeo.epipole_from_fundamental(Ft, det_eps=det_eps)
    ej = jgeo.epipole_from_fundamental(Fj, det_eps=det_eps)
    # see test_fundamental_and_epipoles_match: 1e-3 relative
    np.testing.assert_allclose(N(et), N(ej), rtol=1e-3, atol=1e-2)
    direct = tgeo.epipole_from_fundamental(Ft)
    # SVD vs 2x2 solve of the same fp32 F: agree to 1e-2 relative
    np.testing.assert_allclose(N(et), N(direct), rtol=1e-2, atol=1e-1)
    # F = 0 (one camera centre): both fall back to the null vector [0, 0, 1],
    # so the epipole is finite, (0, 0), in both packages
    zero = np.zeros((2, 3, 3), np.float32)
    ez = N(tgeo.epipole_from_fundamental(T(zero), det_eps=det_eps))
    np.testing.assert_array_equal(ez, N(jgeo.epipole_from_fundamental(jnp.asarray(zero), det_eps=det_eps)))
    np.testing.assert_array_equal(ez, np.zeros((2, 2), np.float32))


@pytest.mark.parametrize("per_pixel", [False, True])
def test_plane_sweep_and_homography_warp(per_pixel):
    rng = np.random.default_rng(2)
    B, H, W, C, D = 2, 12, 20, 5, 6
    ref, src = random_cams(rng, B, H, W, tz=0.1), random_cams(rng, B, H, W, tz=0.1)
    if per_pixel:
        dv = rng.uniform(400, 900, (B, D, H, W)).astype(np.float32)
    else:
        dv = np.tile(np.linspace(400, 900, D, dtype=np.float32), (B, 1))
    rj, tj = jgeo.relative_warp_transform(jnp.asarray(ref), jnp.asarray(src))
    rt, tt = tgeo.relative_warp_transform(T(ref), T(src))
    np.testing.assert_allclose(N(rt), N(rj), rtol=1e-5, atol=1e-5)  # fp32 rounding
    np.testing.assert_allclose(N(tt), N(tj), rtol=1e-5, atol=1e-3)
    pxj, pyj = jgeo.plane_sweep_coords(jnp.asarray(ref), jnp.asarray(src), jnp.asarray(dv), H, W)
    pxt, pyt = tgeo.plane_sweep_coords(T(ref), T(src), T(dv), H, W)
    # pixel coordinates up to a few hundred: fp32 rounding, 1e-5 relative
    np.testing.assert_allclose(N(pxt), N(pxj), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(N(pyt), N(pyj), rtol=1e-5, atol=1e-3)
    feat = rng.standard_normal((B, H, W, C)).astype(np.float32)
    wj = jgeo.homography_warp(jnp.asarray(feat), jnp.asarray(ref), jnp.asarray(src), jnp.asarray(dv))
    wt = tgeo.homography_warp(T(feat), T(ref), T(src), T(dv))
    assert wt.shape == (B, D, H, W, C)
    # bilinear weights from 1e-3-px coordinate differences
    np.testing.assert_allclose(N(wt), N(wj), atol=1e-3)


def test_grid_sample_pixel_zero_padding():
    rng = np.random.default_rng(3)
    B, H, W, C = 2, 7, 9, 4
    src = rng.standard_normal((B, H, W, C)).astype(np.float32)
    # coordinates well outside, on the border and inside
    x = rng.uniform(-3, W + 2, (B, 5, 11)).astype(np.float32)
    y = rng.uniform(-3, H + 2, (B, 5, 11)).astype(np.float32)
    x[0, 0, :4] = [-1.0, W - 1.0, -0.5, W - 0.5]
    want = jgs.grid_sample_pixel(jnp.asarray(src), jnp.asarray(x), jnp.asarray(y))
    got = tgs.grid_sample_pixel(T(src), T(x), T(y))
    np.testing.assert_allclose(N(got), N(want), atol=1e-6)  # same fp32 formula


@pytest.mark.parametrize("in_hw,out_hw", [((7, 10), (16, 23)), ((16, 24), (5, 9)), ((6, 8), (6, 8))])
def test_resize_nearest_and_linear(in_hw, out_hw):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, *in_hw, 3)).astype(np.float32)  # NHWC for both
    got = tresize.resize_nearest(T(x), out_hw, dims=(1, 2))
    want = jresize.resize_nearest(jnp.asarray(x), out_hw)
    np.testing.assert_array_equal(N(got), N(want))  # same indices, a pure gather
    for ac in (False, True):
        got = tresize.resize_linear(T(x), out_hw, dims=(1, 2), align_corners=ac)
        want = jresize.resize_linear(jnp.asarray(x), out_hw, axes=(1, 2), align_corners=ac)
        np.testing.assert_allclose(N(got), N(want), atol=1e-6)  # same weights, fp32 lerp
    got = tresize.upsample2x_nearest(T(x), dims=(1, 2))
    np.testing.assert_array_equal(N(got), N(jresize.upsample2x_nearest(jnp.asarray(x))))


def test_depth_hypotheses():
    rng = np.random.default_rng(5)
    dv = np.tile(np.linspace(425, 905, 64, dtype=np.float32), (2, 1))
    np.testing.assert_allclose(
        N(tsamp.initial_depth_hypotheses(T(dv), 16)),
        N(jsamp.initial_depth_hypotheses(jnp.asarray(dv), 16)), rtol=1e-6)
    # windows near both range ends, so the per-sample clamp matters
    cur = rng.uniform(420, 910, (2, 12, 16)).astype(np.float32)
    cur[0, 0, :4] = [425.0, 430.0, 900.0, 905.0]
    itv = np.array([15.0, 7.5], np.float32)[:, None, None]
    lo = dv[:, 0][:, None, None, None]
    hi = dv[:, -1][:, None, None, None]
    for out_hw in (None, (6, 8)):
        got = tsamp.refined_depth_hypotheses(T(cur), 8, T(itv), T(lo), T(hi), out_hw=out_hw)
        want = jsamp.refined_depth_hypotheses(
            jnp.asarray(cur), 8, jnp.asarray(itv), jnp.asarray(lo), jnp.asarray(hi), out_hw=out_hw)
        np.testing.assert_allclose(N(got), N(want), rtol=1e-6, atol=1e-4)  # fp32 rounding


def test_regression_and_entropy():
    rng = np.random.default_rng(6)
    logits = (3 * rng.standard_normal((2, 12, 5, 7))).astype(np.float32)
    prob_j = jax.nn.softmax(jnp.asarray(logits), axis=1)
    prob_t = torch.softmax(T(logits), 1)
    np.testing.assert_allclose(N(prob_t), N(prob_j), atol=1e-6)
    for dv in (np.linspace(400, 900, 12, dtype=np.float32)[None].repeat(2, 0),
               rng.uniform(400, 900, (2, 12, 5, 7)).astype(np.float32)):
        np.testing.assert_allclose(
            N(tsamp.depth_regression(prob_t, T(dv))),
            N(jsamp.depth_regression(prob_j, jnp.asarray(dv))), rtol=1e-5)
    # the confidence window sits at the truncated (not rounded) index: the
    # expectations lie in (0, 11), none within 1e-4 of an integer here
    cj = jsamp.confidence_regression(prob_j)
    ct = tsamp.confidence_regression(prob_t)
    np.testing.assert_allclose(N(ct), N(cj), atol=1e-6)
    np.testing.assert_allclose(
        N(tsamp.softmax_entropy(T(logits), dim=1)),
        N(jsamp.softmax_entropy(jnp.asarray(logits), axis=1)), atol=1e-5)


def test_confidence_truncates_not_rounds():
    """idx_f = 2.9: the window is [1, 4], not [2, 5]."""
    prob = torch.zeros(1, 8, 1, 1)
    prob[0, 2], prob[0, 3] = 0.1, 0.9  # expectation 2.9
    conf = tsamp.confidence_regression(prob)
    assert float(conf) == pytest.approx(1.0)
    prob = torch.zeros(1, 8, 1, 1)
    prob[0, 1], prob[0, 5] = 0.5, 0.5  # expectation 3.0 -> window [2, 5]
    assert float(tsamp.confidence_regression(prob)) == pytest.approx(0.5)


def numpy_params(init_fn, *args, seed: int = 0):
    """A param tree with the structure ``init_fn(key, *args)`` returns, filled
    from seeded numpy (no JAX compile): conv weights ``U(±1/sqrt(fan_in))``,
    BatchNorm with non-trivial statistics, so eval BN is exercised."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: init_fn(key, *args), jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "running_var" in name:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if "running_mean" in name or ("bias" in name and len(shape) == 1):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if len(shape) == 1:  # BN gamma
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load_module(module: torch.nn.Module, tree, prefix: str) -> None:
    """Load the ``prefix`` subtree of a bridged JAX tree into ``module``."""
    from cds_mvsnet_tpu_torch.models.convert import params_from_jax

    head = prefix.split(".")
    nested = tree
    for part in reversed(head):
        nested = {part: nested}
    state = {k[len(prefix) + 1:]: v for k, v in params_from_jax(nested).items()}
    module.load_state_dict(state, strict=True)
