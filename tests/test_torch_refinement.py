"""The refinement head, eval and train, against the JAX package's
``refinement`` on the same seeded inputs and weights."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.models.layers import StatsCollector as JaxStatsCollector
from cds_mvsnet_tpu.models.refinement import init_refinement, refinement
from cds_mvsnet_tpu_torch.models.layers import StatsCollector
from cds_mvsnet_tpu_torch.models.refinement import RefineNet
from test_torch_ops import N, T, jax_highest, load_module, numpy_params

torch.set_num_threads(2)

B, H, W = 2, 32, 48


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    lo = np.array([425.0, 300.0], np.float32) / 2.5
    hi = np.array([905.0, 800.0], np.float32) / 2.5
    depth = rng.uniform(lo[:, None, None] + 5, hi[:, None, None] - 5, (B, H // 2, W // 2)).astype(np.float32)
    w = rng.standard_normal((B, H, W)).astype(np.float32)
    return img, depth, lo, hi, w


@pytest.fixture(scope="module")
def net():
    p = numpy_params(init_refinement, seed=3)
    m = RefineNet()
    load_module(m, p, "refine_network")
    return p, m


def run_jax(p, img, depth, lo, hi, train):
    coll = JaxStatsCollector()
    with jax_highest():
        out = refinement(p, jnp.asarray(img), jnp.asarray(depth)[..., None], jnp.asarray(lo), jnp.asarray(hi),
                         train=train, collector=coll)[..., 0]
    return N(out), {k: N(v) for k, v in coll.updates.items()}


def run_port(m, img, depth, lo, hi, stats=None):
    return m(T(img).permute(0, 3, 1, 2), T(depth), T(lo), T(hi), stats)


def test_eval_matches_jax(net):
    p, m = net
    img, depth, lo, hi, _ = inputs()
    want, _ = run_jax(p, img, depth, lo, hi, train=False)
    with torch.no_grad():
        got = run_port(m, img, depth, lo, hi)
    assert got.shape == (B, H, W)
    # fp32 convs over a [0, 10] normalised depth, then scaled back by the
    # ~200 range: 1e-5 relative of ~300
    np.testing.assert_allclose(N(got), want, rtol=1e-5, atol=1e-3)


def test_eval_upsamples_with_align_corners(net):
    """With a zero residual the head is the align_corners bilinear 2x
    upsample of the depth: the corners of the map keep their values."""
    _, m = net
    img, depth, lo, hi, _ = inputs(1)
    zero = RefineNet()
    zero.load_state_dict(m.state_dict())
    with torch.no_grad():
        zero.res.weight.zero_()
        got = N(run_port(zero, img, depth, lo, hi))
    for (y, x), (yd, xd) in (((0, 0), (0, 0)), ((-1, -1), (-1, -1)), ((0, -1), (0, -1))):
        np.testing.assert_allclose(got[:, y, x], depth[:, yd, xd], rtol=1e-6)


def test_train_matches_jax(net):
    """Train form: the output, every BN's running-statistics update and the
    gradient of a fixed linear loss, against JAX's ``jax.vjp``."""
    p, m = net
    img, depth, lo, hi, w = inputs(2)
    want, updates = run_jax(p, img, depth, lo, hi, train=True)

    def loss(params):
        out = refinement(params, jnp.asarray(img), jnp.asarray(depth)[..., None], jnp.asarray(lo),
                         jnp.asarray(hi), train=True, collector=JaxStatsCollector())[..., 0]
        return jnp.sum(out * w)

    with jax_highest():
        gj = jax.grad(loss)(jax.tree.map(jnp.asarray, p))

    port = RefineNet()
    port.load_state_dict(m.state_dict())
    stats = StatsCollector()
    got = run_port(port, img, depth, lo, hi, stats)
    # batch statistics: the same fp32 function, ~1e-5 relative of ~300
    np.testing.assert_allclose(N(got), want, rtol=1e-5, atol=1e-3)
    (got * T(w)).sum().backward()
    stats.apply()
    state = port.state_dict()
    assert len(updates) == 2 * 5  # five BNs, mean and var each
    for key, value in updates.items():
        # statistics of fp32 maps summed in another order
        np.testing.assert_allclose(N(state[key.removeprefix("refine_network.")]), value, rtol=1e-5, atol=1e-6,
                                   err_msg=key)

    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(gj)
    from cds_mvsnet_tpu_torch.models.convert import _to_jax_layout

    # layouts are keyed by the full path (the 2-D deconv's flip)
    grads = {n: _to_jax_layout(f"refine_network.{n}", q.grad.numpy()) for n, q in port.named_parameters()}
    assert grads.keys() == {k for k in flat if not k.endswith(("running_mean", "running_var"))}
    for k, g in grads.items():
        # fp32 backward through 6 convs and 5 train BNs, summed in other orders
        rel = np.linalg.norm(g - flat[k]) / np.linalg.norm(flat[k])
        assert rel <= 1e-4, (k, rel)


def test_bf16_stays_near_fp32(net):
    _, m = net
    img, depth, lo, hi, _ = inputs(4)
    with torch.no_grad():
        a = run_port(m, img, depth, lo, hi)
        b = m(T(img, torch.bfloat16).permute(0, 3, 1, 2), T(depth), T(lo), T(hi))
    assert b.dtype == torch.float32
    # bf16 convs on the image and the normalised depth: the residual is
    # O(0.1) of a [0, 10] depth, its bf16 rounding 2^-8 of that, times the
    # ~200 range
    assert float((a - b).abs().max()) < 1.0
