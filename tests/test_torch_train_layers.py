"""Train-mode layers of the port against the JAX package: BatchNorm on batch
statistics (with per-call groups and their call order), the 2-D transposed
conv of the refinement head, and the FeatureNet and the cost-regularisation
UNet in train mode, with their running-statistics updates."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.models import layers as jlayers
from cds_mvsnet_tpu.models.cost_reg import cost_reg_net, init_cost_reg_net
from cds_mvsnet_tpu.models.feature_net import feature_net, init_feature_net
from cds_mvsnet_tpu_torch.models.convert import params_from_jax
from cds_mvsnet_tpu_torch.models.cost_reg import CostRegNet
from cds_mvsnet_tpu_torch.models.feature_net import FeatureNet
from cds_mvsnet_tpu_torch.models.layers import BatchNorm, StatsCollector, deconv2d
from test_torch_ops import N, T, jax_highest, load_module, numpy_params

torch.set_num_threads(2)

MOMENTUM = 0.1


def bn_params(rng, C):
    return {
        "weight": rng.uniform(0.5, 1.5, C).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(C)).astype(np.float32),
        "running_mean": (0.1 * rng.standard_normal(C)).astype(np.float32),
        "running_var": rng.uniform(0.5, 1.5, C).astype(np.float32),
    }


def channels_last(x: np.ndarray) -> np.ndarray:
    return np.moveaxis(x, 1, -1)


def port_updates(stats: StatsCollector, module: torch.nn.Module, prefix: str) -> dict[str, np.ndarray]:
    """Apply the collected statistics and return every BN's running
    statistics under the JAX collector's paths."""
    stats.apply()
    names = {id(m): n for n, m in module.named_modules()}
    out = {}
    for bn, *_ in stats.calls:
        path = f"{prefix}.{names[id(bn)]}"
        out[f"{path}.running_mean"] = N(bn.running_mean)
        out[f"{path}.running_var"] = N(bn.running_var)
    return out


@pytest.mark.parametrize("shape,groups,order", [
    ((4, 6, 5, 7), 1, None),
    ((8, 6, 5, 7), 4, (0, 2, 1, 3)),  # the FeatureNet's stack at V=3: [ref_0, ref_1, src_0, src_1]
    ((6, 3, 4, 5), 3, None),
    ((2, 5, 3, 4, 6), 1, None),  # 3-D maps (cost regularisation)
])
def test_batch_norm_train_matches_jax(shape, groups, order):
    rng = np.random.default_rng(len(shape) + groups)
    C = shape[1]
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    p = bn_params(rng, C)

    def f(x_, w, b, coll=None):
        return jlayers.batch_norm(x_, {**p, "weight": w, "bias": b}, True, coll, "bn", stat_groups=groups,
                                  group_order=order)

    args = (jnp.asarray(channels_last(x)), jnp.asarray(p["weight"]), jnp.asarray(p["bias"]))
    want, vjp = jax.vjp(f, *args)
    gx, gw, gb = vjp(jnp.asarray(channels_last(g)))
    coll = jlayers.StatsCollector()  # the updates, outside the trace
    f(*args, coll)

    bn = BatchNorm(C)
    bn.load_state_dict({k: torch.tensor(v) for k, v in p.items()})
    xt = T(x).requires_grad_()
    stats = StatsCollector()
    got = bn(xt, stats, groups, order)
    (got * T(g)).sum().backward()
    # batch statistics of fp32 maps summed in other orders
    np.testing.assert_allclose(channels_last(N(got)), N(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(channels_last(N(xt.grad)), N(gx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(N(bn.weight.grad), N(gw), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(bn.bias.grad), N(gb), rtol=1e-5, atol=1e-4)
    # the model's buffers move only when the collector is applied
    np.testing.assert_array_equal(N(bn.running_mean), p["running_mean"])
    updates = port_updates(stats, torch.nn.ModuleDict({"bn": bn}), "x")
    for key in ("running_mean", "running_var"):
        np.testing.assert_allclose(updates[f"x.bn.{key}"], N(coll.updates[f"bn.{key}"]), rtol=1e-5, atol=1e-6)


def test_stats_collector_replays_the_sequential_ema_in_call_order():
    """One grouped call moves the running statistics as G upstream calls
    would, one EMA step each, in the order ``order`` gives the groups."""
    rng = np.random.default_rng(5)
    G, C = 4, 3
    order = (0, 2, 1, 3)
    x = rng.standard_normal((G * 2, C, 4, 4)).astype(np.float32)
    bn = BatchNorm(C)
    stats = StatsCollector()
    bn(T(x), stats, G, order)
    stats.apply()
    mean, var = np.zeros(C), np.ones(C)
    for call in range(G):
        grp = x[order.index(call) * 2:(order.index(call) + 1) * 2]
        mean = (1 - MOMENTUM) * mean + MOMENTUM * grp.mean(axis=(0, 2, 3))
        var = (1 - MOMENTUM) * var + MOMENTUM * grp.var(axis=(0, 2, 3), ddof=1)
    np.testing.assert_allclose(N(bn.running_mean), mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(N(bn.running_var), var, rtol=1e-5, atol=1e-6)


def test_deconv2d_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 7, 8)).astype(np.float32)  # NHWC
    w = (rng.standard_normal((3, 3, 8, 8)) / 8).astype(np.float32)  # stored flipped, (k, k, I, O)
    want = jlayers.deconv2d(jnp.asarray(x), {"weight": jnp.asarray(w)}, precision=jax.lax.Precision.HIGHEST)
    wt = params_from_jax({"refine_network": {"deconv": {"weight": w}}})["refine_network.deconv.weight"]
    got = deconv2d(T(x).permute(0, 3, 1, 2), wt)
    assert got.shape == (2, 8, 10, 14)
    np.testing.assert_allclose(channels_last(N(got)), N(want), atol=1e-5)  # fp32 sums of 72 products


def test_feature_net_train_matches_jax():
    """Train mode over a stack of 4 images as one cascade call at V=3 lays
    it out: every attention BN with per-image statistics, replayed in the
    upstream call order; outputs and every BN update."""
    p = numpy_params(init_feature_net, seed=7)
    rng = np.random.default_rng(7)
    n, H, W = 4, 16, 24
    x = rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32)
    epi = np.array([[1e4, -3e3], [20.0, 30.0], [-50.0, 8.0], [7.0, 300.0]], np.float32)
    order = (0, 2, 1, 3)
    coll = jlayers.StatsCollector()
    with jax_highest():
        want = feature_net(p, jnp.asarray(x), jnp.asarray(epi), 1.0, train=True, collector=coll, bn_groups=4,
                           bn_group_order=order)
    net = FeatureNet()
    load_module(net, p, "feature")
    stats = StatsCollector()
    got = net(T(x).permute(0, 3, 1, 2).contiguous(), T(epi), 1.0, stats=stats, bn_groups=4, bn_order=order)
    for stage in ("stage1", "stage2", "stage3"):
        for t, j in zip(got[stage], want[stage]):
            t = N(t)
            t = channels_last(t) if t.ndim == 4 else t
            # fp32 convs in other orders, per-image BN statistics (T = 1)
            np.testing.assert_allclose(t, N(j), rtol=1e-4, atol=1e-4, err_msg=stage)
    updates = port_updates(stats, net, "feature")
    assert updates.keys() == coll.updates.keys()
    assert len(updates) == 2 * 9  # one attention BN per DynamicConv
    for k, v in coll.updates.items():
        np.testing.assert_allclose(updates[k], N(v), rtol=1e-5, atol=1e-6, err_msg=k)


def test_cost_reg_train_matches_jax():
    """The UNet on batch statistics (conv0's BN too): the prob-conv logits,
    every BN update and the gradient of a fixed linear loss."""
    C, B, D, h, w = 16, 2, 8, 16, 16
    p = numpy_params(init_cost_reg_net, C, 8, seed=8)
    rng = np.random.default_rng(8)
    vol = rng.standard_normal((B, D, h, w, C)).astype(np.float32)
    g = rng.standard_normal((B, D, h, w)).astype(np.float32)
    def f(params, coll=None):
        return cost_reg_net(params, jnp.asarray(vol), True, coll, "cost_regularization.1")[..., 0]

    coll = jlayers.StatsCollector()  # the updates, outside the trace
    with jax_highest():
        want, vjp = jax.vjp(f, jax.tree.map(jnp.asarray, p))
        (gj,) = vjp(jnp.asarray(g))
        f(jax.tree.map(jnp.asarray, p), coll)
    net = CostRegNet(C, 8)
    load_module(net, p, "cost_regularization.1")
    stats = StatsCollector()
    got = net.train_logits(T(vol).permute(0, 4, 1, 2, 3).contiguous(), stats)
    assert got.shape == (B, D, h, w)
    # fp32 UNet through 12 convs on batch statistics
    np.testing.assert_allclose(N(got), N(want), rtol=1e-4, atol=1e-4)
    (got * T(g)).sum().backward()
    grads = params_from_jax({"cost_regularization": {"1": gj}})
    for name, q in net.named_parameters():
        want_g = N(grads[f"cost_regularization.1.{name}"])
        rel = np.linalg.norm(N(q.grad) - want_g) / np.linalg.norm(want_g)
        assert rel <= 1e-4, (name, rel)  # fp32 backward, sums in other orders
    updates = port_updates(stats, net, "cost_regularization.1")
    assert updates.keys() == coll.updates.keys()
    assert len(updates) == 2 * 10
    for k, v in coll.updates.items():
        np.testing.assert_allclose(updates[k], N(v), rtol=1e-5, atol=1e-6, err_msg=k)
