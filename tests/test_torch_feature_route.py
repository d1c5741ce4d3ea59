"""The feature route (``Routes.feature``, the JAX package's ``CDS_FEAT_SPARSE``):
its grammar, K4's plain version at each new form against the JAX kernel
``sparse_s2d_conv`` in interpret mode, and the routed FeatureNet against the
JAX fp32 ``feature_net`` by the JAX route's own criterion."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.models.feature_net import feature_net, init_feature_net
from cds_mvsnet_tpu.ops.pallas.s2d_sparse import pack_tiles, plan_sparse_layer, sparse_s2d_conv
from cds_mvsnet_tpu_torch.models import Routes
from cds_mvsnet_tpu_torch.models.feature_net import FeatureNet, k4_forms
from cds_mvsnet_tpu_torch.models.warp_routes import FEATURE_LAYERS, parse_feature_route
from cds_mvsnet_tpu_torch.ops.kernels import dynconv_branches, dynconv_branches_plain
from test_torch_feature_net import _d2s, _s2d
from test_torch_ops import N, T, jax_highest, load_module, numpy_params

torch.set_num_threads(2)


@pytest.mark.parametrize("value,want", [
    ("conv01", {"conv01"}),
    (" Conv00,inner1 ", {"conv00", "inner1"}),
    ("all", set(FEATURE_LAYERS)),
    ("conv00,all", set(FEATURE_LAYERS)),
    ("off", set()), ("none", set()), ("0", set()), ("", set()), ("  ", set()),
    (("out1", "downsample2"), {"out1", "downsample2"}),
])
def test_feature_route_grammar(value, want):
    assert parse_feature_route(value) == frozenset(want)
    assert Routes(feature=value).feature == frozenset(want)


def test_feature_route_refusals_and_default():
    assert Routes().feature == frozenset({"conv01"}) and len(FEATURE_LAYERS) == 13
    for bad in ("conv02", "conv01,inner3", "s2d", ("conv01", "up1")):
        with pytest.raises(ValueError, match="unknown layers"):
            Routes(feature=bad)


@pytest.fixture(scope="module")
def params():
    return numpy_params(init_feature_net, seed=5)


@pytest.fixture(scope="module")
def net(params):
    net = FeatureNet()
    load_module(net, params, "feature")
    return net


def test_default_route_is_the_conv01_route(net):
    """``feature={"conv01"}`` through the model's mapping equals the
    FeatureNet as the default path called it, bit for bit."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.uniform(0, 1, (2, 3, 32, 48)).astype(np.float32)).to(torch.bfloat16)
    epi = torch.tensor([[5.0, 7.0], [-400.0, 900.0]])
    want = net(x, epi, 0.01, branches={"conv01": dynconv_branches})
    got = net(x, epi, 0.01, branches=dict.fromkeys(Routes().feature, dynconv_branches))
    for s in want:
        for a, b in zip(want[s], got[s]):
            assert torch.equal(a, b)


def test_k4_forms_are_what_the_route_sends(net):
    """``feature_net.k4_forms`` (the smoke's and the timing tool's table)
    lists each conv as the routed FeatureNet hands it to K4: input width and
    size, branch weights, stride."""
    seen = {}

    def recorder(name):
        def run(x, ws, stride=1):
            seen[name] = (x.shape[1], ws[0].shape[0], tuple(w.shape[-1] for w in ws), stride, *x.shape[2:])
            return dynconv_branches_plain(x, ws, stride)
        return run

    x = torch.zeros(2, 3, 32, 64, dtype=torch.bfloat16)
    net(x, torch.tensor([[5.0, 7.0], [-40.0, 90.0]]), 0.5, branches={n: recorder(n) for n in FEATURE_LAYERS})
    assert seen == {form[0]: form[1:] for form in k4_forms(32, 64)}


def jax_sparse(x_nhwc, ws_hwio, b_in, stride=1):
    """The JAX kernel in interpret mode on the space-to-depth of ``x``: each
    branch's output back in NHWC."""
    plan = plan_sparse_layer(tuple((w.shape[0], w.shape[2], w.shape[3], (w.shape[0] - 1) // 2) for w in ws_hwio),
                             b_in, stride=stride)
    tiles = pack_tiles(plan, [jnp.asarray(w) for w in ws_hwio])
    x_bf = jnp.asarray(x_nhwc).astype(jnp.bfloat16)
    out = np.asarray(sparse_s2d_conv(_s2d(x_bf, b_in), tiles, plan, interpret=True).astype(jnp.float32))
    b_out = b_in // stride
    return [_d2s(out[..., mo: mo + b_out * b_out * w.shape[3]], b_out) for mo, w in zip(plan.m_offsets, ws_hwio)]


# (layer, I, OA, ks, stride, b_in, H, W): the new forms at the smallest
# shapes whose space-to-depth rows are 8-aligned, as the JAX kernel needs
FORMS = [
    ("conv00", 3, 11, (3, 7, 11), 1, 8, 8, 64),
    ("downsample1", 8, 16, (3,), 2, 8, 16, 64),
    ("inner1", 48, 16, (1,), 1, 4, 8, 32),
    ("out1", 32, 35, (1, 3), 1, 2, 4, 16),
]


@pytest.mark.parametrize("layer,I_,OA,ks,stride,b_in,H,W", FORMS, ids=[f[0] for f in FORMS])
def test_k4_plain_matches_sparse_s2d_kernel(layer, I_, OA, ks, stride, b_in, H, W):
    """K4's plain version against the TPU kernel in interpret mode at each
    new form (k = 11; stride 2; 1x1 at I = 48; OA = 35 with a bias added
    after the kernel, as both packages add it), with the tolerance of the
    conv01 check (``test_torch_feature_net.py``)."""
    rng = np.random.default_rng(7)
    n = 1
    x = rng.standard_normal((n, H, W, I_)).astype(np.float32)
    x_bf = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    ws_hwio = [(rng.standard_normal((k, k, I_, OA)) / np.sqrt(I_ * k * k)).astype(np.float32) for k in ks]
    bias = rng.standard_normal(OA).astype(np.float32) if layer == "out1" else np.zeros(OA, np.float32)
    want = [w + bias for w in jax_sparse(x_bf, ws_hwio, b_in, stride)]

    xt = T(x_bf).to(torch.bfloat16).permute(0, 3, 1, 2).contiguous()
    wt = [torch.tensor(w.transpose(3, 2, 0, 1)).contiguous() for w in ws_hwio]
    got = dynconv_branches_plain(xt, wt, stride)
    Ho, Wo = H // stride, W // stride
    assert got.dtype == torch.bfloat16 and got.shape == (n, len(ks) * OA, Ho, Wo)
    for i in range(len(ks)):
        g = N(got[:, i * OA: (i + 1) * OA].permute(0, 2, 3, 1)) + bias
        # both round an fp32 sum to bf16 once; the TPU kernel multiplies
        # bf16-rounded weights: 2^-7 relative plus a weight-rounding term
        np.testing.assert_allclose(g, want[i], rtol=2 ** -7, atol=2e-2, err_msg=f"{layer} branch {i}")
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(dynconv_branches(xt, wt, stride=stride), got)


def test_wrapper_takes_the_new_forms_and_refuses_the_rest():
    x = torch.zeros(1, 8, 9, 20, dtype=torch.bfloat16)
    assert dynconv_branches(x, [torch.zeros(16, 8, 3, 3)], stride=2).shape == (1, 16, 5, 10)
    assert dynconv_branches(x, [torch.zeros(8, 8, 1, 1)]).shape == (1, 8, 9, 20)
    assert dynconv_branches(x, [torch.zeros(11, 8, k, k) for k in (3, 7, 11)]).shape == (1, 33, 9, 20)
    with pytest.raises(ValueError, match="stride"):
        dynconv_branches(x, [torch.zeros(16, 8, 3, 3)] * 2, stride=2)
    with pytest.raises(ValueError, match="stride"):
        dynconv_branches(x, [torch.zeros(16, 8, 5, 5)], stride=2)
    with pytest.raises(ValueError, match="stride"):
        dynconv_branches(x, [torch.zeros(16, 8, 3, 3)], stride=3)
    with pytest.raises(ValueError, match="weight"):
        dynconv_branches(x, [torch.zeros(11, 8, 9, 9)])
    with pytest.raises(ValueError, match="OA=24"):
        dynconv_branches(x, [torch.zeros(24, 8, 1, 1)])


def test_routed_feature_net_meets_the_jax_route_criterion(params, net):
    """The port's FeatureNet with every conv on K4's plain version (bf16 on
    the CPU) by the JAX route's criterion (``tests/test_feature_net_s2d.py:
    42-57``): against the fp32 FeatureNet (JAX ``feature_net``), its p99.5
    and max error at most twice the dense bf16 FeatureNet's (floors 2e-2
    and 5e-2). The JAX route itself (``feature_net_s2d`` under
    ``CDS_FEAT_SPARSE=all``, interpreted) takes over a minute on the CPU
    even at 64x64; its kernel is held to K4's plain version form by form
    above."""
    rng = np.random.default_rng(1)
    n, H, W = 2, 32, 64
    x = np.asarray(jnp.asarray(rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32)).astype(jnp.bfloat16)
                   .astype(jnp.float32))
    epi = rng.uniform(-2000, 4000, (n, 2)).astype(np.float32)
    with jax_highest():
        truth = jax.jit(lambda p, x, e: feature_net(p, x, e, 0.5))(params, x, epi)

    xt = T(x).permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)
    dense = net(xt, T(epi), 0.5, branches={})
    routed = net(xt, T(epi), 0.5, branches=dict.fromkeys(FEATURE_LAYERS, dynconv_branches))
    for stage in ("stage1", "stage2", "stage3"):
        for k in range(3):
            t = N(truth[stage][k])

            def err(out):
                g = N(out[stage][k].permute(0, 2, 3, 1)) if k == 0 else N(out[stage][k])
                assert g.shape == t.shape, (stage, k)
                return np.abs(g - t)

            ed, er = err(dense), err(routed)
            qd, qr = np.percentile(ed, 99.5), np.percentile(er, 99.5)
            assert qr <= max(2 * qd, 2e-2), (stage, k, qr, qd)
            assert er.max() <= max(2 * ed.max(), 5e-2), (stage, k, er.max(), ed.max())
