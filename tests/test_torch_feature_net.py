"""FeatureNet and K4 (all DynamicConv branches in one launch) vs the JAX package."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.models.feature_net import feature_net, init_feature_net
from cds_mvsnet_tpu.ops.pallas.s2d_sparse import pack_tiles, plan_sparse_layer, sparse_s2d_conv
from cds_mvsnet_tpu_torch.models.feature_net import FeatureNet
from cds_mvsnet_tpu_torch.ops.kernels import dynconv_branches, dynconv_branches_plain
from test_torch_ops import N, T, jax_highest, load_module, numpy_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    return numpy_params(init_feature_net, seed=3)


# fp32 convs summed in another order differ by ~1e-5 after InstanceNorm; the
# branch softmax scales logits by 1/temperature and so amplifies them: at
# T=1 the comparison is tight, at T=0.01 (the eval regime) 100x looser
@pytest.mark.parametrize("temperature,tol", [(1.0, 5e-5), (0.01, 2e-3)])
def test_feature_net_matches_jax_fp32(params, temperature, tol):
    rng = np.random.default_rng(0)
    n, H, W = 2, 32, 48
    x = rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32)
    epi = np.array([[1e4, -3e3], [20.0, 30.0]], np.float32)  # far and in-frame
    with jax_highest():
        want = jax.jit(lambda p, x, e: feature_net(p, x, e, temperature))(params, x, epi)
    net = FeatureNet()
    load_module(net, params, "feature")
    got = net(T(x).permute(0, 3, 1, 2).contiguous(), T(epi), temperature)
    for stage, C in (("stage1", 32), ("stage2", 16), ("stage3", 8)):
        fj, ncj, absj = want[stage]
        ft, nct, abst = got[stage]
        assert ft.shape == (n, C, *fj.shape[1:3])
        np.testing.assert_allclose(N(ft.permute(0, 2, 3, 1)), N(fj), atol=tol, err_msg=stage)
        np.testing.assert_allclose(N(nct), N(ncj), rtol=tol, atol=tol, err_msg=stage)
        np.testing.assert_allclose(N(abst), N(absj), rtol=tol, atol=tol, err_msg=stage)


def test_conv01_branch_routes_agree(params):
    """conv01 through K4's plain version equals one conv per branch (fp32)."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 3, 16, 24)).astype(np.float32))
    epi = torch.tensor([[5.0, 7.0], [-40.0, 90.0]])
    net = FeatureNet()
    load_module(net, params, "feature")
    a = net(x, epi, 0.01)
    b = net(x, epi, 0.01, branches={"conv01": dynconv_branches_plain})
    for s in a:
        for ta, tb in zip(a[s], b[s]):
            torch.testing.assert_close(ta, tb, rtol=1e-5, atol=1e-5)  # same sums


def _s2d(x, b):
    """(N, H, W, C) -> (N, H/b, W/b, b*b*C), channels ordered (by, bx, c)."""
    n, H, W, C = x.shape
    return x.reshape(n, H // b, b, W // b, b, C).transpose(0, 1, 3, 2, 4, 5).reshape(n, H // b, W // b, b * b * C)


def _d2s(x, b):
    n, Hq, Wq, BBC = x.shape
    C = BBC // (b * b)
    return x.reshape(n, Hq, Wq, b, b, C).transpose(0, 1, 3, 2, 4, 5).reshape(n, Hq * b, Wq * b, C)


def test_k4_plain_matches_sparse_s2d_kernel():
    """K4's plain version against the TPU kernel in interpret mode, on the
    conv01 geometry (I=8, O+3=11, k=3/5/7) at block size 8."""
    rng = np.random.default_rng(2)
    n, H, W, I, OA, b = 2, 16, 64, 8, 11, 8
    x = rng.standard_normal((n, H, W, I)).astype(np.float32)
    x_bf = jnp.asarray(x).astype(jnp.bfloat16)
    ws_hwio = [(rng.standard_normal((k, k, I, OA)) / np.sqrt(I * k * k)).astype(np.float32) for k in (3, 5, 7)]
    plan = plan_sparse_layer(tuple((k, I, OA, k // 2) for k in (3, 5, 7)), b)
    tiles = pack_tiles(plan, [jnp.asarray(w) for w in ws_hwio])
    out = np.asarray(sparse_s2d_conv(_s2d(x_bf, b), tiles, plan, interpret=True).astype(jnp.float32))
    want = [_d2s(out[..., mo : mo + b * b * OA], b) for mo in plan.m_offsets]  # (n, H, W, OA)

    xt = T(np.asarray(x_bf.astype(jnp.float32))).to(torch.bfloat16).permute(0, 3, 1, 2).contiguous()
    wt = [torch.tensor(w.transpose(3, 2, 0, 1)).contiguous() for w in ws_hwio]
    got = dynconv_branches_plain(xt, wt)
    assert got.dtype == torch.bfloat16 and got.shape == (n, 3 * OA, H, W)
    for i in range(3):
        g = N(got[:, i * OA : (i + 1) * OA].permute(0, 2, 3, 1))
        # both round an fp32 sum to bf16 once, but the TPU kernel multiplies
        # bf16-rounded weights: 2^-7 relative plus a weight-rounding term
        np.testing.assert_allclose(g, want[i], rtol=2 ** -7, atol=2e-2, err_msg=f"branch {i}")
    # the wrapper takes the plain version for CPU tensors
    torch.testing.assert_close(dynconv_branches(xt, wt), got, rtol=0, atol=0)


def test_k4_wrapper_checks_its_inputs():
    x = torch.zeros(1, 8, 8, 8, dtype=torch.bfloat16)
    w = [torch.zeros(11, 8, 3, 3)]
    with pytest.raises(ValueError, match="bf16"):
        dynconv_branches(x.float(), w)
    with pytest.raises(ValueError, match="OA"):
        dynconv_branches(x, [torch.zeros(12, 8, 3, 3)])
    with pytest.raises(ValueError, match="weight"):
        dynconv_branches(x, [torch.zeros(11, 8, 4, 4)])
    with pytest.raises(ValueError, match="branches"):
        dynconv_branches(x, w * 5)
    with pytest.raises(ValueError, match="contiguous"):
        dynconv_branches(x.transpose(2, 3), w)
