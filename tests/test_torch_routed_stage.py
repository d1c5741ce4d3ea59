"""The slice as a whole: the port's ``stage_net`` under a warp route and a
cost-reg front (plain versions on the CPU, bridged weights) against the JAX
``stage_net(..., s2d_eval=True)`` under ``CDS_WARP_ROUTE`` and
``CDS_COSTREG_FRONT`` with ``CDS_PALLAS_INTERPRET=1``, its kernels
interpreted. Most of its time is the JAX package compiling the interpreted
kernels."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.models.cost_reg import init_cost_reg_net
from cds_mvsnet_tpu.models.stage_net import init_vis_heads
from cds_mvsnet_tpu.models.stage_net import stage_net as jax_stage_net
from cds_mvsnet_tpu_torch.models.cost_reg import CostRegNet
from cds_mvsnet_tpu_torch.models.stage_net import KERNEL_OPS, VisHead, stage_net
from test_stage_batch import _make_inputs
from test_torch_ops import N, T, load_module, numpy_params

torch.set_num_threads(2)


def _stage_inputs(C, seed):
    """``_make_inputs``' smooth bf16 features with bf16 curvatures, as the
    bf16 FeatureNet gives them, for both packages, and bridged weights. The
    prob conv is scaled up 40x and the vis head's last conv 30x: at the
    random init their outputs are so flat that every depth sits near the
    middle plane and every visibility near 0.5; scaled, the depths span most
    of the range, the confidences 0.2-0.9 and the visibilities 0.02-0.84."""
    features, cams, depth_values = _make_inputs(B=1, V=3, C=C, h=32, w=32, D=8, seed=seed)
    features = [{k: tuple(t.astype(jnp.bfloat16) for t in f) for k, f in pair.items()} for pair in features]
    vis_p = numpy_params(init_vis_heads, 3, seed=1)
    vis_p["2"]["3"]["weight"] = vis_p["2"]["3"]["weight"] * 30.0
    cr_p = numpy_params(init_cost_reg_net, C, 8, seed=2)
    cr_p["prob"]["weight"] = cr_p["prob"]["weight"] * 40.0
    vis = VisHead()
    load_module(vis, vis_p["2"], "stage_net.vis.2")
    cr = CostRegNet(C, 8)
    load_module(cr, cr_p, "cost_regularization.0")
    tfeats = [
        {k: (T(N(f[0])).to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(), T(N(f[1]), torch.bfloat16),
             T(N(f[2]), torch.bfloat16))
         for k, f in pair.items()}
        for pair in features
    ]
    return (vis_p, cr_p, features, cams, depth_values), (vis, cr, tfeats, T(cams), T(depth_values))


@pytest.mark.parametrize("warp_route,front", [("v6sb", "pallasf3"), ("v6sd", "pallas3")])
def test_stage_matches_jax_routed(monkeypatch, warp_route, front):
    """The slice as a whole at stage 3 (B=1, V=3, C=8, 32x32, D=8, smooth
    features): the port's stage under a warp route and a front, plain
    versions on the CPU, against the JAX package's interpreted kernels on the
    same route. Tolerance: the serve gate, in plane intervals (measured:
    depth median 0.0034 and p99 0.015 of the interval, confidence median
    6.9e-4; the TPU kernels round their weights to bf16 for the matrix unit,
    the port's keep fp32)."""
    jax_args, port_args = _stage_inputs(8, seed=4)
    monkeypatch.setenv("CDS_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CDS_WARP_ROUTE", f"3:{warp_route}")
    monkeypatch.setenv("CDS_COSTREG_FRONT", f"{front}_interp")
    want = jax_stage_net(*jax_args[:2], jax_args[2], jax_args[3], jax_args[4], 2, s2d_eval=True)
    got = stage_net(*port_args, KERNEL_OPS, warp_route, front)
    dv = N(port_args[4])
    interval = float(dv[0, 1] - dv[0, 0])
    d_depth = np.abs(N(got["depth"]) - N(want["depth"]))
    d_conf = np.abs(N(got["photometric_confidence"]) - N(want["photometric_confidence"]))
    assert np.median(d_depth) <= 0.01 * interval, np.median(d_depth) / interval
    assert np.quantile(d_depth, 0.99) <= 0.25 * interval, np.quantile(d_depth, 0.99) / interval
    assert np.median(d_conf) <= 1e-3, np.median(d_conf)
    np.testing.assert_allclose(N(got["norm_curv"]), N(want["norm_curv"]), atol=1e-2)
