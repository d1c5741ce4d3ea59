"""``cost_dtype`` and the routes at fp32.

The port's ``stage_net(..., cost_dtype=...)`` (plain versions on the CPU,
bridged weights) against the JAX ``stage_net(..., s2d_eval=True,
cost_dtype=...)`` with ``CDS_PALLAS_INTERPRET=1`` (one front here, the
others in ``test_torch_cost_dtype_kernels.py`` and
``test_torch_fp32_routes.py``): the warp on ``xla``
(``CDS_WARP_ROUTE``) in both and the JAX exit on its XLA tail
(``CDS_EXIT_FUSION=off``; the port's K3 is held to the JAX exit kernel
elsewhere), so that of the JAX package's kernels only the front's convs
(``CDS_COSTREG_FRONT=<front>_interp``) run interpreted. Then which dtype reaches each kernel site
of the port's cascade, ``cost_dtype=None`` against today's path, and the
mixed cascade's plain twin. The routes at fp32: ``test_torch_fp32_routes.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.models.cost_reg import init_cost_reg_net
from cds_mvsnet_tpu.models.stage_net import init_vis_heads
from cds_mvsnet_tpu.models.stage_net import stage_net as jax_stage_net
from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.models import build_model, to_tensors
from cds_mvsnet_tpu_torch.models import cds_mvsnet as model_module
from cds_mvsnet_tpu_torch.models import stage_net as stage_module
from cds_mvsnet_tpu_torch.models.cost_reg import CostRegNet
from cds_mvsnet_tpu_torch.models.stage_net import FP32_OPS, KERNEL_OPS, PLAIN_OPS, VisHead, cost_tail, stage_net
from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch
from test_stage_batch import _make_inputs
from test_torch_ops import N, T, load_module, numpy_params

torch.set_num_threads(2)

SIZE = 16


def stage_inputs(feat_dtype, seed: int = 4):
    """``_make_inputs``' smooth features in ``feat_dtype`` (the curvatures
    too), for both packages, and bridged weights; the prob conv scaled 40x
    and the vis head's last conv 30x, as in ``test_torch_routed_stage.py``, so
    that the depths span the range and the visibilities vary."""
    features, cams, depth_values = _make_inputs(B=1, V=3, C=8, h=SIZE, w=SIZE, D=8, seed=seed)
    jdt = jnp.bfloat16 if feat_dtype == torch.bfloat16 else jnp.float32
    features = [{k: tuple(t.astype(jdt) for t in f) for k, f in pair.items()} for pair in features]
    vis_p = numpy_params(init_vis_heads, 3, seed=1)
    vis_p["2"]["3"]["weight"] = vis_p["2"]["3"]["weight"] * 30.0
    cr_p = numpy_params(init_cost_reg_net, 8, 8, seed=2)
    cr_p["prob"]["weight"] = cr_p["prob"]["weight"] * 40.0
    vis = VisHead()
    load_module(vis, vis_p["2"], "stage_net.vis.2")
    cr = CostRegNet(8, 8)
    load_module(cr, cr_p, "cost_regularization.0")
    tfeats = [
        {k: (T(N(f[0])).to(feat_dtype).permute(0, 3, 1, 2).contiguous(), T(N(f[1]), feat_dtype),
             T(N(f[2]), feat_dtype))
         for k, f in pair.items()}
        for pair in features
    ]
    return (vis_p, cr_p, features, cams, depth_values), (vis, cr, tfeats, T(cams), T(depth_values))


def compare_with_jax(monkeypatch, feat_dtype, cost_dtype, front):
    """Stage 3 (B=1, V=3, C=8, 16x16, D=8, smooth features) with the cost
    regularisation in ``cost_dtype``: the port's ops for the features'
    dtype (``KERNEL_OPS`` or ``FP32_OPS``, plain versions on the CPU) against
    the JAX package's interpreted kernels on the same front. Tolerance: the
    serve gate, in plane intervals (depth median 1 % and p99 25 % of the
    interval, confidence median 1e-3). The TPU kernels round an fp32 volume
    and their weights to bf16 for the matrix unit (``conv3d.py:187,198,428``
    of the JAX package); the port keeps fp32, so under the ``pallas*``
    fronts the two differ by that rounding as well."""
    jax_args, port_args = stage_inputs(feat_dtype)
    monkeypatch.setenv("CDS_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("CDS_WARP_ROUTE", "3:xla")
    monkeypatch.setenv("CDS_EXIT_FUSION", "off")
    monkeypatch.setenv("CDS_COSTREG_FRONT", front if front == "s2d" else f"{front}_interp")
    jcost = jnp.float32 if cost_dtype == torch.float32 else jnp.bfloat16
    # one jit of the stage (the environment is read as it traces)
    want = jax.jit(lambda *a: jax_stage_net(*a, 2, s2d_eval=True, cost_dtype=jcost))(*jax_args)
    ops = KERNEL_OPS if feat_dtype == torch.bfloat16 else FP32_OPS
    got = stage_net(*port_args, ops, "xla", front, cost_dtype=cost_dtype)
    dv = N(port_args[4])
    interval = float(dv[0, 1] - dv[0, 0])
    d_depth = np.abs(N(got["depth"]) - N(want["depth"]))
    d_conf = np.abs(N(got["photometric_confidence"]) - N(want["photometric_confidence"]))
    assert np.median(d_depth) <= 0.01 * interval, np.median(d_depth) / interval
    assert np.quantile(d_depth, 0.99) <= 0.25 * interval, np.quantile(d_depth, 0.99) / interval
    assert np.median(d_conf) <= 1e-3, np.median(d_conf)
    np.testing.assert_allclose(N(got["norm_curv"]), N(want["norm_curv"]), atol=1e-2)


# a bf16 cascade with fp32 cost under the fused front; under the cuDNN and
# the three-kernel fronts in test_torch_cost_dtype_kernels.py, and an fp32
# cascade with bf16 cost in test_torch_fp32_routes.py: tracing the JAX
# package's interpreted kernels takes 5-13 s a front
def test_stage_with_fp32_cost_matches_jax(monkeypatch):
    compare_with_jax(monkeypatch, torch.bfloat16, torch.float32, "pallasf")


def test_cost_tail_follows_the_volume():
    assert cost_tail(KERNEL_OPS, torch.bfloat16) is KERNEL_OPS and cost_tail(FP32_OPS, torch.float32) is FP32_OPS
    assert cost_tail(KERNEL_OPS, torch.float32) is FP32_OPS and cost_tail(FP32_OPS, torch.bfloat16) is KERNEL_OPS
    assert cost_tail(PLAIN_OPS, torch.float32) is PLAIN_OPS and cost_tail(PLAIN_OPS, torch.bfloat16) is PLAIN_OPS
    replaced = dataclasses.replace(FP32_OPS, conv0=K.conv3d_bn_relu_plain)
    assert cost_tail(replaced, torch.bfloat16) is replaced


@pytest.fixture(scope="module")
def tiny():
    """A seeded model and a 3-view batch at 64x64, D=16 (ndepths 8/8/8)."""
    model = build_model(ModelConfig(refine=False, ndepths=(8, 8, 8)), seed=0, device="cpu")
    b = to_tensors(textured_plane_batch(V=3, H=64, W=64, D=16, seed=0), "cpu")
    return model, (b["imgs"], b["proj_matrices"], b["depth_values"])


def recording(ops, calls, tag):
    """``ops`` with each site recording ``(tag, site, dtype of its first
    input)`` before it runs."""

    def wrap(site, fn):
        def run(x, *args, **kw):
            calls.append((tag, site, x.dtype))
            return fn(x, *args, **kw)

        return run

    return Ops(**{f.name: wrap(f.name, getattr(ops, f.name)) for f in dataclasses.fields(ops)})


Ops = stage_module.Ops


# (compute dtype, cost dtype) -> the (ops set, site, dtype) each site sees
SITES = {
    (torch.bfloat16, torch.float32): {("kernel", "warp", torch.bfloat16), ("kernel", "dynconv", torch.bfloat16),
                                      ("fp32", "conv0", torch.float32), ("fp32", "exit", torch.float32)},
    (torch.float32, torch.bfloat16): {("fp32", "warp", torch.float32), ("fp32", "dynconv", torch.float32),
                                      ("kernel", "conv0", torch.bfloat16), ("kernel", "exit", torch.bfloat16)},
    (torch.bfloat16, None): {("kernel", "warp", torch.bfloat16), ("kernel", "dynconv", torch.bfloat16),
                             ("kernel", "conv0", torch.bfloat16), ("kernel", "exit", torch.bfloat16)},
    (torch.float32, None): {("fp32", "warp", torch.float32), ("fp32", "dynconv", torch.float32),
                            ("fp32", "conv0", torch.float32), ("fp32", "exit", torch.float32)},
}


@pytest.mark.parametrize("compute_dtype,cost_dtype", list(SITES))
def test_each_site_gets_its_dtype(monkeypatch, tiny, compute_dtype, cost_dtype):
    """The warp, the vis head's input and the FeatureNet's K4 site keep the
    compute dtype; conv0 and the exit take the cost dtype, from the ops set
    of that dtype (bf16: K2 and K3; fp32: K2 and the plain tail). Each site
    runs per stage (the warp per source view), the FeatureNet's once."""
    model, args = tiny
    calls = []
    rec = {"kernel": recording(KERNEL_OPS, calls, "kernel"), "fp32": recording(FP32_OPS, calls, "fp32")}
    for module in (stage_module, model_module):
        monkeypatch.setattr(module, "KERNEL_OPS", rec["kernel"])
        monkeypatch.setattr(module, "FP32_OPS", rec["fp32"])
    out = model(*args, compute_dtype=compute_dtype, cost_dtype=cost_dtype)
    assert set(calls) == SITES[(compute_dtype, cost_dtype)]
    sites = [site for _, site, _ in calls]
    assert (sites.count("warp"), sites.count("conv0"), sites.count("exit"), sites.count("dynconv")) == (6, 3, 3, 1)
    assert bool(torch.isfinite(out["stage3"]["depth"]).all())


@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, torch.float32])
def test_cost_dtype_none_is_todays_path(tiny, compute_dtype):
    """``cost_dtype=None``, and a cost dtype equal to the compute dtype, give
    the default forward's outputs bit for bit."""
    model, args = tiny
    base = model(*args, compute_dtype=compute_dtype)
    for cost in (None, compute_dtype):
        out = model(*args, compute_dtype=compute_dtype, cost_dtype=cost)
        for s in ("stage1", "stage2", "stage3"):
            for key in ("depth", "photometric_confidence"):
                assert torch.equal(out[s][key], base[s][key])


@pytest.mark.parametrize("compute_dtype,cost_dtype", [(torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_mixed_cascade_has_a_plain_twin(tiny, compute_dtype, cost_dtype):
    """``kernels=False`` runs the same mixed cascade on the plain versions.
    On the CPU every kernel site is its plain version already, except that
    the fp32 path's warp (K9's gather) and the plain warp project and sum in
    another order: within 1e-3 of the plane interval (as the fp32 path's
    check in ``test_torch_eval_product.py``). The cost dtype moves the maps."""
    model, args = tiny
    got = model(*args, compute_dtype=compute_dtype, cost_dtype=cost_dtype)["stage3"]
    plain = model(*args, compute_dtype=compute_dtype, cost_dtype=cost_dtype, kernels=False)["stage3"]
    base = model(*args, compute_dtype=compute_dtype)["stage3"]
    interval = float(args[2][0, 1] - args[2][0, 0])
    assert float((got["depth"] - plain["depth"]).abs().max()) <= 1e-3 * interval
    assert not torch.equal(got["photometric_confidence"], base["photometric_confidence"])
    with pytest.raises(ValueError, match="cost_dtype"):
        model(*args, compute_dtype=compute_dtype, cost_dtype=torch.float16)
