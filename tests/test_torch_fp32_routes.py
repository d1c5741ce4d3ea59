"""The fp32 cascade with bf16 cost against the JAX package (the comparison
of ``test_torch_cost_dtype.py`` under the default front: conv0 on K2 in
bf16, K3 at the exit), and the routes at fp32 (``CDSMVSNet.forward(...,
compute_dtype=torch.float32, routes=...)``): every front with the ``v6``/``v3``/``xla`` warps runs, the
fused warps raise (the JAX package's fp32 features reach its variant table,
``ops/pallas/warp.py:1592-1600``, with names it does not have), and the
feature route runs as the fp32 path (the JAX package keeps fp32 features
dense). On the CPU every kernel site is its plain version.
"""

from __future__ import annotations

import pytest
import torch

from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.models import Routes, build_model, to_tensors
from cds_mvsnet_tpu_torch.models.warp_routes import FP32_WARP_ROUTES, FRONTS, WARP_ROUTES
from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch
from test_torch_cost_dtype import compare_with_jax

torch.set_num_threads(2)


def test_fp32_stage_with_bf16_cost_matches_jax(monkeypatch):
    compare_with_jax(monkeypatch, torch.float32, torch.bfloat16, "pallas")


@pytest.fixture(scope="module")
def tiny():
    """A seeded model and a 3-view batch at 64x64, D=16 (ndepths 8/8/8)."""
    model = build_model(ModelConfig(refine=False, ndepths=(8, 8, 8)), seed=0, device="cpu")
    b = to_tensors(textured_plane_batch(V=3, H=64, W=64, D=16, seed=0), "cpu")
    return model, (b["imgs"], b["proj_matrices"], b["depth_values"])


@pytest.mark.parametrize("front", FRONTS)
def test_fp32_routes_take_every_front(tiny, front):
    """Every front at fp32 with the ``v6``/``v3``/``xla`` warps: the fronts'
    kernels in fp32 (their plain versions on the CPU), finite maps. The
    default front with stages not named equals the fp32 path bit for bit."""
    model, args = tiny
    out = model(*args, compute_dtype=torch.float32, routes=Routes({1: "v6", 2: "v3", 3: "xla"}, front))
    assert bool(torch.isfinite(out["stage3"]["depth"]).all())
    if front == "pallas":
        routed = model(*args, compute_dtype=torch.float32, routes=Routes({}, front))["stage3"]
        assert torch.equal(routed["depth"], model(*args, compute_dtype=torch.float32)["stage3"]["depth"])


@pytest.mark.parametrize("warp", sorted(set(WARP_ROUTES) - set(FP32_WARP_ROUTES)))
def test_fp32_refuses_the_fused_warps(tiny, warp):
    model, args = tiny
    with pytest.raises(ValueError, match="1592-1600"):
        model(*args, compute_dtype=torch.float32, routes=Routes({2: warp}, "pallasf3"))
    assert bool(torch.isfinite(model(*args, compute_dtype=torch.bfloat16, routes=Routes({2: warp}))["stage3"]
                               ["depth"]).all())


def test_fp32_feature_route_runs_as_the_fp32_path(tiny):
    """At fp32 the FeatureNet stays as on the fp32 path whatever the feature
    route names (the JAX package keeps fp32 features dense): the maps equal
    the fp32 path's bit for bit, and no kernel's count moves (K4 does not
    launch)."""
    model, args = tiny
    base = model(*args, compute_dtype=torch.float32)["stage3"]
    before = [k.launches for k in (*K.KERNELS, *K.FP32_KERNELS, *K.ROUTE_KERNELS)]
    routed = model(*args, compute_dtype=torch.float32, routes=Routes(feature="all"))["stage3"]
    assert torch.equal(routed["depth"], base["depth"])
    assert [k.launches for k in (*K.KERNELS, *K.FP32_KERNELS, *K.ROUTE_KERNELS)] == before
