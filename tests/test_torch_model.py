"""The whole eval cascade: the port against ``apply_cds_mvsnet`` on the same
fixture and the same (JAX-initialised, bridged) weights."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.config import ModelConfig as JaxModelConfig
from cds_mvsnet_tpu.models.cds_mvsnet import apply_cds_mvsnet, init_cds_mvsnet
from cds_mvsnet_tpu.utils.synthetic import textured_plane_batch as jax_textured_plane_batch
from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.models import build_model, to_tensors
from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch
from test_torch_ops import N, jax_highest

torch.set_num_threads(2)

NDEPTHS = (8, 8, 8)


@pytest.fixture(scope="module")
def setup():
    params = jax.jit(init_cds_mvsnet, static_argnums=1)(jax.random.PRNGKey(0), JaxModelConfig(refine=True))
    batch = textured_plane_batch(V=3, H=64, W=96, D=16)
    model = build_model(ModelConfig(refine=False, ndepths=NDEPTHS), params=jax.tree.map(np.asarray, params),
                        device="cpu")
    return params, batch, model, to_tensors(batch, "cpu")


def jax_cascade(params, batch, temperature):
    cfg = JaxModelConfig(refine=False, ndepths=NDEPTHS)
    with jax_highest():
        run = jax.jit(lambda p, i, pm, dv: apply_cds_mvsnet(
            p, cfg, i, pm, dv, temperature=temperature, feature_impl="plain")[0])
        want = run(params, batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    return jax.tree.map(np.asarray, want)


def test_synthetic_fixture_is_the_jax_one():
    a = textured_plane_batch(V=3, H=32, W=40, D=8, tz_step=2.0, seed=3)
    b = jax_textured_plane_batch(V=3, H=32, W=40, D=8, tz_step=2.0, seed=3)
    np.testing.assert_array_equal(a["imgs"], b["imgs"])
    np.testing.assert_array_equal(a["depth_values"], b["depth_values"])
    for k in b["proj_matrices"]:
        np.testing.assert_array_equal(a["proj_matrices"][k], b["proj_matrices"][k])


# (median, p99, max) of |port - JAX| per output; depth in units of the 32 mm
# plane interval, the others in units of the output's median magnitude.
# At temperature 1 both fp32 cascades agree to fp32 rounding. At the eval
# temperature 0.001 the DynamicConv branch softmax scales its logits by 1000,
# so an fp32 rounding difference of 1e-7 in a logit moves a branch weight by
# about 1e-4; the curvature maps take that directly and the depth softmax
# passes it on through each stage's hypotheses, so a few pixels move further.
TOLERANCES = {
    1.0: {"depth": (1e-5, 3e-5, 1e-4), "photometric_confidence": (1e-6, 1e-6, 2e-6),
          "norm_curv": (1e-5, 3e-5, 1e-4)},
    0.001: {"depth": (1e-4, 1e-2, 0.1), "photometric_confidence": (1e-4, 2e-3, 2e-2),
            "norm_curv": (1e-3, 3e-2, 0.3)},
}


@pytest.mark.parametrize("temperature", sorted(TOLERANCES))
def test_cascade_matches_jax_fp32(setup, temperature):
    params, jbatch, model, batch = setup
    want = jax_cascade(params, jbatch, temperature)
    got = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"], temperature=temperature)
    interval = float(batch["depth_values"][0, 1] - batch["depth_values"][0, 0])  # 32 mm
    for s in ("stage1", "stage2", "stage3"):
        for key, (med, p99, mx) in TOLERANCES[temperature].items():
            g, w = N(got[s][key]), want[s][key]
            assert g.shape == w.shape, (s, key)
            d = np.abs(g - w)
            unit = interval if key == "depth" else float(np.median(np.abs(w)))
            assert np.median(d) <= med * unit, (s, key, np.median(d) / unit)
            assert np.quantile(d, 0.99) <= p99 * unit, (s, key, np.quantile(d, 0.99) / unit)
            assert d.max() <= mx * unit, (s, key, d.max() / unit)
    np.testing.assert_array_equal(N(got["refined_depth"]), N(got["stage3"]["depth"]))


def test_bf16_on_the_cpu_takes_the_plain_versions(setup):
    """On CPU tensors the kernel route runs the plain versions: identical
    results, and no launch is counted."""
    _, _, model, batch = setup
    for k in K.KERNELS:
        k.launches = 0
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    a = model(*args, compute_dtype=torch.bfloat16)
    b = model(*args, compute_dtype=torch.bfloat16, kernels=False)
    for s in ("stage1", "stage2", "stage3"):
        for key in a[s]:
            assert torch.equal(a[s][key], b[s][key]), (s, key)
    assert [k.launches for k in K.KERNELS] == [0, 0, 0, 0]
    # bf16 features and volumes stay near the fp32 cascade on this fixture
    f = model(*args)
    assert float((a["stage3"]["depth"] - f["stage3"]["depth"]).abs().median()) < 2.0


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(ModelConfig(refine=False))


def test_refinement_is_not_ported_yet():
    """Once refused, refinement now runs at eval: the cascade works at half
    the input resolution and the head brings stage 3's depth back to it."""
    model = build_model(ModelConfig(refine=True, ndepths=NDEPTHS), device="cpu")
    b = to_tensors(textured_plane_batch(V=2, H=64, W=64, D=16, refine=True), "cpu")
    out = model(b["imgs"], b["proj_matrices"], b["depth_values"])
    assert out["stage3"]["depth"].shape == (1, 32, 32)
    assert out["refined_depth"].shape == (1, 64, 64)
    assert bool(torch.isfinite(out["refined_depth"]).all())


def test_cascade_with_refinement_matches_jax_fp32(setup):
    params = setup[0]
    batch = textured_plane_batch(V=3, H=64, W=64, D=16, refine=True)
    cfg = JaxModelConfig(refine=True, ndepths=NDEPTHS)
    with jax_highest():
        want = jax.jit(lambda p, i, pm, dv: apply_cds_mvsnet(p, cfg, i, pm, dv, temperature=1.0,
                                                             feature_impl="plain")[0])(
            params, batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    model = build_model(ModelConfig(refine=True, ndepths=NDEPTHS), params=jax.tree.map(np.asarray, params),
                        device="cpu")
    b = to_tensors(batch, "cpu")
    got = model(b["imgs"], b["proj_matrices"], b["depth_values"], temperature=1.0)
    interval = float(b["depth_values"][0, 1] - b["depth_values"][0, 0])
    # at temperature 1 the fp32 cascades agree to fp32 rounding (see
    # TOLERANCES); the head adds fp32 convs on the image and the depth
    for key in ("stage3", "refined_depth"):
        g = N(got[key]["depth"] if key == "stage3" else got[key])
        w = np.asarray(want[key]["depth"] if key == "stage3" else want[key])
        assert g.shape == w.shape, key
        assert np.abs(g - w).max() <= 1e-4 * interval, (key, np.abs(g - w).max() / interval)
