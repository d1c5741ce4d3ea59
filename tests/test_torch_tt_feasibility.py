"""``cds_mvsnet_tpu_torch/tools/tt_feasibility.py`` on the CPU at a tiny
bucket, and a stage net over the Tanks and Temples point's 9 source views
against the JAX package's XLA ``stage_net``."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.models.cost_reg import init_cost_reg_net
from cds_mvsnet_tpu.models.stage_net import init_vis_heads
from cds_mvsnet_tpu.models.stage_net import stage_net as jax_stage_net
from cds_mvsnet_tpu_torch.models.cost_reg import CostRegNet
from cds_mvsnet_tpu_torch.models.stage_net import PLAIN_OPS, VisHead, stage_net
from cds_mvsnet_tpu_torch.tools import tt_feasibility
from test_torch_ops import N, T, jax_highest, load_module, numpy_params, random_cams

torch.set_num_threads(2)


def test_tool_at_a_tiny_bucket(capsys):
    """The tool's JSON line at a 64x128 bucket (V=10, D=256, ndepths
    48/32/8) on the kernels' plain versions: every key the JAX tool reports
    and the port's additions, finite maps, the serve gate against the plain
    bf16 path, and no device numbers on the CPU."""
    assert tt_feasibility.main(["--buckets", "64x128", "--reps", "1"], device="cpu") == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("first_call_s", "sec_per_map", "maps_per_sec", "finite"):  # the JAX tool's keys
        assert key in row
    assert row["bucket"] == "64x128" and row["shape"] == [1, 10, 64, 128, 3] and row["D"] == 256
    assert row["finite"] and row["serve_gate_ok"] and row["ok"]
    assert row["peak_mem_bytes"] is None and row["launches"] == {} and row["device"] == "cpu"
    assert row["maps_per_sec"] == pytest.approx(1.0 / row["sec_per_map"])
    assert set(row["vs_plain_bf16"]) == {"depth_median", "depth_p99", "photometric_confidence_median",
                                         "photometric_confidence_p99"}


def test_tool_takes_buckets_only_by_argument():
    """The default buckets are tt_eval.sh's three; a bucket the strides do
    not divide is refused."""
    assert tt_feasibility.BUCKETS == ("1088x1920", "896x1600", "544x960")
    assert all(tt_feasibility.parse_bucket(b) for b in tt_feasibility.BUCKETS)
    with pytest.raises(SystemExit, match="multiples of 32"):
        tt_feasibility.parse_bucket("1080x1920")


def test_stage_net_with_nine_source_views_matches_jax():
    """Stage 1 (C = 32, 48 planes) over V = 10 views, the T&T point's, on
    seeded features, cameras and weights: the port's plain stage net against
    the JAX XLA ``stage_net`` in fp32 (the tolerances of
    tests/test_torch_stage_net.py: the softmax over D turns 1e-5 logit
    differences into ~1e-3 of depth)."""
    rng = np.random.default_rng(10)
    B, V, C, D, h, w = 1, 10, 32, 48, 16, 24
    vis_p = numpy_params(init_vis_heads, 3, seed=1)
    cr_p = numpy_params(init_cost_reg_net, C, 8, seed=2)

    def one():
        feat = np.tanh(rng.standard_normal((B, h, w, C))).astype(np.float32)
        nc = rng.uniform(0, 1, (B, h, w)).astype(np.float32)
        return feat, (nc**2).astype(np.float32), nc

    feats = [{"ref": one(), "src": one()} for _ in range(V - 1)]
    cams = np.stack([random_cams(rng, B, h, w, tz=0.2) for _ in range(V)], 1)
    cams[:, 0, 0] = np.eye(4)
    dv = np.tile(np.linspace(425, 937, D), (B, 1)).astype(np.float32)
    with jax_highest():
        want = jax_stage_net(vis_p, cr_p, feats, jnp.asarray(cams), jnp.asarray(dv), 0)

    vis = VisHead()
    load_module(vis, vis_p["0"], "stage_net.vis.0")
    cr = CostRegNet(C, 8)
    load_module(cr, cr_p, "cost_regularization.0")
    tfeats = [{k: (T(f[0]).permute(0, 3, 1, 2).contiguous(), T(f[1]), T(f[2])) for k, f in pair.items()}
              for pair in feats]
    got = stage_net(vis, cr, tfeats, T(cams), T(dv), PLAIN_OPS)
    np.testing.assert_allclose(N(got["depth"]), N(want["depth"]), rtol=0, atol=2e-2)
    np.testing.assert_allclose(N(got["photometric_confidence"]), N(want["photometric_confidence"]), atol=1e-4)
    np.testing.assert_allclose(N(got["norm_curv"]), N(want["norm_curv"]), atol=1e-6)
