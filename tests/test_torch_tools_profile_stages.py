"""``cds_mvsnet_tpu_torch/tools/profile_stages.py`` on the CPU at 64x128
(its point's constants patched), its marginals against the JAX tool's
formula, and the prefix cascades against the full cascade's first stages."""

from __future__ import annotations

import ast
import json
import sys
from pathlib import Path

import pytest
import torch

from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.models import build_model, to_tensors
from cds_mvsnet_tpu_torch.tools import profile_stages
from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch
from test_torch_tools_source import PS_MARGINALS, jax_marginal_keys, jax_profile_keys

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(profile_stages, "H", 64)
    monkeypatch.setattr(profile_stages, "W", 128)


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_tool_at_64x128(small, capsys):
    """Prefixes and components: the JAX tool's keys and K1's, every time
    positive and the marginals their differences, every prefix's stages
    equal to the full cascade's, no launch on the CPU."""
    report = profile_stages.main(["--reps", "1"], device="cpu")
    line = last_json(capsys)
    assert line == report["line"]
    assert set(jax_profile_keys()) <= set(line) and list(line) == profile_stages.line_keys()
    assert all(v > 0 for k, v in line.items() if not k.endswith("marginal"))
    assert line["stage3_marginal"] == pytest.approx(line["prefix3"] - line["prefix2"], abs=0.011)
    assert report["prefix_equal"] == {"prefix1": True, "prefix2": True, "prefix3": True}
    assert report["launches"] == {"prefix1": {}, "prefix2": {}, "prefix3": {}} and report["device"] == "cpu"
    gates = chip_smoke.tool_problems
    assert gates("profile_stages", ["--reps", "1"], report) == []
    # on the card: prefix n launches K1 4n, K2 n, K3 n, K4 once
    card = {**report, "device": "cuda", "launches": {
        f"prefix{n}": {"warp_entropy": 4 * n, "conv3d_bn_relu": n, "exit_softargmin": n, "dynconv_branches": 1}
        for n in (1, 2, 3)}}
    assert gates("profile_stages", [], card) == []
    assert gates("profile_stages", [], {**card, "prefix_equal": {**report["prefix_equal"], "prefix2": False}}) == [
        "prefix2: stages differ from the full cascade's"]
    assert gates("profile_stages", [], {**report, "device": "cuda"}) == [
        f"prefix{n} launches {{}} != {card['launches'][f'prefix{n}']}" for n in (1, 2, 3)]


@pytest.mark.parametrize("flag,keys", [
    ("--prefix-only", ["dispatch", "prefix1", "prefix2", "prefix3", "stage2_marginal", "stage3_marginal"]),
    ("--skip-prefix", [k for k in profile_stages.line_keys() if "prefix" not in k and "marginal" not in k]),
])
def test_tool_parts(small, capsys, flag, keys):
    """``--prefix-only`` stops after the prefixes, ``--skip-prefix`` runs
    the dispatch and the components only."""
    profile_stages.main(["--reps", "1", flag], device="cpu")
    assert list(last_json(capsys)) == keys


def test_marginals_at_64x64(monkeypatch, capsys):
    """``--marginals``: the prefix x views matrix and the four split values
    under the JAX tool's keys."""
    monkeypatch.setattr(profile_stages, "H", 64)
    monkeypatch.setattr(profile_stages, "W", 64)
    monkeypatch.setattr(profile_stages, "MARGINAL_REPS", 1)
    report = profile_stages.main(["--marginals"], device="cpu")
    line = last_json(capsys)
    assert line == report["line"]
    assert sorted(line) == sorted(jax_marginal_keys()) and len(line) == 6 + 4


@pytest.mark.parametrize("times", [
    {"p1V2": 0.0101, "p2V2": 0.0212, "p3V2": 0.0355, "p1V5": 0.0153, "p2V5": 0.0334, "p3V5": 0.0561},
    {"p1V2": 0.5, "p2V2": 0.25, "p3V2": 0.125, "p1V5": 0.0625, "p2V5": 1.0, "p3V5": 3.0},
])
def test_marginal_split_is_the_jax_formula(times):
    """:func:`marginal_split` against the JAX tool's loop
    (``tools/profile_stages.py:243-248``), executed from its source on the
    same times."""
    loop = next(n for n in PS_MARGINALS.body if isinstance(n, ast.For) and ast.unparse(n.iter) == "(2, 3)")
    ns = {"res": times, "out": {}}
    exec(compile(ast.Module(body=[loop], type_ignores=[]), "<jax tool>", "exec"), {}, ns)
    assert profile_stages.marginal_split(times) == ns["out"]
    assert len(ns["out"]) == 4


def test_prefix_stages_equal_the_full_cascade():
    """In fp32 on seeded weights, prefix n's stage-k depth, confidence and
    curvature (k <= n) equal the full cascade's bit for bit: a prefix runs
    the full model's weights with the missing stages' dropped."""
    full = build_model(profile_stages.PREFIXES[3], seed=5, device="cpu")
    b = to_tensors(textured_plane_batch(V=3, H=64, W=96, D=48, seed=2), "cpu")
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    want = full(*args, temperature=0.01)
    for n, cfg in profile_stages.PREFIXES.items():
        model = profile_stages.prefix_model(full, cfg)
        assert len(model.cost_regularization) == len(model.stage_net.vis) == n
        got = model(*args, temperature=0.01)
        for k in range(1, n + 1):
            for key in ("depth", "photometric_confidence", "norm_curv"):
                assert torch.equal(got[f"stage{k}"][key], want[f"stage{k}"][key]), (n, k, key)
        assert f"stage{n + 1}" not in got
        assert torch.equal(got["refined_depth"], want[f"stage{n}"]["depth"])
    assert profile_stages.prefix_model(full, ModelConfig(refine=False)).state_dict().keys() == full.state_dict().keys()
