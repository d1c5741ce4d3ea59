"""The port's tools (``cds_mvsnet_tpu_torch/tools/{profile_stages,bench_scan,
bench_train,train_convergence,convert_checkpoint}.py``) at the JAX tools'
points and under their keys, read from the JAX tools' source with ``ast``
(importing them would start JAX and its compile caches); each tool raising
without a card unless asked for the CPU; and ``convert_checkpoint``'s round
trip. The helpers here are shared with the ``test_torch_tools_*`` files
that run the tools."""

from __future__ import annotations

import argparse
import ast
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.tools import bench_scan, bench_train, convert_checkpoint, profile_stages, train_convergence

torch.set_num_threads(2)

JAX_TOOLS = Path(__file__).resolve().parents[1] / "tools"


def tree(tool: str) -> ast.Module:
    return ast.parse((JAX_TOOLS / f"{tool}.py").read_text())


def function(node: ast.AST, name: str) -> ast.FunctionDef:
    return next(n for n in ast.walk(node) if isinstance(n, ast.FunctionDef) and n.name == name)


def value(expr: ast.AST, env: dict | None = None):
    return eval(compile(ast.Expression(expr), "<jax tool>", "eval"), {"max": max}, env or {})


def module_constants(module: ast.Module, names: tuple[str, ...]) -> tuple:
    """The value of a module-level ``a, b, ... = ...``."""
    for node in module.body:
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Tuple)
                and tuple(e.id for e in node.targets[0].elts) == names):
            return ast.literal_eval(node.value)
    raise KeyError(names)


def assigned(fn: ast.AST, name: str) -> ast.AST:
    """The value of the (first) ``name = ...`` in ``fn``."""
    return next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name) and n.targets[0].id == name)


def calls(fn: ast.AST, name: str) -> list[ast.Call]:
    """Calls of ``name`` (a plain name or an attribute) in ``fn``."""
    def called(c):
        f = c.func
        return (f.id if isinstance(f, ast.Name) else f.attr if isinstance(f, ast.Attribute) else None) == name

    return [n for n in ast.walk(fn) if isinstance(n, ast.Call) and called(n)]


def keywords(call: ast.Call, env: dict | None = None) -> dict:
    return {k.arg: value(k.value, env) for k in call.keywords}


def keyword(call: ast.Call, name: str, env: dict | None = None):
    return value(next(k.value for k in call.keywords if k.arg == name), env)


def argparse_defaults(fn: ast.AST) -> dict:
    out = {}
    for c in calls(fn, "add_argument"):
        kw = {k.arg: k.value for k in c.keywords}
        flag = c.args[0].value
        if "default" in kw:
            out[flag] = ast.literal_eval(kw["default"])
        elif "action" in kw:
            out[flag] = False
    return out


def model_configs(fn: ast.AST, main: ast.AST) -> dict[int, ModelConfig]:
    """``prefixes = {n: ModelConfig(...) or a name}`` in ``fn`` as the port's
    ``ModelConfig``s (a name resolved in ``main``)."""
    out = {}
    node = assigned(fn, "prefixes")
    for k, v in zip(node.keys, node.values):
        call = assigned(main, v.id) if isinstance(v, ast.Name) else v
        out[k.value] = ModelConfig(**keywords(call))
    return out


def subscript_keys(fn: ast.AST, dict_name: str, loops: dict[str, list]) -> list[str]:
    """Every key assigned as ``dict_name[key] = ...`` in ``fn``, f-strings
    expanded over ``loops`` (a loop variable's values)."""
    keys = []
    for n in ast.walk(fn):
        if not isinstance(n, ast.Assign):
            continue
        for t in n.targets:
            if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) and t.value.id == dict_name:
                used = sorted({x.id for x in ast.walk(t.slice) if isinstance(x, ast.Name)} & set(loops))
                envs = [dict(zip(used, vs)) for vs in itertools.product(*(loops[u] for u in used))]
                keys += [value(t.slice, env) for env in envs]
    return keys


def dumped_dict_keys(fn: ast.AST) -> list[str]:
    """The constant keys of the dict literal ``fn`` passes to ``json.dumps``."""
    node = next(c.args[0] for c in calls(fn, "dumps") if isinstance(c.args[0], ast.Dict))
    return [k.value for k in node.keys]


# -- profile_stages ----------------------------------------------------------

PS = tree("profile_stages")
PS_MAIN = function(PS, "main")
PS_MARGINALS = function(PS, "marginals")


def jax_stage_shapes() -> dict:
    H, W, _, _ = module_constants(PS, ("H", "W", "V", "D"))
    return value(assigned(PS_MAIN, "stage_shapes"), {"H": H, "W": W})


def jax_profile_keys() -> list[str]:
    """The keys of the JAX tool's full line (``tools/profile_stages.py:97-191``)."""
    loops = {"n": list(model_configs(PS_MAIN, PS_MAIN)), "sname": list(jax_stage_shapes())}
    return subscript_keys(PS_MAIN, "results", loops)


def jax_marginal_keys() -> list[str]:
    loops = {"n": list(model_configs(PS_MARGINALS, PS_MAIN)), "nv": [2, 5], "k": [2, 3]}
    return subscript_keys(PS_MARGINALS, "res", loops) + subscript_keys(PS_MARGINALS, "out", loops)


def test_profile_stages_point_is_the_jax_tools():
    """``H, W, V, D``, the prefix configs of ``main`` and of ``marginals``,
    the stage shapes, the views and reps of ``marginals`` and the
    temperature."""
    assert (profile_stages.H, profile_stages.W, profile_stages.V, profile_stages.D) == \
        module_constants(PS, ("H", "W", "V", "D"))
    assert profile_stages.PREFIXES == model_configs(PS_MAIN, PS_MAIN) == model_configs(PS_MARGINALS, PS_MAIN)
    assert profile_stages.stage_shapes(profile_stages.H, profile_stages.W) == jax_stage_shapes()
    loop = next(n for n in ast.walk(PS_MARGINALS) if isinstance(n, ast.For) and n.target.id == "nv")
    assert profile_stages.MARGINAL_VIEWS == ast.literal_eval(loop.iter)
    assert [ast.literal_eval(c.args[2]) for c in calls(PS_MARGINALS, "timed")] == [profile_stages.MARGINAL_REPS]
    temps = {keyword(c, "temperature") for fn in (PS_MAIN, PS_MARGINALS) for c in calls(fn, "apply_cds_mvsnet")}
    assert temps == {profile_stages.TEMPERATURE}


def test_profile_stages_keys_are_the_jax_tools():
    """Fixed and per-stage keys of ``tools/profile_stages.py:97-191``, and
    the port's one addition a stage (K1, ``warp_entropy_<stage>_1view``)."""
    jax_keys = jax_profile_keys()
    assert len(jax_keys) == 7 + 3 * 3
    port = profile_stages.line_keys()
    assert sorted(set(port) - set(jax_keys)) == sorted(f"warp_entropy_{s}_1view" for s in jax_stage_shapes())
    assert set(jax_keys) <= set(port)
    per_stage = {k.format(s) for k in profile_stages.STAGE_KEYS for s in jax_stage_shapes()}
    assert set(profile_stages.FIXED_KEYS) == set(jax_keys) - per_stage
    assert per_stage <= set(jax_keys)


# -- bench_scan ----------------------------------------------------------------

BS_MAIN = function(tree("bench_scan"), "main")


def jax_scan_keys() -> list[str]:
    return dumped_dict_keys(BS_MAIN)


def test_bench_scan_point_is_the_jax_tools():
    """Flags and their defaults (``--cpu`` is ``main(device="cpu")``),
    ``CDS_SCAN_SMALL``, the depth leg's arguments, the fusion knobs."""
    jax_flags = argparse_defaults(BS_MAIN)
    port_flags = {a.option_strings[0]: a.default for a in bench_scan.parser()._actions if a.option_strings[0] != "-h"}
    assert jax_flags.pop("--cpu") is False
    assert port_flags == jax_flags
    small = next(n for n in ast.walk(BS_MAIN) if isinstance(n, ast.If) and "CDS_SCAN_SMALL" in ast.unparse(n.test))
    assert bench_scan.SMALL == ast.literal_eval(small.body[0].value)
    (save,) = calls(BS_MAIN, "save_depths")
    kw = {k.arg: k.value for k in save.keywords}
    assert ast.literal_eval(kw["interval_scale"]) == bench_scan.INTERVAL_SCALE
    assert ast.literal_eval(kw["num_workers"]) == bench_scan.NUM_WORKERS
    assert ast.literal_eval(kw["dataset"]) == "general"
    (loader,) = calls(BS_MAIN, "DataLoader")
    assert keyword(loader, "num_workers") == bench_scan.NUM_WORKERS
    (apply,) = calls(BS_MAIN, "apply_cds_mvsnet")
    assert keyword(apply, "temperature") == bench_scan.TEMPERATURE
    (fcfg,) = calls(BS_MAIN, "FusionConfig")
    assert keywords(fcfg, {"args": argparse.Namespace(nviews=5)}) == {"n_src_views": 4,
                                                                       "conf_thresholds": bench_scan.CONF_THRESHOLDS}
    (native,) = calls(BS_MAIN, "fuse_scan_native")
    assert keywords(native) == {"conf_thresholds": bench_scan.CONF_THRESHOLDS, "disp_thresh": bench_scan.DISP_THRESH,
                                "num_consistent": bench_scan.NUM_CONSISTENT}
    assert [keywords(c) for c in calls(BS_MAIN, "ModelConfig")] == [{"refine": False}]


# -- bench_train ----------------------------------------------------------------

BT = tree("bench_train")
BT_MAIN = function(BT, "main")


def jax_train_mode_keys() -> list[str]:
    node = next(n.value for n in ast.walk(BT_MAIN) if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Subscript) and isinstance(n.value, ast.Dict))
    return [k.value for k in node.keys]


def test_bench_train_point_is_the_jax_tools():
    """``H, W, V, D``, ``--bs/--reps/--modes`` (``--ablate`` left out), the
    batch's arguments, the model's refinement and the step's temperature."""
    H, W, V, D = module_constants(BT, ("H", "W", "V", "D"))
    assert (bench_train.H, bench_train.W, bench_train.V, bench_train.D) == (H, W, V, D)
    jax_flags = argparse_defaults(BT_MAIN)
    assert jax_flags.pop("--ablate") is None
    port_flags = {a.option_strings[0]: a.default for a in bench_train.parser()._actions
                  if a.option_strings[0] != "-h"}
    assert port_flags == jax_flags
    (batch,) = calls(BT_MAIN, "synthetic_batch")
    env = {"args": argparse.Namespace(bs=2), "H": H, "W": W, "V": V, "D": D}
    assert keywords(batch, env) == {"B": 2, "V": V, "H": H, "W": W, "D": D, **bench_train.BATCH}
    assert [keywords(c) for c in calls(BT_MAIN, "ModelConfig")] == [{"refine": True}]
    steps = calls(BT_MAIN, "step")
    assert {ast.literal_eval(c.args[2]) for c in steps} == {bench_train.TEMPERATURE}


# -- train_convergence -----------------------------------------------------------

TC = tree("train_convergence")
TC_MAIN = function(TC, "main")


def jax_conv_defaults() -> dict[str, str]:
    return {c.args[0].value: c.args[1].value for c in calls(TC, "get")
            if isinstance(c.args[0], ast.Constant) and c.args[0].value.startswith("CONV_")}


def test_train_convergence_point_is_the_jax_tools():
    """The ``CONV_*`` defaults (``CONV_SIZE`` 64x64 where the JAX tool's
    64x80 fails in the JAX package's own UNet, and the card where the JAX
    tool defaults to the CPU), the Trainer's settings, the sphere scene's
    views and each batch's sources."""
    jax_env = jax_conv_defaults()
    assert jax_env.pop("CONV_PLATFORM") == "cpu"
    assert jax_env.pop("CONV_SIZE") == "64x80" and train_convergence.DEFAULTS["CONV_SIZE"] == "64x64"
    assert {k: v for k, v in train_convergence.DEFAULTS.items() if k != "CONV_SIZE"} == jax_env
    (train_cfg,) = calls(TC_MAIN, "TrainConfig")
    want = keywords(train_cfg, {"epochs": 10, "lr": 0.01})
    port = train_convergence.config(10, 0.01)
    assert {k: getattr(port.train, k) for k in want} == want
    assert port.train.seed == 0 and port.model == ModelConfig(**keywords(calls(TC_MAIN, "ModelConfig")[0]))
    (scene,) = calls(TC_MAIN, "sphere_scene")
    assert keyword(scene, "V") == train_convergence.VIEWS
    assert ast.unparse(assigned(TC_MAIN, "srcs")) == "[(ref + 1) % 5, (ref + 2) % 5]"
    assert ast.unparse(assigned(TC_MAIN, "ref")) == "r % 5"


def jax_curve_keys() -> tuple[list[str], list[str]]:
    """The keys of a curve entry and of the line."""
    (entry,) = [c.args[0] for c in calls(TC_MAIN, "append") if isinstance(c.args[0], ast.Dict)]
    return [k.value for k in entry.keys], dumped_dict_keys(TC_MAIN)


# -- every tool ---------------------------------------------------------------------


@pytest.mark.parametrize("tool,argv", [
    (profile_stages, []), (bench_scan, []), (bench_train, []), (train_convergence, []),
    (convert_checkpoint, ["in.pth", "out.npz"]),
])
def test_each_tool_raises_without_a_card(tool, argv, monkeypatch):
    """No device asked for: the card, and without one a raise before any
    work (``resolve_device``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("CONV_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


def test_convert_checkpoint_round_trips_a_seeded_model(tmp_path, capsys):
    """A ``.pth`` of a seeded port model's ``state_dict`` (with the DDP
    ``module.`` prefix upstream checkpoints carry) -> ``.npz`` -> a model:
    the same tensors, and the JAX tool's line."""
    from cds_mvsnet_tpu_torch.models import build_model

    model = build_model(ModelConfig(refine=True), seed=3, device="cpu")
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}, "epoch": 24},
               tmp_path / "ckpt.pth")
    flat = convert_checkpoint.main([str(tmp_path / "ckpt.pth"), str(tmp_path / "out.npz")], device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    total = sum(v.numel() for v in model.state_dict().values())
    assert line == f"converted {len(model.state_dict())} tensors / {total} elements -> {tmp_path / 'out.npz'}"
    assert re.fullmatch(r"converted \d+ tensors / \d+ elements -> .+", line)
    assert len(flat) == len(model.state_dict())
    again = build_model(ModelConfig(refine=True), params=str(tmp_path / "out.npz"), seed=9, device="cpu")
    want, got = model.state_dict(), again.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert np.load(tmp_path / "out.npz").files  # the JAX package's format: dotted keys in one .npz
