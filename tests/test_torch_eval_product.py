"""The port's eval product against the JAX package's: ``save_depths`` on the
same scene and weights in fp32, the fp32 route's kernel sites, checkpoint
loading, the CLI's parser, and ``main`` end to end on the CPU."""

from __future__ import annotations

import pickle

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from cds_mvsnet_tpu.cli.test_cli import build_parser as jax_build_parser
from cds_mvsnet_tpu.config import ModelConfig as JaxModelConfig
from cds_mvsnet_tpu.eval.depth_inference import save_depths as jax_save_depths
from cds_mvsnet_tpu.models.cds_mvsnet import init_cds_mvsnet
from cds_mvsnet_tpu_torch.cli.test_cli import build_parser, main
from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.eval.depth_inference import resolve_fast_path, save_depths
from cds_mvsnet_tpu_torch.io.pfm import read_pfm
from cds_mvsnet_tpu_torch.io.ply import read_ply
from cds_mvsnet_tpu_torch.models import build_model, to_tensors
from cds_mvsnet_tpu_torch.models.convert import load_any_checkpoint, save_model
from cds_mvsnet_tpu_torch.models.stage_net import FP32_OPS, PLAIN_OPS
from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch
from test_torch_model import TOLERANCES
from test_torch_ops import jax_highest

torch.set_num_threads(2)

NDEPTHS = (8, 8, 8)
SIZE = dict(nviews=3, ndepths=16, interval_scale=1.0, max_h=64, max_w=96, dataset="general", num_workers=1,
            verbose=False)
N_VIEWS = 4


def write_scene(root):
    """``tests/test_eval_pipeline.py``'s scene: 4 views of 240x320 noise, a
    4-token depth line, every other view a source."""
    rng = np.random.default_rng(0)
    scan = root / "scan1"
    (scan / "images").mkdir(parents=True)
    (scan / "cams").mkdir()
    f = 300.0
    for v in range(N_VIEWS):
        Image.fromarray(rng.uniform(0, 255, (240, 320, 3)).astype(np.uint8)).save(scan / "images" / f"{v:0>8}.jpg")
        c, s = np.cos(0.05 * (v - 1.5)), np.sin(0.05 * (v - 1.5))
        (scan / "cams" / f"{v:0>8}_cam.txt").write_text(
            "extrinsic\n" + f"{c} 0 {s} {0.1 * v} \n0 1 0 0 \n{-s} 0 {c} {0.02 * v} \n0 0 0 1 \n"
            + "\nintrinsic\n" + f"{f} 0 160 \n0 {f} 120 \n0 0 1 \n" + "\n10.0 0.1 64 16.4\n")
    lines = [str(N_VIEWS)]
    for v in range(N_VIEWS):
        srcs = [u for u in range(N_VIEWS) if u != v]
        lines += [str(v), f"{len(srcs)} " + " ".join(f"{u} 2.0" for u in srcs)]
    (scan / "pair.txt").write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def product(tmp_path_factory):
    """The scene, JAX weights (also as an ``.npz``) and both packages'
    ``save_depths`` output in fp32."""
    root = tmp_path_factory.mktemp("product")
    write_scene(root / "data")
    params = jax.tree.map(np.asarray, jax.jit(init_cds_mvsnet, static_argnums=1)(
        jax.random.PRNGKey(0), JaxModelConfig(refine=False)))
    params.pop("refine_network", None)
    with jax_highest():
        jstats = jax_save_depths(params, JaxModelConfig(refine=False, ndepths=NDEPTHS), datapath=str(root / "data"),
                                 scans=["scan1"], outdir=str(root / "jax"), compute_dtype="fp32",
                                 feature_impl="plain", precision="highest", **SIZE)
    stats = save_depths(params, ModelConfig(refine=False, ndepths=NDEPTHS), datapath=str(root / "data"),
                        scans=["scan1"], outdir=str(root / "torch"), device="cpu", **SIZE)
    return {"root": root, "params": params, "jax_stats": jstats, "stats": stats}


def test_save_depths_matches_jax(product):
    root = product["root"]
    assert product["stats"]["n"] == product["jax_stats"]["n"] == N_VIEWS
    assert product["stats"].keys() == product["jax_stats"].keys()
    assert product["stats"]["compute_dtype"] == "fp32" and product["stats"]["feature_impl"] == "plain"
    interval = 4 * 0.1  # the depth line's 64 planes of 0.1 mm respanned to 16
    tol = TOLERANCES[0.001]  # temperature 0.01: the looser of the cascade's tolerances
    for v in range(N_VIEWS):
        name = f"{v:0>8}"
        for sub, key in (("depth_est", "depth"), ("confidence", "photometric_confidence")):
            got, _ = read_pfm(root / "torch" / "scan1" / sub / f"{name}.pfm")
            want, _ = read_pfm(root / "jax" / "scan1" / sub / f"{name}.pfm")
            assert got.shape == want.shape == ((64, 96) if key == "depth" else (64, 96, 3))
            d = np.abs(got - want)
            unit = interval if key == "depth" else float(np.median(np.abs(want)))
            med, p99, mx = tol[key]
            assert np.median(d) <= med * unit and np.quantile(d, 0.99) <= p99 * unit and d.max() <= mx * unit, (
                sub, v, np.median(d) / unit, np.quantile(d, 0.99) / unit, d.max() / unit)
        for sub, suffix in (("cams", "_cam.txt"), ("images", ".jpg")):
            got = (root / "torch" / "scan1" / sub / f"{name}{suffix}").read_bytes()
            assert got == (root / "jax" / "scan1" / sub / f"{name}{suffix}").read_bytes(), (sub, v)


def test_save_depths_pads_a_ragged_final_batch(product, tmp_path):
    """Batch 3 over 4 views: the last batch is padded to 3 and only the 4
    real views are written, each equal to the batch-1 run's map."""
    root = product["root"]
    save_depths(product["params"], ModelConfig(refine=False, ndepths=NDEPTHS), datapath=str(root / "data"),
                scans=["scan1"], outdir=str(tmp_path), device="cpu", batch_size=3, **SIZE)
    files = sorted(p.name for p in (tmp_path / "scan1" / "depth_est").glob("*.pfm"))
    assert files == [f"{v:0>8}.pfm" for v in range(N_VIEWS)]
    for name in files:
        got, _ = read_pfm(tmp_path / "scan1" / "depth_est" / name)
        want, _ = read_pfm(root / "torch" / "scan1" / "depth_est" / name)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * 0.4)  # batched convs sum in another order


def test_resolve_fast_path():
    assert resolve_fast_path(device="cpu") == (torch.float32, "plain", "highest")
    assert resolve_fast_path(device="cuda") == (torch.bfloat16, "s2d", "default")
    assert resolve_fast_path("fp32", "s2d", "default", max_h=130, max_w=192, device="cuda")[:2] == (
        torch.float32, "plain")


def test_fp32_route_runs_k9_and_k2_sites():
    """``FP32_OPS`` against ``PLAIN_OPS`` on the same fp32 inputs: K9's
    gather from ``plane_sweep_coords``'s arithmetic against the plain
    warp's projection (the same fp32 terms, summed in another order), K2's
    site (one plain version on the CPU)."""
    rng = np.random.default_rng(0)
    C, H, W, D = 16, 24, 40, 6
    src = torch.tensor(rng.standard_normal((H, W, C)).astype(np.float32))
    ref = torch.tensor(rng.standard_normal((C, H, W)).astype(np.float32))
    rt = torch.tensor([1.01, 0.02, -1.5, -0.015, 0.99, 2.0, 1e-4, -2e-4, 1.0, 8.0, -4.0, 0.05])
    for depth in (torch.linspace(2.0, 40.0, D),
                  torch.linspace(2.0, 40.0, D)[:, None, None] * torch.tensor(rng.uniform(0.8, 1.2, (1, H, W)),
                                                                               dtype=torch.float32)):
        ip, ent = FP32_OPS.warp(src, ref, depth.contiguous(), rt)
        ip_p, ent_p = PLAIN_OPS.warp(src, ref, depth.contiguous(), rt)
        assert ip.dtype == torch.float32 and ip.shape == (C, D, H, W)
        torch.testing.assert_close(ip, ip_p, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(ent, ent_p, rtol=1e-4, atol=1e-5)
    vol = torch.tensor(rng.standard_normal((C, D, H, W)).astype(np.float32))
    w, b = torch.tensor(rng.standard_normal((8, C, 3, 3, 3)).astype(np.float32)) * 0.05, torch.zeros(8)
    assert torch.equal(FP32_OPS.conv0(vol, w, b), PLAIN_OPS.conv0(vol, w, b))
    assert FP32_OPS.exit is K.exit_softargmin_plain and FP32_OPS.dynconv is K.dynconv_branches_plain


def test_forward_routes_by_dtype():
    """fp32 takes ``FP32_OPS``, bf16 ``KERNEL_OPS``, ``kernels=False`` the
    plain versions; on the CPU every route runs plain versions and counts no
    launch. Another dtype raises."""
    model = build_model(ModelConfig(refine=False, ndepths=NDEPTHS), device="cpu")
    b = to_tensors(textured_plane_batch(V=3, H=64, W=96, D=16, tz_step=2.0), "cpu")
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    before = [k.launches for k in (*K.KERNELS, *K.FP32_KERNELS)]
    fp32 = model(*args)["stage3"]["depth"]
    plain = model(*args, kernels=False)["stage3"]["depth"]
    assert [k.launches for k in (*K.KERNELS, *K.FP32_KERNELS)] == before
    # the two fp32 warps project and sum in another order: fp32 rounding
    assert float((fp32 - plain).abs().max()) <= 1e-3 * float(b["depth_values"][0, 1] - b["depth_values"][0, 0])
    with pytest.raises(ValueError, match="bf16 or fp32"):
        model(*args, compute_dtype=torch.float16)


class UpstreamConfig:
    """Stands for the config object upstream checkpoints pickle."""

    def __init__(self):
        self.name = "cds"


def test_load_any_checkpoint(tmp_path):
    model = build_model(ModelConfig(refine=True), seed=3, device="cpu")
    save_model(tmp_path / "w.npz", model)
    state = {f"module.{k}": v for k, v in model.state_dict().items()}
    state["module.feature.bn.num_batches_tracked"] = torch.tensor(7)
    torch.save({"state_dict": state, "config": UpstreamConfig(), "epoch": 3}, tmp_path / "w.pth", pickle_module=pickle)
    torch.save(model.state_dict(), tmp_path / "bare.ckpt")
    for name in ("w.npz", "w.pth", "bare.ckpt"):
        loaded = build_model(ModelConfig(refine=True), params=load_any_checkpoint(tmp_path / name), seed=9,
                             device="cpu")
        for (k, a), b in zip(model.state_dict().items(), loaded.state_dict().values()):
            assert torch.equal(a, b), (name, k)
    no_refine = load_any_checkpoint(tmp_path / "w.pth")
    no_refine.pop("refine_network")
    build_model(ModelConfig(refine=False), params=no_refine, device="cpu")


def test_parser_matches_jax():
    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.required, a.type, a.nargs, a.const)
                for a in parser._actions if a.dest != "help"}

    assert options(build_parser()) == options(jax_build_parser())


def test_main_end_to_end_on_the_cpu(product, tmp_path):
    root = product["root"]
    save_model(tmp_path / "ckpt.npz", build_model(ModelConfig(refine=True), device="cpu"))
    common = ["--dataset", "general", "--testpath", str(root / "data"), "--resume", str(tmp_path / "ckpt.npz"),
              "--outdir", str(tmp_path / "out"), "--interval_scale", "1.0", "--num_view", "3", "--numdepth", "64"]
    out = main([*common, "--max_h", "128", "--max_w", "192", "--stage_ndepths", "8,8,8", "--filter_method",
                "normal", "--thres_view", "2", "--thres_disp", "50.0", "--compute_dtype", "auto"], device="cpu")
    assert out["inference"]["n"] == N_VIEWS and out["inference"]["compute_dtype"] == "fp32"
    pts, cols = read_ply(tmp_path / "out" / "scan1.ply")
    assert len(pts) == out["points"]["scan1"] > 0 and np.isfinite(pts).all()
    depth, _ = read_pfm(tmp_path / "out" / "scan1" / "depth_est" / "00000000.pfm")
    assert depth.shape == (128, 192) and np.isfinite(depth).all() and (depth >= 10.0 - 1e-3).all()
    out = main([*common, "--skip_inference", "--filter_method", "gipuma", "--disp_threshold", "0.1",
                "--num_consistent", "2"], device="cpu")
    assert out["inference"] is None
    assert len(read_ply(tmp_path / "out" / "scan1.ply")[0]) == out["points"]["scan1"]
    for bad in ("8,12,8", "8,0,8", "-8,8,8", "8,8"):
        with pytest.raises(SystemExit, match="positive multiples of 8"):
            main([*common, f"--stage_ndepths={bad}"], device="cpu")


def test_main_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--testpath", str(tmp_path), "--resume", str(tmp_path / "none.npz")])
