"""The port's scorers and custom-scene converter against the JAX package's
on the same inputs: ``eval/depth_metrics.py``, ``eval/dtu_benchmark.py``,
``data/colmap.py::convert_scene`` (text and binary models), and the
synthetic scenes and writers of ``utils/synthetic.py``. All of it is numpy
on the host, so both give the same numbers and the same files."""

from __future__ import annotations

import dataclasses
import filecmp
import os
import struct

import numpy as np
import pytest
from PIL import Image

from cds_mvsnet_tpu.data import colmap as jax_colmap
from cds_mvsnet_tpu.eval import depth_metrics as jax_dm
from cds_mvsnet_tpu.eval import dtu_benchmark as jax_dtu
from cds_mvsnet_tpu.utils import synthetic as jax_synthetic
from cds_mvsnet_tpu_torch.data import colmap
from cds_mvsnet_tpu_torch.data.eval_set import EvalDataset
from cds_mvsnet_tpu_torch.eval import depth_metrics as dm
from cds_mvsnet_tpu_torch.eval import dtu_benchmark as dtu
from cds_mvsnet_tpu_torch.io.pfm import write_pfm
from cds_mvsnet_tpu_torch.io.ply import write_ply
from cds_mvsnet_tpu_torch.tools import colmap2mvs
from cds_mvsnet_tpu_torch.utils import synthetic


def same_dict(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# -- depth maps --------------------------------------------------------------


@pytest.mark.parametrize("case", ["masked_resized", "plain", "empty"])
def test_eval_depth_map_matches_jax(case):
    rng = np.random.default_rng(0)
    est = rng.uniform(400, 900, (24, 32)).astype(np.float32)
    gt = est + rng.normal(0, 3, est.shape).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.2] = 0
    mask = (rng.uniform(size=gt.shape) > 0.3).astype(np.float32)
    if case == "masked_resized":  # GT and mask at twice the estimate's size
        gt, mask = np.repeat(np.repeat(gt, 2, 0), 2, 1), np.repeat(np.repeat(mask, 2, 0), 2, 1)
    elif case == "empty":
        gt[:] = 0
    args = (est, gt) if case == "plain" else (est, gt, mask)
    got, want = dm.eval_depth_map(*args), jax_dm.eval_depth_map(*args)
    same_dict(got.as_dict(), want.as_dict())


@pytest.fixture(scope="module")
def depth_layout(tmp_path_factory):
    """Estimates of two views under both method layouts, DTU GT depth maps
    at twice their size and visibility PNGs."""
    root = tmp_path_factory.mktemp("depths")
    rng = np.random.default_rng(1)
    for vid in (0, 3):
        est = rng.uniform(400, 900, (16, 24)).astype(np.float32)
        gt = np.repeat(np.repeat(est + rng.normal(0, 2, est.shape).astype(np.float32), 2, 0), 2, 1)
        for sub, name in (("est/scan1/depth_est", f"{vid:0>8}.pfm"), ("est/scan1/depths_mvsnet", f"{vid:0>8}_init.pfm"),
                          ("gt/scan1", f"depth_map_{vid:0>4}.pfm")):
            os.makedirs(root / sub, exist_ok=True)
            write_pfm(root / sub / name, gt if sub.startswith("gt") else est)
        open(root / "est/scan1/depths_mvsnet" / f"{vid:0>8}_prob.pfm", "w").close()
        vis = (rng.uniform(size=gt.shape) > 0.25).astype(np.uint8) * 255
        Image.fromarray(vis).save(root / "gt/scan1" / f"depth_visual_{vid:0>4}.png")
    return root


def test_eval_scan_depths_matches_jax(depth_layout):
    args = (str(depth_layout / "est/scan1"), str(depth_layout / "gt/scan1"), [0, 3], str(depth_layout / "gt/scan1"))
    (per, mean), (per_j, mean_j) = dm.eval_scan_depths(*args), jax_dm.eval_scan_depths(*args)
    same_dict(mean, mean_j)
    for a, b in zip(per, per_j, strict=True):
        same_dict(a.as_dict(), b.as_dict())


@pytest.mark.parametrize("method", ["ours", "mvsnet"])
def test_depth_evaluation_matches_jax(depth_layout, method):
    args = (str(depth_layout / "gt"), str(depth_layout / "est"), ["scan1"], method)
    got, want = dm.DepthEvaluation(*args), jax_dm.DepthEvaluation(*args)
    assert (got.est_depths, got.gt_depths, got.masks) == (want.est_depths, want.gt_depths, want.masks)
    same_dict(got.eval(16, 24), want.eval(16, 24))
    assert got.eval_resolutions([(16, 24)]).keys() == want.eval_resolutions([(16, 24)]).keys()


# -- point clouds ------------------------------------------------------------


@pytest.mark.parametrize("chunk", [64, 10_000])  # across chunks, and one chunk
def test_reduce_points_and_distances_match_jax(chunk):
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 1.0, (900, 3))
    np.testing.assert_array_equal(dtu.reduce_points(pts, 0.2, seed=1, chunk=chunk),
                                  jax_dtu.reduce_points(pts, 0.2, seed=1, chunk=chunk))
    other = rng.uniform(-0.5, 1.5, (300, 3))
    for q_from, q_to, cap in ((pts, other, 60.0), (other, pts, 0.05), (pts, other[:0], 60.0)):
        np.testing.assert_array_equal(dtu.nn_distances(q_from, q_to, cap), jax_dtu.nn_distances(q_from, q_to, cap))


def test_score_points_matches_jax():
    scene = synthetic.sphere_scene(V=2, H=24, W=32)
    rng = np.random.default_rng(2)
    pred = scene["gt_points"][::3] + rng.normal(0, 0.4, (len(scene["gt_points"][::3]), 3)).astype(np.float32)
    same_dict(dtu.score_points(pred, scene["gt_points"], dst=0.5),
              jax_dtu.score_points(pred, scene["gt_points"], dst=0.5))
    same_dict(dtu.score_points(pred[:0], scene["gt_points"]), jax_dtu.score_points(pred[:0], scene["gt_points"]))


def test_evaluate_scan_matches_jax(tmp_path):
    """The fixture of tests/test_dtu_benchmark.py: a GT plane, the prediction
    shifted by 0.1 mm plus far outliers, a full observability mask."""
    scipy_io = pytest.importorskip("scipy.io")
    rng = np.random.default_rng(1)
    xs, ys = np.meshgrid(np.linspace(0, 20, 50), np.linspace(0, 20, 50))
    gt = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, 5.0)], -1)
    outliers = rng.uniform(0, 20, (100, 3)) + np.array([0, 0, 100.0])
    pred_all = np.concatenate([gt + np.array([0, 0, 0.1]), outliers])
    gt_dir = tmp_path / "gt"
    (gt_dir / "Points" / "stl").mkdir(parents=True)
    (gt_dir / "ObsMask").mkdir(parents=True)
    (tmp_path / "pred").mkdir()
    for scan in (1, 4):
        write_ply(gt_dir / "Points" / "stl" / f"stl{scan:03d}_total.ply", gt.astype(np.float32))
        bb = np.array([[-1.0, -1.0, -1.0], [22.0, 22.0, 110.0]])
        obs = np.ones(np.ceil((bb[1] - bb[0]) / 1.0).astype(int) + 2, dtype=np.uint8)
        scipy_io.savemat(gt_dir / "ObsMask" / f"ObsMask{scan}_10.mat", {"ObsMask": obs, "BB": bb, "Res": 1.0})
        scipy_io.savemat(gt_dir / "ObsMask" / f"Plane{scan}.mat", {"P": np.array([0, 0, 1.0, -1.0])})
    write_ply(tmp_path / "pred" / "scan1.ply", pred_all.astype(np.float32))  # the name fallback
    write_ply(tmp_path / "pred" / "mvsnet004_l3.ply", pred_all[::2].astype(np.float32))
    got = dtu.evaluate_scan(str(tmp_path / "pred" / "scan1.ply"), str(gt_dir), 1)
    want = jax_dtu.evaluate_scan(str(tmp_path / "pred" / "scan1.ply"), str(gt_dir), 1)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert abs(got.acc_mean - 0.1) < 0.02
    (rows, summary), (rows_j, summary_j) = (mod.evaluate_scans(str(tmp_path / "pred"), str(gt_dir), [1, 4])
                                            for mod in (dtu, jax_dtu))
    assert [dataclasses.asdict(r) for r in rows] == [dataclasses.asdict(r) for r in rows_j]
    assert summary == summary_j and dtu.DTU_EVAL_SETS == jax_dtu.DTU_EVAL_SETS


# -- custom scenes -----------------------------------------------------------


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """One sphere scene written as a COLMAP workspace twice, with a text and
    with a binary model."""
    root = tmp_path_factory.mktemp("colmap")
    scene = synthetic.sphere_scene(V=4, H=48, W=64)
    for ext in (".txt", ".bin"):
        synthetic.write_colmap_workspace(root / ext[1:], scene, n_points=200, ext=ext)
    return root


def tree_files(root) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def same_tree(a, b) -> None:
    assert tree_files(a) == tree_files(b)
    for rel in tree_files(a):
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel


@pytest.mark.parametrize("max_d", [64, 0])  # a fixed plane count, and one derived from inverse depth
def test_convert_scene_matches_jax(workspace, tmp_path, max_d):
    """Text and binary models convert to the files the JAX converter writes
    from the text model. The JAX binary reader reads 8 bytes for each
    64-byte image header and raises on any binary model; the port reads 64."""
    want = tmp_path / "jax"
    assert jax_colmap.convert_scene(str(workspace / "txt"), str(want), max_d=max_d, model_ext=".txt") == 4
    for ext in ("txt", "bin"):
        got = tmp_path / ext
        assert colmap.convert_scene(str(workspace / ext), str(got), max_d=max_d, model_ext=f".{ext}") == 4
        same_tree(got, want)
    with pytest.raises(struct.error):
        jax_colmap.read_colmap_model(str(workspace / "bin" / "sparse"), ".bin")


def test_binary_and_text_models_read_alike(workspace):
    (cams_t, imgs_t, pts_t), (cams_b, imgs_b, pts_b) = (
        colmap.read_colmap_model(str(workspace / ext / "sparse"), f".{ext}") for ext in ("txt", "bin"))
    assert cams_t.keys() == cams_b.keys() and imgs_t.keys() == imgs_b.keys() and pts_t.keys() == pts_b.keys()
    np.testing.assert_array_equal(cams_t[1].params, cams_b[1].params)
    for k in imgs_t:
        for field in ("qvec", "tvec", "point3d_ids"):
            np.testing.assert_array_equal(getattr(imgs_t[k], field), getattr(imgs_b[k], field))
        assert (imgs_t[k].name, imgs_t[k].camera_id) == (imgs_b[k].name, imgs_b[k].camera_id)
    for k in pts_t:
        np.testing.assert_array_equal(pts_t[k], pts_b[k])


def test_colmap2mvs_converts_for_the_general_dataset(workspace, tmp_path, capsys):
    scene_dir = tmp_path / "data" / "scan1"
    n = colmap2mvs.main(["--dense_folder", str(workspace / "bin"), "--save_folder", str(scene_dir),
                         "--max_d", "32", "--interval_scale", "1.0"])
    assert n == 4 and "converted 4 images" in capsys.readouterr().out
    ds = EvalDataset(str(tmp_path / "data"), ["scan1"], nviews=3, ndepths=32, interval_scale=1.06, max_h=48,
                     max_w=64, dataset="general", refine=False)
    assert len(ds) == 4 and ds[0]["imgs"].shape == (3, 48, 64, 3)


def test_sphere_scene_and_eval_scene_writer_match_jax(tmp_path):
    got, want = synthetic.sphere_scene(V=3, H=20, W=28), jax_synthetic.sphere_scene(V=3, H=20, W=28)
    same_dict(got, want)
    synthetic.write_eval_scene(tmp_path / "port", "scan1", got, ndepths=64)
    jax_synthetic.write_eval_scene(tmp_path / "jax", "scan1", want, ndepths=64)
    same_tree(tmp_path / "port", tmp_path / "jax")
