"""The port's fusion against the JAX package's on the same depth maps: each
op, ``fuse_view``, ``fuse_scan`` through the files, and the native fusion's
ctypes binding.

Tolerances: both sides compute in fp32 (JAX at Precision.HIGHEST), so
values agree to 1e-5 relative. Masks come from ``<``, ``>`` and ``>=`` on
fp32 results, and two correct implementations may disagree on a pixel that
sits at a threshold: masks are equal except on at most 1e-4 of the pixels.
The native fusion is one C++ source bound by both packages: the same points,
compared sorted (its threads may emit them in another order).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.data.image import save_image
from cds_mvsnet_tpu.fusion import native as jnative
from cds_mvsnet_tpu.fusion import ops as jops
from cds_mvsnet_tpu.fusion import pipeline as jpipe
from cds_mvsnet_tpu.io.cams import write_cam_file
from cds_mvsnet_tpu.io.pfm import write_pfm
from cds_mvsnet_tpu.io.ply import read_ply
from cds_mvsnet_tpu_torch.fusion import native as tnative
from cds_mvsnet_tpu_torch.fusion import ops as tops
from cds_mvsnet_tpu_torch.fusion import pipeline as tpipe
from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

torch.set_num_threads(2)

V, H, W = 4, 96, 128
FLIPS = 1e-4  # share of pixels where a mask may differ
RTOL = 1e-5


@pytest.fixture(scope="module")
def maps():
    """Depth maps of a plane seen by a rig with finite epipoles, with smooth
    noise, per-stage confidences, packed cams and images."""
    rng = np.random.default_rng(0)
    rig = textured_plane_batch(V=V, H=H, W=W, D=8, tz_step=6.0, seed=0)
    cams = rig["proj_matrices"]["stage3"][0].copy()
    depths = np.stack([np.full((H, W), 600.0 - 6.0 * v, np.float32) for v in range(V)])
    depths += rng.uniform(-3.0, 3.0, (V, 1, W)).astype(np.float32) * np.linspace(0, 1, H, dtype=np.float32)[:, None]
    depths[:, 10:20, 30:50] += 40.0  # an inconsistent patch
    confs = rng.uniform(0, 1, (V, H, W, 3)).astype(np.float32)
    return depths, confs, cams, rig["imgs"][0]


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) <= rtol * np.maximum(np.abs(b), 1.0)


def T(a):
    return torch.tensor(np.asarray(a))


def test_geometry_ops_match(maps):
    depths, _, cams, _ = maps
    x, y = tops.pixel_center_grid(H, W)
    xj, yj = jops.pixel_center_grid(H, W)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
    world = tops.unproject_to_world(T(depths), T(cams))
    world_j = jops.unproject_to_world(jnp.asarray(depths), jnp.asarray(cams))
    assert close(world.numpy(), world_j).all()
    for a, b in zip(tops.project_world_to_img(world, T(cams[::-1].copy())),
                    jops.project_world_to_img(world_j, jnp.asarray(cams[::-1].copy()))):
        assert close(a.numpy(), b).all()


@pytest.mark.parametrize("thresholds", [(0.0, 0.0, 0.0), (0.2, 0.5, 0.1)])
def test_prob_filter_matches(maps, thresholds):
    conf = maps[1]
    np.testing.assert_array_equal(tops.prob_filter(T(conf), thresholds).numpy(),
                                  np.asarray(jops.prob_filter(jnp.asarray(conf), thresholds)))


def test_reproject_visibility_and_average_match(maps):
    depths, _, cams, _ = maps
    ref, src, rc, sc = depths[:1], depths[None, 1:], cams[:1], cams[None, 1:]
    xyd, in_range = tops.reproject(T(ref), T(src), T(rc), T(sc))
    xyd_j, in_range_j = jops.reproject(*(jnp.asarray(a) for a in (ref, src, rc, sc)))
    assert (in_range.numpy() != np.asarray(in_range_j)).mean() <= FLIPS
    finite = np.isfinite(np.asarray(xyd_j))
    assert np.array_equal(finite, np.isfinite(xyd.numpy()))
    assert close(xyd.numpy()[finite], np.asarray(xyd_j)[finite]).mean() >= 1 - FLIPS
    # the filter and the average on the same (the JAX package's) inputs
    for img_dist, depth_th, vth in ((1.0, 0.01, 3.0), (50.0, 0.5, 2.0)):
        masks, mask = tops.visibility_filter(T(ref), T(xyd_j), T(in_range_j), img_dist, depth_th, vth)
        masks_j, mask_j = jops.visibility_filter(jnp.asarray(ref), xyd_j, in_range_j, img_dist, depth_th, vth)
        assert (masks.numpy() != np.asarray(masks_j)).mean() <= FLIPS
        assert (mask.numpy() != np.asarray(mask_j)).mean() <= FLIPS
        assert 0.05 < float(mask.float().mean()) < 1.0  # the masks keep some pixels and drop others
        fused = tops.average_fusion(T(ref), T(xyd_j), T(masks_j))
        assert close(fused.numpy(), jops.average_fusion(jnp.asarray(ref), xyd_j, masks_j)).all()


@pytest.mark.parametrize("cfg", [
    dict(n_src_views=3, vthresh=2.0, img_dist_thresh=50.0, depth_thresh=0.5),
    dict(n_src_views=3, conf_thresholds=(0.1, 0.2, 0.1), vthresh=3.0, img_dist_thresh=1.0, depth_thresh=0.01),
])
def test_fuse_view_matches(maps, cfg):
    depths, confs, cams, _ = maps
    args = (depths[0], confs[0], depths[1:], confs[1:], cams[0], cams[1:])
    pts, mask, fused = tpipe.fuse_view(*(T(a) for a in args), tpipe.FusionConfig(**cfg))
    pts_j, mask_j, fused_j = jpipe.fuse_view(*(jnp.asarray(a) for a in args), jpipe.FusionConfig(**cfg))
    assert mask.dtype == torch.bool
    assert (mask.numpy() != np.asarray(mask_j)).mean() <= FLIPS
    assert close(fused.numpy(), fused_j).mean() >= 1 - FLIPS
    both = mask.numpy() & np.asarray(mask_j)
    assert both.mean() > 0.01  # the strict thresholds keep about 4 %
    assert close(pts.numpy()[both], np.asarray(pts_j)[both]).all(-1).mean() >= 1 - FLIPS


def write_scan(root, maps):
    depths, confs, cams, imgs = maps
    scan = root / "scan1"
    for v in range(V):
        write_pfm(scan / "depth_est" / f"{v:0>8}.pfm", depths[v])
        write_pfm(scan / "confidence" / f"{v:0>8}.pfm", confs[v])
        (scan / "cams").mkdir(parents=True, exist_ok=True)
        (scan / "images").mkdir(parents=True, exist_ok=True)
        cam = cams[v].copy()
        cam[1, 3] = [0, 0, 0, 1]
        write_cam_file(scan / "cams" / f"{v:0>8}_cam.txt", cam)
        save_image(scan / "images" / f"{v:0>8}.jpg", imgs[v])
    lines = [str(V)]
    for v in range(V):
        srcs = [u for u in range(V) if u != v]
        lines += [str(v), f"{len(srcs)} " + " ".join(f"{u} 1.0" for u in srcs)]
    (root / "pair.txt").write_text("\n".join(lines) + "\n")
    return scan


def test_fuse_scan_matches(maps, tmp_path):
    scan = write_scan(tmp_path, maps)
    cfg = dict(n_src_views=3, vthresh=2.0, img_dist_thresh=1.0, depth_thresh=0.01)
    n = tpipe.fuse_scan(str(tmp_path), str(scan), str(tmp_path / "t.ply"), tpipe.FusionConfig(**cfg), device="cpu")
    n_j = jpipe.fuse_scan(str(tmp_path), str(scan), str(tmp_path / "j.ply"), jpipe.FusionConfig(**cfg))
    assert abs(n - n_j) <= FLIPS * V * H * W and n > 0.05 * V * H * W
    (pts, cols), (pts_j, cols_j) = read_ply(tmp_path / "t.ply"), read_ply(tmp_path / "j.ply")
    assert len(pts) == n
    if n == n_j:  # the same pixels kept: the same order
        assert close(pts, pts_j).all(-1).mean() >= 1 - FLIPS
        np.testing.assert_array_equal(cols, cols_j)


def test_native_fusion_matches(maps, tmp_path):
    depths, _, cams, imgs = maps
    colors = (imgs * 255).astype(np.uint8)
    for disp, cons in ((0.2, 3), (0.1, 2)):
        pts, cols = tnative.fuse_depth_maps_native(depths, cams, colors, disp_thresh=disp, num_consistent=cons)
        pts_j, cols_j = jnative.fuse_depth_maps_native(depths, cams, colors, disp_thresh=disp, num_consistent=cons)
        assert len(pts) > 0
        order, order_j = np.lexsort(pts.T), np.lexsort(pts_j.T)
        np.testing.assert_array_equal(pts[order], pts_j[order_j])
        np.testing.assert_array_equal(cols[order], cols_j[order_j])
    scan = write_scan(tmp_path, maps)
    kw = dict(conf_thresholds=(0.1, 0.0, 0.0), disp_thresh=0.1, num_consistent=2)
    n = tpipe.fuse_scan_native(str(scan), str(tmp_path / "t.ply"), **kw)
    n_j = jpipe.fuse_scan_native(str(scan), str(tmp_path / "j.ply"), **kw)
    assert n == n_j > 0
    (pts, _), (pts_j, _) = read_ply(tmp_path / "t.ply"), read_ply(tmp_path / "j.ply")
    np.testing.assert_array_equal(pts[np.lexsort(pts.T)], pts_j[np.lexsort(pts_j.T)])
    assert tnative.build_native_fusion().parent.parent.name == "native"  # the port's own build
