"""Scan-level fusion: filter each view's depth map and fuse a scan into a
point cloud (``.ply``).

Counterpart of ``cds_mvsnet_tpu/fusion/pipeline.py``. :func:`fuse_view`
runs one reference view's math (prob filter, reprojection, visibility
filter, average fusion, unprojection) on the device; :func:`fuse_scan`
gathers the variable number of kept points on the host; and
:func:`fuse_scan_native` runs the native C++ fusion (the ``gipuma`` filter
of the eval CLI) on the host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..data.image import load_image, resize_nearest_np
from ..io.cams import read_cam_file, read_pair_file
from ..io.pfm import read_pfm
from ..io.ply import write_ply
from .ops import average_fusion, prob_filter, reproject, unproject_to_world, visibility_filter

__all__ = ["FusionConfig", "fuse_scan", "fuse_view", "fuse_scan_native"]


@dataclass(frozen=True)
class FusionConfig:
    n_src_views: int = 10
    conf_thresholds: tuple[float, ...] = (0.0, 0.0, 0.0)
    img_dist_thresh: float = 1.0
    depth_thresh: float = 0.01
    vthresh: float = 3.0


@torch.no_grad()
def fuse_view(ref_depth, ref_conf, src_depths, src_confs, ref_cam, src_cams, cfg: FusionConfig):
    """One reference view -> (world points (H,W,3), final mask (H,W) bool,
    fused depth (H,W)), on the inputs' device.

    ``ref_depth (H,W)``, ``ref_conf (H,W,S)``, ``src_depths (V,H,W)``,
    ``src_confs (V,H,W,S)``, ``ref_cam (2,4,4)``, ``src_cams (V,2,4,4)``.
    """
    rd = ref_depth[None]
    rc = ref_cam[None]
    sc = src_cams[None]
    src_mask = prob_filter(src_confs, cfg.conf_thresholds)  # (V, H, W)
    sd = src_depths[None] * src_mask[None].to(src_depths.dtype)
    ref_mask = prob_filter(ref_conf[None], cfg.conf_thresholds)  # (1, H, W)

    reproj_xyd, in_range = reproject(rd, sd, rc, sc)
    vis_masks, vis_mask = visibility_filter(rd, reproj_xyd, in_range, cfg.img_dist_thresh, cfg.depth_thresh,
                                            cfg.vthresh)
    fused = average_fusion(rd, reproj_xyd, vis_masks)  # (1, H, W)
    mask = ref_mask & vis_mask
    points = unproject_to_world(fused, rc)  # (1, H, W, 3)
    return points[0], mask[0], fused[0]


def _load_view(scan_folder: str, vid: int):
    depth = read_pfm(os.path.join(scan_folder, f"depth_est/{vid:0>8}.pfm"))[0]
    conf = read_pfm(os.path.join(scan_folder, f"confidence/{vid:0>8}.pfm"))[0]
    cf = read_cam_file(os.path.join(scan_folder, f"cams/{vid:0>8}_cam.txt"))
    cam = np.zeros((2, 4, 4), dtype=np.float32)
    cam[0] = cf.extrinsic
    cam[1, :3, :3] = cf.intrinsic
    cam[1, 3, 3] = 1.0
    return depth, conf, cam


def fuse_scan(pair_folder: str, scan_folder: str, ply_path: str, cfg: FusionConfig = FusionConfig(),
              verbose: bool = False, device="cuda") -> int:
    """Fuse every reference view of a scan into one .ply, each view's math
    on ``device``. Returns the number of points."""
    from ..models.cds_mvsnet import resolve_device, strict_fp32

    dev = resolve_device(device)
    if dev.type == "cuda":
        strict_fp32()

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    all_pts, all_cols = [], []
    for ref_id, src_ids in read_pair_file(os.path.join(pair_folder, "pair.txt")):
        src_ids = list(src_ids)[: cfg.n_src_views]
        if not src_ids:
            continue
        ref_depth, ref_conf, ref_cam = _load_view(scan_folder, ref_id)
        srcs = [_load_view(scan_folder, v) for v in src_ids]
        points, mask, _ = fuse_view(
            t(ref_depth), t(ref_conf), t(np.stack([s[0] for s in srcs])), t(np.stack([s[1] for s in srcs])),
            t(ref_cam), t(np.stack([s[2] for s in srcs])), cfg,
        )
        mask_np = mask.cpu().numpy()
        pts = points.cpu().numpy()[mask_np]
        img = load_image(os.path.join(scan_folder, f"images/{ref_id:0>8}.jpg"))
        if img.shape[:2] != mask_np.shape:
            img = resize_nearest_np(img, mask_np.shape)
        all_pts.append(pts)
        all_cols.append((img[mask_np] * 255).astype(np.uint8))
        if verbose:
            print(f"{scan_folder} ref {ref_id:02d}: mask {mask_np.mean():.3f}, {len(pts)} pts")

    pts = np.concatenate(all_pts, axis=0) if all_pts else np.zeros((0, 3), np.float32)
    cols = np.concatenate(all_cols, axis=0) if all_cols else np.zeros((0, 3), np.uint8)
    write_ply(ply_path, pts, cols)
    return len(pts)


def fuse_scan_native(scan_folder: str, ply_path: str, conf_thresholds=(0.0, 0.0, 0.0), disp_thresh: float = 0.2,
                     num_consistent: int = 3, view_ids: list[int] | None = None) -> int:
    """Fuse a scan with the native C++ fusibile-equivalent
    (duplicate-suppressing) fusion, the ``gipuma`` filter of the eval CLI.
    Returns the number of points."""
    from .native import fuse_depth_maps_native

    if view_ids is None:
        view_ids = sorted(int(p.stem) for p in (Path(scan_folder) / "depth_est").glob("*.pfm"))
    if not view_ids:
        raise FileNotFoundError(
            f"no depth maps under {scan_folder}/depth_est — run inference first "
            "(or check --testlist: 'all' lists every directory in --testpath, "
            "including a nested --outdir)"
        )
    depths, cams, colors = [], [], []
    for vid in view_ids:
        d, conf, cam = _load_view(scan_folder, vid)
        keep = np.ones(d.shape, bool)
        for s, th in enumerate(conf_thresholds):
            keep &= conf[..., s] > th
        depths.append(np.where(keep, d, 0.0).astype(np.float32))
        cams.append(cam)
        colors.append((load_image(os.path.join(scan_folder, f"images/{vid:0>8}.jpg")) * 255).astype(np.uint8))
    pts, cols = fuse_depth_maps_native(np.stack(depths), np.stack(cams), np.stack(colors),
                                       disp_thresh=disp_thresh, num_consistent=num_consistent)
    write_ply(ply_path, pts, cols)
    return len(pts)
