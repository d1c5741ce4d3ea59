"""Standalone depth-map evaluation vs DTU ground truth.

Own copy of ``cds_mvsnet_tpu/eval/depth_metrics.py`` (numpy on the host; the
same numbers for the same files).

Behavioral reference: evaluations/precision.py in TruongKhang/cds-mvsnet —
MAE / RMSE / <1,2,4 mm inlier ratios of estimated depth PFMs against GT
depth, masked by the GT visibility mask, at the estimate's resolution.
``DepthEvaluation`` reproduces precision.py's comparison harness
(precision.py:16-119): multi-method output layouts, GT depth + visibility
mask nearest-resized to a requested (max_h, max_w), evaluated per view and
averaged — so saved PFMs from different methods/stages/resolutions can be
compared in one table.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..data.image import resize_nearest_np
from ..io.pfm import read_pfm

__all__ = ["DepthMetrics", "DepthEvaluation", "eval_depth_map", "eval_scan_depths"]


@dataclass
class DepthMetrics:
    mae: float
    rmse: float
    inlier_1mm: float
    inlier_2mm: float
    inlier_4mm: float
    n_pixels: int

    def as_dict(self):
        return self.__dict__.copy()


def eval_depth_map(est: np.ndarray, gt: np.ndarray, mask: np.ndarray | None = None) -> DepthMetrics:
    if gt.shape != est.shape:
        gt = resize_nearest_np(gt, est.shape[:2])
        if mask is not None:
            mask = resize_nearest_np(mask, est.shape[:2])
    valid = gt > 0
    if mask is not None:
        valid &= mask > 0.5
    err = np.abs(est - gt)[valid]
    if err.size == 0:
        return DepthMetrics(np.nan, np.nan, np.nan, np.nan, np.nan, 0)
    return DepthMetrics(
        mae=float(err.mean()),
        rmse=float(np.sqrt((err**2).mean())),
        inlier_1mm=float((err < 1).mean()),
        inlier_2mm=float((err < 2).mean()),
        inlier_4mm=float((err < 4).mean()),
        n_pixels=int(err.size),
    )


class DepthEvaluation:
    """Multi-method / multi-resolution depth-PFM comparison harness.

    Mirrors evaluations/precision.py:16-119: for each scene, discover the
    estimated-depth view indices from the method's on-disk layout, pair them
    with DTU GT `depth_map_{idx:04d}.pfm` + `depth_visual_{idx:04d}.png`
    visibility masks, then ``eval(max_h, max_w)`` nearest-resizes GT and mask
    to the requested resolution (the estimates must already be saved at it,
    as in precision.py:87-91) and averages MAE / RMSE / threshold inliers.

    Layouts (precision.py:22-50):
      - "casmvsnet" / "pvamvsnet" / "cvpmvsnet" / "ours":
        ``{input}/{scene}/{depth_folder}/{idx:08d}.pfm``
      - "mvsnet" / "rmvsnet":
        ``{input}/{scene}/depths_{method}/{idx:08d}_init.pfm`` with indices
        discovered from the sibling ``_prob`` files.
    """

    def __init__(
        self,
        gt_depth_folder: str,
        input_folder: str,
        scenes,
        method: str = "casmvsnet",
        depth_folder: str = "depth_est",
    ):
        self.gt_depths: list[str] = []
        self.masks: list[str] = []
        self.est_depths: list[str] = []
        for scene in scenes:
            gt_dir = os.path.join(gt_depth_folder, scene)
            if method in ("casmvsnet", "pvamvsnet", "cvpmvsnet", "ours"):
                est_dir = os.path.join(input_folder, scene, depth_folder)
                indices = sorted(
                    int(f.split(".")[0])
                    for f in os.listdir(est_dir)
                    if os.path.isfile(os.path.join(est_dir, f)) and f.endswith(".pfm")
                )
                est_paths = [os.path.join(est_dir, f"{i:0>8}.pfm") for i in indices]
            elif method in ("mvsnet", "rmvsnet"):
                est_dir = os.path.join(input_folder, scene, f"depths_{method}")
                indices = sorted(
                    int(f.split("_")[0])
                    for f in os.listdir(est_dir)
                    if os.path.isfile(os.path.join(est_dir, f)) and "prob" in f
                )
                est_paths = [os.path.join(est_dir, f"{i:0>8}_init.pfm") for i in indices]
            else:
                raise ValueError(f"unknown method layout: {method!r}")
            for idx, est in zip(indices, est_paths):
                self.gt_depths.append(os.path.join(gt_dir, f"depth_map_{idx:0>4}.pfm"))
                self.masks.append(os.path.join(gt_dir, f"depth_visual_{idx:0>4}.png"))
                self.est_depths.append(est)

    def eval(self, max_h: int = 864, max_w: int = 1152) -> dict:
        """Mean metrics over all views at one resolution (precision.py:79-93)."""
        from PIL import Image

        sums: dict[str, float] = {}
        n = 0
        for gt_p, mask_p, est_p in zip(self.gt_depths, self.masks, self.est_depths):
            gt = resize_nearest_np(
                np.asarray(read_pfm(gt_p)[0], dtype=np.float32), (max_h, max_w)
            )
            mask = resize_nearest_np(
                (np.asarray(Image.open(mask_p), dtype=np.float32) > 10).astype(np.float32),
                (max_h, max_w),
            )
            est = np.asarray(read_pfm(est_p)[0], dtype=np.float32)
            if est.shape != gt.shape:
                raise ValueError(
                    f"{est_p}: estimate {est.shape} != requested eval res {gt.shape}"
                )
            valid = mask > 0.5
            err = np.abs(est - gt)[valid]
            m = {
                "MAE": float(err.mean()),
                "RMSE": float(np.sqrt((err**2).mean())),
                "thresh1mm_error": float((err <= 1).mean()),
                "thresh2mm_error": float((err <= 2).mean()),
                "thresh4mm_error": float((err <= 4).mean()),
            }
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + v
            n += 1
        return {k: v / max(n, 1) for k, v in sums.items()}

    def eval_resolutions(self, resolutions) -> dict:
        """The multi-resolution table of precision.py:110-119:
        {(max_h, max_w): mean-metrics dict}."""
        return {(h, w): self.eval(max_h=h, max_w=w) for h, w in resolutions}


def eval_scan_depths(est_dir: str, gt_dir: str, view_ids, mask_dir: str | None = None):
    """Average metrics over a scan's views. est layout: depth_est/%08d.pfm;
    gt layout: depth_map_%04d.pfm (+ optional depth_visual_%04d.png masks)."""
    from PIL import Image

    per_view = []
    for vid in view_ids:
        est = read_pfm(os.path.join(est_dir, f"depth_est/{vid:0>8}.pfm"))[0]
        gt = read_pfm(os.path.join(gt_dir, f"depth_map_{vid:0>4}.pfm"))[0]
        mask = None
        if mask_dir:
            mp = os.path.join(mask_dir, f"depth_visual_{vid:0>4}.png")
            if os.path.exists(mp):
                mask = (np.asarray(Image.open(mp), dtype=np.float32) > 10).astype(np.float32)
        per_view.append(eval_depth_map(est, gt, mask))
    keys = ["mae", "rmse", "inlier_1mm", "inlier_2mm", "inlier_4mm"]
    mean = {k: float(np.nanmean([getattr(m, k) for m in per_view])) for k in keys}
    return per_view, mean
