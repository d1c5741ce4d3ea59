"""Generic evaluation dataset (DTU test / Tanks&Temples / ETH3D / COLMAP).

Own copy of ``cds_mvsnet_tpu/data/eval_set.py::EvalDataset``, sample for
sample the same numpy arrays. Per view: read the jpg and the cam file,
rescale to exactly (max_h, max_w) with the intrinsic rows scaled alike, pad
T&T's 1080 rows to 1088 with edge rows and shift cy by 4, an optional
per-scan interval_scale, and 3-token depth lines that re-derive the interval
over ndepths. Emits the refine-aware stage camera pyramid.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.cams import read_cam_file, read_pair_file
from .image import load_image, resize_bilinear_np

__all__ = ["EvalDataset"]


class EvalDataset:
    def __init__(
        self,
        datapath: str,
        scans: list[str],
        nviews: int = 5,
        ndepths: int = 192,
        interval_scale: float | dict = 1.06,
        max_h: int = 864,
        max_w: int = 1152,
        fix_res: bool = False,
        dataset: str = "dtu",
        refine: bool = True,
    ):
        self.datapath = datapath
        self.nviews = nviews
        self.ndepths = ndepths
        self.max_h, self.max_w = max_h, max_w
        self.fix_res = fix_res
        self.fix_wh = False
        self.dataset = dataset
        self.refine = refine
        self._s_hw = None

        self.interval_scale = {}
        self.metas = []
        for scan in scans:
            self.interval_scale[scan] = (
                interval_scale[scan] if isinstance(interval_scale, dict) else interval_scale
            )
            for ref, srcs in read_pair_file(os.path.join(datapath, scan, "pair.txt")):
                if not srcs:
                    # Real COLMAP/T&T pair.txt files can contain views with no
                    # matched sources; the reference skips them
                    # (general_eval.py:49-54).
                    continue
                if len(srcs) < nviews:
                    srcs = srcs + [srcs[0]] * (nviews - len(srcs))
                self.metas.append((scan, ref, srcs[: nviews - 1]))

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, path, interval_scale):
        cf = read_cam_file(path)
        intr = cf.intrinsic.copy()
        if self.dataset == "tt":
            intr[1, 2] += 4  # compensates the 1080->1088 edge pad
        intr[:2, :] /= 4.0
        interval = cf.depth_interval
        if cf.num_depth is not None:
            depth_max = cf.depth_min + int(cf.num_depth) * interval
            interval = (depth_max - cf.depth_min) / self.ndepths
        interval *= interval_scale
        return intr, cf.extrinsic, cf.depth_min, interval

    def _read_img(self, path):
        img = load_image(path)
        if self.dataset == "tt":
            img = np.pad(img, ((4, 4), (0, 0), (0, 0)), "edge")
        return img

    def _scale(self, img, intr):
        h, w = img.shape[:2]
        new_h, new_w = self.max_h, self.max_w
        intr = intr.copy()
        intr[0, :] *= new_w / w
        intr[1, :] *= new_h / h
        return resize_bilinear_np(img, (new_h, new_w)), intr

    def __getitem__(self, idx: int) -> dict:
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + list(src_views)

        imgs, cams = [], []
        depth_values = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(self.datapath, scan, f"images_post/{vid:0>8}.jpg")
            if not os.path.exists(img_path):
                img_path = os.path.join(self.datapath, scan, f"images/{vid:0>8}.jpg")
            img = self._read_img(img_path)
            intr, extr, dmin, dint = self._read_cam(
                os.path.join(self.datapath, scan, f"cams/{vid:0>8}_cam.txt"),
                self.interval_scale[scan],
            )
            img, intr = self._scale(img, intr)

            if self.fix_res:
                self._s_hw = img.shape[:2]
                self.fix_res = False
                self.fix_wh = True
            if i == 0 and not self.fix_wh:
                self._s_hw = img.shape[:2]
            if img.shape[:2] != self._s_hw:
                sh, sw = self._s_hw
                intr[0, :] *= sw / img.shape[1]
                intr[1, :] *= sh / img.shape[0]
                img = resize_bilinear_np(img, (sh, sw))

            cam = np.zeros((2, 4, 4), dtype=np.float32)
            cam[0] = extr
            cam[1, :3, :3] = intr
            cams.append(cam)
            imgs.append(img)
            if i == 0:
                depth_values = np.arange(
                    dmin, dint * (self.ndepths - 0.5) + dmin, dint, dtype=np.float32
                )[: self.ndepths]

        imgs = np.stack(imgs)
        cams = np.stack(cams)
        scales = [0.5, 1.0, 2.0, 4.0] if self.refine else [1.0, 2.0, 4.0]
        proj = {}
        for s_idx, scale in enumerate(scales):
            m = cams.copy()
            m[:, 1, :2, :] *= scale
            proj[f"stage{s_idx + 1}"] = m

        return {
            "imgs": imgs,
            "proj_matrices": proj,
            "depth_values": depth_values,
            "filename": scan + "/{}/" + f"{view_ids[0]:0>8}" + "{}",
        }
