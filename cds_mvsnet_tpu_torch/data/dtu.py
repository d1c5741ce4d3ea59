"""DTU training and validation samples, in Yao Yao's preprocessed layout.

Own copy of ``cds_mvsnet_tpu/data/dtu.py``, array for array. Metas are each
scan × each ref view of ``Cameras/pair.txt`` × 7 lights. The rectified
images are used as decoded (640x512 in that layout). The raw GT depth and
its mask (``depth_visual`` > 10 on the PNG's first channel), at 1600x1200,
are halved by nearest sampling and cropped to 640x512 at the centre, then
come as pyramids at 1/8, 1/4, 1/2 and 1/1 of the crop; the cam files'
intrinsics, at 1/4 of the crop, form the stage pyramid ×0.5, ×1, ×2 and
×4.

In ``mode="train"`` a sample's source views are a permutation drawn from
the dataset's one generator. :meth:`draw` takes that draw and :meth:`load`
decodes the sample for it, so that a loader can draw in the order of its
indices and decode in a thread pool: the draws then do not depend on which
worker runs first. ``dataset[idx]`` is ``load(idx, draw(idx))``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..io.cams import read_cam_file, read_pair_file
from ..io.pfm import read_pfm
from .image import load_image, resize_nearest_np

__all__ = ["DTUDataset", "prepare_hr", "pyramid", "stage_cams"]

CROP_H, CROP_W = 512, 640
LIGHTS = 7


def prepare_hr(hr: np.ndarray) -> np.ndarray:
    """1600x1200 -> nearest ½ -> the centre 640x512."""
    h, w = hr.shape[:2]
    ds = resize_nearest_np(hr, (h // 2, w // 2))
    h, w = ds.shape[:2]
    sh, sw = (h - CROP_H) // 2, (w - CROP_W) // 2
    return ds[sh : sh + CROP_H, sw : sw + CROP_W]


def pyramid(img: np.ndarray) -> dict[str, np.ndarray]:
    """``img`` by nearest sampling at 1/8, 1/4, 1/2 and 1/1 (stage1-stage4)."""
    h, w = img.shape[:2]
    return {
        "stage1": resize_nearest_np(img, (h // 8, w // 8)),
        "stage2": resize_nearest_np(img, (h // 4, w // 4)),
        "stage3": resize_nearest_np(img, (h // 2, w // 2)),
        "stage4": img,
    }


def stage_cams(cams: np.ndarray) -> dict[str, np.ndarray]:
    """Packed cams ``(V, 2, 4, 4)`` with 1/4-resolution intrinsics as the
    stage pyramid: intrinsic rows 0-1 ×0.5, ×1, ×2 and ×4."""
    proj = {}
    for stage, scale in (("stage1", 0.5), ("stage2", 1.0), ("stage3", 2.0), ("stage4", 4.0)):
        m = cams.copy()
        m[:, 1, :2, :] *= scale
        proj[stage] = m
    return proj


def packed_cam(extrinsic: np.ndarray, intrinsic: np.ndarray) -> np.ndarray:
    cam = np.zeros((2, 4, 4), dtype=np.float32)
    cam[0] = extrinsic
    cam[1, :3, :3] = intrinsic
    return cam


class DTUDataset:
    def __init__(self, datapath: str, listfile: str, mode: str = "train", nviews: int = 5, ndepths: int = 192,
                 interval_scale: float = 1.06, rng: np.random.Generator | None = None):
        assert mode in ("train", "val", "test")
        self.datapath = datapath
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.rng = rng or np.random.default_rng(123)

        scans = [s for s in Path(listfile).read_text().split() if s]
        pairs = read_pair_file(os.path.join(datapath, "Cameras/pair.txt"))
        self.metas = [(scan, light, ref, srcs) for scan in scans for ref, srcs in pairs for light in range(LIGHTS)]

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx: int) -> dict:
        return self.load(idx, self.draw(idx))

    def draw(self, idx: int) -> list[int]:
        """The sample's view ids, ref first; in train mode the sources are
        shuffled by the dataset's generator."""
        _, _, ref_view, src_views = self.metas[idx]
        src_views = list(src_views)
        if self.mode == "train":
            self.rng.shuffle(src_views)
        return [ref_view] + src_views[: self.nviews - 1]

    def load(self, idx: int, view_ids: list[int]) -> dict:
        from PIL import Image

        scan, light = self.metas[idx][:2]
        imgs = [load_image(os.path.join(self.datapath, f"Rectified/{scan}_train/rect_{vid + 1:0>3}_{light}_r5000.png"))
                for vid in view_ids]
        cfs = [read_cam_file(os.path.join(self.datapath, f"Cameras/train/{vid:0>8}_cam.txt")) for vid in view_ids]
        ref, ref_cf = view_ids[0], cfs[0]
        raw = np.asarray(Image.open(os.path.join(self.datapath, f"Depths_raw/{scan}/depth_visual_{ref:0>4}.png")),
                         dtype=np.float32)
        if raw.ndim == 3:
            raw = raw[..., 0]
        mask_hr = (raw > 10).astype(np.float32)
        depth_hr = read_pfm(os.path.join(self.datapath, f"Depths_raw/{scan}/depth_map_{ref:0>4}.pfm"))[0]
        interval = ref_cf.depth_interval * self.interval_scale
        depth_max = interval * self.ndepths + ref_cf.depth_min
        depth_values = np.arange(ref_cf.depth_min, depth_max, interval, dtype=np.float32)[: self.ndepths]
        return {
            "imgs": np.stack(imgs),  # (V, H, W, 3)
            "proj_matrices": stage_cams(np.stack([packed_cam(cf.extrinsic, cf.intrinsic) for cf in cfs])),
            "depth": pyramid(prepare_hr(depth_hr)),
            "depth_values": depth_values,
            "mask": pyramid(prepare_hr(mask_hr)),
        }
