"""BlendedMVS training and validation samples, in the low-res layout.

Own copy of ``cds_mvsnet_tpu/data/blended.py``, array for array. Metas are
each scan × each ref view of its ``cams/pair.txt`` (a source list shorter
than ``nviews`` is padded with its first view). Images and the GT depth are
cropped to 768x576 at the centre (the identity at the layout's size); the
intrinsics are divided by 4; a 4-token depth line ``min interval num max``
re-derives the interval as ``num · interval / ndepths``; the mask is depth
> 0; ``filename`` names the sample's outputs. Train mode shuffles the first
7 source views. :meth:`draw` and :meth:`load` split a sample as
``data/dtu.py`` does.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..io.cams import read_cam_file, read_pair_file
from ..io.pfm import read_pfm
from .dtu import packed_cam, pyramid, stage_cams
from .image import load_image

__all__ = ["BlendedMVSDataset"]

CROP_H, CROP_W = 576, 768


def _crop(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    sh, sw = (h - CROP_H) // 2, (w - CROP_W) // 2
    return img[sh : sh + CROP_H, sw : sw + CROP_W]


class BlendedMVSDataset:
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
        self.metas = []
        for scan in scans:
            for ref, srcs in read_pair_file(os.path.join(datapath, scan, "cams/pair.txt")):
                if len(srcs) < nviews:
                    srcs = srcs + [srcs[0]] * (nviews - len(srcs))
                self.metas.append((scan, ref, srcs))

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx: int) -> dict:
        return self.load(idx, self.draw(idx))

    def _read_cam(self, path):
        cf = read_cam_file(path)
        intr = cf.intrinsic.copy()
        intr[:2, :] /= 4.0
        interval = cf.depth_interval
        if cf.num_depth is not None:
            depth_max = cf.depth_min + int(cf.num_depth) * interval
            interval = (depth_max - cf.depth_min) / self.ndepths
        interval *= self.interval_scale
        return intr, cf.extrinsic, cf.depth_min, interval

    def draw(self, idx: int) -> list[int]:
        """The sample's view ids, ref first; in train mode the first 7
        sources are shuffled by the dataset's generator."""
        _, ref_view, src_views = self.metas[idx]
        src_views = list(src_views)
        if self.mode == "train":
            src_views = src_views[:7]
            self.rng.shuffle(src_views)
        return [ref_view] + src_views[: self.nviews - 1]

    def load(self, idx: int, view_ids: list[int]) -> dict:
        scan = self.metas[idx][0]
        root = os.path.join(self.datapath, scan)
        imgs = [_crop(load_image(os.path.join(root, f"blended_images/{vid:0>8}.jpg"))) for vid in view_ids]
        cams = [self._read_cam(os.path.join(root, f"cams/{vid:0>8}_cam.txt")) for vid in view_ids]
        _, _, dmin, dint = cams[0]
        depth = read_pfm(os.path.join(root, f"rendered_depth_maps/{view_ids[0]:0>8}.pfm"))[0]
        depth_max = dint * (self.ndepths - 0.5) + dmin
        return {
            "imgs": np.stack(imgs),
            "proj_matrices": stage_cams(np.stack([packed_cam(extr, intr) for intr, extr, _, _ in cams])),
            "depth": pyramid(_crop(depth)),
            "depth_values": np.arange(dmin, depth_max, dint, dtype=np.float32)[: self.ndepths],
            "mask": pyramid(_crop((depth > 0).astype(np.float32))),
            "filename": scan + "/{}/" + f"{view_ids[0]:0>8}" + "{}",
        }
