"""Camera file IO: MVSNet-style ``*_cam.txt`` and ``pair.txt`` formats.

Own copy of ``cds_mvsnet_tpu/io/cams.py``: the same text, token for token.

A cam file holds a 4x4 world->camera extrinsic (lines 1-4 after the
``extrinsic`` tag), a 3x3 intrinsic (lines after the ``intrinsic`` tag), and a
depth line ``depth_min depth_interval [num_depth [depth_max]]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["CameraFile", "read_cam_file", "write_cam_file", "read_pair_file", "pack_cam"]


@dataclass
class CameraFile:
    extrinsic: np.ndarray  # (4, 4) float32
    intrinsic: np.ndarray  # (3, 3) float32
    depth_min: float
    depth_interval: float
    num_depth: float | None = None
    depth_max: float | None = None


def read_cam_file(path) -> CameraFile:
    lines = [ln.rstrip() for ln in Path(path).read_text().splitlines()]
    extr = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intr = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    tokens = lines[11].split()
    depth_min = float(tokens[0])
    depth_interval = float(tokens[1]) if len(tokens) > 1 else 0.0
    num_depth = float(tokens[2]) if len(tokens) > 2 else None
    depth_max = float(tokens[3]) if len(tokens) > 3 else None
    return CameraFile(extr, intr, depth_min, depth_interval, num_depth, depth_max)


def write_cam_file(path, cam: np.ndarray) -> None:
    """Write a packed ``(2, 4, 4)`` camera (reference test.py:133-150 layout:
    the depth line is stashed in intrinsic row 3)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for i in range(4):
            f.write(" ".join(str(cam[0][i][j]) for j in range(4)) + " \n")
        f.write("\nintrinsic\n")
        for i in range(3):
            f.write(" ".join(str(cam[1][i][j]) for j in range(3)) + " \n")
        f.write(
            "\n"
            + " ".join(str(cam[1][3][j]) for j in range(4))
            + "\n"
        )


def read_pair_file(path) -> list[tuple[int, list[int]]]:
    """Parse ``pair.txt``: (ref_view, [src views sorted by score])."""
    data = []
    with open(path) as f:
        num_viewpoint = int(f.readline())
        for _ in range(num_viewpoint):
            ref_view = int(f.readline().rstrip())
            src_views = [int(x) for x in f.readline().rstrip().split()[1::2]]
            if src_views:
                data.append((ref_view, src_views))
    return data


def pack_cam(extrinsic: np.ndarray, intrinsic: np.ndarray) -> np.ndarray:
    """Pack (4x4 extrinsic, 3x3 intrinsic) into the framework's (2, 4, 4)."""
    cam = np.zeros((2, 4, 4), dtype=np.float32)
    cam[0] = extrinsic
    cam[1, :3, :3] = intrinsic
    cam[1, 3, 3] = 1.0
    return cam
