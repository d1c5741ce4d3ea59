"""COLMAP sparse-model reader and MVS-format scene converter.

Behavioral reference: colmap2mvsnet.py in TruongKhang/cds-mvsnet. Converts a
COLMAP reconstruction (cameras/images/points3D, .bin or .txt) into the
framework's scene layout: ``cams/%08d_cam.txt`` (extrinsic, pinhole
intrinsic, depth line "min interval num max"), ``pair.txt`` with
angle-Gaussian view-selection scores, and jpg images.

Own copy of ``cds_mvsnet_tpu/data/colmap.py``: the same files for the same
workspace. One repair: the JAX copy reads 8 bytes for the 64-byte header of
each ``images.bin`` record (``_read_images_bin``), so it raises on every
binary model; the port reads 64.

Differences from the reference (results identical, faster):
  * pairwise view scores are computed with vectorized numpy over shared
    track ids instead of a multiprocessing pool of per-pair python loops.
"""

from __future__ import annotations

import os
import shutil
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["read_colmap_model", "qvec2rotmat", "convert_scene"]

# COLMAP camera models: (model_id, name, param names). Only the pinhole
# subset of params is consumed (distortion is ignored, like the reference).
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", ["f", "cx", "cy"]),
    1: ("PINHOLE", ["fx", "fy", "cx", "cy"]),
    2: ("SIMPLE_RADIAL", ["f", "cx", "cy", "k"]),
    3: ("RADIAL", ["f", "cx", "cy", "k1", "k2"]),
    4: ("OPENCV", ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"]),
    5: ("OPENCV_FISHEYE", ["fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"]),
    6: ("FULL_OPENCV", ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "k4", "k5", "k6"]),
    7: ("FOV", ["fx", "fy", "cx", "cy", "omega"]),
    8: ("SIMPLE_RADIAL_FISHEYE", ["f", "cx", "cy", "k"]),
    9: ("RADIAL_FISHEYE", ["f", "cx", "cy", "k1", "k2"]),
    10: ("THIN_PRISM_FISHEYE", ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "k4", "sx1", "sy1"]),
}
_MODEL_BY_NAME = {name: (mid, params) for mid, (name, params) in _CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    def intrinsic(self) -> np.ndarray:
        names = _MODEL_BY_NAME[self.model][1]
        d = dict(zip(names, self.params))
        fx = d.get("fx", d.get("f"))
        fy = d.get("fy", d.get("f"))
        return np.array([[fx, 0, d["cx"]], [0, fy, d["cy"]], [0, 0, 1]], dtype=np.float64)


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    point3d_ids: np.ndarray  # (-1 for unmatched keypoints)


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def _read_bytes(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def _read_cameras_bin(path):
    cameras = {}
    with open(path, "rb") as f:
        (num,) = _read_bytes(f, 8, "Q")
        for _ in range(num):
            cid, mid, w, h = _read_bytes(f, 24, "iiQQ")
            name, pnames = _CAMERA_MODELS[mid]
            params = np.array(_read_bytes(f, 8 * len(pnames), "d" * len(pnames)))
            cameras[cid] = ColmapCamera(cid, name, w, h, params)
    return cameras


def _read_images_bin(path):
    images = {}
    with open(path, "rb") as f:
        (num,) = _read_bytes(f, 8, "Q")
        for _ in range(num):
            # id + qvec(4) + tvec(3) + cam: 64 bytes (the JAX copy reads 8 and raises)
            iid = _read_bytes(f, 64, "idddddddi")
            image_id, qw, qx, qy, qz, tx, ty, tz, cam_id = iid
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n2d,) = _read_bytes(f, 8, "Q")
            data = np.frombuffer(f.read(24 * n2d), dtype=np.dtype("<f8, <f8, <i8"))
            p3d = data["f2"].astype(np.int64)
            images[image_id] = ColmapImage(
                image_id,
                np.array([qw, qx, qy, qz]),
                np.array([tx, ty, tz]),
                cam_id,
                name.decode("utf-8"),
                p3d,
            )
    return images


def _read_points3d_bin(path):
    xyz = {}
    with open(path, "rb") as f:
        (num,) = _read_bytes(f, 8, "Q")
        for _ in range(num):
            vals = _read_bytes(f, 43, "QdddBBBd")
            pid = vals[0]
            xyz[pid] = np.array(vals[1:4])
            (track_len,) = _read_bytes(f, 8, "Q")
            f.read(8 * track_len)
    return xyz


def _read_cameras_txt(path):
    cameras = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        e = line.split()
        cid = int(e[0])
        cameras[cid] = ColmapCamera(cid, e[1], int(e[2]), int(e[3]), np.array(list(map(float, e[4:]))))
    return cameras


def _read_images_txt(path):
    images = {}
    lines = [l.strip() for l in Path(path).read_text().splitlines() if l.strip() and not l.strip().startswith("#")]
    for i in range(0, len(lines), 2):
        e = lines[i].split()
        iid = int(e[0])
        pts = lines[i + 1].split()
        p3d = np.array([int(pts[k]) for k in range(2, len(pts), 3)], dtype=np.int64)
        images[iid] = ColmapImage(
            iid,
            np.array(list(map(float, e[1:5]))),
            np.array(list(map(float, e[5:8]))),
            int(e[8]),
            e[9],
            p3d,
        )
    return images


def _read_points3d_txt(path):
    xyz = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        e = line.split()
        xyz[int(e[0])] = np.array(list(map(float, e[1:4])))
    return xyz


def read_colmap_model(model_dir: str, ext: str = ".bin"):
    d = Path(model_dir)
    if ext == ".bin":
        return (
            _read_cameras_bin(d / "cameras.bin"),
            _read_images_bin(d / "images.bin"),
            _read_points3d_bin(d / "points3D.bin"),
        )
    return (
        _read_cameras_txt(d / "cameras.txt"),
        _read_images_txt(d / "images.txt"),
        _read_points3d_txt(d / "points3D.txt"),
    )


# ---------------------------------------------------------------------------


def _view_scores(images, points3d, extrinsics, theta0=5.0, sigma1=1.0, sigma2=10.0):
    """Pairwise angle-Gaussian view-selection scores (reference calc_score,
    colmap2mvsnet.py:279-293), vectorized over shared 3D tracks."""
    ids = sorted(images.keys())
    n = len(ids)
    centers = {
        i: -extrinsics[i][:3, :3].T @ extrinsics[i][:3, 3] for i in ids
    }
    track_sets = {i: images[i].point3d_ids[images[i].point3d_ids != -1] for i in ids}
    pid_to_xyz = points3d
    score = np.zeros((n, n))
    for a in range(n):
        ia = ids[a]
        set_a = track_sets[ia]
        if len(set_a) == 0:
            continue
        sa = set(set_a.tolist())
        for b in range(a + 1, n):
            ib = ids[b]
            shared = [p for p in track_sets[ib].tolist() if p in sa]
            if not shared:
                continue
            P = np.stack([pid_to_xyz[p] for p in shared])  # (k, 3)
            va = centers[ia] - P
            vb = centers[ib] - P
            cos = np.sum(va * vb, axis=1) / (
                np.linalg.norm(va, axis=1) * np.linalg.norm(vb, axis=1)
            )
            theta = np.degrees(np.arccos(np.clip(cos, -1, 1)))
            sigma = np.where(theta <= theta0, sigma1, sigma2)
            score[a, b] = score[b, a] = np.sum(
                np.exp(-((theta - theta0) ** 2) / (2 * sigma**2))
            )
    return score


def convert_scene(
    dense_folder: str,
    save_folder: str,
    max_d: int = 192,
    interval_scale: float = 1.0,
    model_ext: str = ".bin",
    theta0: float = 5.0,
    sigma1: float = 1.0,
    sigma2: float = 10.0,
    convert_images: bool = True,
):
    """COLMAP dense workspace -> MVS scene (cams/, pair.txt, images_post/)."""
    image_dir = os.path.join(dense_folder, "images")
    model_dir = os.path.join(dense_folder, "sparse")
    cam_dir = os.path.join(save_folder, "cams")
    img_out_dir = os.path.join(save_folder, "images_post")

    cameras, images_raw, points3d = read_colmap_model(model_dir, model_ext)
    # renumber to 1..N by sorted original id (reference behavior)
    images = {i + 1: images_raw[k] for i, k in enumerate(sorted(images_raw.keys()))}
    n = len(images)

    intrinsics = {cid: cam.intrinsic() for cid, cam in cameras.items()}
    extrinsics = {}
    for iid, im in images.items():
        e = np.eye(4)
        e[:3, :3] = qvec2rotmat(im.qvec)
        e[:3, 3] = im.tvec
        extrinsics[iid] = e

    # depth ranges from sparse-point camera-frame z statistics
    depth_ranges = {}
    for iid, im in images.items():
        pids = im.point3d_ids[im.point3d_ids != -1]
        zs = sorted(
            float((extrinsics[iid] @ np.append(points3d[p], 1.0))[2]) for p in pids
        )
        num_max = max(5, int(len(zs) * 0.1))
        num_min = max(1, int(len(zs) * 0.03))
        depth_min = float(np.mean(zs[:num_min]))
        depth_max = float(np.mean(zs[-num_max:]))
        if max_d == 0:
            K = intrinsics[images[iid].camera_id]
            R = extrinsics[iid][:3, :3]
            t = extrinsics[iid][:3, 3]
            p1 = np.array([K[0, 2], K[1, 2], 1.0])
            p2 = np.array([K[0, 2] + 1, K[1, 2], 1.0])
            P1 = np.linalg.inv(R) @ (np.linalg.inv(K) @ p1 * depth_min - t)
            P2 = np.linalg.inv(R) @ (np.linalg.inv(K) @ p2 * depth_min - t)
            depth_num = (1 / depth_min - 1 / depth_max) / (
                1 / depth_min - 1 / (depth_min + np.linalg.norm(P2 - P1))
            )
        else:
            depth_num = max_d
        interval = (depth_max - depth_min) / (depth_num - 1) / interval_scale
        depth_ranges[iid] = (depth_min, interval, depth_num, depth_max)

    score = _view_scores(images, points3d, extrinsics, theta0, sigma1, sigma2)

    os.makedirs(cam_dir, exist_ok=True)
    for i in range(n):
        iid = i + 1
        K = intrinsics[images[iid].camera_id]
        with open(os.path.join(cam_dir, f"{i:08d}_cam.txt"), "w") as f:
            f.write("extrinsic\n")
            for r in range(4):
                f.write(" ".join(str(extrinsics[iid][r, c]) for c in range(4)) + " \n")
            f.write("\nintrinsic\n")
            for r in range(3):
                f.write(" ".join(str(K[r, c]) for c in range(3)) + " \n")
            dr = depth_ranges[iid]
            f.write("\n%f %f %f %f\n" % dr)

    with open(os.path.join(save_folder, "pair.txt"), "w") as f:
        f.write(f"{n}\n")
        for i in range(n):
            top = np.argsort(score[i])[::-1][:10]
            f.write(f"{i}\n{len(top)} ")
            for k in top:
                f.write(f"{k} {score[i, k]:f} ")
            f.write("\n")

    if convert_images:
        from PIL import Image

        if os.path.exists(img_out_dir):
            shutil.rmtree(img_out_dir)
        os.makedirs(img_out_dir)
        for i in range(n):
            src = os.path.join(image_dir, images[i + 1].name)
            dst = os.path.join(img_out_dir, f"{i:08d}.jpg")
            if src.endswith(".jpg"):
                shutil.copyfile(src, dst)
            else:
                Image.open(src).convert("RGB").save(dst, quality=95)
    return n
