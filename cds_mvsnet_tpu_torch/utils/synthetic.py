"""Synthetic, geometrically consistent multi-view batches (numpy only).

Own copies of ``cds_mvsnet_tpu.utils.synthetic.textured_plane_batch``,
``synthetic_batch``, ``sphere_scene``, ``sphere_train_batch`` and
``write_eval_scene``: the same seed gives the same arrays, so the port and
the JAX package can be fed the same fixture. ``write_colmap_workspace``
writes a scene as a COLMAP dense workspace, the input of
``data/colmap.py::convert_scene``; ``write_dtu_train_scan`` and
``write_blended_scan`` write a textured plane in the training datasets'
on-disk layouts, the input of ``data/dtu.py`` and ``data/blended.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["textured_plane_batch", "synthetic_batch", "stage_resolutions", "sphere_scene", "sphere_train_batch",
           "write_eval_scene", "rotmat_to_qvec", "write_colmap_workspace", "write_dtu_train_scan",
           "write_blended_scan"]


def textured_plane_batch(
    V: int = 5,
    H: int = 256,
    W: int = 320,
    D: int = 192,
    plane_depth: float = 600.0,
    depth_min: float = 425.0,
    depth_max: float = 905.0,
    seed: int = 0,
    refine: bool = False,
    tz_step: float = 0.0,
):
    """Views of a textured fronto-parallel plane at ``z = plane_depth``.

    Returns ``imgs (1,V,H,W,3)``, per-stage packed cameras
    ``proj_matrices[stage] (1,V,2,4,4)``, ``depth_values (1,D)`` and
    ``gt_plane_depth``. ``tz_step`` moves view v by ``tz_step * v`` along z;
    the default pure x/y rig puts every epipole at infinity.
    """
    rng = np.random.default_rng(seed)
    f = 1.1 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float64)

    # bandlimited texture over the plane's world extent
    tex_n = 96
    tex = rng.uniform(0, 1, (tex_n, tex_n, 3))
    for _ in range(2):
        tex = 0.25 * (
            np.roll(tex, 1, 0) + np.roll(tex, -1, 0) + np.roll(tex, 1, 1) + np.roll(tex, -1, 1)
        )
    extent = plane_depth * W / f * 1.6

    cams = np.zeros((V, 2, 4, 4), dtype=np.float32)
    imgs = np.zeros((V, H, W, 3), dtype=np.float32)
    ys, xs = np.meshgrid(np.arange(H) + 0.0, np.arange(W) + 0.0, indexing="ij")
    for v in range(V):
        t = np.array([18.0 * (v - (V - 1) / 2), 6.0 * ((v % 2) - 0.5), tz_step * v])
        E = np.eye(4)
        E[:3, 3] = -t  # R = I, camera centre at t
        cams[v, 0] = E
        cams[v, 1, :3, :3] = K
        cams[v, 1, 3, 3] = 1.0
        z_cam = plane_depth - t[2]
        Xw = (xs - K[0, 2]) / f * z_cam + t[0]
        Yw = (ys - K[1, 2]) / f * z_cam + t[1]
        u = (Xw / extent + 0.5) * (tex_n - 1)
        vgrid = (Yw / extent + 0.5) * (tex_n - 1)
        u0 = np.clip(np.floor(u).astype(int), 0, tex_n - 2)
        v0 = np.clip(np.floor(vgrid).astype(int), 0, tex_n - 2)
        fu = np.clip(u - u0, 0, 1)[..., None]
        fv = np.clip(vgrid - v0, 0, 1)[..., None]
        imgs[v] = (
            tex[v0, u0] * (1 - fu) * (1 - fv)
            + tex[v0, u0 + 1] * fu * (1 - fv)
            + tex[v0 + 1, u0] * (1 - fu) * fv
            + tex[v0 + 1, u0 + 1] * fu * fv
        ).astype(np.float32)

    proj = {}
    for stage, (h_s, w_s) in stage_resolutions(H, W, refine).items():
        m = cams.copy()
        m[:, 1, 0, :] *= w_s / W
        m[:, 1, 1, :] *= h_s / H
        proj[stage] = m
    depth_values = np.linspace(depth_min, depth_max, D, dtype=np.float32)
    return {
        "imgs": imgs[None],
        "proj_matrices": {k: v[None] for k, v in proj.items()},
        "depth_values": depth_values[None],
        "gt_plane_depth": plane_depth,
    }


def synthetic_batch(
    B: int = 1,
    V: int = 3,
    H: int = 256,
    W: int = 320,
    D: int = 192,
    refine: bool = False,
    with_gt: bool = False,
    seed: int = 0,
    depth_min: float = 425.0,
    depth_max: float = 905.0,
):
    """A training batch of random images on a ring of cameras: ``imgs
    (B,V,H,W,3)``, ``proj_matrices[stage] (B,V,2,4,4)``, ``depth_values
    (B,D)`` and, with ``with_gt``, smooth random ``depth[stage]`` and random
    ``mask[stage]`` pyramids, each ``(B, h, w)``."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (B, V, H, W, 3)).astype(np.float32)

    cams = np.zeros((B, V, 2, 4, 4), dtype=np.float32)
    f = 1.1 * W
    K_full = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float32)
    for v in range(V):
        angle = 0.08 * (v - (V - 1) / 2)
        c, s = np.cos(angle), np.sin(angle)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)
        t = np.array([30.0 * v, 5.0 * v, 8.0 * v], dtype=np.float32)
        cams[:, v, 0] = np.eye(4)
        cams[:, v, 0, :3, :3] = R
        cams[:, v, 0, :3, 3] = t
        cams[:, v, 1, :3, :3] = K_full
        cams[:, v, 1, 3, 3] = 1.0

    proj = {}
    for stage, (h_s, w_s) in stage_resolutions(H, W, refine).items():
        m = cams.copy()
        m[:, :, 1, 0, :] *= w_s / W
        m[:, :, 1, 1, :] *= h_s / H
        proj[stage] = m

    depth_values = np.linspace(depth_min, depth_max, D, dtype=np.float32)[None].repeat(B, 0)
    batch = {"imgs": imgs, "proj_matrices": proj, "depth_values": depth_values}

    if with_gt:
        depth_ms, mask_ms = {}, {}
        wh, ww = (H // 2, W // 2) if refine else (H, W)
        gt_res = {
            "stage1": (wh // 4, ww // 4),
            "stage2": (wh // 2, ww // 2),
            "stage3": (wh, ww),
            "stage4": (H, W) if refine else (wh, ww),
        }
        base = rng.uniform(depth_min + 50, depth_max - 50, (B, 8, 8)).astype(np.float32)
        for stage, (h_s, w_s) in gt_res.items():
            # bilinear blow-up of a low-resolution random field
            ys = np.linspace(0, 7, h_s)
            xs = np.linspace(0, 7, w_s)
            y0 = np.floor(ys).astype(int)
            x0 = np.floor(xs).astype(int)
            ty = (ys - y0)[None, :, None]
            tx = (xs - x0)[None, None, :]
            y1 = np.minimum(y0 + 1, 7)
            x1 = np.minimum(x0 + 1, 7)
            d = (
                base[:, y0][:, :, x0] * (1 - ty) * (1 - tx)
                + base[:, y0][:, :, x1] * (1 - ty) * tx
                + base[:, y1][:, :, x0] * ty * (1 - tx)
                + base[:, y1][:, :, x1] * ty * tx
            ).astype(np.float32)
            depth_ms[stage] = d
            mask_ms[stage] = (rng.uniform(0, 1, (B, h_s, w_s)) > 0.2).astype(np.float32)
        batch["depth"] = depth_ms
        batch["mask"] = mask_ms
    return batch


def stage_resolutions(H: int, W: int, refine: bool, num_stages: int = 3):
    """Feature-map resolution per cascade stage (+ stage4 = full res when
    refine)."""
    wh, ww = (H // 2, W // 2) if refine else (H, W)
    res = {f"stage{i+1}": (wh // s, ww // s) for i, s in enumerate((4, 2, 1)[:num_stages])}
    if refine:
        res["stage4"] = (H, W)
    return res


def _world_texture(p: np.ndarray) -> np.ndarray:
    """Smooth view-consistent RGB texture of world points ``(..., 3)``.

    Sum of incommensurate sinusoids over three frequency octaves. The top
    octave's wavelength (~6-9 world units) is a few pixel footprints at the
    scene's depth (~1.6 units/px at z=600), so a 3x3 matching window sees
    real gradient — with only long-wavelength content the plane-sweep cost is
    flat over many depth intervals and the regressed depth drifts ~4 σ.
    """
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rng = np.random.default_rng(7)
    chans = []
    for c in range(3):
        v = np.full(x.shape, 0.5)
        # 3 octaves x 3 random orientations each; top octave ~6-9 units
        for octave, amp in ((0.05, 0.16), (0.22, 0.12), (0.85, 0.10)):
            for _ in range(3):
                d = rng.normal(size=3)
                d = d / np.linalg.norm(d) * octave * rng.uniform(0.7, 1.3)
                v = v + amp / np.sqrt(3) * np.sin(
                    d[0] * x + d[1] * y + d[2] * z + rng.uniform(0, 6.28)
                )
        chans.append(v)
    return np.clip(np.stack(chans, axis=-1), 0.0, 1.0).astype(np.float32)


def sphere_scene(
    V: int = 5,
    H: int = 256,
    W: int = 320,
    sphere_center=(0.0, 0.0, 600.0),
    sphere_radius: float = 130.0,
    plane_depth: float = 820.0,
    depth_min: float = 425.0,
    depth_max: float = 937.0,
):
    """Render V views of a textured sphere in front of a textured backplane.

    Closed-form ray geometry (no sampling error in the ground truth): every
    pixel's depth is the exact z-depth of its ray's first hit. Returns
      imgs ``(V, H, W, 3)`` float32, cams ``(V, 2, 4, 4)`` packed,
      gt_depth ``(V, H, W)`` exact z-depth, gt_points ``(N, 3)`` the world
      surface points seen by all pixels of all views (the scene's GT cloud).

    This is the obtainable stand-in for a DTU scan:
    depth -> filter -> fuse -> score runs end to end against exact geometry.
    """
    f = 1.15 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float64)
    c0 = np.asarray(sphere_center, dtype=np.float64)

    imgs = np.zeros((V, H, W, 3), np.float32)
    cams = np.zeros((V, 2, 4, 4), np.float32)
    gt_depth = np.zeros((V, H, W), np.float32)
    pts_all = []

    ys, xs = np.meshgrid(np.arange(H) + 0.0, np.arange(W) + 0.0, indexing="ij")
    for v in range(V):
        # camera center on a small lateral arc, looking down +z with a slight
        # inward yaw so all views converge on the sphere
        t = np.array([26.0 * (v - (V - 1) / 2), 9.0 * ((v % 2) - 0.5), 0.0])
        yaw = -np.arctan2(t[0], c0[2]) * 0.5
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]], dtype=np.float64)
        E = np.eye(4)
        E[:3, :3] = R
        E[:3, 3] = -R @ t
        cams[v, 0] = E
        cams[v, 1, :3, :3] = K
        cams[v, 1, 3, 3] = 1.0

        # pixel rays in world: d_w = R^T @ K^-1 (x, y, 1)
        d_cam = np.stack([(xs - K[0, 2]) / f, (ys - K[1, 2]) / f, np.ones_like(xs)], -1)
        d_w = d_cam @ R  # (H, W, 3) == (R.T @ d_cam^T)^T
        o = t[None, None]

        # sphere: |o + s d - c|^2 = r^2
        oc = o - c0[None, None]
        a = np.sum(d_w * d_w, -1)
        b = 2 * np.sum(d_w * oc, -1)
        cq = np.sum(oc * oc, -1) - sphere_radius**2
        disc = b * b - 4 * a * cq
        hit = disc > 0
        s_sph = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), np.inf)
        s_sph = np.where(s_sph > 0, s_sph, np.inf)

        # backplane z = plane_depth: o_z + s d_z = plane_depth
        s_pl = (plane_depth - o[..., 2]) / d_w[..., 2]
        s = np.minimum(s_sph, s_pl)
        p_world = o + s[..., None] * d_w
        # z-depth in the CAMERA frame (what MVS predicts)
        gt_depth[v] = (p_world @ R.T[:, 2] + E[2, 3]).astype(np.float32)
        imgs[v] = _world_texture(p_world)
        pts_all.append(p_world.reshape(-1, 3))

    gt_points = np.concatenate(pts_all, 0).astype(np.float32)
    return {
        "imgs": imgs,
        "cams": cams,
        "gt_depth": gt_depth,
        "gt_points": gt_points,
        "depth_min": depth_min,
        "depth_max": depth_max,
    }


def sphere_train_batch(scene: dict, ref_view: int, src_views, D: int = 48, refine: bool = True):
    """One training sample (B=1) from a ``sphere_scene``: the dataset's
    arrays (imgs, per-stage packed cams, depth_values, GT depth and mask
    pyramids), whose photometric evidence supports the ground truth."""
    views = [ref_view, *src_views]
    imgs = scene["imgs"][views][None]  # (1, V, H, W, 3)
    cams = scene["cams"][views]  # (V, 2, 4, 4)
    _, _, H, W, _ = imgs.shape

    proj = {}
    for stage, (h_s, w_s) in stage_resolutions(H, W, refine).items():
        m = cams.copy()
        m[:, 1, 0, :] *= w_s / W
        m[:, 1, 1, :] *= h_s / H
        proj[stage] = m[None]

    depth_values = np.linspace(scene["depth_min"], scene["depth_max"], D, dtype=np.float32)[None]

    gt_full = scene["gt_depth"][ref_view]  # (H, W) exact z-depth
    wh, ww = (H // 2, W // 2) if refine else (H, W)
    gt_res = {
        "stage1": (wh // 4, ww // 4),
        "stage2": (wh // 2, ww // 2),
        "stage3": (wh, ww),
        "stage4": (H, W) if refine else (wh, ww),
    }
    depth_ms, mask_ms = {}, {}
    for stage, (h_s, w_s) in gt_res.items():
        sy, sx = H // h_s, W // w_s
        d = gt_full[::sy, ::sx][None].astype(np.float32)
        depth_ms[stage] = d
        mask_ms[stage] = ((d > scene["depth_min"]) & (d < scene["depth_max"])).astype(np.float32)

    return {"imgs": imgs, "proj_matrices": proj, "depth_values": depth_values, "depth": depth_ms, "mask": mask_ms}


def _cam_text(extrinsic, intrinsic, depth_line) -> str:
    rows = [" ".join(str(float(x)) for x in row) for row in (*extrinsic, *intrinsic)]
    return ("extrinsic\n" + "\n".join(rows[:4]) + "\n\nintrinsic\n" + "\n".join(rows[4:]) + "\n\n"
            + " ".join(str(float(x)) for x in depth_line) + "\n")


def _pair_text(refs, views) -> str:
    """A pair file that gives each of ``refs`` every other view of ``views``
    as its sources, nearest first."""
    lines = [str(len(refs))]
    for r in refs:
        srcs = sorted((v for v in views if v != r), key=lambda v: (abs(v - r), v))
        lines += [str(r), f"{len(srcs)} " + " ".join(f"{v} {100.0 - abs(v - r):.1f}" for v in srcs)]
    return "\n".join(lines) + "\n"


def _valid_band(h: int, w: int, v: int) -> np.ndarray:
    """A view's GT mask: valid but for a band along the left edge whose
    width grows with the view, so that views count different pixels."""
    mask = np.ones((h, w), dtype=bool)
    mask[:, : w // 8 * (1 + v % 3)] = False
    return mask


def write_dtu_train_scan(root, scan: str = "scan1", views: int = 5, refs=(0, 1, 2), seed: int = 0,
                         plane_depth: float = 600.0, tz_step: float = 4.0) -> None:
    """A textured plane in Yao Yao's DTU training layout under ``root``,
    rendered at 1600x1200: ``Depths_raw/<scan>/depth_map_{vid:04}.pfm`` (the
    plane's depth, 0 in a band at the left) and ``depth_visual_{vid:04}.png``
    (255 where valid, 0 in the band) at that size;
    ``Rectified/<scan>_train/rect_{vid+1:03}_{light}_r5000.png``, the
    rendering halved and cropped to 640x512 as the reader crops the depth
    (one image copied for the 7 lights); ``Cameras/train/{vid:08}_cam.txt``
    with the crop's intrinsics at 1/4 (160x128) and the depth line
    ``425 2.5``; and ``Cameras/pair.txt`` with entries for ``refs`` only."""
    import os
    import shutil

    from PIL import Image

    from ..data.dtu import prepare_hr
    from ..io.pfm import write_pfm

    H, W = 1200, 1600
    rig = textured_plane_batch(V=views, H=H, W=W, D=192, plane_depth=plane_depth, tz_step=tz_step, seed=seed)
    rect = os.path.join(root, "Rectified", f"{scan}_train")
    cams_dir = os.path.join(root, "Cameras", "train")
    depths = os.path.join(root, "Depths_raw", scan)
    for d in (rect, cams_dir, depths):
        os.makedirs(d, exist_ok=True)
    sh, sw = (H // 2 - 512) // 2, (W // 2 - 640) // 2
    for v in range(views):
        first = os.path.join(rect, f"rect_{v + 1:0>3}_0_r5000.png")
        Image.fromarray((prepare_hr(rig["imgs"][0, v]) * 255).round().astype(np.uint8)).save(first)
        for light in range(1, 7):
            shutil.copyfile(first, os.path.join(rect, f"rect_{v + 1:0>3}_{light}_r5000.png"))
        cam = rig["proj_matrices"]["stage3"][0, v]  # full-resolution intrinsics
        intr = cam[1, :3, :3].astype(np.float64) / 2  # the halved image
        intr[0, 2] -= sw
        intr[1, 2] -= sh
        intr[:2] /= 4
        with open(os.path.join(cams_dir, f"{v:0>8}_cam.txt"), "w") as f:
            f.write(_cam_text(cam[0], intr, (425.0, 2.5)))
        mask = _valid_band(H, W, v)
        write_pfm(os.path.join(depths, f"depth_map_{v:0>4}.pfm"),
                  np.where(mask, plane_depth - tz_step * v, 0.0).astype(np.float32))
        Image.fromarray(mask.astype(np.uint8) * 255).save(os.path.join(depths, f"depth_visual_{v:0>4}.png"))
    with open(os.path.join(root, "Cameras", "pair.txt"), "w") as f:
        f.write(_pair_text(refs, range(views)))


def write_blended_scan(root, scan: str = "scan1", views: int = 3, seed: int = 0, plane_depth: float = 600.0,
                       tz_step: float = 4.0) -> None:
    """A textured plane in the BlendedMVS low-res layout under
    ``root/<scan>``: ``blended_images/{vid:08}.jpg`` at 768x576,
    ``cams/{vid:08}_cam.txt`` with full-resolution intrinsics (the reader
    divides them by 4) and a 4-token depth line, ``cams/pair.txt`` giving
    each view every other, and ``rendered_depth_maps/{vid:08}.pfm`` (0,
    invalid, in a band at the left)."""
    import os

    from PIL import Image

    from ..io.pfm import write_pfm

    H, W = 576, 768
    rig = textured_plane_batch(V=views, H=H, W=W, D=128, plane_depth=plane_depth, tz_step=tz_step, seed=seed)
    base = os.path.join(root, scan)
    for sub in ("blended_images", "cams", "rendered_depth_maps"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for v in range(views):
        Image.fromarray((rig["imgs"][0, v] * 255).round().astype(np.uint8)).save(
            os.path.join(base, "blended_images", f"{v:0>8}.jpg"), quality=95)
        cam = rig["proj_matrices"]["stage3"][0, v]
        with open(os.path.join(base, "cams", f"{v:0>8}_cam.txt"), "w") as f:
            f.write(_cam_text(cam[0], cam[1, :3, :3], (425.0, 3.75, 128, 905.0)))
        write_pfm(os.path.join(base, "rendered_depth_maps", f"{v:0>8}.pfm"),
                  np.where(_valid_band(H, W, v), plane_depth - tz_step * v, 0.0).astype(np.float32))
    with open(os.path.join(base, "cams", "pair.txt"), "w") as f:
        f.write(_pair_text(range(views), range(views)))


def write_eval_scene(root, scan: str, scene: dict, ndepths: int = 192) -> None:
    """Persist a rendered scene in the eval-dataset on-disk layout
    (images/ cams/ pair.txt — reference datasets/general_eval.py contract)."""
    import os

    from PIL import Image

    from ..io.cams import write_cam_file

    V = scene["imgs"].shape[0]
    scan_dir = os.path.join(str(root), scan)
    os.makedirs(os.path.join(scan_dir, "images"), exist_ok=True)
    interval = (scene["depth_max"] - scene["depth_min"]) / ndepths
    for v in range(V):
        Image.fromarray((scene["imgs"][v] * 255).astype(np.uint8)).save(
            os.path.join(scan_dir, "images", f"{v:0>8}.jpg"), quality=97
        )
        cam = scene["cams"][v].copy()
        cam[1, 3] = [scene["depth_min"], interval, ndepths, scene["depth_max"]]
        write_cam_file(os.path.join(scan_dir, "cams", f"{v:0>8}_cam.txt"), cam)
    lines = [str(V)]
    for v in range(V):
        srcs = [s for s in range(V) if s != v]
        lines.append(str(v))
        lines.append(f"{len(srcs)} " + " ".join(f"{s} 10.0" for s in srcs))
    with open(os.path.join(scan_dir, "pair.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """COLMAP's ``(w, x, y, z)`` quaternion of a rotation matrix, ``w ≥ 0``."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1], R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q if q[0] >= 0 else -q


def write_colmap_workspace(root, scene: dict, n_points: int = 400, ext: str = ".txt") -> None:
    """A ``sphere_scene`` as a COLMAP dense workspace under ``root``:
    ``images/view<v>.jpg`` and ``sparse/{cameras,images,points3D}{ext}``
    (``.txt`` or ``.bin``), one PINHOLE camera, each view's pose as a
    quaternion and translation, and ``n_points`` samples (seed 0) of the
    exact surface as the sparse cloud, each observed (and tracked) in the
    views it projects into."""
    import os
    import struct

    from PIL import Image

    V, H, W, _ = scene["imgs"].shape
    f = 1.15 * W  # sphere_scene's focal length
    os.makedirs(os.path.join(str(root), "images"), exist_ok=True)
    os.makedirs(os.path.join(str(root), "sparse"), exist_ok=True)
    rng = np.random.default_rng(0)
    pts = scene["gt_points"][rng.choice(len(scene["gt_points"]), n_points, replace=False)].astype(np.float64)
    views, tracks = [], [[] for _ in range(n_points)]
    for v in range(V):
        Image.fromarray((scene["imgs"][v] * 255).astype(np.uint8)).save(
            os.path.join(str(root), "images", f"view{v}.jpg"), quality=97)
        E = scene["cams"][v, 0].astype(np.float64)
        pc = pts @ E[:3, :3].T + E[:3, 3]
        uv = pc[:, :2] / pc[:, 2:3] * f + np.array([W / 2, H / 2])
        obs = [(u, y, j) for j, (u, y) in enumerate(uv) if pc[j, 2] > 0 and 0 <= u < W and 0 <= y < H]
        for k, (_, _, j) in enumerate(obs):
            tracks[j].append((v + 1, k))
        views.append((rotmat_to_qvec(E[:3, :3]), E[:3, 3], obs))
    sparse = os.path.join(str(root), "sparse")
    if ext == ".txt":
        with open(os.path.join(sparse, "cameras.txt"), "w") as fh:
            fh.write(f"# synthetic\n1 PINHOLE {W} {H} {f} {f} {W / 2} {H / 2}\n")
        lines = []
        for v, (q, t, obs) in enumerate(views):
            lines.append(f"{v + 1} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} 1 view{v}.jpg")
            lines.append(" ".join(f"{u:.2f} {y:.2f} {j + 1}" for u, y, j in obs))
        with open(os.path.join(sparse, "images.txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as fh:
            fh.write("\n".join(f"{j + 1} {p[0]} {p[1]} {p[2]} 200 200 200 0.5 "
                                + " ".join(f"{i} {k}" for i, k in tracks[j]) for j, p in enumerate(pts)) + "\n")
        return
    if ext != ".bin":
        raise ValueError(f"ext {ext!r}: .txt or .bin")
    with open(os.path.join(sparse, "cameras.bin"), "wb") as fh:
        fh.write(struct.pack("<QiiQQ", 1, 1, 1, W, H) + struct.pack("<4d", f, f, W / 2, H / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", V))
        for v, (q, t, obs) in enumerate(views):
            fh.write(struct.pack("<idddddddi", v + 1, *q, *t, 1) + f"view{v}.jpg".encode() + b"\x00")
            fh.write(struct.pack("<Q", len(obs)) + b"".join(struct.pack("<ddq", u, y, j + 1) for u, y, j in obs))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", n_points))
        for j, p in enumerate(pts):
            fh.write(struct.pack("<QdddBBBd", j + 1, *p, 200, 200, 200, 0.5) + struct.pack("<Q", len(tracks[j]))
                     + b"".join(struct.pack("<ii", i, k) for i, k in tracks[j]))
