"""Synthetic, geometrically consistent multi-view batches (numpy only).

Own copies of ``cds_mvsnet_tpu.utils.synthetic.textured_plane_batch`` and
``synthetic_batch``: the same seed gives the same arrays, so the port and the
JAX package can be fed the same fixture.
"""

from __future__ import annotations

import numpy as np

__all__ = ["textured_plane_batch", "synthetic_batch", "stage_resolutions"]


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
