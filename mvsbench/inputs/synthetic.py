"""Seeded synthetic inputs, made on the device in a few large calls.

Frozen copies, rewritten in torch, of the port's ``utils/synthetic.py``
generators (``textured_plane_batch`` and ``synthetic_batch``, themselves
copies of the JAX package's): the same scenes and rigs, drawn from a
``torch.Generator`` on the device instead of numpy's, so that set-up makes
a pool of inputs in milliseconds. Cameras are packed as the readers pack
them: ``cams[..., 0, :, :]`` the 4x4 world-to-camera extrinsic,
``cams[..., 1, :3, :3]`` the intrinsic at each stage's resolution.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["stage_resolutions", "plane_scenes", "train_batches"]


def stage_resolutions(H: int, W: int, refine: bool) -> dict:
    """Each cascade stage's resolution (and ``stage4``, the input's, with
    refinement, whose cascade runs at half the input)."""
    wh, ww = (H // 2, W // 2) if refine else (H, W)
    res = {f"stage{i + 1}": (wh // s, ww // s) for i, s in enumerate((4, 2, 1))}
    if refine:
        res["stage4"] = (H, W)
    return res


def _stage_cams(cams: torch.Tensor, H: int, W: int, refine: bool) -> dict:
    out = {}
    for stage, (h, w) in stage_resolutions(H, W, refine).items():
        if stage == "stage4":
            continue
        m = cams.clone()
        m[..., 1, 0, :] *= w / W
        m[..., 1, 1, :] *= h / H
        out[stage] = m
    return out


def _intrinsic(H: int, W: int, device) -> torch.Tensor:
    f = 1.1 * W
    return torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=torch.float32, device=device)


def plane_scenes(n: int, V: int, H: int, W: int, D: int, depth_min: float, interval: float, refine: bool,
                 gen: torch.Generator, tz_step: float = 10.0, tex_n: int = 96) -> dict:
    """``n`` scenes, each a textured fronto-parallel plane at its own depth
    seen by V cameras (``textured_plane_batch``'s rig, moved ``tz_step`` a
    view along z so that every epipole is finite): ``imgs (n,V,H,W,3)``
    in [0, 1], ``proj_matrices[stage] (n,V,2,4,4)``, ``depth_values
    (n,D)`` from ``depth_min`` by ``interval``."""
    dev = gen.device
    depth_max = depth_min + interval * (D - 1)
    tex = torch.rand((n, 3, tex_n, tex_n), generator=gen, device=dev)
    for _ in range(2):
        tex = 0.25 * (tex.roll(1, 2) + tex.roll(-1, 2) + tex.roll(1, 3) + tex.roll(-1, 3))
    plane = depth_min + (depth_max - depth_min) * (0.2 + 0.6 * torch.rand((n,), generator=gen, device=dev))
    K = _intrinsic(H, W, dev)
    f = K[0, 0]
    v = torch.arange(V, dtype=torch.float32, device=dev)
    t = torch.stack([18.0 * (v - (V - 1) / 2), 6.0 * ((v % 2) - 0.5), tz_step * v], -1)  # (V, 3) centres
    cams = torch.zeros((n, V, 2, 4, 4), dtype=torch.float32, device=dev)
    cams[:, :, 0] = torch.eye(4, device=dev)
    cams[:, :, 0, :3, 3] = -t
    cams[:, :, 1, :3, :3] = K
    cams[:, :, 1, 3, 3] = 1.0
    extent = plane * W / f * 1.6  # (n,)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    z_cam = plane[:, None] - t[None, :, 2]  # (n, V)
    Xw = (xs[None, None, None, :] - K[0, 2]) / f * z_cam[..., None, None] + t[None, :, 0, None, None]
    Yw = (ys[None, None, :, None] - K[1, 2]) / f * z_cam[..., None, None] + t[None, :, 1, None, None]
    Xw, Yw = torch.broadcast_tensors(Xw, Yw)  # (n, V, H, W)
    grid = torch.stack([2 * Xw / extent[:, None, None, None], 2 * Yw / extent[:, None, None, None]], -1)
    imgs = F.grid_sample(tex, grid.reshape(n, V * H, W, 2), mode="bilinear", padding_mode="border",
                         align_corners=True)  # (n, 3, V*H, W)
    imgs = imgs.reshape(n, 3, V, H, W).permute(0, 2, 3, 4, 1).contiguous()
    depth_values = depth_min + interval * torch.arange(D, dtype=torch.float32, device=dev)
    return {"imgs": imgs, "proj_matrices": _stage_cams(cams, H, W, refine),
            "depth_values": depth_values[None].expand(n, D).contiguous()}


def train_batches(n: int, B: int, V: int, H: int, W: int, D: int, depth_min: float, interval: float,
                  refine: bool, gen: torch.Generator) -> list:
    """``n`` training batches of ``synthetic_batch``'s kind: random images
    on a ring of cameras, smooth random ground-truth depth (a bilinear
    blow-up of an 8x8 field) and random masks at every stage."""
    dev = gen.device
    depth_max = depth_min + interval * (D - 1)
    imgs = torch.rand((n, B, V, H, W, 3), generator=gen, device=dev)
    K = _intrinsic(H, W, dev)
    cams = torch.zeros((V, 2, 4, 4), dtype=torch.float32, device=dev)
    for v in range(V):
        a = 0.08 * (v - (V - 1) / 2)
        c, s = math.cos(a), math.sin(a)
        cams[v, 0] = torch.eye(4, device=dev)
        cams[v, 0, :3, :3] = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]], device=dev)
        cams[v, 0, :3, 3] = torch.tensor([30.0 * v, 5.0 * v, 8.0 * v], device=dev)
        cams[v, 1, :3, :3] = K
        cams[v, 1, 3, 3] = 1.0
    proj = _stage_cams(cams[None].expand(B, V, 2, 4, 4), H, W, refine)
    base = (depth_min + 50) + (depth_max - depth_min - 100) * torch.rand((n, B, 1, 8, 8), generator=gen, device=dev)
    res = stage_resolutions(H, W, refine)
    if not refine:
        res["stage4"] = res["stage3"]
    masks = {k: torch.rand((n, B) + hw, generator=gen, device=dev) > 0.2 for k, hw in res.items()}
    depth = {k: F.interpolate(base.reshape(n * B, 1, 8, 8), size=hw, mode="bilinear",
                              align_corners=True).reshape((n, B) + hw) for k, hw in res.items()}
    dv = depth_min + interval * torch.arange(D, dtype=torch.float32, device=dev)
    return [{"imgs": imgs[i], "proj_matrices": {k: m.clone() for k, m in proj.items()},
             "depth_values": dv[None].expand(B, D).contiguous(),
             "depth": {k: d[i] for k, d in depth.items()}, "mask": {k: m[i].float() for k, m in masks.items()}}
            for i in range(n)]
