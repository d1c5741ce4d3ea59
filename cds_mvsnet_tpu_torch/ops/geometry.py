"""Multi-view projective geometry: fundamental matrices, epipoles, plane sweeps.

Counterpart of ``cds_mvsnet_tpu/ops/geometry.py``. A view is packed as
``(B, 2, 4, 4)``: ``cams[:, 0]`` is the 4x4 world->camera extrinsic and
``cams[:, 1, :3, :3]`` the intrinsic. Everything runs in float32; callers on
the card keep TF32 off (``models.cds_mvsnet.strict_fp32``), since a TF32
product costs pixels of plane-sweep coordinate error.
"""

from __future__ import annotations

import torch

from .grid_sample import grid_sample_pixel

__all__ = [
    "skew_matrix",
    "fundamental_matrix",
    "epipole_from_fundamental",
    "relative_warp_transform",
    "plane_sweep_coords",
    "sweep_coords",
    "homography_warp",
]


def skew_matrix(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix of ``(B, 3)`` vectors -> ``(B, 3, 3)``."""
    zero = torch.zeros_like(v[:, 0])
    return torch.stack(
        [
            torch.stack([zero, -v[:, 2], v[:, 1]], -1),
            torch.stack([v[:, 2], zero, -v[:, 0]], -1),
            torch.stack([-v[:, 1], v[:, 0], zero], -1),
        ],
        -2,
    )


def _invert_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched upper-triangular pinhole intrinsics."""
    fx, s, cx = K[:, 0, 0], K[:, 0, 1], K[:, 0, 2]
    fy, cy = K[:, 1, 1], K[:, 1, 2]
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    row0 = torch.stack([1 / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)], -1)
    row1 = torch.stack([zero, 1 / fy, -cy / fy], -1)
    row2 = torch.stack([zero, zero, one], -1)
    return torch.stack([row0, row1, row2], -2)


def fundamental_matrix(cams1: torch.Tensor, cams2: torch.Tensor) -> torch.Tensor:
    """F mapping image-1 points to epipolar lines in image 2:
    ``[e2]_x (K2 R2) (K1 R1)^-1``, with structured (exact) inverses."""
    intr1, extr1 = cams1[:, 1, :3, :3], cams1[:, 0, :3, :4]
    intr2, extr2 = cams2[:, 1, :3, :3], cams2[:, 0, :3, :4]
    rot1, t1 = extr1[:, :, :3], extr1[:, :, 3:]
    rot2, t2 = extr2[:, :, :3], extr2[:, :, 3:]
    rot1_T = rot1.transpose(-1, -2)
    rot2_T = rot2.transpose(-1, -2)
    center1 = -(rot1_T @ t1)
    center2 = -(rot2_T @ t2)
    proj2 = intr2 @ rot2
    e2 = (proj2 @ (center1 - center2))[..., 0]
    return skew_matrix(e2) @ proj2 @ rot1_T @ _invert_intrinsics(intr1)


def epipole_from_fundamental(F: torch.Tensor, det_eps: float = 1e-12) -> torch.Tensor:
    """Epipole in image 1 (right null direction of F) in pixels, ``(B, 2)``.

    The regular case solves the upstream 2x2 system built from F's rows; where
    its determinant is at most ``det_eps`` (epipole at infinity) the right
    null vector is used, with its homogeneous scale clamped, so the result
    stays finite. The JAX package takes that vector from an SVD; F has rank
    2, so the longest cross product of two of its rows spans the same line.
    It is taken in fp64 and needs no host round trip, where
    ``torch.linalg.svd`` of a CUDA tensor synchronises the host with the card
    on every forward. Its sign is free, as the SVD's: DynamicConv uses only
    the line's direction, through ``(u², 2uv, v²)``. Where F is 0 (two views
    with one camera centre) every cross product is 0 and the vector is
    ``[0, 0, 1]``, as the SVD of a zero matrix gives.
    """
    c = 1e3
    eq1 = c * F[:, 0] + F[:, 1] + F[:, 2]
    eq2 = c * F[:, 0] - F[:, 1] - F[:, 2]
    a, b = eq1[:, 0], eq1[:, 1]
    d, e = eq2[:, 0], eq2[:, 1]
    det = a * e - b * d
    ok = det.abs() > det_eps
    safe_det = torch.where(ok, det, torch.ones_like(det))
    rhs1, rhs2 = -eq1[:, 2], -eq2[:, 2]
    ex = (e * rhs1 - b * rhs2) / safe_det
    ey = (-d * rhs1 + a * rhs2) / safe_det
    direct = torch.stack([ex, ey], -1)

    rows = F.double().unbind(1)
    cands = torch.stack([torch.linalg.cross(rows[i], rows[j]) for i, j in ((0, 1), (0, 2), (1, 2))], 1)
    norms = cands.norm(dim=-1)  # (B, 3)
    best = norms.argmax(1)[:, None, None].expand(-1, 1, 3)
    top = norms.amax(1, keepdim=True)
    n = torch.gather(cands, 1, best)[:, 0] / torch.where(top > 0, top, torch.ones_like(top))
    unit = torch.zeros_like(n)
    unit[:, 2] = 1.0  # a fill on the device: a tensor made from a list would be a host copy
    n = torch.where(top > 0, n, unit).to(F.dtype)
    w = n[:, 2]
    w = torch.sign(torch.where(w == 0, torch.ones_like(w), w)) * w.abs().clamp_min(1e-8)
    fallback = n[:, :2] / w[:, None]
    return torch.where(ok[:, None], direct, fallback)


def relative_warp_transform(ref_cam: torch.Tensor, src_cam: torch.Tensor):
    """``(rot (B,3,3), trans (B,3,1))`` with
    ``x_src_h ∝ rot @ x_ref_h * depth + trans``, i.e.
    ``(K_src E_src) (K_ref E_ref)^-1`` from structured inverses."""
    K1, E1 = ref_cam[:, 1, :3, :3], ref_cam[:, 0]
    K2, E2 = src_cam[:, 1, :3, :3], src_cam[:, 0]
    R1, t1 = E1[:, :3, :3], E1[:, :3, 3:]
    R2, t2 = E2[:, :3, :3], E2[:, :3, 3:]
    R_rel = R2 @ R1.transpose(-1, -2)
    t_rel = t2 - R_rel @ t1
    rot = K2 @ R_rel @ _invert_intrinsics(K1)
    trans = K2 @ t_rel
    return rot, trans


def plane_sweep_coords(ref_cam, src_cam, depth_values: torch.Tensor, H: int, W: int):
    """Source-pixel coordinates ``(px, py)``, each ``(B, D, H*W)``, of every
    (depth plane, ref pixel) pair. ``depth_values`` is ``(B, D)`` or
    ``(B, D, H, W)``."""
    return sweep_coords(*relative_warp_transform(ref_cam, src_cam), depth_values, H, W)


def sweep_coords(rot: torch.Tensor, trans: torch.Tensor, depth_values: torch.Tensor, H: int, W: int):
    """:func:`plane_sweep_coords` from the pair's ``(rot (B,3,3), trans
    (B,3,1))`` of :func:`relative_warp_transform`."""
    B, D = depth_values.shape[:2]
    dtype, device = depth_values.dtype, depth_values.device
    y, x = torch.meshgrid(
        torch.arange(H, dtype=dtype, device=device),
        torch.arange(W, dtype=dtype, device=device),
        indexing="ij",
    )
    xyz = torch.stack([x.reshape(-1), y.reshape(-1), torch.ones(H * W, dtype=dtype, device=device)])
    rot_xyz = rot @ xyz  # (B, 3, HW)
    depth = depth_values.reshape(B, 1, D, -1)
    proj_xyz = rot_xyz[:, :, None, :] * depth + trans[:, :, None, :]  # (B, 3, D, HW)
    px = proj_xyz[:, 0] / (proj_xyz[:, 2] + 1e-6)
    py = proj_xyz[:, 1] / (proj_xyz[:, 2] + 1e-6)
    return px, py


def homography_warp(src_feat, ref_cam, src_cam, depth_values) -> torch.Tensor:
    """Plane-sweep warp of ``src_feat (B,H,W,C)`` into the reference frustum:
    ``(B, D, H, W, C)``, zeros where a plane projects outside the source."""
    B, H, W, C = src_feat.shape
    D = depth_values.shape[1]
    px, py = plane_sweep_coords(ref_cam, src_cam, depth_values, H, W)
    return grid_sample_pixel(src_feat, px, py).reshape(B, D, H, W, C)
