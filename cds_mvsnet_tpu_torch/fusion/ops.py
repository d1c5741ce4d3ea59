"""Depth-map fusion on the device: geometric consistency and averaging.

Counterpart of ``cds_mvsnet_tpu/fusion/ops.py`` (the "normal" filter path of
the eval CLI): ``prob_filter``, ``reproject``, ``visibility_filter`` and
``average_fusion``, batched, in fp32. Products must stay fp32 (the JAX
package runs them at ``Precision.HIGHEST``), so on the card the caller keeps
TF32 off (``models.cds_mvsnet.strict_fp32``).

Conventions: depths ``(B, H, W)``, confidences channel-last, packed cams
``(B, 2, 4, 4)`` (``[:, 1, :3, :3]`` the intrinsic). The pixel grid has +0.5
centres. The upstream sampling quirk stays for parity: coordinates are
normalised by the width and height, clamped to ±1.1 and sampled with
``align_corners=True``, an (size−1)/size scale of the pixel coordinate; and
so does every ``1e-9`` guard.
"""

from __future__ import annotations

import torch

from ..ops.geometry import _invert_intrinsics
from ..ops.grid_sample import grid_sample_pixel

__all__ = [
    "pixel_center_grid",
    "unproject_to_world",
    "project_world_to_img",
    "prob_filter",
    "reproject",
    "visibility_filter",
    "average_fusion",
]


def pixel_center_grid(height: int, width: int, dtype=torch.float32, device=None):
    """(x+0.5, y+0.5) grids, each (H, W)."""
    x = torch.arange(width, dtype=dtype, device=device) + 0.5
    y = torch.arange(height, dtype=dtype, device=device) + 0.5
    return x[None, :].expand(height, width), y[:, None].expand(height, width)


def _cam_inverses(cam: torch.Tensor):
    """Exact K^-1 (3x3) and E^-1 (4x4) of packed cams (B,2,4,4)."""
    Kinv = _invert_intrinsics(cam[:, 1, :3, :3])
    R = cam[:, 0, :3, :3]
    t = cam[:, 0, :3, 3:]
    Rt = R.transpose(-1, -2)
    Einv = torch.zeros_like(cam[:, 0])
    Einv[:, :3, :3] = Rt
    Einv[:, :3, 3:] = -(Rt @ t)
    Einv[:, 3, 3] = 1.0
    return Kinv, Einv


def unproject_to_world(depth: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """``depth (B,H,W)`` -> world points ``(B,H,W,3)`` (+0.5 pixel centres)."""
    B, H, W = depth.shape
    Kinv, Einv = _cam_inverses(cam)
    x, y = pixel_center_grid(H, W, depth.dtype, depth.device)
    pix = torch.stack([x, y, torch.ones_like(x)], -1).reshape(1, H * W, 3)
    cam_dirs = pix @ Kinv.transpose(-1, -2)  # (B, HW, 3)
    cam_dirs = cam_dirs / (cam_dirs[..., 2:3] + 1e-9)
    cam_pts = cam_dirs * depth.reshape(B, H * W, 1)
    world = cam_pts @ Einv[:, :3, :3].transpose(-1, -2) + Einv[:, None, :3, 3]
    return world.reshape(B, H, W, 3)


def project_world_to_img(points: torch.Tensor, cam: torch.Tensor):
    """World points ``(B,...,3)`` -> (x, y, z_cam) in +0.5-centre pixel
    coordinates."""
    shape = points.shape
    pts = points.reshape(shape[0], -1, 3)
    E = cam[:, 0]
    K = cam[:, 1, :3, :3]
    cam_pts = pts @ E[:, :3, :3].transpose(-1, -2) + E[:, None, :3, 3]
    z = cam_pts[..., 2:3]
    img = (cam_pts / (z + 1e-9)) @ K.transpose(-1, -2)
    img = img / (img[..., 2:3] + 1e-9)
    out_shape = shape[:-1]
    return img[..., 0].reshape(out_shape), img[..., 1].reshape(out_shape), z[..., 0].reshape(out_shape)


def prob_filter(conf: torch.Tensor, thresholds) -> torch.Tensor:
    """Per-stage confidence AND-mask: ``conf (B,H,W,S)`` vs thresholds[S]."""
    mask = None
    for i, t in enumerate(thresholds):
        m = conf[..., i] > t
        mask = m if mask is None else (mask & m)
    return mask


def _sample_ref_quirk(src_map: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Sample with the upstream normalise -> clamp(±1.1) -> align_corners=True
    round trip: pixel coordinates are scaled by (size-1)/size."""
    B, H, W, _ = src_map.shape
    xn = torch.clamp(x / W * 2 - 1, -1.1, 1.1)
    yn = torch.clamp(y / H * 2 - 1, -1.1, 1.1)
    in_range = ((xn >= -1) & (xn <= 1) & (yn >= -1) & (yn <= 1)).to(src_map.dtype)
    xs = (xn + 1) * ((W - 1) / 2)
    ys = (yn + 1) * ((H - 1) / 2)
    return grid_sample_pixel(src_map, xs, ys), in_range


def reproject(ref_depth: torch.Tensor, src_depths: torch.Tensor, ref_cam: torch.Tensor, src_cams: torch.Tensor):
    """For each ref pixel and src view: where the matching src pixel lands
    back in the ref image and the ref-frame depth it implies.

    Args:
      ref_depth ``(B,H,W)``, src_depths ``(B,V,H,W)``, ref_cam ``(B,2,4,4)``,
      src_cams ``(B,V,2,4,4)``.
    Returns:
      reproj_xyd ``(B,V,H,W,3)``, in_range ``(B,V,H,W)``.
    """
    B, V, H, W = src_depths.shape
    src_depths_f = src_depths.reshape(B * V, H, W)
    src_cams_f = src_cams.reshape(B * V, 2, 4, 4)
    ref_depth_r = ref_depth[:, None].expand(B, V, H, W).reshape(B * V, H, W)
    ref_cam_r = ref_cam[:, None].expand(B, V, 2, 4, 4).reshape(B * V, 2, 4, 4)

    # src pixel -> world -> ref image (x, y, ref-frame z)
    world = unproject_to_world(src_depths_f, src_cams_f)
    rx, ry, rz = project_world_to_img(world, ref_cam_r)
    xyd_src = torch.stack([rx, ry, rz], -1)  # (BV, H, W, 3)

    # that map in ref pixel space: each ref pixel projects into the src image
    # through the ref depth and samples it
    ref_world = unproject_to_world(ref_depth_r, ref_cam_r)
    sx, sy, _ = project_world_to_img(ref_world, src_cams_f)
    sampled, in_range = _sample_ref_quirk(xyd_src, sx, sy)
    return sampled.reshape(B, V, H, W, 3), in_range.reshape(B, V, H, W)


def visibility_filter(ref_depth, reproj_xyd, in_range, img_dist_thresh: float, depth_thresh: float,
                      vthresh: float):
    """Geometric-consistency masks: per-view masks ``(B,V,H,W)`` float and
    the fused mask ``(B,H,W)`` bool, visible in >= vthresh-1.1 source views."""
    B, V, H, W = in_range.shape
    x, y = pixel_center_grid(H, W, ref_depth.dtype, ref_depth.device)
    dist = torch.sqrt((reproj_xyd[..., 0] - x) ** 2 + (reproj_xyd[..., 1] - y) ** 2)
    dist_mask = (dist < img_dist_thresh).to(ref_depth.dtype)
    rd = reproj_xyd[..., 2]
    depth_mask = ((ref_depth[:, None] - rd).abs() < torch.maximum(ref_depth[:, None], rd) * depth_thresh).to(
        ref_depth.dtype)
    masks = torch.minimum(torch.minimum(in_range, dist_mask), depth_mask)
    mask = masks.sum(1) >= (vthresh - 1.1)
    return masks, mask


def average_fusion(ref_depth, reproj_xyd, masks):
    """Masked mean of the reprojected depths and the reference's own."""
    num = (reproj_xyd[..., 2] * masks).sum(1) + ref_depth
    den = masks.sum(1) + 1
    return num / den
