"""Masked depth validation metrics.

Counterpart of ``cds_mvsnet_tpu/training/metrics.py``: per-image masked
reductions, averaged over the batch, and the running average of a dict of
scalars.
"""

from __future__ import annotations

import torch

__all__ = ["threshold_error", "abs_depth_error", "DictAverageMeter", "validation_metrics"]


def _per_image(fn, depth_est, depth_gt, mask):
    return torch.stack([fn(depth_est[i], depth_gt[i], mask[i]) for i in range(depth_est.shape[0])]).mean()


def threshold_error(depth_est, depth_gt, mask, thres: float):
    """Fraction of masked pixels with ``|err| > thres`` (per image, then mean)."""

    def one(est, gt, m):
        err = ((est - gt).abs() > thres).to(m.dtype)
        return (err * m).sum() / m.sum().clamp(min=1.0)

    return _per_image(one, depth_est, depth_gt, mask.to(depth_est.dtype))


def abs_depth_error(depth_est, depth_gt, mask, band: tuple[float, float] | None = None):
    """Mean ``|err|`` over masked pixels, optionally only where the error lies
    in ``band``."""

    def one(est, gt, m):
        err = (est - gt).abs()
        sel = m
        if band is not None:
            sel = sel * ((err >= band[0]) & (err <= band[1])).to(m.dtype)
        return (err * sel).sum() / sel.sum().clamp(min=1.0)

    return _per_image(one, depth_est, depth_gt, mask.to(depth_est.dtype))


def validation_metrics(depth_est, depth_gt, mask, depth_interval: float) -> dict:
    """The validation panel: ``di = interval / 2.65``, thresholds at 2, 4, 8,
    14 and 20 di, and the absolute error in the bands between them."""
    di = float(depth_interval) / 2.65
    m = mask > 0.5
    out = {"abs_depth_error": abs_depth_error(depth_est, depth_gt, m)}
    for k in (2, 4, 8, 14, 20):
        out[f"thres{k}mm_error"] = threshold_error(depth_est, depth_gt, m, di * k)
    bands = [
        ("thres2mm_abserror", 0, 2),
        ("thres4mm_abserror", 2, 4),
        ("thres8mm_abserror", 4, 8),
        ("thres14mm_abserror", 8, 14),
        ("thres20mm_abserror", 14, 20),
        ("thres>20mm_abserror", 20, 1e5 / di),
    ]
    for name, lo, hi in bands:
        out[name] = abs_depth_error(depth_est, depth_gt, m, (di * lo, di * hi))
    return out


class DictAverageMeter:
    def __init__(self):
        self.data: dict[str, float] = {}
        self.count = 0

    def reset(self):
        self.data = {}
        self.count = 0

    def update(self, new: dict, n: int = 1):
        self.count += n
        for k, v in new.items():
            self.data[k] = self.data.get(k, 0.0) + float(v) * n

    def mean(self) -> dict[str, float]:
        return {k: v / max(self.count, 1) for k, v in self.data.items()}
