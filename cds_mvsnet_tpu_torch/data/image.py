"""Host-side image decode and resize, in numpy.

Own copy of ``cds_mvsnet_tpu/data/image.py``: cv2's INTER_NEAREST
(``floor(dst * scale)`` source indexing) and INTER_LINEAR (half-pixel
bilinear with edge clamping, torch's ``align_corners=False`` sampling) with
the same index math. Decoding and encoding use Pillow, imported where they
run, so the rest of the package imports without it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_image", "resize_nearest_np", "resize_bilinear_np", "save_image"]


def load_image(path) -> np.ndarray:
    """Decode to float32 RGB in [0, 1]."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def save_image(path, img01: np.ndarray) -> None:
    """Encode a float RGB image in [0, 1] (format from the suffix)."""
    from PIL import Image

    arr = np.clip(img01 * 255, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def _nearest_idx(in_size: int, out_size: int) -> np.ndarray:
    scale = in_size / out_size
    return np.minimum(np.floor(np.arange(out_size) * scale).astype(np.int64), in_size - 1)


def resize_nearest_np(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """cv2 INTER_NEAREST-equivalent resize on (H, W[, C]) arrays."""
    h, w = out_hw
    yi = _nearest_idx(img.shape[0], h)
    xi = _nearest_idx(img.shape[1], w)
    return img[yi][:, xi]


def _linear_axis(size_in: int, size_out: int):
    src = np.maximum((np.arange(size_out) + 0.5) * size_in / size_out - 0.5, 0.0)
    lo = np.minimum(np.floor(src).astype(np.int64), size_in - 1)
    hi = np.minimum(lo + 1, size_in - 1)
    t = (src - lo).astype(np.float32)
    return lo, hi, t


def resize_bilinear_np(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """cv2 INTER_LINEAR-equivalent (half-pixel) resize on (H, W[, C])."""
    h, w = out_hw
    ylo, yhi, ty = _linear_axis(img.shape[0], h)
    xlo, xhi, tx = _linear_axis(img.shape[1], w)
    if img.ndim == 3:
        ty = ty[:, None, None]
        tx = tx[None, :, None]
    else:
        ty = ty[:, None]
        tx = tx[None, :]
    top = img[ylo]
    bot = img[yhi]
    rows = top * (1 - ty) + bot * ty
    return (rows[:, xlo] * (1 - tx) + rows[:, xhi] * tx).astype(img.dtype)
