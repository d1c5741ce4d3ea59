"""PFM (portable float map) IO, the depth and confidence map format.

Own copy of ``cds_mvsnet_tpu/io/pfm.py``, byte for byte the same files:
bottom-up rows, and a negative scale that marks little-endian data.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

__all__ = ["read_pfm", "write_pfm"]


def read_pfm(path) -> tuple[np.ndarray, float]:
    """Read a PFM file -> (HxW or HxWx3 float32 array, scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline().decode("latin-1")
        m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dimension line {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("latin-1").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, dtype=endian + "f", count=width * height * channels)
    shape = (height, width, 3) if channels == 3 else (height, width)
    return np.flipud(data.reshape(shape)).astype(np.float32), abs(scale)


def write_pfm(path, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 image as PFM (little-endian)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        header = b"PF\n"
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        header = b"Pf\n"
    else:
        raise ValueError(f"unsupported PFM shape {image.shape}")
    data = np.flipud(image)
    with open(path, "wb") as f:
        f.write(header)
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())  # negative => little-endian
        data.astype("<f").tofile(f)
