"""ctypes binding of the native (C++) fusibile-equivalent fusion.

Counterpart of ``cds_mvsnet_tpu/fusion/native.py``. It compiles the
repository's ``native/fusion/fusion.cc`` (one source for both packages) with
``g++`` at first use into ``cds_mvsnet_tpu_torch/_build/native/``, a
directory keyed by the source's hash, and exposes
:func:`fuse_depth_maps_native`. The fusion runs on the host, on numpy arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["build_native_fusion", "fuse_depth_maps_native"]

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG.parent / "native" / "fusion" / "fusion.cc"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None


def build_native_fusion() -> Path:
    """The shared library of ``fusion.cc``, compiled if this source and these
    flags have not been built yet."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    lib = _PKG / "_build" / "native" / h / "libcds_fusion.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"libcds_fusion.{os.getpid()}.{threading.get_ident()}.tmp.so")
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], check=True)
        os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_native_fusion()))
            lib.fuse_depth_maps.restype = ctypes.c_longlong
            lib.fuse_depth_maps.argtypes = [
                ctypes.POINTER(ctypes.c_float),   # depths
                ctypes.POINTER(ctypes.c_float),   # cams
                ctypes.POINTER(ctypes.c_ubyte),   # colors
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # V, H, W
                ctypes.c_float, ctypes.c_int, ctypes.c_int,  # disp, num_cons, threads
                ctypes.POINTER(ctypes.c_float),   # out_points
                ctypes.POINTER(ctypes.c_ubyte),   # out_colors
                ctypes.c_longlong,                # max_points
            ]
            _lib = lib
    return _lib


def fuse_depth_maps_native(
    depths: np.ndarray,     # (V, H, W) float32, 0 = filtered out
    cams: np.ndarray,       # (V, 2, 4, 4) float32
    colors: np.ndarray,     # (V, H, W, 3) uint8
    disp_thresh: float = 0.2,
    num_consistent: int = 3,
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Fuse a whole scan's depth maps -> (points (N,3), colors (N,3))."""
    lib = _load()
    depths = np.ascontiguousarray(depths, dtype=np.float32)
    cams = np.ascontiguousarray(cams, dtype=np.float32)
    colors = np.ascontiguousarray(colors, dtype=np.uint8)
    V, H, W = depths.shape
    max_points = V * H * W
    out_pts = np.empty((max_points, 3), dtype=np.float32)
    out_cols = np.empty((max_points, 3), dtype=np.uint8)
    n = lib.fuse_depth_maps(
        depths.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cams.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        colors.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        V, H, W,
        ctypes.c_float(disp_thresh), num_consistent, n_threads,
        out_pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        max_points,
    )
    return out_pts[:n].copy(), out_cols[:n].copy()
