"""Binary PLY point-cloud writer and reader.

Own copy of ``cds_mvsnet_tpu/io/ply.py``: the same header and vertex
records (float32 x/y/z, uint8 red/green/blue, binary little-endian).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["write_ply", "read_ply"]

_VERTEX_DTYPE = np.dtype(
    [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"), ("blue", "u1")]
)


def write_ply(path, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Write ``(N, 3)`` float points (+ optional ``(N, 3)`` uint8 colors)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = len(points)
    if colors is None:
        colors = np.zeros((n, 3), dtype=np.uint8)
    rec = np.empty(n, dtype=_VERTEX_DTYPE)
    pts = np.asarray(points, dtype=np.float32)
    cols = np.asarray(colors, dtype=np.uint8)
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    rec["red"], rec["green"], rec["blue"] = cols[:, 0], cols[:, 1], cols[:, 2]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def read_ply(path) -> tuple[np.ndarray, np.ndarray]:
    """Read a PLY written by :func:`write_ply` (or any binary-LE/ascii PLY
    whose vertex element leads with float x/y/z). Returns (points, colors)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().strip().decode("ascii")
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append((parts[2], parts[1]))
        typemap = {
            "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
            "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4",
            "ushort": "<u2", "uint16": "<u2", "short": "<i2", "int16": "<i2",
        }
        if fmt == "binary_little_endian":
            dtype = np.dtype([(name, typemap[t]) for name, t in props])
            rec = np.fromfile(f, dtype=dtype, count=n)
        elif fmt == "ascii":
            data = np.loadtxt(f, max_rows=n)
            rec = {name: data[:, i] for i, (name, _) in enumerate(props)}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    pts = np.stack([np.asarray(rec["x"]), np.asarray(rec["y"]), np.asarray(rec["z"])], -1).astype(
        np.float32
    )
    names = [p[0] for p in props]
    if "red" in names:
        cols = np.stack(
            [np.asarray(rec["red"]), np.asarray(rec["green"]), np.asarray(rec["blue"])], -1
        ).astype(np.uint8)
    else:
        cols = np.zeros((len(pts), 3), dtype=np.uint8)
    return pts, cols
