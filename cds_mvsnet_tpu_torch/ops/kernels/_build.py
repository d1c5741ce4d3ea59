"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. All sources are compiled together, one ``nvcc`` process each, so
the first build costs one ``nvcc`` run of wall time. Libraries go to
``cds_mvsnet_tpu_torch/_build/<hash of sources and flags>/`` inside the
checkout; a changed source gets a new directory. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["library", "build_all", "check"]

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_info: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return PKG_DIR / "_build" / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` that is not built yet, all in parallel.

    Returns ``{"dir", "seconds", "log"}``; raises with ``nvcc``'s output if a
    source does not compile.
    """
    with _lock:
        if _info:
            return _info
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for src in _sources():
            lib = out_dir / f"lib{src.stem}.so"
            if lib.exists():
                continue
            tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[src.stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
        log = []
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            log.append(f"== {name}.cu\n{out}")
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, lib)
        text = "\n".join(log)
        (out_dir / "build.log").write_text(text)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{text}")
        _info.update(dir=str(out_dir), seconds=time.perf_counter() - t0, log=text)
        return _info


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        info = build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(Path(info["dir"]) / f"lib{name}.so"))
                _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        lib.cds_error_string.restype = ctypes.c_char_p
        msg = lib.cds_error_string(ctypes.c_int(err)).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
