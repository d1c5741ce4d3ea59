"""Build and load the hand-written CUDA kernels and their binding.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. ``csrc/launch.cpp``, the light launch path's Python module
(``_launch.binding``), is compiled by the host's C++ compiler against
torch's headers (``torch.utils.cpp_extension.include_paths()`` and
``library_paths()``; no CUDA header). All sources are compiled together, one
process each, so the first build costs the slowest one's wall time.
Libraries go to ``cds_mvsnet_tpu_torch/_build/<hash of sources, flags and
torch version>/`` inside the checkout; a changed source gets a new
directory. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["library", "extension", "build_all", "check"]

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

CXX_FLAGS = ("-O2", "-std=c++20", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_modules: dict[str, object] = {}
_info: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cpp"))


def _cxx_command(src: Path, out: Path) -> list[str]:
    """The C++ compiler's command for a module against torch's headers."""
    import sysconfig

    import torch
    from torch.utils import cpp_extension

    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found for the launch path's binding")
    includes = [sysconfig.get_paths()["include"], *cpp_extension.include_paths()]
    libs = cpp_extension.library_paths()
    return [cxx, *CXX_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
            *(f"-I{d}" for d in includes), "-o", str(out), str(src), *(f"-L{d}" for d in libs),
            *(f"-Wl,-rpath,{d}" for d in libs), "-lc10", "-ltorch_cpu", "-ltorch_python"]


def _build_dir() -> Path:
    import torch

    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *CXX_FLAGS, torch.__version__)).encode())
    for src in sorted(CSRC.glob("*.c*")):
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
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)] if src.suffix == ".cu" else _cxx_command(src, tmp)
            procs[src.name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
        log = []
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            log.append(f"== {name}\n{out}")
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


def extension(name: str, module: str):
    """The Python module ``module`` built from ``csrc/<name>.cpp`` (built on
    first use)."""
    mod = _modules.get(name)
    if mod is None:
        info = build_all()
        with _lock:
            mod = _modules.get(name)
            if mod is None:
                loader = importlib.machinery.ExtensionFileLoader(module, str(Path(info["dir"]) / f"lib{name}.so"))
                mod = importlib.util.module_from_spec(importlib.util.spec_from_loader(module, loader))
                loader.exec_module(mod)
                _modules[name] = mod
    return mod


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        lib.cds_error_string.restype = ctypes.c_char_p
        msg = lib.cds_error_string(ctypes.c_int(err)).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
