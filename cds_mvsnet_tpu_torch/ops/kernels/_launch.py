"""Argument checks and bindings shared by the kernel wrappers.

Two launch paths. K1-K9 use ``require``, ``on_card``, ``entry``, ``ptr``
and ``stream``: Python checks, a ``torch.empty`` output and a ctypes call.
P1 and P2 (``lane_slice.py``, ``gather16.py``) use the light path: inline
checks that format a message only when they fail, ``card_index`` (one
integer a tensor for the device test), ``current_stream`` (the current
stream's raw handle, without a ``torch.cuda.Stream``), then one call of
``binding()``, the Python module compiled from ``csrc/launch.cpp``, which
allocates the output with ``at::empty`` and launches through the kernel's C
entry point, whose address it received once per process. Both launch on the
caller's current stream and raise on a failed build or launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["require", "on_card", "entry", "ptr", "stream", "P", "I", "L", "card_index", "current_stream", "binding"]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when all are on
    the CPU; raises for any other mix."""
    devices = {t.device for t in tensors}
    require(len(devices) == 1, f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    require(dev.type == "cuda", f"{name}: unsupported device {dev}")
    return True


def entry(lib_name: str, fn_name: str, argtypes) -> tuple[ctypes.CDLL, object]:
    """The C entry point ``fn_name`` of ``csrc/<lib_name>.cu``, typed."""
    lib = _build.library(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong


def card_index(name: str, a: torch.Tensor, b: torch.Tensor | None = None) -> int:
    """The CUDA device index of ``a`` (and ``b``), or -1 when they lie on the
    CPU; raises when they lie on two devices or on a device that is neither."""
    dev = a.get_device()
    if b is not None and b.get_device() != dev:
        raise ValueError(f"{name}: tensors on several devices {a.device}, {b.device}")
    if dev < 0 and not (a.is_cpu and (b is None or b.is_cpu)):
        raise ValueError(f"{name}: unsupported device {a.device}")
    return dev


def current_stream(index: int) -> int:
    """The raw handle of card ``index``'s current stream, as
    ``torch.cuda.current_stream(index).cuda_stream`` gives it."""
    return torch._C._cuda_getCurrentRawStream(index)


# the C entry points csrc/launch.cpp calls: (library, entry point)
BOUND = (("gather16", "row_gather_launch"), ("gather16", "int16_arith_launch"), ("lane_slice", "lane_slice_launch"),
         ("gather16", "cds_error_string"))
_binding = None


def binding():
    """The module of ``csrc/launch.cpp`` with the C entry points of ``BOUND``
    bound, built and loaded at the first call, once per process."""
    global _binding
    if _binding is None:
        mod = _build.extension("launch", "cds_launch")
        for lib, name in BOUND:
            mod.bind(name, ctypes.cast(_build.library(lib)[name], ctypes.c_void_p).value)
        _binding = mod
    return _binding
