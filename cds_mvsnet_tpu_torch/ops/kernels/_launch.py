"""Argument checks and ctypes binding shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["require", "on_card", "entry", "ptr", "stream", "P", "I", "L"]


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
