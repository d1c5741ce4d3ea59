"""What the tools ported from the JAX package's ``tools/`` share: the clock
they time with and the kernels' launch counts.

A tool times a call on the host clock, ending it in a barrier of the device
(``torch.cuda.synchronize``), as the JAX tools end theirs in the transfer of
one scalar; it counts the hand-written kernels' launches around the calls it
times, so that a caller can hold the path to the launches it expects.
"""

from __future__ import annotations

import statistics
import time

import torch


def barrier(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, reps: int, name: str, dev: torch.device) -> float:
    """Median seconds of ``reps`` calls of ``fn`` after one warm-up call,
    each on the host clock and ending in a barrier of the device; prints the
    JAX tools' progress line."""
    fn()
    barrier(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        barrier(dev)
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    print(f"{name:30s} {dt * 1e3:9.1f} ms", flush=True)
    return dt


def all_kernels() -> dict:
    """Every hand-written kernel's wrapper by name."""
    from ..ops import kernels as K

    return {k.__name__: k for k in (*K.KERNELS, *K.TRAIN_KERNELS, *K.FP32_KERNELS, *K.ROUTE_KERNELS,
                                    *K.PROBE_KERNELS)}


def count_launches(fn):
    """``(fn(), {wrapper name: launches})`` of the kernels that ``fn``
    launched: every count set to 0 just before the call, read just after."""
    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    out = fn()
    return out, {name: k.launches for name, k in kernels.items() if k.launches}
