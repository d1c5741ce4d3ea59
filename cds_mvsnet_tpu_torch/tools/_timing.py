"""What the ``time_*`` tools share: build the same kernel sources from several
directories, time closures between CUDA events, alternate their order.

A tool compares the ``csrc`` of this checkout with that of another commit
unpacked beside it, in one process on one card, so that both see the same
clocks, power limit and host.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops.kernels import _build

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build(dirs: list[Path], names: tuple[str, ...], out: Path) -> list[dict[str, ctypes.CDLL]]:
    """``DIR/<name>.cu`` of every directory, built with the flags of
    ``ops/kernels/_build.py`` (all ``nvcc`` runs at once), as
    ``[{name: library}]`` in the order of ``dirs``."""
    procs = []
    for i, d in enumerate(dirs):
        for name in names:
            lib = out / f"{name}{i}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(lib), str(d / f"{name}.cu")]
            procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), i,
                          name, lib))
    libs = [{} for _ in dirs]
    for proc, i, name, lib in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {dirs[i]}/{name}.cu:\n{log}")
        libs[i][name] = ctypes.CDLL(str(lib))
    return libs


def typed(lib: ctypes.CDLL, entry: str, argtypes) -> object:
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def stream_ptr() -> P:
    return P(torch.cuda.current_stream().cuda_stream)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def mean_ms(fn, reps: int) -> float:
    """One warm-up call, then the mean of ``reps`` calls between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alternate(runs: dict, rounds: int, reps: int) -> dict[object, list[float]]:
    """``mean_ms`` of every closure in each of ``rounds`` rounds, the order
    reversed every other round (A B, B A, ...): the times of each, by round."""
    times = {k: [] for k in runs}
    for r in range(rounds):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            times[k].append(mean_ms(runs[k], reps))
    return times


def medians(runs: dict, rounds: int, reps: int) -> dict[object, float]:
    """``alternate``'s median over rounds, for each closure."""
    return {k: statistics.median(v) for k, v in alternate(runs, rounds, reps).items()}
