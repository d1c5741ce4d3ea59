"""What the ``time_*`` tools share: build the same kernel sources from several
directories, time closures between CUDA events or by device time under
``torch.profiler``, alternate their order.

A tool compares the ``csrc`` of this checkout with that of another commit
unpacked beside it, in one process on one card, so that both see the same
clocks, power limit and host.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops.kernels import _build

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build(dirs: list, names: tuple[str, ...], out: Path) -> list[dict[str, ctypes.CDLL]]:
    """``DIR/<name>.cu`` of every directory, built with the flags of
    ``ops/kernels/_build.py`` (all ``nvcc`` runs at once), as
    ``[{name: library}]`` in the order of ``dirs``; each library keeps
    ``nvcc``'s output (ptxas ``-v``) as ``ptxas_log``. An entry of ``dirs``
    may be ``(DIR, defines)``: then ``-D`` each of ``defines`` too."""
    procs = []
    for i, entry in enumerate(dirs):
        d, defines = entry if isinstance(entry, tuple) else (entry, ())
        for name in names:
            lib = out / f"{name}{i}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{x}" for x in defines), "-I", str(d), "-o", str(lib),
                   str(d / f"{name}.cu")]
            procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), i,
                          name, lib))
    libs = [{} for _ in dirs]
    for proc, i, name, lib in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {dirs[i]}/{name}.cu:\n{log}")
        libs[i][name] = ctypes.CDLL(str(lib))
        libs[i][name].ptxas_log = log
    return libs


def ptxas_registers(log: str, kernel: str) -> dict[str, list[int]]:
    """Registers a thread and spill-store bytes of each entry function whose
    mangled name holds ``kernel``, from ptxas ``-v`` output:
    ``{mangled name: [registers, spill bytes]}``."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and kernel in name:
            out[name] = [int(m.group(1)), spill]
            name = None
    return out


def blocks_per_sm(registers: int, threads: int) -> int:
    """Resident blocks an H100 SM allows a kernel with no shared memory by its
    registers and threads: registers go to warps in units of 256 (8 a
    thread), 65,536 an SM, at most 64 warps and 32 blocks."""
    warps = -(-threads // 32)
    by_regs = 65536 // (-(-registers // 8) * 8 * 32) // warps
    return min(by_regs, 64 // warps, 32)


def device_ms(fn, reps: int) -> tuple[float, dict[str, float]]:
    """One warm-up call, then ``reps`` calls of ``fn`` under
    ``torch.profiler``: the device time of one call (every kernel and memset
    it ran) and of each kernel by name, in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {e.key: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    return sum(by_name.values()), by_name


def alternate_device(runs: dict, rounds: int, reps: int) -> dict[object, list[tuple[float, dict]]]:
    """``device_ms`` of every closure in each of ``rounds`` rounds, the order
    reversed every other round: the results of each, by round."""
    out = {k: [] for k in runs}
    for r in range(rounds):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            out[k].append(device_ms(runs[k], reps))
    return out


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
