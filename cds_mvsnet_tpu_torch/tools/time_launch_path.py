"""Where a probe kernel's call spends its host time, step by step, and P1's
and P2's calls at their shapes, split into host and device time, on the card.

    python -m cds_mvsnet_tpu_torch.tools.time_launch_path [ROOT ...] [--reps 10000]

Part 1, this checkout, in this process: ``row_gather`` at the probe's
inputs (fp32 values, int32 indices, (64, 128)) taken apart into the steps of
the two launch paths of ``ops/kernels/_launch.py``, each step called
``--reps`` times alone and timed with ``time.perf_counter_ns`` (µs a call):

- the path K1-K9 use, as P2's wrapper took it before the light path: its
  six checks (``require`` with f-string messages, formatted whether or not
  they fail), ``on_card``, ``entry()``, three ``ptr``, ``stream(device)``
  (a ``torch.cuda.Stream``), the ctypes call with its argument conversion
  and the launch, ``_build.check``, ``torch.empty`` on the card, and the
  whole call composed of these steps;
- the light path: the inline checks, ``card_index``, ``current_stream``,
  ``binding()``, the binding's call (``at::empty``, the launch, the
  output's Python object), the same call on (0, 128) tensors (no launch, no
  bytes), and ``row_gather`` itself;
- beside them ``torch.gather``'s call on the same inputs (the values in
  their type, int64 indices), ``torch.empty_like`` with and without a
  ``dtype``, an empty ctypes call (the C entry with ``R = 0``: argument
  conversion and call, no launch) and an empty Python loop step (what every
  other number includes); then the whole calls and ``torch.gather`` again
  after one ``torch.profiler`` session (``.after_profiler``), which leaves
  every later launch of the process slower.

A launch step enqueues ``--reps`` launches back to back; the kernel takes
less time on the card than the host takes to launch it, so the queue never
fills and the step times the host.

Part 2, each ``ROOT`` (a checkout: ``.`` for this one, or another commit's
tree unpacked beside it with ``git archive <commit> | tar -x -C DIR``): one
child process imports that root's ``cds_mvsnet_tpu_torch`` and calls P1 and
P2 through their public wrappers at the probes' inputs and at the shapes
past the parent's caps (P1 on a 192 KB and a 2 MB band, P2 on (64, 16384)
fp32 and (8, 65536) bf16 sources), each beside ``torch.gather`` where one
call computes the same gather: ``ms`` (CUDA events around ``--reps`` // 10
back-to-back calls), ``host_ms`` (the host clock around the same calls'
enqueue, no sync inside), each the smaller of two rounds, ``device_ms``
(``torch.profiler``: every kernel of a call, over 20 calls; taken after
every row's times), or the error a wrapper raises. One JSON line per row, the card's
``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..ops.kernels import _build, row_gather
from ..ops.kernels._launch import I, P, binding, card_index, current_stream, entry, on_card, ptr, require, stream
from ..ops.kernels.gather16 import _FORMS, INDEX_DTYPES, VALUE_DTYPES
from ._timing import card

ROW_BYTES = 48 * 1024  # the parent's row cap, which its checks tested


def per_call_us(fn, reps: int) -> float:
    """µs a call of ``fn`` on the host clock, over ``reps`` calls after one
    warm-up; the card is idle before and drained after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return t / reps / 1e3


def old_checks(src, idx, vdt, idt) -> None:
    """The parent's six checks of ``row_gather``, as it wrote them."""
    require(src.ndim == 2 and idx.shape == src.shape, f"row_gather: src {tuple(src.shape)}, idx {tuple(idx.shape)}")
    require(src.dtype in VALUE_DTYPES and idx.dtype == torch.int32,
            f"row_gather: src {src.dtype} must be fp32 or bf16, idx {idx.dtype} int32")
    require(vdt in VALUE_DTYPES and idt in INDEX_DTYPES,
            f"row_gather: value type {vdt} (fp32, bf16), index type {idt} (int32, int16)")
    R, n = src.shape
    require(R * n > 0, "row_gather: empty input")
    row_bytes = n * (2 if vdt == torch.bfloat16 else 4)
    require(row_bytes <= ROW_BYTES, f"row_gather: a row of {row_bytes} bytes exceeds {ROW_BYTES} of shared memory")
    require(src.is_contiguous() and idx.is_contiguous(), "row_gather: inputs must be contiguous")


def light_checks(src, idx, vdt, idt) -> int:
    """``row_gather``'s checks on the light path, a message formatted only
    on failure; returns the C entry point's form."""
    if not (src.ndim == 2 and idx.shape == src.shape):
        raise ValueError(f"row_gather: src {tuple(src.shape)}, idx {tuple(idx.shape)}")
    form = _FORMS.get((src.dtype, vdt, idt))
    if form is None or idx.dtype != torch.int32:
        raise ValueError("row_gather: types")
    R, n = src.shape
    if not R * n > 0:
        raise ValueError("row_gather: empty input")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather: inputs must be contiguous")
    return form


def steps(reps: int) -> dict:
    """Part 1: µs a call of each step, both paths, on the probe's inputs."""
    from .probe_gather16 import inputs

    src_np, idx_np = inputs()
    src, idx = torch.as_tensor(src_np, device="cuda"), torch.as_tensor(idx_np, device="cuda")
    vdt, idt = torch.float32, torch.int32
    R, n = src.shape
    dev = src.device
    out = torch.empty_like(src)
    argtypes = [P, P, P, I, I, I, P]
    lib, fn = entry("gather16", "row_gather_launch", argtypes)
    old_args = (ptr(src), ptr(idx), ptr(out), 0, R, n, stream(dev))
    empty_old = (ptr(src), ptr(idx), ptr(out), 0, 0, n, stream(dev))
    index = src.get_device()
    ext, st = binding(), current_stream(index)
    none, none_idx = src[:0], idx[:0]

    def old_call():
        old_checks(src, idx, vdt, idt)
        if not on_card("row_gather", src, idx):
            raise RuntimeError("row_gather: not on the card")
        o = torch.empty((R, n), dtype=torch.float32, device=src.device)
        lib, fn = entry("gather16", "row_gather_launch", argtypes)
        err = fn(ptr(src), ptr(idx), ptr(o), 0, R, n, stream(src.device))
        _build.check(lib, err, "row_gather")
        return o

    values, idx64 = src.to(vdt), idx.long()
    runs = {
        "loop": lambda: None,
        "old.checks": lambda: old_checks(src, idx, vdt, idt),
        "old.on_card": lambda: on_card("row_gather", src, idx),
        "old.entry": lambda: entry("gather16", "row_gather_launch", argtypes),
        "old.ptr_x3": lambda: (ptr(src), ptr(idx), ptr(out)),
        "old.stream": lambda: stream(dev),
        "old.ctypes_call_and_launch": lambda: fn(*old_args),
        "old.build_check": lambda: _build.check(lib, 0, "row_gather"),
        "old.torch_empty": lambda: torch.empty((R, n), dtype=torch.float32, device=dev),
        "old.empty_ctypes_call": lambda: fn(*empty_old),
        "old.whole_call": old_call,
        "light.checks": lambda: light_checks(src, idx, vdt, idt),
        "light.card_index": lambda: card_index("row_gather", src, idx),
        "light.current_stream": lambda: current_stream(index),
        "light.binding": binding,
        "light.binding_call_and_launch": lambda: ext.row_gather(src, idx, 0, st),
        "light.binding_call_no_launch": lambda: ext.row_gather(none, none_idx, 0, st),
        "light.whole_call": lambda: row_gather(src, idx, vdt, idt),
        "alloc.empty_like": lambda: torch.empty_like(src),
        "alloc.empty_like_dtype": lambda: torch.empty_like(src, dtype=torch.float32),
        "torch.gather": lambda: torch.gather(values, 1, idx64),
    }
    # each step twice, the order reversed the second time; the smaller
    first = {k: per_call_us(f, reps) for k, f in runs.items()}
    second = {k: per_call_us(runs[k], reps) for k in reversed(runs)}
    out = {k: min(first[k], second[k]) for k in runs}
    # the same calls after one torch.profiler session in this process
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        row_gather(src, idx, vdt, idt)
        torch.cuda.synchronize()
    for k in ("light.whole_call", "torch.gather", "old.whole_call"):
        out[f"{k}.after_profiler"] = per_call_us(runs[k], reps)
    return out


CHILD = r"""
import json, sys, time
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from cds_mvsnet_tpu_torch.ops import kernels as K
reps = int(sys.argv[1])


def device_ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    t = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return t / 1e3 / n if t > 0 else None


rows = []


def measure(name, shape, f, args, plain=None):  # f(*args) timed, held to plain(*args) where given
    fn = lambda: f(*args)  # noqa: E731
    row = {"name": name, "shape": list(shape)}
    rows.append((row, fn))
    try:
        got = fn()
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - a wrapper that refuses the shape is a result
        row["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
        return
    if plain is not None:
        row["bit_for_bit"] = bool(torch.equal(got.view(torch.int32), plain(*args).view(torch.int32)))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ms, host = [], []
    for _ in range(2):  # two rounds; the smaller of each
        fn()
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / reps)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / reps)
    row.update(ms=min(ms), host_ms=min(host))


rng = np.random.default_rng(0)
for nseg in (4, 48, 512):
    if nseg == 4:
        x = torch.arange(8 * 128 * nseg, dtype=torch.float32, device="cuda").reshape(8, -1)
        offs = torch.arange(nseg, dtype=torch.int32, device="cuda") * 128
    else:
        x = torch.as_tensor(rng.standard_normal((8, 128 * nseg)).astype(np.float32), device="cuda")
        offs = torch.as_tensor(rng.integers(0, 128 * nseg, nseg).astype(np.int32), device="cuda")
    measure(f"lane_slice_sum.nseg{nseg}", x.shape, K.lane_slice_sum, (x, offs), K.lane_slice_sum_plain)
FORMS = {"ctrl_fp32_i32": (torch.float32, torch.int32), "g16_bf16_i16": (torch.bfloat16, torch.int16),
         "bf16_i32": (torch.bfloat16, torch.int32)}
for (R, n), sdt in (((64, 128), torch.float32), ((64, 16384), torch.float32), ((8, 65536), torch.bfloat16)):
    g = np.random.default_rng(0)
    src = torch.as_tensor(g.standard_normal((R, n)).astype(np.float32), device="cuda").to(sdt)
    idx = torch.as_tensor(g.integers(0, n, (R, n)).astype(np.int32), device="cuda")
    idx64 = idx.long()
    for form, (v, i) in FORMS.items():
        measure(f"row_gather.{form}", (R, n), K.row_gather, (src, idx, v, i), K.row_gather_plain)
        measure(f"torch.gather.{form}", (R, n), torch.gather, (src.to(v), 1, idx64))
    if n == 128:
        measure("int16_arith", (R, n), K.int16_arith, (src,), K.int16_arith_plain)
# device times last: a profiler session leaves the launches after it slower
for row, fn in rows:
    if "error" not in row:
        row["device_ms"] = device_ms(fn)
    print(json.dumps(row), flush=True)
"""


def calls(root: Path, reps: int) -> list[dict]:
    """Part 2 for one root, in a child process that imports its package."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    proc = subprocess.run([sys.executable, "-c", CHILD, str(reps)], cwd=root, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: the child failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="P1's and P2's launch path and calls on the card")
    ap.add_argument("roots", nargs="*", type=Path, help="checkouts whose P1 and P2 calls to time (default: none)")
    ap.add_argument("--reps", type=int, default=10_000, help="calls of each step (part 1); a tenth in part 2")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the launch path is timed on the card")
    print(card(), flush=True)
    print(json.dumps({"part": "steps", "unit": "us a call", "reps": args.reps, **steps(args.reps)}), flush=True)
    for root in args.roots:
        for row in calls(root.resolve(), max(args.reps // 10, 1)):
            print(json.dumps({"part": "calls", "root": str(root), **row}), flush=True)


if __name__ == "__main__":
    main()
