"""What every cell shares: finding the cell, the cards, the program, the
weights, the result line and the look at what the process has imported.

The harness is driven by data: ``BENCHMARK.json`` names a cell's
configuration and traffic; ``mvsbench/configs/<config>.json`` holds the
configuration, ``mvsbench/traffic/<traffic>.json`` the traffic's
parameters and the driver (``mvsbench/drivers/<driver>.py``) that reads
them, ``mvsbench/limits/<cell>.json`` the limits of its correctness check,
and ``mvsbench/metrics/<metric>.py`` each per-layer metric.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["BENCH_DIR", "Cell", "Clock", "FORBIDDEN", "cache_env", "forbidden_modules", "load_cell", "p95",
           "require_cards", "result_line"]

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cds_mvsnet_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    per_layer: list  # the BENCHMARK.json entries of the per-layer metrics this cell reports
    end_to_end: list


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, root: Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` at the checkout's root, with
    its configuration, traffic, limits and metrics."""
    root = BENCH_DIR.parent if root is None else root
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(root / configs[w["config"]]["file"])
    traffic = _read(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH_DIR / "limits" / f"{name}.json"
    limits = _read(limits_path) if limits_path.exists() else {}
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return Cell(name, int(w["chips"]), config, traffic, limits, per_layer, e2e)


def cache_env(root: Path | None = None) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths: the
    port builds into ``cds_mvsnet_tpu_torch/_build/`` by itself; these are
    for PyTorch's extension loader and Triton, should anything use them."""
    root = BENCH_DIR.parent if root is None else root
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "mvsbench" / ".cache" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "mvsbench" / ".cache" / "triton"))


def require_cards(chips: int) -> None:
    """Exit without a result unless ``chips`` CUDA devices are visible."""
    import torch

    if not torch.cuda.is_available():
        print("mvsbench: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        raise SystemExit(3)
    if torch.cuda.device_count() < chips:
        print(f"mvsbench: the cell needs {chips} CUDA devices, {torch.cuda.device_count()} are visible",
              file=sys.stderr)
        raise SystemExit(3)


def forbidden_modules(names=FORBIDDEN) -> list:
    """The top-level names among ``names`` that ``sys.modules`` holds,
    compared whole: ``cds_mvsnet_tpu_torch`` is not ``cds_mvsnet_tpu``."""
    loaded = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(n for n in names if n in loaded)


def p95(values) -> float:
    """The 95th percentile by nearest rank."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict, check: dict,
                breakdown: dict | None = None) -> str:
    """The last line of standard output; ``check`` (each compared number
    with its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = check
    return json.dumps(out)


def _process_start() -> float:
    """When this process began, on the ``perf_counter`` clock (Linux's
    ``/proc``, to a clock tick); the import of this module where that
    cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))


class Clock:
    """Seconds since the process started."""

    T0 = _process_start()

    @classmethod
    def since_start(cls) -> float:
        return time.perf_counter() - cls.T0
