"""Tiny cells for the CPU tests: the real cell's configuration and traffic
at a size the CPU runs in seconds."""

from __future__ import annotations

import copy
import json

from mvsbench.harness import BENCH_DIR, load_cell


def tiny_cell(name: str, mix: str | None = None, **traffic):
    """The cell ``name`` at a tiny size; ``mix`` runs it under the traffic
    ``mvsbench/traffic/<mix>.json`` in place of its own."""
    cell = load_cell(name)
    if mix is not None:
        cell.traffic = json.loads((BENCH_DIR / "traffic" / f"{mix}.json").read_text())
    c = copy.deepcopy(cell.config)
    c.update(height=128, width=192, views=3, numdepth=48, interval=10.6)
    c["model"]["ndepths"] = [16, 8, 8]
    if "batch_size" in c:
        c["batch_size"] = 2
    cell.config = c
    if cell.traffic["driver"] == "eval":
        small = {"batch": min(2, cell.traffic["batch"]), "pool": 4, "sample": 2, "check_batches": 2, "trace_batches": 1}
    else:
        small = {"pool": 3, "trace_steps": 1}
    cell.traffic = {**cell.traffic, **small, **traffic}
    return cell
