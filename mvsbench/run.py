"""Run one cell once.

    python3 -m mvsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With ``--trace 0`` the last line of standard
output holds the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, read from a short traced sub-window by the readers in
``mvsbench/metrics/``. Each run checks what its timed path produced against
the plain reference (``mvsbench/reference/``) and prints each number
compared beside its limit, as the last lines of standard error and under
``check`` in the result line. It exits without a result when the cell's
cards are not there, and when the process has loaded JAX or the JAX
package.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys

from mvsbench.harness import BENCH_DIR, cache_env, forbidden_modules, load_cell, require_cards, result_line

__all__ = ["main"]


def load_metric(name: str):
    """The reader ``mvsbench/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"mvsbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    return importlib.import_module(f"mvsbench.drivers.{name}")


def _breakdown(summary) -> dict:
    ops = sorted(summary.kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[name, s] for name, (s, _) in ops], "idle_gaps": summary.gaps[:10]}


def main(argv=None, device: str | None = None, cell=None) -> int:
    """Run a cell and print its result; ``device`` (tests) skips the look
    for cards and runs there; ``cell`` (tests) stands in for the one
    ``BENCHMARK.json`` names."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env()
    cell = cell or load_cell(args.workload)
    if device is None:
        require_cards(cell.chips)
        device = "cuda"
    import torch

    driver = load_driver(cell.traffic["driver"])
    res = driver.run(cell, args.seed, args.seconds, bool(args.trace), device=device)

    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(res["memory_peak_bytes"])}
    print(json.dumps({"memory_peak_bytes": info["memory_peak_bytes"], "launch_counts": res["extra"].pop("launch_counts"),
                      **res["extra"]}), flush=True)
    breakdown = None
    if args.trace:
        s = res["summary"]
        metrics = {}
        if s is not None:
            info["busy_s"], info["window_s"] = s.busy_s, s.window_s
            for m in cell.per_layer:
                value = load_metric(m["name"]).read(s, cell.config)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            breakdown = _breakdown(s)
    else:
        metrics = {m["name"]: res["metrics"][m["name"]] for m in cell.end_to_end}

    found = forbidden_modules()
    if found:
        print(f"mvsbench: the process has loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for name, c in res["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(result_line(res["correct"], res["attempted"], res["failed"], metrics, info, res["check"], breakdown),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
