"""Tanks and Temples on one card: the no-refinement cascade at every
resolution bucket of ``scripts/tt_eval.sh``.

    python -m cds_mvsnet_tpu_torch.tools.tt_feasibility [--buckets 1088x1920,896x1600,544x960] [--reps 3]

Counterpart of the JAX package's ``tools/tt_feasibility.py``, which showed
that the stage-1 volume at 1088x1920 fits one TPU chip, with the warp
chunked over depth for the TPU's memory. The H100 holds 80 GB, so the port
runs every bucket whole, with no depth chunking, and reports the peak.

Per bucket (``HxW``; the three of the script's per-scene table by default,
others only by argument): ``textured_plane_batch(V=10, H, W, D=256,
refine=False)``, the bf16 cascade with no refinement at temperature 0.01
(``tt_eval.sh``: ``--num_view 10 --numdepth 256 --no_refinement``; ndepths
48/32/8), on weights from seed 0 (the JAX tool loads the upstream checkpoint
where one is on disk; this repository has none). One JSON line a bucket with
what the JAX tool reports, ``first_call_s`` (the JAX tool's compile and
first call: here the kernels' build at first use and cuDNN's set-up),
``sec_per_map`` (median of ``--reps`` requests, each ending in a sync),
``maps_per_sec`` and ``finite``, and besides: ``peak_mem_bytes`` of a
request (``torch.cuda.max_memory_allocated``; null on the CPU), the
``launches`` of each kernel in one request (K1 27, K2 3, K3 3, K4 1 on the
card), and the serve gate of ``chip_smoke.py`` against the plain bf16 path
on the same weights and batch (stage 3: depth median <= 0.01 and p99 <= 0.25
of the plane interval, confidence median <= 1e-3 and p99 <= 0.05). The
card's ``nvidia-smi`` name and power limit come first, the exit code is 1
where a bucket fails. ``--device cpu`` runs the same at a tiny bucket on
the kernels' plain versions (no times of the card).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from ._common import all_kernels

# the buckets of scripts/tt_eval.sh's per-scene table (RES_H x RES_W)
BUCKETS = ("1088x1920", "896x1600", "544x960")
V, D = 10, 256  # tt_eval.sh: --num_view 10 --numdepth 256
NDEPTHS = (48, 32, 8)
TEMPERATURE = 0.01
GATE = {"depth_median_max_intervals": 0.01, "depth_p99_max_intervals": 0.25, "conf_median_max": 1e-3,
        "conf_p99_max": 0.05}


def parse_bucket(name: str) -> tuple[int, int]:
    h, w = (int(x) for x in name.split("x"))
    if h % 32 or w % 32:
        raise SystemExit(f"bucket {name}: H and W must be multiples of 32 (the FeatureNet and UNet strides)")
    return h, w


def quantiles(diff: torch.Tensor) -> tuple[float, float]:
    d = diff.flatten()[:: max(1, diff.numel() // 1_000_000)].float()
    q = torch.quantile(d, torch.tensor([0.5, 0.99], device=d.device))
    return float(q[0]), float(q[1])


def run_bucket(model, name: str, reps: int, dev: torch.device) -> dict:
    from ..models import to_tensors
    from ..utils.synthetic import textured_plane_batch

    H, W = parse_bucket(name)
    b = to_tensors(textured_plane_batch(V=V, H=H, W=W, D=D, refine=False), dev)
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    cuda = dev.type == "cuda"

    def request(**kw):
        out = model(*args, temperature=TEMPERATURE, compute_dtype=torch.bfloat16, **kw)
        if cuda:
            torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    request()
    first = time.perf_counter() - t0
    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = request()
    launches = {n: k.launches for n, k in kernels.items() if k.launches}
    peak = torch.cuda.max_memory_allocated() if cuda else None
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        request()
        secs.append(time.perf_counter() - t0)
    s3 = out["stage3"]
    finite = all(bool(torch.isfinite(s3[k]).all()) for k in ("depth", "photometric_confidence"))
    plain = request(kernels=False)["stage3"]
    interval = float(b["depth_values"][0, 1] - b["depth_values"][0, 0])  # stage 3 sweeps at ratio 1
    cmp = {}
    for key in ("depth", "photometric_confidence"):
        cmp[f"{key}_median"], cmp[f"{key}_p99"] = quantiles((s3[key] - plain[key]).abs())
    gate_ok = (cmp["depth_median"] <= GATE["depth_median_max_intervals"] * interval
               and cmp["depth_p99"] <= GATE["depth_p99_max_intervals"] * interval
               and cmp["photometric_confidence_median"] <= GATE["conf_median_max"]
               and cmp["photometric_confidence_p99"] <= GATE["conf_p99_max"])
    dt = statistics.median(secs)
    return {"bucket": name, "shape": [1, V, H, W, 3], "D": D, "ndepths": list(NDEPTHS), "device": dev.type,
            "first_call_s": first, "sec_per_map": dt, "sec_per_map_reps": secs, "maps_per_sec": 1.0 / dt,
            "finite": finite, "peak_mem_bytes": peak, "launches": launches, "depth_interval": interval,
            "vs_plain_bf16": cmp, "serve_gate_ok": gate_ok, "ok": finite and gate_ok}


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--buckets", default=",".join(BUCKETS), help="comma list of HxW")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=device, choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from ..config import ModelConfig
    from ..models import build_model
    from ..models.cds_mvsnet import resolve_device

    dev = resolve_device(args.device)
    names = [n for n in args.buckets.split(",") if n]
    for n in names:
        parse_bucket(n)
    if dev.type == "cuda":
        from ._timing import card

        print(json.dumps({"card": card()}), flush=True)
    model = build_model(ModelConfig(refine=False, ndepths=NDEPTHS), seed=0, device=dev)
    ok = True
    for name in names:
        row = run_bucket(model, name, args.reps, dev)
        ok &= row["ok"]
        print(json.dumps(row), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
