"""Host time of one eval forward with the port's epipoles and with an SVD of
each fundamental matrix added back, on one card.

    python -m cds_mvsnet_tpu_torch.tools.time_epipole [--rounds N] [--reps N]

The JAX package takes the epipole at infinity from an SVD of F;
``torch.linalg.svd`` of a CUDA tensor synchronises the host with the card, so
the host cannot queue the next view's forward until the card has caught up.
The port takes a cross product instead (``ops/geometry.py``). This tool runs
the bf16 forward at the DTU protocol point of ``scripts/dtu_eval.sh``
(1152x1536, V=5, D=192, ndepths 48/32/8, refinement, seeded random weights,
one ``textured_plane_batch``) both ways, the SVD added to
``epipole_from_fundamental`` as ``models/cds_mvsnet.py`` calls it. Rounds
alternate the order of the two; each time is the median over rounds of
``--reps`` forwards: ``host_ms`` until ``forward`` returns (what the next view
waits for before it can be queued) and ``total_ms`` until the card has
finished. One JSON line each, after the card's ``nvidia-smi`` name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from ..config import ModelConfig
from ..models import build_model, strict_fp32, to_tensors
from ..models import cds_mvsnet as cm
from ..utils.synthetic import textured_plane_batch

H, W, V, D = 1152, 1536, 5, 192
shipped = cm.epipole_from_fundamental


def with_svd(F, det_eps=1e-12):
    torch.linalg.svd(F)
    return shipped(F, det_eps)


def forward_ms(model, args, reps: int) -> tuple[float, float]:
    host, total = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        model(*args, temperature=0.01, compute_dtype=torch.bfloat16)
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        total.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(host), statistics.median(total)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_epipole: no CUDA device", file=sys.stderr)
        return 2
    strict_fp32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "shape": [1, V, H, W, 3], "D": D}), flush=True)
    model = build_model(ModelConfig(refine=True, ndepths=(48, 32, 8)), seed=0, device="cuda")
    b = to_tensors(textured_plane_batch(V=V, H=H, W=W, D=D, refine=True, tz_step=4.0, seed=0), "cuda")
    fargs = (b["imgs"], b["proj_matrices"], b["depth_values"])
    variants = {"shipped": shipped, "with_svd": with_svd}
    times = {tag: {"host_ms": [], "total_ms": []} for tag in variants}
    try:
        for tag, fn in variants.items():  # warm-up: cuDNN plans, the allocator
            cm.epipole_from_fundamental = fn
            forward_ms(model, fargs, 1)
        for rnd in range(args.rounds):
            for tag in list(variants)[:: 1 if rnd % 2 == 0 else -1]:
                cm.epipole_from_fundamental = variants[tag]
                host, total = forward_ms(model, fargs, args.reps)
                times[tag]["host_ms"].append(host)
                times[tag]["total_ms"].append(total)
    finally:
        cm.epipole_from_fundamental = shipped
    for tag, t in times.items():
        print(json.dumps({"epipoles": tag, "compute_dtype": "bf16", "host_ms": statistics.median(t["host_ms"]),
                          "total_ms": statistics.median(t["total_ms"]), "rounds": t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
