"""Whether the default bf16 and fp32 requests of several checkouts agree bit
for bit, on one card.

    python -m cds_mvsnet_tpu_torch.tools.same_requests ROOT [ROOT ...] [--cudnn-deterministic]

Each ``ROOT`` is the root of a checkout: this one (``.``), or another
commit's tree unpacked beside it (``git archive <commit> | tar -x -C
DIR``). For each, one child process imports that root's
``cds_mvsnet_tpu_torch``, builds its kernels and runs the serve point of
``chip_smoke.py`` (1152x864, V=5, D=192, ndepths 48/32/8, no refinement,
weights and batch from seed 0) twice in bf16 and twice in fp32, on the
default path (no routes, no ``cost_dtype``), as a user gets it, and saves
stage 3's depth and confidence. The port holds cuDNN to its deterministic
algorithms itself (``models.cds_mvsnet.strict_fp32``; in fp32 cuDNN's
default choice differs between two requests of one process);
``--cudnn-deterministic`` sets that flag in every child, for checkouts whose
port does not. Then one JSON line per root and dtype says whether its two
requests agree (``repeatable``) and whether its maps equal the first root's
(``equals_first``), with the largest difference, and the latency of five
more requests (host clock, each ending in a sync; the cost of cuDNN's
deterministic algorithms shows between a checkout that sets them and one
that does not). The card's ``nvidia-smi`` name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ._timing import card

CHILD = """
import sys, time, torch
from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.models import build_model, to_tensors
from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch
if sys.argv[2] == "1":
    torch.backends.cudnn.deterministic = True
model = build_model(ModelConfig(refine=False, ndepths=(48, 32, 8)), seed=0, device="cuda")
b = to_tensors(textured_plane_batch(V=5, H=864, W=1152, D=192, seed=0), "cuda")
out = {}
for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
    out[name] = []
    for _ in range(2):
        s3 = model(b["imgs"], b["proj_matrices"], b["depth_values"], compute_dtype=dtype)["stage3"]
        out[name].append({k: s3[k].cpu() for k in ("depth", "photometric_confidence")})
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        model(b["imgs"], b["proj_matrices"], b["depth_values"], compute_dtype=dtype)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out[name + "_ms"] = ms
torch.save(out, sys.argv[1])
"""


def run_root(root: Path, out: Path, cudnn_deterministic: bool) -> dict:
    """The child's maps of ``root``; raises with its output if it fails."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out), str(int(cudnn_deterministic))], cwd=root, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: the child failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return torch.load(out)


def max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--cudnn-deterministic", action="store_true",
                    help="set torch.backends.cudnn.deterministic in every child")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("same_requests: needs the card", file=sys.stderr)
        return 2
    print(json.dumps({"card": card(), "roots": [str(r) for r in args.roots],
                      "cudnn_deterministic_by_the_tool": args.cudnn_deterministic}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        maps = [run_root(root.resolve(), Path(tmp) / f"maps{i}.pt", args.cudnn_deterministic)
                for i, root in enumerate(args.roots)]
    ok = True
    for root, m in zip(args.roots, maps):
        for dtype in ("bf16", "fp32"):
            first, again = m[dtype]
            row = {"root": str(root), "dtype": dtype, "repeatable": equal(first, again),
                   "equals_first": equal(first, maps[0][dtype][0]), "max_abs_diff_to_first": max_diff(first, maps[0][dtype][0]),
                   "latency_ms": m[dtype + "_ms"], "latency_ms_median": statistics.median(m[dtype + "_ms"])}
            ok = ok and row["repeatable"] and row["equals_first"]
            print(json.dumps(row), flush=True)
    print(json.dumps({"all_equal": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
