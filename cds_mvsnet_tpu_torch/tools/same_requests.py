"""Whether the default bf16 and fp32 requests of several checkouts agree bit
for bit, on one card.

    python -m cds_mvsnet_tpu_torch.tools.same_requests ROOT [ROOT ...]

Each ``ROOT`` is the root of a checkout: this one (``.``), or another
commit's tree unpacked beside it (``git archive <commit> | tar -x -C
DIR``). For each, one child process imports that root's
``cds_mvsnet_tpu_torch``, builds its kernels and runs the serve point of
``chip_smoke.py`` (1152x864, V=5, D=192, ndepths 48/32/8, no refinement,
weights and batch from seed 0) twice in bf16 and twice in fp32, on the
default path (no routes, no ``cost_dtype``), with cuDNN held to its
deterministic algorithms (in fp32 its default choice differs between two
requests of one process), and saves stage 3's depth and confidence. Then
one JSON line per root and dtype says whether its two requests agree
(``repeatable``) and whether its maps equal the first root's
(``equals_first``), with the largest difference. The card's
``nvidia-smi`` name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ._timing import card

CHILD = """
import sys, torch
from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.models import build_model, to_tensors
from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
model = build_model(ModelConfig(refine=False, ndepths=(48, 32, 8)), seed=0, device="cuda")
b = to_tensors(textured_plane_batch(V=5, H=864, W=1152, D=192, seed=0), "cuda")
out = {}
for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
    out[name] = []
    for _ in range(2):
        s3 = model(b["imgs"], b["proj_matrices"], b["depth_values"], compute_dtype=dtype)["stage3"]
        out[name].append({k: s3[k].cpu() for k in ("depth", "photometric_confidence")})
torch.save(out, sys.argv[1])
"""


def run_root(root: Path, out: Path) -> dict:
    """The child's maps of ``root``; raises with its output if it fails."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out)], cwd=root, env=env, capture_output=True, text=True)
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("same_requests: needs the card", file=sys.stderr)
        return 2
    print(json.dumps({"card": card(), "roots": [str(r) for r in args.roots]}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        maps = [run_root(root.resolve(), Path(tmp) / f"maps{i}.pt") for i, root in enumerate(args.roots)]
    ok = True
    for root, m in zip(args.roots, maps):
        for dtype in ("bf16", "fp32"):
            first, again = m[dtype]
            row = {"root": str(root), "dtype": dtype, "repeatable": equal(first, again),
                   "equals_first": equal(first, maps[0][dtype][0]), "max_abs_diff_to_first": max_diff(first, maps[0][dtype][0])}
            ok = ok and row["repeatable"] and row["equals_first"]
            print(json.dumps(row), flush=True)
    print(json.dumps({"all_equal": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
