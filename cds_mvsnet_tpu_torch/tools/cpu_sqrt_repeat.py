"""Whether the root inside
``models/dynamic_conv.py::epipolar_direction_quadratic`` gives the same
bits in every process on the CPU.

    python -m cds_mvsnet_tpu_torch.tools.cpu_sqrt_repeat [--procs 12] [--threads 2] [--root shipped|fp32|fp64]

Each of ``--procs`` fresh processes, at ``--threads`` intra-op threads (2,
as the 2-rank test's processes), builds the seeded refined cascade and
runs its fp32 train forward on one seeded ``synthetic_batch`` element at
the 2-rank test's shape (64x64, V=3, D=48), the function replaced by a
stand-in that keeps the root's input ``u*u + v*v`` and the root at the
first call: ``--root shipped`` (the default) takes it with the shipped
``dynamic_conv.epipolar_norm`` (numpy's root on the CPU), ``--root fp32``
with the CPU's fp32 ``torch.sqrt``, which the port took before, and
``--root fp64`` with its fp64 ``torch.sqrt`` rounded once to fp32; neither
of those two repeats in every process. It reports a digest of that
input, of that root and of a second root of the same input taken after the
forward, with the number of elements one ulp, and more than one ulp, from
the correctly rounded root (numpy's fp32 ``sqrt``). Prints one JSON line per
process, then one summary line: the distinct input digests and the
distinct roots with their counts.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch


def _digest(t: torch.Tensor) -> str:
    return hashlib.md5(t.contiguous().numpy().tobytes()).hexdigest()[:12]


def child(threads: int, root_of: str) -> dict:
    from ..config import ModelConfig
    from ..models import build_model, dynamic_conv, to_tensors
    from ..models.layers import StatsCollector
    from ..utils.synthetic import synthetic_batch

    torch.set_num_threads(threads)
    taken = []

    def root_fn(u, v):
        if root_of == "fp32":
            return torch.sqrt(u * u + v * v)
        if root_of == "fp64":
            return torch.sqrt((u * u + v * v).double()).float()
        return dynamic_conv.epipolar_norm(u, v)

    def take(epipole, height, width):
        u, v = dynamic_conv.epipolar_offsets(epipole, height, width)
        root = root_fn(u, v)
        if not taken:
            taken.append((u, v, root))
        return torch.stack([root], 1)

    dynamic_conv.epipolar_direction_quadratic = take
    b = to_tensors(synthetic_batch(B=2, V=3, H=64, W=64, D=48, refine=True, with_gt=True, seed=1), "cpu")
    b = {k: {s: t[:1] for s, t in v.items()} if isinstance(v, dict) else v[:1] for k, v in b.items()}
    model = build_model(ModelConfig(refine=True), seed=0, device="cpu")
    try:  # the stand-in's output does not fit the next layer: the forward stops there
        model.forward_train(b["imgs"], b["proj_matrices"], b["depth_values"], b["depth"], StatsCollector(),
                            temperature=1.0)
    except RuntimeError:
        pass
    u, v, root = taken[0]
    n2 = u * u + v * v
    exact = torch.from_numpy(np.sqrt(n2.numpy()))  # numpy's fp32 root is correctly rounded
    ulps = (root.view(torch.int32) - exact.view(torch.int32)).abs()
    return {"input": _digest(n2), "root": _digest(root), "second_root": _digest(root_fn(u, v)), "n": n2.numel(),
            "one_ulp": int((ulps == 1).sum()), "over_one_ulp": int((ulps > 1).sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=12)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--root", choices=("shipped", "fp32", "fp64"), default="shipped")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.threads, args.root)), flush=True)
        return 0
    rows = []
    for _ in range(args.procs):
        argv = [sys.executable, "-m", __spec__.name, "--child", "--threads", str(args.threads), "--root", args.root]
        out = subprocess.run(argv, capture_output=True, text=True, check=True).stdout
        rows.append(json.loads(out.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({
        "procs": len(rows), "threads": args.threads, "root_of": args.root, "inputs": sorted({r["input"] for r in rows}),
        "roots": collections.Counter(r["root"] for r in rows),
        "second_roots": collections.Counter(r["second_root"] for r in rows),
        "torch": torch.__version__, "cpu_capability": torch.backends.cpu.get_cpu_capability(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
