"""Whether the train steps of several checkouts repeat bit for bit, on one
card, and which path varies.

    python -m cds_mvsnet_tpu_torch.tools.same_steps ROOT [ROOT ...] [--cudnn-deterministic]

Each ``ROOT`` is the root of a checkout, as for ``tools/same_requests.py``.
For each, one child process imports that root's ``cds_mvsnet_tpu_torch``
and, at the train point of ``chip_smoke.py`` (512x640, B=2, V=5, D=192,
ndepths 48/32/8, refinement, FeatureNet recomputed in the backward,
temperature 0.01, weights and batch from seed 0), takes two steps from the
same weights (a fresh optimizer each) on each of three paths: the plain
bf16 path (``kernels=False``), the kernel path in bf16 (K5) and the fp32
step (the plain warp). A step is forward, backward and the SGD update with
the BN statistics. Then one JSON line per root and path says whether the
two steps agree in the loss, in every gradient and in the updated state
(``repeatable``), how far the gradients lie apart (relative L2 over all
trainable leaves) and how many leaves differ, and whether the first step
equals the first root's. ``--cudnn-deterministic`` sets
``torch.backends.cudnn.deterministic`` in every child, for checkouts whose
port does not set it itself (``models.cds_mvsnet.strict_fp32`` does from
this one on). The card's ``nvidia-smi`` name and power limit come first.
``--device cpu --size HxW`` runs the children on the CPU at a small size.
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

CHILD = """
import sys, torch
from cds_mvsnet_tpu_torch.config import ModelConfig, TrainConfig
from cds_mvsnet_tpu_torch.models import build_model, to_tensors
from cds_mvsnet_tpu_torch.training import TrainStep
from cds_mvsnet_tpu_torch.utils.synthetic import synthetic_batch
path, deterministic, dev, H, W = sys.argv[1], sys.argv[2] == "1", sys.argv[3], int(sys.argv[4]), int(sys.argv[5])
if deterministic:
    torch.backends.cudnn.deterministic = True
model = build_model(ModelConfig(refine=True, ndepths=(48, 32, 8)), seed=0, device=dev)
batch = to_tensors(synthetic_batch(B=2, V=5, H=H, W=W, D=192, refine=True, with_gt=True, seed=0), dev)
start = {k: v.clone() for k, v in model.state_dict().items()}
out = {}
for tag, dtype, kernels in PATHS:
    out[tag] = []
    for _ in range(2):
        model.load_state_dict(start)
        step = TrainStep(model, TrainConfig(compute_dtype=dtype, remat_features=True), kernels=kernels)
        loss = step(batch, 0.01)["loss"]
        out[tag].append({"loss": loss.detach().cpu(), "grads": [p.grad.detach().cpu() for p in step.params],
                         "state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}})
torch.save(out, path)
"""
PATHS = (("plain_bf16", "bf16", False), ("kernel_bf16", "bf16", True), ("fp32", "fp32", True))


def run_root(root: Path, out: Path, deterministic: bool, device: str, size: tuple[int, int]) -> dict:
    """The child's two steps a path of ``root``; raises with its output if it fails."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    code = f"PATHS = {PATHS!r}\n{CHILD}"
    proc = subprocess.run([sys.executable, "-c", code, str(out), str(int(deterministic)), device, *map(str, size)],
                          cwd=root, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: the child failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return torch.load(out)


def same(a: dict, b: dict) -> dict:
    """Bit-for-bit agreement of two steps, and the gradients' distance."""
    num = sum(float((x.double() - y.double()).square().sum()) for x, y in zip(a["grads"], b["grads"]))
    den = sum(float(y.double().square().sum()) for y in b["grads"])
    return {"loss": torch.equal(a["loss"], b["loss"]),
            "grads": all(torch.equal(x, y) for x, y in zip(a["grads"], b["grads"])),
            "update": all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"]),
            "grads_unequal": sum(not torch.equal(x, y) for x, y in zip(a["grads"], b["grads"])),
            "grad_rel_l2": (num / max(den, 1e-300)) ** 0.5}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--cudnn-deterministic", action="store_true",
                    help="set torch.backends.cudnn.deterministic in every child")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--size", default="512x640", help="HxW of the batch")
    args = ap.parse_args(argv)
    size = tuple(int(x) for x in args.size.split("x"))
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("same_steps: needs the card (or --device cpu)", file=sys.stderr)
            return 2
        from ._timing import card

        where = card()
    else:
        where = "cpu"
    print(json.dumps({"card": where, "roots": [str(r) for r in args.roots], "size": list(size),
                      "cudnn_deterministic_by_the_tool": args.cudnn_deterministic}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        steps = [run_root(root.resolve(), Path(tmp) / f"steps{i}.pt", args.cudnn_deterministic, args.device, size)
                 for i, root in enumerate(args.roots)]
    ok = True
    for root, s in zip(args.roots, steps):
        for tag, *_ in PATHS:
            first, again = s[tag]
            rep = same(first, again)
            to_first = same(first, steps[0][tag][0])
            row = {"root": str(root), "path": tag, "repeatable": rep["loss"] and rep["grads"] and rep["update"],
                   **{f"two_steps_same_{k}": v for k, v in rep.items() if k in ("loss", "grads", "update")},
                   "two_steps_grads_unequal": rep["grads_unequal"], "two_steps_grad_rel_l2": rep["grad_rel_l2"],
                   "leaves": len(first["grads"]), "loss": float(first["loss"]),
                   "equals_first": to_first["loss"] and to_first["grads"] and to_first["update"],
                   "grad_rel_l2_to_first": to_first["grad_rel_l2"]}
            ok = ok and row["repeatable"]
            print(json.dumps(row), flush=True)
    print(json.dumps({"all_repeatable": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
