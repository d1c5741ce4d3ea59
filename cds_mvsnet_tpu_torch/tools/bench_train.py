"""Train-step time on the card at the DTU training shape, fp32 against bf16.

    python -m cds_mvsnet_tpu_torch.tools.bench_train [--bs 2] [--reps 5] [--modes fp32,bf16]

Counterpart of the JAX package's ``tools/bench_train.py``, at its point
(``H, W, V, D``: 512x640 crops, V=5 views, D=192, refinement; reference
batch size 2) on ``synthetic_batch(..., seed=0)`` and seed-0 weights, with
its JSON line: per mode ``compile_s`` (the first step: here the kernels'
build at first use and cuDNN's set-up), ``step_s`` (median of ``--reps``),
``samples_per_sec`` and ``loss_finite``. Every step is a port ``TrainStep``
(forward, loss, backward, SGD, BN statistics) from the same weights and a
fresh optimizer, as the JAX tool steps from the same state, timed on the
host clock and ending in ``torch.cuda.synchronize``. ``CDS_TRAIN_REMAT``
("0"/"1") overrides ``TrainConfig.remat_features``. The JAX tool's
``--ablate`` is left out: the knobs it sets (``CDS_ABLATE``,
``CDS_TRAIN_WARP``) tune the TPU's kernels and have no counterpart here.

``main`` returns the printed line with each mode's kernel launches in its
last step, for a caller to hold to the launches it expects (in bf16 the
step runs K5, forward and backward, B·3·(V−1)·2 times each).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import time

from ._common import barrier, count_launches

H, W, V, D = 512, 640, 5, 192
BATCH = {"refine": True, "with_gt": True, "seed": 0}  # synthetic_batch's other arguments
TEMPERATURE = 0.01


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--modes", default="fp32,bf16")
    return ap


def main(argv=None, device=None) -> dict:
    """Run the tool on ``device`` (None: the card, which must be present);
    returns ``{"line": the printed JSON, "launches": {mode: counts of its
    last step}, "bs", "device"}``."""
    args = parser().parse_args(argv)

    from ..config import ModelConfig, TrainConfig
    from ..models import build_model, to_tensors
    from ..models.cds_mvsnet import resolve_device
    from ..training import TrainStep
    from ..utils.synthetic import synthetic_batch

    dev = resolve_device(device or "cuda")
    batch = to_tensors(synthetic_batch(B=args.bs, V=V, H=H, W=W, D=D, **BATCH), dev)
    model = build_model(ModelConfig(refine=True), seed=0, device=dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    res, launches = {}, {}
    for mode in args.modes.split(","):
        remat = os.environ.get("CDS_TRAIN_REMAT")  # "0"/"1" override
        train_cfg = (TrainConfig(compute_dtype=mode) if remat is None
                     else TrainConfig(compute_dtype=mode, remat_features=remat == "1"))
        step = TrainStep(model, train_cfg)

        def run():
            model.load_state_dict(start)
            step.reset_optimizer()
            barrier(dev)
            t0 = time.perf_counter()
            metrics = step(batch, TEMPERATURE)
            barrier(dev)
            return time.perf_counter() - t0, float(metrics["loss"])

        compile_s, loss = run()
        times = []
        for _ in range(args.reps):
            (dt, loss), launches[mode] = count_launches(run)
            times.append(dt)
        dt = statistics.median(times)
        res[mode] = {
            "compile_s": round(compile_s, 1),
            "step_s": round(dt, 3),
            "samples_per_sec": round(args.bs / dt, 3),
            "loss_finite": math.isfinite(loss),
        }
        print(f"{mode}: {res[mode]}", flush=True)
    print(json.dumps(res), flush=True)
    return {"line": res, "launches": launches, "bs": args.bs, "device": dev.type}


if __name__ == "__main__":
    main()
