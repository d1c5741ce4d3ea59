"""Multi-step training evidence: a loss curve through the full Trainer.

    python -m cds_mvsnet_tpu_torch.tools.train_convergence

Counterpart of the JAX package's ``tools/train_convergence.py``: about 50
``Trainer`` steps from scratch on the closed-form sphere scene
(``sphere_scene``: multi-view-consistent photometric evidence and exact
ground truth), exercising the epoch machinery together (BN statistics,
StepLR, temperature annealing, validation, monitor and early stop), and one
JSON line with the per-epoch means under the JAX tool's keys.

Environment, as the JAX tool's: ``CONV_EPOCHS`` (default 10),
``CONV_STEPS_PER_EPOCH`` (5), ``CONV_LR`` (0.01), ``CONV_SIZE``, ``CONV_D``
(48), and ``CONV_PLATFORM=cpu`` for the CPU; without it the run is on the
card, as every entry point of the port (the JAX tool defaults to the CPU).
``CONV_SIZE`` defaults to 64x64 where the JAX tool's 64x80 fails: with
refinement stage 1 works at 8x10, and the cost-regularisation UNet's skip
sums need stage-1 sides divisible by 8, so H and W must be multiples of 64
(the JAX package's own ``tests/test_convergence.py`` says so and runs
64x64). ``main`` returns the printed line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

DEFAULTS = {"CONV_EPOCHS": "10", "CONV_STEPS_PER_EPOCH": "5", "CONV_SIZE": "64x64", "CONV_D": "48",
            "CONV_LR": "0.01"}
VIEWS = 5  # the sphere scene's; each batch a reference and its next two views


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter([dict(b) for b in self.batches])


def config(epochs: int, lr: float):
    """The run's configuration: the JAX tool's, with the weights from seed 0
    (the JAX tool initialises from ``PRNGKey(0)``)."""
    from ..config import Config, ModelConfig, TrainConfig

    return Config(
        model=ModelConfig(refine=True),
        train=TrainConfig(epochs=epochs, lr=lr, eval_freq=2, save_period=max(epochs, 1), logging_every=1000,
                          monitor="min val_loss", early_stop=epochs, seed=0),
    )


def main(argv=None, device=None) -> dict:
    """Run the tool on ``device`` (None: the CPU under ``CONV_PLATFORM=cpu``,
    else the card, which must be present); returns the printed line."""
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)

    from ..models.cds_mvsnet import resolve_device
    from ..training import Trainer
    from ..utils.synthetic import sphere_scene, sphere_train_batch

    env = {k: os.environ.get(k, v) for k, v in DEFAULTS.items()}
    if device is None:
        device = "cpu" if os.environ.get("CONV_PLATFORM") == "cpu" else "cuda"
    dev = resolve_device(device)
    epochs = int(env["CONV_EPOCHS"])
    spe = int(env["CONV_STEPS_PER_EPOCH"])
    H, W = map(int, env["CONV_SIZE"].split("x"))
    D = int(env["CONV_D"])
    lr = float(env["CONV_LR"])

    scene = sphere_scene(V=VIEWS, H=H, W=W)
    batches = [sphere_train_batch(scene, r % VIEWS, [(r + 1) % VIEWS, (r + 2) % VIEWS], D=D, refine=True)
               for r in range(spe)]
    cfg = config(epochs, lr)

    curve: list[dict] = []
    with tempfile.TemporaryDirectory() as td:
        trainer = Trainer(cfg, None, [_Loader(batches)], [_Loader(batches)], save_dir=td,
                          log=lambda *a: print(*a, flush=True), device=dev)
        train_epoch, valid_epoch = trainer._train_epoch, trainer._valid_epoch

        def rec_train(epoch):
            t0 = time.perf_counter()
            log = train_epoch(epoch)
            curve.append({"epoch": epoch, "loss": round(log["loss"], 4),
                          "depth_loss": round(log.get("depth_loss", float("nan")), 4),
                          "secs": round(time.perf_counter() - t0, 1)})
            return log

        def rec_valid():
            val = valid_epoch()
            curve[-1].update({f"val_{k}": round(v, 4) for k, v in val.items()})
            return val

        trainer._train_epoch = rec_train
        trainer._valid_epoch = rec_valid
        trainer.train()

    first, last = curve[0]["loss"], curve[-1]["loss"]
    line = {
        "curve": curve,
        "loss_first_epoch": first,
        "loss_last_epoch": last,
        "loss_decreased": last < first,
        "steps_total": epochs * spe,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
