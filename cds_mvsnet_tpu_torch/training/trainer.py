"""Epoch-level training: schedules, validation, early stop, checkpoints.

Counterpart of ``cds_mvsnet_tpu/training/trainer.py::Trainer``: temperature
annealing over the first 4 epochs, StepLR per epoch, validation every
``eval_freq`` epochs (the eval forward with refinement, fp32, temperature
0.01), the monitor with early stop, and a checkpoint every ``save_period``
epochs. Checkpoints are ``.npz`` files in the JAX package's ``save_params``
format (its ``load_params`` reads them) with a JSON sidecar (epoch,
monitor_best); the optimizer state is not saved or restored, as in the
reference.

Under a process group (``train_cli --n_devices N``: a rank a device, each
loader yielding its rank's slice of every global batch) the weights are
broadcast from rank 0, the step is the global batch's (``TrainStep``), the
validation metrics are global means (each batch's loss summed over the
ranks' shares, then every rank's sums and counts summed), so the monitor
and the early stop take the same decision on every rank, and only rank 0
writes ``config.json`` and the checkpoints.

``timings`` holds, for every train step, the seconds spent waiting for the
loader's batch and the seconds of the step, which ends in a
synchronisation of the device; ``history`` each epoch's log.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from ..config import Config
from ..models.cds_mvsnet import build_model, to_tensors
from ..models.convert import load_into, save_model
from ..parallel.mesh import replicate
from .loss import final_loss
from .metrics import DictAverageMeter, validation_metrics
from .train_step import TrainStep, temperature_schedule

__all__ = ["Trainer"]


class Trainer:
    """Train ``build_model(config.model, params, seed=config.train.seed,
    device=device)`` over ``train_loaders`` (iterables of batches: numpy
    arrays, as ``synthetic_batch`` gives them, or tensors on ``device``, as
    ``data.DataLoader`` does), validating on ``val_loaders``; ``group``: the
    process group of data-parallel training."""

    def __init__(self, config: Config, params, train_loaders: list, val_loaders: list | None = None,
                 save_dir: str | None = None, log=print, device="cuda", group=None):
        self.config = config
        self.train_cfg = config.train
        self.train_loaders = train_loaders
        self.val_loaders = val_loaders or []
        self.log = log
        self.device = device
        self.group = group
        self.rank0 = group is None or torch.distributed.get_rank(group) == 0
        self.timings: list[dict] = []
        self.history: list[dict] = []

        self.save_dir = Path(save_dir or config.save_dir)
        if self.rank0:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            (self.save_dir / "config.json").write_text(config.to_json())

        self.model = build_model(config.model, params=params, seed=config.train.seed, device=device)
        if group is not None:
            replicate(self.model, group)
        self.step = TrainStep(self.model, self.train_cfg, group=group)
        self.start_epoch = 1
        # "min val_loss" / "max val_thres2mm_error" / "off"
        monitor = (self.train_cfg.monitor or "off").split()
        self.monitor_mode = monitor[0] if monitor[0] in ("min", "max") else "off"
        self.monitor_metric = monitor[1].removeprefix("val_") if len(monitor) > 1 else "loss"
        self.monitor_best = float("inf") if self.monitor_mode != "max" else -float("inf")
        self.not_improved = 0

    def train(self) -> float:
        for epoch in range(self.start_epoch, self.train_cfg.epochs + 1):
            log = self._train_epoch(epoch)
            if epoch % self.train_cfg.eval_freq == 0 or epoch == self.train_cfg.epochs:
                val = self._valid_epoch()
                log.update({f"val_{k}": v for k, v in val.items()})
                if self.monitor_mode != "off" and self.monitor_metric not in val:
                    self.log(f"warning: monitor metric '{self.monitor_metric}' not in "
                             f"validation metrics {sorted(val)}; monitoring disabled")
                    self.monitor_mode = "off"
                if self.monitor_mode != "off":
                    value = val[self.monitor_metric]
                    improved = value < self.monitor_best if self.monitor_mode == "min" else value > self.monitor_best
                    if improved:
                        self.monitor_best = value
                        self.not_improved = 0
                        self._save_checkpoint(epoch, best=True)
                    else:
                        self.not_improved += 1
                    if self.not_improved > self.train_cfg.early_stop:
                        self.log(f"early stop at epoch {epoch}")
                        break
            if epoch % self.train_cfg.save_period == 0:
                self._save_checkpoint(epoch)
            self.history.append({"epoch": epoch, **log})
            self.log(f"epoch {epoch}: " + ", ".join(f"{k}={v:.4f}" for k, v in log.items()))
        return self.monitor_best

    def _train_epoch(self, epoch: int) -> dict:
        temperature = temperature_schedule(epoch)
        meter = DictAverageMeter()
        cuda = torch.device(self.device).type == "cuda"
        for dl in self.train_loaders:
            t_ready = time.perf_counter()  # when the loop asks the loader for a batch
            for it, batch in enumerate(dl):
                t0 = time.perf_counter()
                metrics = {k: float(v) for k, v in self.step(to_tensors(batch, self.device), temperature, epoch).items()}
                if cuda:
                    torch.cuda.synchronize(self.device)
                t1 = time.perf_counter()
                step_s = t1 - t0
                self.timings.append({"epoch": epoch, "wait_s": t0 - t_ready, "step_s": step_s})
                t_ready = t1
                if it % self.train_cfg.logging_every == 0:
                    self.log(f"epoch {epoch} iter {it}/{len(dl)} loss {metrics['loss']:.3f} ({step_s:.2f}s)")
                meter.update(metrics)
        return meter.mean()

    def _valid_epoch(self) -> dict:
        meter = DictAverageMeter()
        for dl in self.val_loaders:
            for raw in dl:
                batch = to_tensors(raw, self.device)
                dv = batch["depth_values"]
                with torch.no_grad():
                    outputs = self.model(batch["imgs"], batch["proj_matrices"], dv, temperature=0.01)
                    di = dv[:, 1] - dv[:, 0]
                    losses = torch.stack(final_loss(outputs, batch["depth"], batch["mask"], self.train_cfg.dlossw, di,
                                                    group=self.group))
                    if self.group is not None:  # the global batch's loss from the ranks' shares
                        torch.distributed.all_reduce(losses, group=self.group)
                    m = validation_metrics(outputs["refined_depth"], batch["depth"]["stage4"],
                                           batch["mask"]["stage4"], di[0])
                m.update({"loss": losses[0], "depth_loss": losses[1]})
                meter.update({k: float(v) for k, v in m.items()})
        if self.group is None:
            return meter.mean()
        # every rank's sums and counts: the per-image metrics' mean over
        # all ranks' images (equal slices), the losses' mean over batches
        keys = sorted(meter.data)
        sums = torch.tensor([meter.data[k] for k in keys] + [meter.count], dtype=torch.float64, device=self.device)
        torch.distributed.all_reduce(sums, group=self.group)
        return {k: float(v) / max(float(sums[-1]), 1.0) for k, v in zip(keys, sums[:-1])}

    def _save_checkpoint(self, epoch: int, best: bool = False) -> None:
        if not self.rank0:
            return
        name = "model_best" if best else f"checkpoint-epoch{epoch}"
        save_model(self.save_dir / f"{name}.npz", self.model)
        meta = {"epoch": epoch, "monitor_best": self.monitor_best, "arch": "CDSMVSNet"}
        (self.save_dir / f"{name}.json").write_text(json.dumps(meta))
        self.log(f"saved checkpoint {name}")

    def resume(self, path) -> None:
        """Restore the weights and the epoch; the optimizer starts afresh,
        as in the reference."""
        path = Path(path)
        load_into(self.model, path)
        if self.group is not None:
            replicate(self.model, self.group)
        self.step.reset_optimizer()
        meta_path = path.with_suffix(".json")
        if meta_path.exists():
            meta = json.loads(meta_path.read_text())
            self.start_epoch = int(meta.get("epoch", 0)) + 1
            self.monitor_best = float(meta.get("monitor_best", float("inf")))
        self.log(f"resumed from {path} at epoch {self.start_epoch}")
