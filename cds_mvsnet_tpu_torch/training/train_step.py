"""One training step: forward, loss, backward, SGD update, BN statistics.

Counterpart of ``cds_mvsnet_tpu/training/train_step.py::make_train_step``.

- SGD with weight decay (``torch.optim.SGD``, the semantics of the JAX
  package's ``add_decayed_weights`` + ``trace`` chain) on the trainable
  leaves only: the BN running statistics are buffers, not parameters. A
  trainable leaf the loss does not reach still decays, as it does under the
  JAX package's masked optimizer, so its gradient is taken as zero.
- ``lr = lr·gamma^((epoch − 1) // lr_step)`` for the 1-based epoch.
- The BN running statistics move after the optimizer step, once
  (``StatsCollector.apply``), as ``merge_stat_updates`` does.
- Under a process group (data parallelism, a batch slice a rank) the step
  is the one-process step on the global batch, as the JAX package's
  data-parallel step is: the BN statistics and the loss's masked means are
  global (``models/layers.py``, ``training/loss.py``), each rank's loss is
  its share of the global loss, and the gradients are summed over the ranks
  before the update (one all-reduce of every leaf's gradient), so every
  rank applies the same update to the same weights.
- On the card the step repeats bit for bit: the set-up holds cuDNN to
  deterministic algorithms (``models.cds_mvsnet.strict_fp32``), K5 sums
  ``d_src`` in fixed point, and the plain warp's and the resizes' gathers
  differentiate in a fixed order (``ops/index.py``).
- Under ``torch.profiler`` a step records the span ``cds.step`` and in it
  ``cds.step.forward``, ``.loss``, ``.backward`` (the gradient all-reduce
  stays outside it), ``.optimizer`` and ``.bn_apply``
  (``utils.profiling.span``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import TrainConfig
from ..models.cds_mvsnet import CDSMVSNet, strict_fp32
from ..models.layers import StatsCollector
from ..utils.profiling import span
from .loss import final_loss

__all__ = ["TrainStep", "learning_rate", "temperature_schedule"]


def learning_rate(cfg: TrainConfig, epoch: int) -> float:
    """StepLR for the 1-based ``epoch``."""
    return cfg.lr * cfg.lr_gamma ** ((epoch - 1) // cfg.lr_step)


def temperature_schedule(epoch: int) -> float:
    """``10^(-(epoch-1)/2)`` for epochs 1-4, then 0.01 (1-based)."""
    if epoch <= 4:
        return float(10.0 ** (-(epoch - 1) / 2.0))
    return 0.01


class TrainStep:
    """``step(batch, temperature, epoch) -> {"loss", "depth_loss"}`` on
    ``model``, in place.

    ``batch`` holds tensors on the model's device: ``imgs (B,V,H,W,3)``,
    ``proj_matrices[stage] (B,V,2,4,4)``, ``depth_values (B,D)``, and the GT
    pyramids ``depth[stage]``, ``mask[stage]`` ``(B,h,w)``. In bf16 the warp
    runs K5 (``kernels=True``) or its plain version; fp32 always runs the
    plain version.
    """

    def __init__(self, model: CDSMVSNet, cfg: TrainConfig, kernels: bool = True, group=None):
        self.model = model
        self.cfg = cfg
        self.kernels = kernels
        self.group = group
        self.compute_dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[cfg.compute_dtype]
        if next(model.parameters()).is_cuda:
            strict_fp32()
        self.reset_optimizer()

    def reset_optimizer(self) -> None:
        """A fresh optimizer (momentum buffers empty) over the model's
        parameters."""
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.SGD(self.params, lr=self.cfg.lr, momentum=self.cfg.momentum,
                                         weight_decay=self.cfg.weight_decay)

    def gradients(self, batch: dict, temperature: float) -> tuple[dict, StatsCollector]:
        """Forward, loss and backward, without the update: leaves each
        trainable leaf's gradient in ``.grad`` and returns ``({"loss",
        "depth_loss"}, the step's BN statistics)``; under a process group the
        gradients and the losses are the global batch's."""
        stats = StatsCollector(self.group)
        dv = batch["depth_values"]
        with span("cds.step.forward"):
            outputs = self.model.forward_train(
                batch["imgs"], batch["proj_matrices"], dv, batch["depth"], stats, temperature=temperature,
                compute_dtype=self.compute_dtype, kernels=self.kernels, remat_features=self.cfg.remat_features,
            )
        with span("cds.step.loss"):
            loss, depth_loss = final_loss(outputs, batch["depth"], batch["mask"], self.cfg.dlossw,
                                          dv[:, 1] - dv[:, 0], group=self.group)
        with span("cds.step.backward"):
            for p in self.params:
                p.grad = None
            loss.backward()
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        losses = torch.stack([loss.detach(), depth_loss.detach()])
        if self.group is not None:
            flat = torch.cat([p.grad.reshape(-1) for p in self.params])
            dist.all_reduce(flat, group=self.group)
            dist.all_reduce(losses, group=self.group)
            for p, g in zip(self.params, flat.split([p.numel() for p in self.params])):
                p.grad = g.view_as(p)
        return {"loss": losses[0], "depth_loss": losses[1]}, stats

    def __call__(self, batch: dict, temperature: float, epoch: int = 1) -> dict:
        with span("cds.step"):
            metrics, stats = self.gradients(batch, temperature)
            for group in self.optimizer.param_groups:
                group["lr"] = learning_rate(self.cfg, epoch)
            with span("cds.step.optimizer"):
                self.optimizer.step()
            with span("cds.step.bn_apply"):
                stats.apply()
        return metrics
