"""Model and training hyperparameters (own copies of
``cds_mvsnet_tpu.config.ModelConfig``, ``TrainConfig`` and ``Config``, with
the fields the train path reads)."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of the cascade."""

    refine: bool = True
    ndepths: tuple[int, ...] = (48, 32, 8)
    depth_intervals_ratio: tuple[float, ...] = (4.0, 2.0, 1.0)
    share_cr: bool = False
    cr_base_chs: tuple[int, ...] = (8, 8, 8)
    grad_method: str = "detach"  # "detach" | "undetach"
    arch_mode: str = "fpn"

    @property
    def num_stages(self) -> int:
        return len(self.ndepths)

    # Working-resolution scale per cascade stage.
    stage_scales: tuple[float, ...] = (4.0, 2.0, 1.0)


@dataclass(frozen=True)
class TrainConfig:
    """SGD with weight decay and a step learning-rate schedule, as the
    shipped ``configs/config_*.json`` set it."""

    epochs: int = 30
    lr: float = 0.01
    weight_decay: float = 0.01
    momentum: float = 0.0
    lr_step: int = 3
    lr_gamma: float = 0.5
    dlossw: tuple[float, ...] = (0.5, 1.0, 2.0)
    save_period: int = 1
    eval_freq: int = 3
    logging_every: int = 50
    early_stop: int = 10
    monitor: str = "min val_loss"
    # "fp32" or "bf16": dtype of the convolutions, features and volumes;
    # parameters, the loss and the softmaxes stay fp32
    compute_dtype: str = "fp32"
    # recompute the FeatureNet in the backward (torch.utils.checkpoint)
    # instead of keeping its full-resolution intermediates
    remat_features: bool = True


@dataclass(frozen=True)
class Config:
    """What the Trainer writes to ``config.json`` beside its checkpoints."""

    name: str = "cds_mvsnet_tpu"
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    save_dir: str = "saved"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)
