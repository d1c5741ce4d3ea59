"""Model, data and training hyperparameters (own copies of
``cds_mvsnet_tpu.config.ModelConfig``, ``DataConfig``, ``TrainConfig`` and
``Config``): ``Config.load`` reads the shipped ``configs/config_*.json`` to
the same fields and values."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path


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
class DataConfig:
    """One training dataset: its reader (``dtu`` or ``blended``), where it
    lies, and its batch."""

    datapath: str = ""
    listfile: str = ""
    dataset: str = "dtu"  # dtu | blended | general
    nviews: int = 5
    ndepths: int = 192
    interval_scale: float = 1.06
    max_h: int = 864
    max_w: int = 1152
    fix_res: bool = False
    batch_size: int = 1
    shuffle: bool = False


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
    depth_scale: float = 1.0
    save_period: int = 1
    eval_freq: int = 3
    logging_every: int = 50
    seed: int = 123
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
    """A training run; the Trainer writes it to ``config.json`` beside its
    checkpoints."""

    name: str = "cds_mvsnet_tpu"
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: tuple[DataConfig, ...] = ()
    save_dir: str = "saved"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "Config":
        """Keys a section's dataclass lacks are ignored; lists become
        tuples."""
        raw = json.loads(text)

        def tupled(d, cls):
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names})

        return Config(
            name=raw.get("name", "cds_mvsnet_tpu"),
            model=tupled(raw.get("model", {}), ModelConfig),
            train=tupled(raw.get("train", {}), TrainConfig),
            data=tuple(tupled(d, DataConfig) for d in raw.get("data", [])),
            save_dir=raw.get("save_dir", "saved"),
        )

    @staticmethod
    def load(path) -> "Config":
        return Config.from_json(Path(path).read_text())
