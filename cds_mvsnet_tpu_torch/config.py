"""Model hyperparameters (own copy of ``cds_mvsnet_tpu.config.ModelConfig``)."""

from __future__ import annotations

from dataclasses import dataclass


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
