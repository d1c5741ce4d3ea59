"""The cascade's shapes by stage, from a configuration."""

from __future__ import annotations

FEATURE_CHANNELS = (32, 16, 8)
STAGE_SCALES = (4, 2, 1)


def stages(cfg: dict) -> list:
    """Per stage ``(C, D, h, w)``: feature channels, planes and the stage's
    resolution (the cascade runs at half the input with refinement)."""
    H, W = cfg["height"], cfg["width"]
    if cfg["model"]["refine"]:
        H, W = H // 2, W // 2
    return [(c, d, H // s, W // s) for c, d, s in zip(FEATURE_CHANNELS, cfg["model"]["ndepths"], STAGE_SCALES)]
