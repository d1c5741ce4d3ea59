"""The port's config against the JAX package's: the shipped configs load
to the same fields and values, and the defaults agree."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import pytest

from cds_mvsnet_tpu import config as jax_config
from cds_mvsnet_tpu_torch import config

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["config_dtu.json", "config_blended.json", "config_all_dataset.json"])
def test_shipped_configs_load_the_same(name):
    got = config.Config.load(REPO / "configs" / name)
    want = jax_config.Config.load(REPO / "configs" / name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.data and all(isinstance(d, config.DataConfig) for d in got.data)
    assert config.Config.from_json(got.to_json()) == got


@pytest.mark.parametrize("cls", ["ModelConfig", "DataConfig", "TrainConfig", "Config"])
def test_defaults_agree(cls):
    assert dataclasses.asdict(getattr(config, cls)()) == dataclasses.asdict(getattr(jax_config, cls)())
