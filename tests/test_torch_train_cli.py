"""The port's train CLI against the JAX package's on tiny DTU and
BlendedMVS layouts: ``build_loaders`` (loader counts, lengths, batch
shapes), ``main`` with ``--epochs 0`` on the CPU in one process and over two
``gloo`` ranks, and the refusal of ``--n_devices`` beyond the visible
cards."""

from __future__ import annotations

import json

import jax
import pytest
import torch

from cds_mvsnet_tpu.cli import train_cli as jax_cli
from cds_mvsnet_tpu.config import Config as JaxConfig
from cds_mvsnet_tpu_torch.cli import train_cli
from cds_mvsnet_tpu_torch.config import Config
from cds_mvsnet_tpu_torch.utils.synthetic import write_blended_scan, write_dtu_train_scan

from test_torch_train_config import REPO


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    """``configs/config_all_dataset.json`` pointed at a DTU layout (3 views,
    2 ref views) with ``train.txt`` and ``val.txt``, and a BlendedMVS one (3
    views) with ``training_list.txt`` and ``validation_list.txt``."""
    root = tmp_path_factory.mktemp("train_cli")
    write_dtu_train_scan(root / "dtu", views=3, refs=(0, 1))
    write_blended_scan(root / "blended", views=3)
    lists = {"dtu": ("train.txt", "val.txt"), "blended": ("training_list.txt", "validation_list.txt")}
    for name, files in lists.items():
        for f in files:
            (root / name / f).write_text("scan1\n")
    raw = json.loads((REPO / "configs" / "config_all_dataset.json").read_text())
    for d in raw["data"]:
        d["datapath"] = str(root / d["dataset"])
        d["listfile"] = str(root / d["dataset"] / lists[d["dataset"]][0])
    raw["save_dir"] = str(root / "saved")
    path = root / "config.json"
    path.write_text(json.dumps(raw))
    return path


@pytest.mark.parametrize("bs", [None, 2])
def test_build_loaders_match_jax(config_path, bs):
    got_train, got_val = train_cli.build_loaders(Config.load(config_path), bs, device="cpu")
    want_train, want_val, mesh = jax_cli.build_loaders(JaxConfig.load(config_path), bs)
    assert mesh is None
    assert (len(got_train), len(got_val)) == (len(want_train), len(want_val)) == (2, 2)
    for got, want in zip(got_train + got_val, want_train + want_val):
        assert (len(got), got.batch_size, got.shuffle, got.drop_last) == (
            len(want), want.batch_size, want.shuffle, want.drop_last)
        assert len(got.dataset) == len(want.dataset) and got.dataset.mode == want.dataset.mode
        assert got.dataset.nviews == want.dataset.nviews
        if len(got):
            g, w = next(iter(got)), next(iter(want))
            shapes = jax.tree.map(lambda a: tuple(a.shape), {k: v for k, v in w.items() if k != "filename"})
            assert jax.tree.map(lambda a: tuple(a.shape), g["host"]) == shapes


def test_main_without_epochs_writes_the_config(config_path, tmp_path):
    trainer = train_cli.main(["-c", str(config_path), "--epochs", "0", "--lr", "0.005", "--save_dir",
                              str(tmp_path)], device="cpu")
    written = json.loads((tmp_path / "config.json").read_text())
    assert written["train"]["epochs"] == 0 and written["train"]["lr"] == 0.005
    assert Config.from_json(json.dumps(written)) == trainer.config
    assert trainer.history == [] and next(trainer.model.parameters()).device.type == "cpu"
    # the seeded init of train.seed
    from cds_mvsnet_tpu_torch.models import build_model

    want = build_model(trainer.config.model, seed=trainer.config.train.seed, device="cpu").state_dict()
    assert all(torch.equal(v, want[k]) for k, v in trainer.model.state_dict().items())


def test_main_over_two_gloo_ranks(config_path, tmp_path):
    assert train_cli.main(["-c", str(config_path), "--epochs", "0", "--bs", "2", "--n_devices", "2",
                           "--save_dir", str(tmp_path)], device="cpu") is None
    assert json.loads((tmp_path / "config.json").read_text())["train"]["epochs"] == 0


def test_n_devices_beyond_the_cards_raises(config_path, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA devices; 0 are visible"):
        train_cli.main(["-c", str(config_path), "--n_devices", "2", "--save_dir", str(tmp_path)])
    assert not (tmp_path / "config.json").exists()


def test_without_a_card_main_raises(config_path, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["-c", str(config_path), "--save_dir", str(tmp_path)])


def test_an_uneven_train_batch_is_refused(config_path, monkeypatch):
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    with pytest.raises(ValueError, match="a train batch of 3 does not split over 2 ranks"):
        train_cli.build_loaders(Config.load(config_path), 3, device="cpu", group=object())
