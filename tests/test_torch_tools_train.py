"""``cds_mvsnet_tpu_torch/tools/{bench_train,train_convergence}.py`` on the
CPU at tiny sizes: the JAX tools' keys, steps from the same weights, and
the curve through the full Trainer."""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import pytest
import torch

from cds_mvsnet_tpu_torch.tools import bench_train, train_convergence
from cds_mvsnet_tpu_torch.training import TrainStep
from test_torch_tools_source import jax_curve_keys, jax_train_mode_keys

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)


def test_bench_train_at_64x128(monkeypatch, capsys):
    """``--bs 1 --reps 2`` at 64x128 in both modes: the JAX tool's keys a
    mode, finite losses, and every step from the same weights, so both timed
    steps of a mode give the same loss; no launch on the CPU."""
    monkeypatch.setattr(bench_train, "H", 64)
    monkeypatch.setattr(bench_train, "W", 128)
    losses = []
    original = TrainStep.__call__

    def recording(self, batch, temperature, epoch=1):
        metrics = original(self, batch, temperature, epoch)
        losses.append((self.cfg.compute_dtype, float(metrics["loss"])))
        return metrics

    monkeypatch.setattr(TrainStep, "__call__", recording)
    report = bench_train.main(["--bs", "1", "--reps", "2"], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == report["line"] and list(line) == ["fp32", "bf16"]
    for mode in ("fp32", "bf16"):
        assert list(line[mode]) == jax_train_mode_keys()
        assert line[mode]["loss_finite"] is True and line[mode]["step_s"] > 0
        assert line[mode]["samples_per_sec"] == pytest.approx(1 / line[mode]["step_s"], rel=1e-2)
        mode_losses = [loss for m, loss in losses if m == mode]
        assert len(mode_losses) == 3 and len(set(mode_losses)) == 1, mode_losses
    assert report["launches"] == {"fp32": {}, "bf16": {}}
    gates = chip_smoke.tool_problems
    assert gates("bench_train", [], report) == []
    assert gates("bench_train", [], {**report, "device": "cuda"}) == ["bf16 step launches {} != "
                                                                     "{'warp_sim': 24, 'warp_sim_backward': 24}"]
    card_b2 = {**report, "device": "cuda", "bs": 2,
               "launches": {"fp32": {}, "bf16": {"warp_sim": 48, "warp_sim_backward": 48}}}
    assert gates("bench_train", [], card_b2) == []


def test_train_convergence_two_epochs(monkeypatch, capsys):
    """``CONV_EPOCHS=2 CONV_STEPS_PER_EPOCH=2`` at 64x64 under
    ``CONV_PLATFORM=cpu``: the JAX tool's keys, one curve entry an epoch,
    validation on the second (``eval_freq=2``), finite losses."""
    for k, v in {"CONV_EPOCHS": "2", "CONV_STEPS_PER_EPOCH": "2", "CONV_SIZE": "64x64", "CONV_PLATFORM": "cpu"}.items():
        monkeypatch.setenv(k, v)
    line = train_convergence.main([])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    entry_keys, line_keys = jax_curve_keys()
    assert list(line) == line_keys
    assert [e["epoch"] for e in line["curve"]] == [1, 2] and line["steps_total"] == 4
    assert all(list(e)[:4] == entry_keys for e in line["curve"])
    assert "val_loss" in line["curve"][1] and "val_loss" not in line["curve"][0]
    assert all(k.startswith("val_") for k in list(line["curve"][1])[4:])
    assert all(math.isfinite(e["loss"]) for e in line["curve"])
    assert line["loss_first_epoch"] == line["curve"][0]["loss"]
    assert line["loss_decreased"] == (line["loss_last_epoch"] < line["loss_first_epoch"])


@pytest.mark.parametrize("remat,recomputes", [("0", False), ("1", True), (None, True)])
def test_bench_train_remat_override(monkeypatch, capsys, remat, recomputes):
    """``CDS_TRAIN_REMAT`` sets ``TrainConfig.remat_features`` for every
    step: "0" runs the FeatureNet without ``torch.utils.checkpoint``, "1"
    through it, and unset the default (through it); the step's loss stays
    finite either way."""
    from cds_mvsnet_tpu_torch.models import cds_mvsnet

    calls = []
    original = cds_mvsnet.checkpoint

    def counting(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(cds_mvsnet, "checkpoint", counting)
    monkeypatch.setattr(bench_train, "H", 64)
    monkeypatch.setattr(bench_train, "W", 128)
    if remat is None:
        monkeypatch.delenv("CDS_TRAIN_REMAT", raising=False)
    else:
        monkeypatch.setenv("CDS_TRAIN_REMAT", remat)
    report = bench_train.main(["--bs", "1", "--reps", "1", "--modes", "fp32"], device="cpu")
    assert report["line"]["fp32"]["loss_finite"] is True
    assert bool(calls) == recomputes, len(calls)
