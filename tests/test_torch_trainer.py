"""The port's Trainer over in-memory loaders, as ``tests/test_trainer.py``
drives the JAX package's: an epoch with validation, checkpoints in the JAX
package's ``.npz`` format, resume, and the monitor with early stop."""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.config import ModelConfig as JaxModelConfig
from cds_mvsnet_tpu.models.cds_mvsnet import init_cds_mvsnet
from cds_mvsnet_tpu.models.convert import flatten_params, load_params
from cds_mvsnet_tpu.training import metrics as jax_metrics
from cds_mvsnet_tpu_torch.config import Config, ModelConfig, TrainConfig
from cds_mvsnet_tpu_torch.models.convert import params_to_jax
from cds_mvsnet_tpu_torch.training import Trainer
from cds_mvsnet_tpu_torch.training import metrics
from cds_mvsnet_tpu_torch.utils.synthetic import synthetic_batch

torch.set_num_threads(2)


class FakeLoader:
    """The same tiny synthetic batches, as numpy arrays, on every pass."""

    def __init__(self, n=2, seed=0):
        self.batches = [synthetic_batch(B=1, V=3, H=64, W=64, D=48, refine=True, with_gt=True, seed=seed + i)
                        for i in range(n)]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter([dict(b) for b in self.batches])


@pytest.fixture(scope="module")
def params():
    tree = jax.jit(init_cds_mvsnet, static_argnums=1)(jax.random.PRNGKey(0), JaxModelConfig(refine=True))
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trained(params, tmp_path_factory):
    run = tmp_path_factory.mktemp("run")
    cfg = Config(model=ModelConfig(refine=True),
                 train=TrainConfig(epochs=1, eval_freq=1, logging_every=10, save_period=1))
    logs = []
    trainer = Trainer(cfg, params, [FakeLoader(2)], [FakeLoader(1, seed=9)], save_dir=run, log=logs.append,
                      device="cpu")
    best = trainer.train()
    return trainer, run, logs, best


def test_trainer_epoch_and_checkpoint(trained):
    trainer, run, logs, best = trained
    for name in ("checkpoint-epoch1.npz", "checkpoint-epoch1.json", "model_best.npz", "config.json"):
        assert (run / name).exists(), name
    assert np.isfinite(best)
    meta = json.loads((run / "checkpoint-epoch1.json").read_text())
    assert meta["epoch"] == 1 and meta["monitor_best"] == best
    epoch_line = [ln for ln in logs if ln.startswith("epoch 1:")]
    assert len(epoch_line) == 1 and "val_abs_depth_error" in epoch_line[0] and "val_loss" in epoch_line[0]
    assert json.loads((run / "config.json").read_text())["model"]["refine"] is True


def test_checkpoint_loads_into_jax_load_params(trained, params):
    """The port's checkpoint is the JAX package's ``save_params`` format:
    ``load_params`` gives the init tree's leaves, each in its JAX layout and
    equal to the port's trained weights and statistics."""
    trainer, run, _, _ = trained
    loaded = flatten_params(load_params(run / "checkpoint-epoch1.npz"))
    init = flatten_params(params)
    assert loaded.keys() == init.keys()
    want = flatten_params(params_to_jax(trainer.model))
    moved = 0
    for k, v in loaded.items():
        assert v.shape == init[k].shape and v.dtype == np.float32, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
        moved += not np.array_equal(v, init[k])
    assert moved > 0.9 * len(init)  # two steps moved nearly every leaf


def test_resume_restores_weights_and_epoch(trained, params, tmp_path):
    trainer, run, _, best = trained
    cfg = Config(model=ModelConfig(refine=True), train=TrainConfig(epochs=1))
    again = Trainer(cfg, params, [FakeLoader(1)], save_dir=tmp_path / "run2", log=lambda *a: None, device="cpu")
    again.resume(run / "checkpoint-epoch1.npz")
    assert again.start_epoch == 2 and again.monitor_best == best
    a, b = trainer.model.state_dict(), again.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # a fresh optimizer, as in the reference: no momentum state carried over
    assert again.step.optimizer.state_dict()["state"] == {}


@pytest.mark.parametrize("monitor,values,stop_epoch,best_epochs", [
    ("min val_loss", [3.0, 2.0, 2.5, 2.6, 2.7, 1.0], 4, [1, 2]),
    ("max val_thres2mm_error", [0.1, 0.3, 0.2, 0.2, 0.5, 0.6], 4, [1, 2]),
    ("min val_bogus", [1.0] * 6, None, []),  # a metric validation lacks: monitoring off
])
def test_monitor_and_early_stop(params, tmp_path, monitor, values, stop_epoch, best_epochs):
    """The monitor's logic alone, with the epochs stubbed: early stop once
    more than ``early_stop`` validations did not improve."""
    cfg = Config(model=ModelConfig(refine=True),
                 train=TrainConfig(epochs=6, eval_freq=1, save_period=100, early_stop=1, monitor=monitor))
    logs = []
    trainer = Trainer(cfg, params, [], save_dir=tmp_path, log=logs.append, device="cpu")
    vals = iter(values)
    trainer._train_epoch = lambda epoch: {}
    trainer._valid_epoch = lambda: (lambda v: {"loss": v, "thres2mm_error": v})(next(vals))
    saved = []
    trainer._save_checkpoint = lambda epoch, best=False: saved.append((epoch, best))
    trainer.train()
    stops = [ln for ln in logs if ln.startswith("early stop")]
    assert stops == ([f"early stop at epoch {stop_epoch}"] if stop_epoch else [])
    assert [e for e, b in saved if b] == best_epochs
    if not best_epochs:
        assert any("monitoring disabled" in ln for ln in logs)


def test_validation_metrics_match_jax():
    """The validation panel and the running average, on errors spread over
    every band (a 2.5 mm interval: bands of 1.887 mm)."""
    rng = np.random.default_rng(11)
    gt = rng.uniform(500, 900, (2, 24, 32)).astype(np.float32)
    est = (gt + rng.standard_normal(gt.shape) * rng.choice([0.5, 5.0, 60.0], gt.shape)).astype(np.float32)
    mask = (rng.uniform(0, 1, gt.shape) > 0.3).astype(np.float32)
    want = jax_metrics.validation_metrics(est, gt, mask, 2.5)
    got = metrics.validation_metrics(torch.tensor(est), torch.tensor(gt), torch.tensor(mask), torch.tensor(2.5))
    assert got.keys() == want.keys()
    for k in want:
        # fp32 masked sums in other orders
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    a, b = metrics.DictAverageMeter(), jax_metrics.DictAverageMeter()
    for step in ({"loss": 2.0, "x": 1.0}, {"loss": 4.0, "x": 3.0}):
        a.update(step, n=2)
        b.update(step, n=2)
    assert a.mean() == b.mean() == {"loss": 3.0, "x": 2.0}
