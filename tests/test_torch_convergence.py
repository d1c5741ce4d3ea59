"""Multi-step training of the port: the full Trainer (epoch loop,
validation, monitor) over 4 epochs on three ``sphere_train_batch`` batches
of one ``sphere_scene`` (64x64, D = 48, V = 3, refinement) must lower the
loss, as ``tests/test_convergence.py`` asserts of the JAX package's: the
last epoch's loss under 0.8 of the first's, and the least in the last two
epochs. Single steps cannot show faults of the BN statistics' merge, the
learning-rate schedule or the temperature annealing across epochs."""

from __future__ import annotations

import torch

from cds_mvsnet_tpu_torch.config import Config, ModelConfig, TrainConfig
from cds_mvsnet_tpu_torch.training import Trainer
from cds_mvsnet_tpu_torch.utils.synthetic import sphere_scene, sphere_train_batch

torch.set_num_threads(2)


class SphereLoader:
    # with refinement the cascade halves the working resolution and the
    # cost-reg UNet needs stage-1 sizes divisible by 8: H and W multiples of 64
    def __init__(self, n=3, H=64, W=64, D=48):
        scene = sphere_scene(V=5, H=H, W=W)
        self.batches = [sphere_train_batch(scene, r % 5, [(r + 1) % 5, (r + 2) % 5], D=D, refine=True)
                        for r in range(n)]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter([dict(b) for b in self.batches])


def test_loss_decreases_over_epochs(tmp_path):
    cfg = Config(model=ModelConfig(refine=True),
                 train=TrainConfig(epochs=4, lr=0.01, eval_freq=4, save_period=10, logging_every=1000,
                                   monitor="min val_loss"))
    trainer = Trainer(cfg, None, [SphereLoader(3)], [SphereLoader(1)], save_dir=tmp_path, log=lambda *a: None,
                      device="cpu")
    trainer.train()
    losses = [log["loss"] for log in trainer.history]
    assert len(losses) == 4 and len(trainer.timings) == 12
    assert "val_loss" in trainer.history[-1]
    assert losses[-1] < 0.8 * losses[0], losses
    assert min(losses) == min(losses[-2:]), losses
