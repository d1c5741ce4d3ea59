"""The frozen reference against the port's plain path at a tiny size in
fp32, where both compute the same function: eval forward, and a train
step's loss, gradients and BN statistics."""

import pytest
import torch

from mvsbench import program
from mvsbench.inputs.synthetic import plane_scenes, train_batches
from mvsbench.reference.model import Rounding, eval_cascade
from mvsbench.reference.train import train_step, trainable_keys
from mvsbench.weights import seeded_state

from ._tiny import tiny_cell


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_eval_matches_the_ports_plain_fp32_path(seed):
    cfg = tiny_cell("dtu-eval.offline").config
    gen = torch.Generator().manual_seed(seed)
    P = seeded_state(program.parameter_shapes(cfg), gen)
    model = program.build_model(cfg, P, "cpu")
    sc = plane_scenes(2, cfg["views"], cfg["height"], cfg["width"], cfg["numdepth"], cfg["depth_min"],
                      cfg["interval"], True, gen)
    args = (sc["imgs"], sc["proj_matrices"], sc["depth_values"])
    got = model(*args, temperature=cfg["temperature"], compute_dtype=torch.float32, kernels=False)
    want = eval_cascade(P, *args, cfg["temperature"], cfg["model"], Rounding(torch.float32))
    for s in ("stage1", "stage2", "stage3"):
        assert (got[s]["depth"] - want[s]["depth"]).abs().max() / cfg["interval"] < 1e-2
        assert (got[s]["photometric_confidence"] - want[s]["photometric_confidence"]).abs().max() < 1e-3
    assert (got["refined_depth"] - want["refined_depth"]).abs().max() / cfg["interval"] < 1e-2


def test_train_step_matches_the_ports_plain_fp32_step():
    cell = tiny_cell("dtu-train.b8")
    cfg = cell.config
    t = dict(cfg["train"], compute_dtype="fp32", remat_features=False)
    cfg = dict(cfg, train=t)
    gen = torch.Generator().manual_seed(4)
    P0 = seeded_state(program.parameter_shapes(cfg), gen)
    batch = train_batches(1, cfg["batch_size"], cfg["views"], cfg["height"], cfg["width"], cfg["numdepth"],
                          cfg["depth_min"], cfg["interval"], True, gen)[0]
    model = program.build_model(cfg, P0, "cpu")
    loss = float(program.train_step(model, cfg)(batch, t["temperature"], t["epoch"])["loss"])
    got = model.state_dict()
    want, want_loss, _ = train_step(P0, batch, dict(cfg["model"], temperature=t["temperature"], lr=t["lr"],
                                                       weight_decay=t["weight_decay"], dlossw=t["dlossw"]),
                                    Rounding(torch.float32))
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    # gradients at random weights are ill-conditioned (the reference takes
    # its geometry in fp64): each leaf's update within 5 % of its own
    worst = max(float((got[k] - want[k]).norm() / (want[k] - P0[k]).norm().clamp_min(1e-12))
                for k in trainable_keys(P0))
    assert worst < 5e-2, worst
    for k in P0:
        if k.endswith(("running_mean", "running_var")):
            assert torch.allclose(got[k], want[k], rtol=1e-5, atol=1e-6), k
