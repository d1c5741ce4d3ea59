"""The data-parallel driver on the CPU over two ``gloo`` ranks at a tiny
size: the global samples are counted once, the replicas stay equal, the
check holds rank 0's steps to the reference on the global batch, and two
faults planted in the ranks (each BN on its rank's own statistics; one
rank stepping on its own gradient) come out not correct; a rank that dies
ends the run."""

import time

import pytest

from mvsbench.calibrate_dp import local_bn, one_rank_keeps_its_gradient, rank_exits
from mvsbench.drivers import train_dp

from ._tiny import tiny_cell

SEED = 2**31 + 41


@pytest.fixture(scope="module")
def sound():
    cell = tiny_cell("dtu-train.dp4", ranks=2)
    return cell, train_dp.run(cell, SEED, 0.05, False, device="cpu")


def _tight(cell, res):
    """Limits at three times a sound run's readings of the numbers that the
    card's limits compare (CPU readings at a tiny size are not the card's),
    and the replicas' 0."""
    compared = set(cell.limits["limits"]) - {"replicas"}
    limits = {k: 3 * res["check"][k]["value"] + 1e-12 for k in compared}
    cell.limits = {"limits": {**limits, "replicas": 0.0}}
    return cell


def test_a_sound_run_counts_global_samples_once_and_keeps_replicas_equal(sound):
    cell, res = sound
    ranks, B = cell.traffic["ranks"], cell.config["batch_size"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    rate = res["metrics"]["train_samples_per_s"]["value"]
    assert rate * res["extra"]["window_s"] == pytest.approx(res["attempted"] * ranks * B, rel=1e-12)
    assert res["check"]["replicas"]["value"] == 0.0
    assert set(cell.limits["limits"]) <= set(res["check"])
    assert res["check"]["loss1"]["value"] < 1e-2  # bf16 program against the fp32 reference, on the global batch
    again = train_dp.run(_tight(tiny_cell("dtu-train.dp4", ranks=2), res), SEED, 0.05, False, device="cpu")
    assert again["correct"], again["check"]


@pytest.mark.parametrize("plant", [local_bn, one_rank_keeps_its_gradient], ids=lambda f: f.__name__)
def test_a_fault_in_the_ranks_is_not_correct(sound, plant):
    cell = _tight(tiny_cell("dtu-train.dp4", ranks=2), sound[1])
    res = train_dp.run(cell, SEED, 0.05, False, device="cpu", plant=plant)
    assert not res["correct"], res["check"]
    assert res["check"]["replicas"]["value"] > 0.0


def test_a_rank_that_dies_ends_the_run():
    """Rank 1 exits mid-window: the run raises at once, rather than leaving
    rank 0 waiting in a collective until the process group's timeout."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="exit"):
        train_dp.run(tiny_cell("dtu-train.dp4", ranks=2), SEED, 30.0, False, device="cpu", plant=rank_exits)
    assert time.monotonic() - t0 < train_dp.COLLECTIVE_TIMEOUT_S


def test_the_blocked_reference_is_the_whole_batch_step():
    """``reference/blocks.py`` in two blocks against ``train.train_step`` on
    the whole batch: the same loss and BN statistics to fp32 rounding, and
    gradients within what rounding makes of them. On the CPU the median
    leaf's relative gap read 1.3e-3, where moving the weights by 1e-7 of
    themselves reads 5e-4 and BN statistics per block read 0.38."""
    import torch

    from mvsbench import program
    from mvsbench.inputs.synthetic import train_batches
    from mvsbench.reference.blocks import train_step_blocks
    from mvsbench.reference.model import Rounding
    from mvsbench.reference.train import train_step, trainable_keys
    from mvsbench.weights import seeded_state

    cfg = tiny_cell("dtu-train.dp4", ranks=2).config
    t = cfg["train"]
    rcfg = dict(cfg["model"], temperature=t["temperature"], lr=t["lr"], weight_decay=t["weight_decay"],
                dlossw=t["dlossw"])
    gen = torch.Generator().manual_seed(5)
    P = seeded_state(program.parameter_shapes(cfg), gen)
    b = train_batches(1, 4, cfg["views"], cfg["height"], cfg["width"], cfg["numdepth"], cfg["depth_min"],
                      cfg["interval"], True, gen)[0]
    whole, loss, grad = train_step(P, b, rcfg, Rounding(torch.float32))
    blocked, bloss, bgrad = train_step_blocks(P, b, rcfg, Rounding(torch.float32), ["cpu", "cpu"])
    assert abs(loss - bloss) <= 1e-6 * abs(loss)
    for k in P:
        if k.endswith(("running_mean", "running_var")):
            assert torch.allclose(whole[k], blocked[k], rtol=1e-6, atol=1e-6), k
    gaps = sorted(float((grad[k] - bgrad[k]).norm() / grad[k].norm().clamp_min(1e-30)) for k in trainable_keys(P))
    assert gaps[len(gaps) // 2] < 1e-2, gaps[len(gaps) // 2]


def test_the_new_files_load_no_jax_and_the_reference_nothing_of_the_port():
    from .test_mvsbench_imports import _modules_after

    mods = _modules_after("import mvsbench.drivers.train_dp, mvsbench.calibrate_dp")
    assert not mods & {"jax", "jaxlib", "flax", "cds_mvsnet_tpu"}
    mods = _modules_after("import mvsbench.reference.blocks, mvsbench.roofline.k4")
    assert not mods & {"jax", "jaxlib", "flax", "cds_mvsnet_tpu", "cds_mvsnet_tpu_torch"}
