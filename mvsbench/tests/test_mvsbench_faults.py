"""A run's check, driven end to end on the CPU at a tiny size with the
cards' look skipped: a sound run comes out correct, and each fault that a
cell can have, planted in the timed path, comes out not correct; the fp8
control, put in the program's place, fails the limits too."""

import json

import pytest
import torch

from mvsbench import run
from mvsbench.inputs.synthetic import plane_scenes
from mvsbench.reference.compare import eval_numbers, judge
from mvsbench.weights import seeded_state

from ._tiny import tiny_cell


def _run(capsys, cell, seed=2**31 + 21):
    assert run.main(["--workload", cell.name, "--seed", str(seed), "--seconds", "0.05", "--trace", "0"],
                    device="cpu", cell=cell) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    res = json.loads(out)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(res)[-1] == "check"
    return res


def _tight(cell, res):
    """The cell with limits at three times a sound run's readings of the
    numbers that its card limits compare: CPU readings at a tiny size are
    not the card's."""
    compared = cell.limits["limits"]
    cell.limits = {"limits": {k: 3 * res["check"][k]["value"] + 1e-12 for k in compared}}
    return cell


@pytest.mark.parametrize("name, mix", [("dtu-eval.offline", None), ("dtu-eval.offline", "interactive"),
                                       ("dtu-train.b8", None)])
def test_a_sound_run_reports_and_repeats(capsys, name, mix):
    cell = tiny_cell(name, mix)
    res = _run(capsys, cell)
    assert set(res["metrics"]) == {"setup_s", {"dtu-eval.offline": "maps_per_s",
                                                "dtu-train.b8": "train_samples_per_s"}[name]}
    assert set(cell.limits["limits"]) <= set(res["check"])
    assert _run(capsys, _tight(cell, res))["correct"]


def test_an_altered_answer_is_not_correct(capsys, monkeypatch):
    from cds_mvsnet_tpu_torch.ops.kernels import regress

    cell = _tight(tiny_cell("dtu-eval.offline"), _run(capsys, tiny_cell("dtu-eval.offline")))
    plain = regress.exit_softargmin_plain

    def altered(y, w, hyp):
        depth, conf = plain(y, w, hyp)
        return depth + 0.5 * (hyp.flatten()[1] - hyp.flatten()[0]).abs(), conf

    monkeypatch.setattr(regress, "exit_softargmin_plain", altered)
    assert not _run(capsys, cell)["correct"]


def test_a_step_that_keeps_its_state_is_not_correct(capsys, monkeypatch):
    from cds_mvsnet_tpu_torch.training.train_step import TrainStep

    cell = _tight(tiny_cell("dtu-train.b8"), _run(capsys, tiny_cell("dtu-train.b8")))
    monkeypatch.setattr(TrainStep, "__call__", lambda self, batch, temperature, epoch=1:
                        self.gradients(batch, temperature)[0])
    assert not _run(capsys, cell)["correct"]


def test_half_a_batch_is_not_correct(capsys, monkeypatch):
    from cds_mvsnet_tpu_torch.training.train_step import TrainStep

    cell = _tight(tiny_cell("dtu-train.b8"), _run(capsys, tiny_cell("dtu-train.b8")))
    whole = TrainStep.gradients

    def half(self, batch, temperature):
        n = batch["imgs"].shape[0] // 2
        cut = {k: ({s: x[:n] for s, x in v.items()} if isinstance(v, dict) else v[:n]) for k, v in batch.items()}
        return whole(self, cut, temperature)

    monkeypatch.setattr(TrainStep, "gradients", half)
    assert not _run(capsys, cell)["correct"]


def test_the_fp8_control_is_not_correct():
    from mvsbench import program
    from mvsbench.calibrate import control_record

    cell = tiny_cell("dtu-eval.offline")
    cfg = cell.config
    gen = torch.Generator().manual_seed(2**31 + 33)
    P = seeded_state(program.parameter_shapes(cfg), gen)
    sc = plane_scenes(1, cfg["views"], cfg["height"], cfg["width"], cfg["numdepth"], cfg["depth_min"],
                      cfg["interval"], True, gen)
    rec = control_record(P, cfg, sc["imgs"], sc["proj_matrices"], sc["depth_values"])
    correct, check = judge(eval_numbers(P, cfg, rec), cell.limits)
    assert not correct, check


def test_the_fp8_train_control_is_not_correct():
    from mvsbench.calibrate import _train_setup
    from mvsbench.reference.model import Rounding
    from mvsbench.reference.train import train_step

    cell = tiny_cell("dtu-train.b8")
    cfg, t = cell.config, cell.config["train"]
    P0, batches = _train_setup(cell, 2**31 + 34, torch.device("cpu"))
    rcfg = dict(cfg["model"], temperature=t["temperature"], lr=t["lr"], weight_decay=t["weight_decay"],
                dlossw=t["dlossw"])
    R, losses, P1 = P0, [], None
    for b in batches:
        R, loss, _ = train_step(R, b, rcfg, Rounding(torch.float8_e4m3fn))
        losses.append(loss)
        P1 = P1 if P1 is not None else R
    from mvsbench.reference.compare import train_numbers

    correct, check = judge(train_numbers(P0, P1, R, losses, batches, cfg)[0], cell.limits)
    assert not correct, check
