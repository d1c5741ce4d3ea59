"""The T&T cell's check, driven end to end on the CPU at a tiny size of
its kind (no refinement, 10 views): a sound run passes limits at three
times its readings, and a stage-3 depth moved by half a plane fails them."""

import json

import torch

from mvsbench import run

from ._tiny import tiny_cell


def _cell():
    cell = tiny_cell("tt-eval.offline")
    cell.config["views"] = 10
    return cell


def _run(capsys, cell, seed=2**31 + 51):
    assert run.main(["--workload", cell.name, "--seed", str(seed), "--seconds", "0.05", "--trace", "0"],
                    device="cpu", cell=cell) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_an_altered_stage3_depth_is_not_correct(capsys, monkeypatch):
    from cds_mvsnet_tpu_torch.ops.kernels import regress

    cell = _cell()
    res = _run(capsys, cell)
    compared = cell.limits["limits"]
    assert {"chain_med.s2", "chain_med.s3", "chain_p99.s2", "chain_p99.s3"} <= set(compared)
    cell.limits = {"limits": {k: 3 * res["check"][k]["value"] + 1e-12 for k in compared}}
    assert _run(capsys, cell)["correct"]

    plain = regress.exit_softargmin_plain
    H = cell.config["height"]

    def altered(y, w, hyp):
        depth, conf = plain(y, w, hyp)
        if hyp.ndim == 3 and hyp.shape[-2] == H:  # stage 3, at the input's resolution
            depth = depth + 0.5 * cell.config["interval"]
        return depth, conf

    monkeypatch.setattr(regress, "exit_softargmin_plain", altered)
    bad = _run(capsys, cell)
    assert not bad["correct"]
    assert bad["check"]["chain_med.s3"]["value"] > cell.limits["limits"]["chain_med.s3"]
    assert bad["check"]["chain_med.s2"]["value"] <= cell.limits["limits"]["chain_med.s2"]
    assert torch.isfinite(torch.tensor(bad["check"]["depth_p99.s3"]["value"]))
