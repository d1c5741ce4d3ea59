"""The frozen FLOP count equals what torch's FLOP counter reads on the
reference, forward and train step."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from mvsbench.inputs.synthetic import plane_scenes, train_batches
from mvsbench.program import parameter_shapes
from mvsbench.reference.model import Rounding, eval_cascade
from mvsbench.reference.train import train_step
from mvsbench.roofline.flops import eval_flops_per_map, train_flops_per_sample
from mvsbench.weights import seeded_state

from ._tiny import tiny_cell


def _convs(fc):
    return sum(v for k, v in fc.get_flop_counts()["Global"].items() if "convolution" in str(k))


def test_eval_flops_match_the_counter():
    cfg = tiny_cell("dtu-eval.offline").config
    gen = torch.Generator().manual_seed(1)
    P = seeded_state(parameter_shapes(cfg), gen)
    sc = plane_scenes(1, cfg["views"], cfg["height"], cfg["width"], cfg["numdepth"], cfg["depth_min"],
                      cfg["interval"], True, gen)
    with FlopCounterMode(display=False) as fc:
        eval_cascade(P, sc["imgs"], sc["proj_matrices"], sc["depth_values"], 0.01, cfg["model"],
                     Rounding(torch.float32))
    assert _convs(fc) == eval_flops_per_map(cfg)


def test_train_flops_match_the_counter():
    cell = tiny_cell("dtu-train.b8")
    cfg = cell.config
    gen = torch.Generator().manual_seed(2)
    P = seeded_state(parameter_shapes(cfg), gen)
    b = train_batches(1, cfg["batch_size"], cfg["views"], cfg["height"], cfg["width"], cfg["numdepth"],
                      cfg["depth_min"], cfg["interval"], True, gen)[0]
    t = cfg["train"]
    with FlopCounterMode(display=False) as fc:
        train_step(P, b, dict(cfg["model"], temperature=t["temperature"], lr=t["lr"],
                              weight_decay=t["weight_decay"], dlossw=t["dlossw"]), Rounding(torch.float32))
    assert _convs(fc) == cfg["batch_size"] * train_flops_per_sample(cfg)
