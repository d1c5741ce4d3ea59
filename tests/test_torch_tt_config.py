"""The Tanks and Temples configuration of the benchmark (``tt-eval``):
the port's plain fp32 forward at its kind (10 views, no refinement, 48/32/8
planes over a 256-interval range) against the plain reference
(``mvsbench/reference/model.py``) at a small size, the cell's shapes, and
K4's least-time count (``mvsbench/roofline/k4.py``) against an independent
count."""

from __future__ import annotations

import copy

import pytest
import torch
import torch.nn.functional as F

from mvsbench import program
from mvsbench.harness import load_cell
from mvsbench.inputs.synthetic import plane_scenes
from mvsbench.reference.model import Rounding, eval_cascade
from mvsbench.roofline import k4
from mvsbench.roofline.shapes import stages
from mvsbench.weights import seeded_state

torch.set_num_threads(2)

STAGES = ("stage1", "stage2", "stage3")
# Both sides compute the same fp32 function; they differ in the order of
# sums and in the geometry (the reference takes its homographies in fp64),
# which moved a depth by 1.5e-4 to 3.7e-4 of an interval (a dozen fp32 ulps
# of a depth near 600) and a confidence by at most 3e-6 over three seeds. A
# depth within 2e-3 of a plane interval, a confidence within 1e-4: the
# reference with bf16 storage (the cell's precision) read 0.56 to 1.4
# intervals and 1.2e-3 to 9.5e-3 on the same seeds, and so fails (asserted
# below).
DEPTH_TOL = 2e-3
CONF_TOL = 1e-4


def _small(cfg: dict) -> dict:
    c = copy.deepcopy(cfg)
    c.update(height=64, width=96)
    return c


def _gaps(got, want, interval) -> dict:
    out = {}
    for s in STAGES:
        out[f"depth.{s}"] = float((got[s]["depth"] - want[s]["depth"]).abs().max()) / interval
        out[f"conf.{s}"] = float((got[s]["photometric_confidence"] - want[s]["photometric_confidence"]).abs().max())
    return out


def _within(gaps) -> bool:
    return all(v <= (DEPTH_TOL if k.startswith("depth") else CONF_TOL) for k, v in gaps.items())


@pytest.fixture(scope="module")
def tt():
    cell = load_cell("tt-eval.offline")
    cfg = _small(cell.config)
    gen = torch.Generator().manual_seed(2**31 + 23)
    P = seeded_state(program.parameter_shapes(cfg), gen)
    sc = plane_scenes(1, cfg["views"], cfg["height"], cfg["width"], cfg["numdepth"], cfg["depth_min"],
                      cfg["interval"], cfg["model"]["refine"], gen)
    return cfg, P, (sc["imgs"], sc["proj_matrices"], sc["depth_values"])


def test_the_cell_is_the_tt_protocol():
    cell = load_cell("tt-eval.offline")
    cfg = cell.config
    assert (cell.chips, cfg["views"], cfg["numdepth"], cfg["model"]["refine"]) == (1, 10, 256, False)
    assert [(d, h, w) for _, d, h, w in stages(cfg)] == [(48, 272, 480), (32, 544, 960), (8, 1088, 1920)]
    assert cell.traffic["batch"] == 2 and cell.traffic["driver"] == "eval"
    assert {m["name"] for m in cell.end_to_end} == {"maps_per_s", "setup_s"}


def test_the_ports_fp32_forward_matches_the_reference(tt):
    cfg, P, args = tt
    model = program.build_model(cfg, P, "cpu")
    got = model(*args, temperature=cfg["temperature"], compute_dtype=torch.float32, kernels=False)
    assert torch.equal(got["refined_depth"], got["stage3"]["depth"])  # no refinement
    want = eval_cascade(P, *args, cfg["temperature"], cfg["model"], Rounding(torch.float32))
    gaps = _gaps(got, want, cfg["interval"])
    assert _within(gaps), gaps
    # the tolerances hold the port to fp32: the reference with bf16 storage fails them
    bf16 = eval_cascade(P, *args, cfg["temperature"], cfg["model"], Rounding(torch.bfloat16))
    assert not _within(_gaps(bf16, want, cfg["interval"]))


@pytest.mark.parametrize("H, W, k, stride", [(7, 9, 3, 1), (6, 11, 5, 1), (5, 4, 7, 1), (9, 8, 3, 2), (13, 12, 11, 1)])
def test_k4_in_bounds_taps_match_a_convolution_of_ones(H, W, k, stride):
    """Counted independently: a conv of ones with ones over a zero-padded
    input sums, at each output pixel, the taps that land inside."""
    ones = F.conv2d(torch.ones(1, 1, H, W, dtype=torch.float64), torch.ones(1, 1, k, k, dtype=torch.float64),
                    stride=stride, padding=k // 2)
    assert k4.in_bounds_taps(H, W, k, stride) == int(ones.sum())


def test_k4_counts_each_in_bounds_multiply_add_once():
    """The operations of one K4 call at a tiny shape, against FLOPs counted
    on the layer's plain version with the padding's taps taken out."""
    N, I, OA, ks, H, W = 2, 8, 11, (3, 5, 7), 6, 10
    nbytes, ops = k4.k4_bytes_ops(N, H, W, I, OA, ks)
    dense = sum(2 * N * H * W * OA * I * k * k for k in ks)
    pad = 0
    for k in ks:
        inside = F.conv2d(torch.ones(1, 1, H, W), torch.ones(1, 1, k, k), padding=k // 2).sum()
        pad += 2 * N * OA * I * int(H * W * k * k - inside)
    assert ops == dense - pad
    assert nbytes == N * I * H * W * 2 + sum(OA * I * k * k * 4 for k in ks) + N * len(ks) * OA * H * W * 2
    cfg = load_cell("tt-eval.offline").config
    b, o = k4.k4_bytes_ops(18, 1088, 1920, *k4.CONV01)
    assert k4.least_seconds_per_map(cfg) == max(b / 3.35e12, o / 67e12)
    assert o < 2 * 18 * 1088 * 1920 * 11 * 8 * (9 + 25 + 49)
