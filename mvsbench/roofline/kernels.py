"""Each hand-written kernel's bytes and operations, computed from the
configuration's shapes (frozen from ``chip_smoke.py``'s reckonings and
PERF.md's "bound ms, by" column): every input byte read once, every output
byte written once. A kernel's least time is the larger of its bytes at the
HBM rate and its operations at the peak of their type; its roofline share
is that least time over its device time in the trace, summed over the
launches the traced work makes. Each entry names the kernels (by name in
the trace) whose device time it sums."""

from __future__ import annotations

from . import peaks
from .shapes import stages

__all__ = ["KERNELS", "least_seconds"]


def _k1(C, D, h, w, planes_1d: bool):
    hyp = D if planes_1d else D * h * w
    nbytes = h * w * C * 2 + C * h * w * 2 + hyp * 4 + 48 + C * D * h * w * 2 + h * w * 4
    return nbytes, D * h * w * (11 * C + 20), peaks.FP32_FLOPS


def _k2(C, D, h, w):
    nbytes = C * D * h * w * 2 + 8 * C * 27 * 4 + 32 + 8 * D * h * w * 2
    return nbytes, 2 * 27 * C * 8 * D * h * w, peaks.BF16_FLOPS


def _k5_backward(C, D, h, w, hyp):
    nbytes = (h * w * C * 2 + C * h * w * 2 + hyp * 4 + 48 + C * D * h * w * 2 + D * h * w * 4
              + h * w * C * 2 + C * h * w * 2)
    return nbytes, D * h * w * (20 * C + 12), peaks.FP32_FLOPS


def _least(calls) -> float:
    return sum(max(b / peaks.BYTES_PER_S, f / p) for b, f, p in calls)


def k1_per_map(cfg: dict) -> float:
    """K1 (``warp_entropy``): one launch a stage and source view."""
    V = cfg["views"]
    return _least(_k1(C, D, h, w, s == 0) for s, (C, D, h, w) in enumerate(stages(cfg)) for _ in range(V - 1))


def k2_per_map(cfg: dict) -> float:
    """K2 (``conv3d_bn_relu``, bf16): the cost volume's conv0, one launch a
    stage."""
    return _least(_k2(C, D, h, w) for C, D, h, w in stages(cfg))


def k5_backward_per_sample(cfg: dict) -> float:
    """K5's backward (``warp_sim_backward``): per sample, stage and source
    view, the sweep over the stage's planes and the warp at the ground
    truth (one plane a pixel)."""
    V = cfg["views"]
    calls = []
    for s, (C, D, h, w) in enumerate(stages(cfg)):
        for _ in range(V - 1):
            calls.append(_k5_backward(C, D, h, w, D if s == 0 else D * h * w))
            calls.append(_k5_backward(C, 1, h, w, h * w))
    return _least(calls)


# name -> (kernel names in the trace, least seconds per unit of work)
KERNELS = {
    "k1_warp_entropy": (("warp_entropy_kernel",), k1_per_map),
    "k2_conv3d_front": (("conv3d_mma_kernel",), k2_per_map),
    "k5_backward": (("warp_sim_backward",), k5_backward_per_sample),
}


def least_seconds(kernel: str, cfg: dict) -> float:
    return KERNELS[kernel][1](cfg)
