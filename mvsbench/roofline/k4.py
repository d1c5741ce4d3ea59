"""K4's (``dynconv_branches``) bytes and operations a map, from the
configuration's shapes: ``chip_smoke.py``'s K4 reckoning at the cascade's
full resolution (``stages(cfg)``'s last stage) over the 2(V-1) FeatureNet
images of a map.

K4 runs the FeatureNet's conv01 on the eval path (the port's default
feature route): a bf16 input of I = 8 channels and three branches, k = 3,
5 and 7, each with OA = 8 + 3 output channels (the conv and its curvature
coefficients), fp32 weights, bf16 outputs. Its least time is the larger of

- bytes: the input, the weights and the output, each once, at the HBM
  rate; and
- operations: two (an FMA) for each multiply-add that every implementation
  of the layer has to do, at the fp32 FMA peak. The layer's contract keeps
  each output the fp32 chain over (channel, ky, kx) that its plain version
  computes (bit for bit), so it runs on the CUDA cores; a tap that falls
  outside the image multiplies a zero of the padding and may be skipped.
  So the count is ``N x OA x I x (in-bounds taps)``, where the in-bounds
  taps of a k x k branch are ``sum over (dy, dx) of (H - |dy|)(W - |dx|)``:
  the dense count ``N x H x W x OA x I x k^2`` less the padding's. No
  implementation, skipping the padding or not, does fewer.

The roofline share is this least time times the traced maps over the
device time of ``dynconv_kernel`` in the trace.
"""

from __future__ import annotations

from . import peaks
from .shapes import stages

__all__ = ["CONV01", "KERNEL_NAMES", "in_bounds_taps", "k4_bytes_ops", "least_seconds_per_map"]

KERNEL_NAMES = ("dynconv_kernel",)
# conv01 as K4 runs it: input channels, outputs a branch, branch kernel sizes, stride
CONV01 = (8, 11, (3, 5, 7), 1)


def _out(n: int, stride: int) -> int:
    return (n - 1) // stride + 1


def in_bounds_taps(H: int, W: int, k: int, stride: int = 1) -> int:
    """The (output pixel, tap) pairs of a k x k conv with padding k // 2
    whose input pixel lies inside ``H x W``."""
    r = k // 2

    def along(n):
        no = _out(n, stride)
        return sum(sum(1 for i in range(no) if 0 <= i * stride + d < n) for d in range(-r, r + 1))

    return along(H) * along(W)


def k4_bytes_ops(N: int, H: int, W: int, I: int, OA: int, ks, stride: int = 1) -> tuple[int, int]:
    """``(bytes, operations)`` of one K4 call over ``N`` images."""
    Ho, Wo = _out(H, stride), _out(W, stride)
    nbytes = N * I * H * W * 2 + sum(OA * I * k * k * 4 for k in ks) + N * len(ks) * OA * Ho * Wo * 2
    ops = 2 * N * OA * I * sum(in_bounds_taps(H, W, k, stride) for k in ks)
    return nbytes, ops


def least_seconds_per_map(cfg: dict) -> float:
    """K4's least time a map: conv01 over the map's 2(V-1) images."""
    _, _, h, w = stages(cfg)[-1]
    I, OA, ks, stride = CONV01
    nbytes, ops = k4_bytes_ops(2 * (cfg["views"] - 1), h, w, I, OA, ks, stride)
    return max(nbytes / peaks.BYTES_PER_S, ops / peaks.FP32_FLOPS)
