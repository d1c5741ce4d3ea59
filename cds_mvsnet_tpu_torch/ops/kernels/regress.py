"""K3: exit fusion, the prob conv and the softmax/depth/confidence tail.

Replaces ``cds_mvsnet_tpu/ops/pallas/regress.py::exit_softargmin`` (:224,
bodies ``_exit_body`` :102, ``_exit_kernel`` :213, ``_exit_kernel_d`` :218).
Kernel source: ``csrc/regress.cu``.

Input: the UNet exit ``y (8, D, h, w)`` (conv0 + deconv11) in plain layout.
Per pixel: bias-free 3x3x3 8->1 logits over D, ``softmax_D``, depth
``Σ p·d`` over the true hypotheses and confidence = the mass in
``[idx-1, idx+2]`` at the truncated ``idx = Σ p·j``. The exact expectation
over the true hypotheses is the only mode at every stage: the TPU's affine
depth reconstruction is bounded, not exact, where refined windows are
partly clamped at the range ends.

Bound on the H100: memory and the CUDA cores alike; about 48 / 159 / 159 MB
per launch at stages 1/2/3 of the 1152x864 main path (y, the per-pixel
hypotheses of stages 2/3, two fp32 maps) and 2·216·D·h·w fp32 operations
(0.019 / 0.051 / 0.051 ms at 67 TFLOP/s; one output channel leaves the
tensor cores nothing to do). Design (``csrc/regress.cu``): a block owns a
tile of 64 columns (32 where D is large) x ``rows`` rows and every plane of
it. It walks the planes in chunks and, within a chunk, the 8 channels; each
(chunk, channel) is staged in shared memory as bf16 pairs, with a one-plane,
one-row and 8-column halo and zeros outside, by 16-byte asynchronous copies
issued three steps ahead, so the 216-tap loops run without branches and
the copies overlap the arithmetic. A thread computes ``DPT`` consecutive
planes of two adjacent pixels, rolling three planes' 3x4 windows through
registers: one shared load feeds up to six FMAs (three planes, two
pixels). Each logit is one fp32 FMA chain in the order ``(c, kd, ky, kx)``
from 0, as the first CUDA form summed it (which skipped the taps outside
the volume: the logits agree up to the sign of a zero). The logits stay in
shared memory; then ``256 / pixels`` lanes per pixel reduce the max,
``Σe``, ``Σe·d`` and ``Σe·j`` over D with shuffles (another order of the
sums than the plain softmax: fp32 rounding of the depth), and the first
reads the at most four window logits back. The tile shrinks as D grows so
that its logits fit (the launcher picks it; its C entry
``exit_softargmin_tile`` reports the tile and how many blocks an SM holds,
``tools/time_exit.py`` prints them), and D past :data:`MAX_D` is refused.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sampling import confidence_regression, depth_regression
from . import _build
from ._launch import I, P, entry, on_card, ptr, require, stream

__all__ = ["exit_softargmin", "exit_softargmin_plain", "MAX_D"]

C = 8
MAX_D = 1024  # the most planes the wrapper takes; every D of the entry points fits


def exit_softargmin_plain(y: torch.Tensor, w_prob: torch.Tensor, hyp: torch.Tensor):
    """Plain version: fp32 logits, fp32 softmax and regressions."""
    logits = F.conv3d(y.float()[None], w_prob.float(), padding=1)[0, 0]  # (D, h, w)
    prob = torch.softmax(logits, 0)[None]
    depth = depth_regression(prob, hyp.float()[None])[0]
    conf = confidence_regression(prob)[0]
    return depth, conf


def exit_softargmin(y: torch.Tensor, w_prob: torch.Tensor, hyp: torch.Tensor):
    """``y (8, D, h, w)`` bf16, ``w_prob (1, 8, 3, 3, 3)`` fp32, ``hyp (D,)``
    or ``(D, h, w)`` fp32 -> ``(depth (h, w), conf (h, w))`` fp32."""
    require(y.ndim == 4 and y.shape[0] == C, f"exit_softargmin: y {tuple(y.shape)}")
    _, D, h, w = y.shape
    require(tuple(w_prob.shape) == (1, C, 3, 3, 3), f"exit_softargmin: w_prob {tuple(w_prob.shape)}")
    require(tuple(hyp.shape) in ((D,), (D, h, w)), f"exit_softargmin: hyp {tuple(hyp.shape)}")
    require(y.dtype == torch.bfloat16, "exit_softargmin: y must be bf16")
    require(w_prob.dtype == hyp.dtype == torch.float32, "exit_softargmin: w_prob and hyp must be fp32")
    require(all(t.is_contiguous() for t in (y, w_prob, hyp)), "exit_softargmin: inputs must be contiguous")
    require(1 <= D <= MAX_D, f"exit_softargmin: D={D} planes, the kernel takes 1 to MAX_D={MAX_D}")
    if not on_card("exit_softargmin", y, w_prob, hyp):
        return exit_softargmin_plain(y, w_prob, hyp)
    depth = torch.empty((h, w), dtype=torch.float32, device=y.device)
    conf = torch.empty((h, w), dtype=torch.float32, device=y.device)
    lib, fn = entry("regress", "exit_softargmin_launch", [P, P, P, I, P, P, I, I, I, P])
    err = fn(ptr(y), ptr(w_prob), ptr(hyp), int(hyp.ndim == 3), ptr(depth), ptr(conf),
             D, h, w, stream(y.device))
    _build.check(lib, err, "exit_softargmin")
    exit_softargmin.launches += 1
    return depth, conf


exit_softargmin.launches = 0
