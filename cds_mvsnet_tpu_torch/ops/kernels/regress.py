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

Bound on the H100: memory; about 48 / 159 / 159 MB per launch at stages
1/2/3 of the 1152x864 main path (y, the per-pixel hypotheses of stages 2/3,
two fp32 maps). Design: one thread per pixel; pass 1 runs an online max with
rescaled ``Σe``, ``Σe·d`` and ``Σe·j``; pass 2 recomputes the at most four
logits of the confidence window, so no D-long buffer exists. The 216 prob
weights sit in shared memory; the 27-fold reuse of y is left to the caches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sampling import confidence_regression, depth_regression
from . import _build
from ._launch import I, P, entry, on_card, ptr, require, stream

__all__ = ["exit_softargmin", "exit_softargmin_plain"]

C = 8


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
