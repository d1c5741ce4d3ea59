"""K5: the fused plane-sweep warp for training, forward and backward.

Replaces ``cds_mvsnet_tpu/ops/pallas/warp_vjp.py::fused_warp_train``
(custom_vjp :74-107). Its forward is K1's TPU kernel in sim mode
(``warp_pallas_v8(..., emit_entropy=False)`` :53-56, ``pl.pallas_call`` at
``warp.py:1419``); its backward (:92-104) is the VJP of the bilinear gather,
which the JAX package leaves to XLA. Kernel sources: ``csrc/warp.cu``
(forward: one thread a pixel, the sim epilogue, ``warp_kernel<C>``)
and ``csrc/warp_vjp.cu`` (backward); both include ``csrc/warp.cuh``.

- :func:`warp_sim` ``(src (H,W,C), ref (C,h,w), depth, rt) -> (in_prod
  (C,D,h,w) bf16, sim (D,h,w) fp32)``: K1 with ``sim = Σ_C ref·warped``
  stored per plane instead of folded into the entropy. K1's numerics: fp32
  bilinear weights, the warped value rounded to bf16 before the product.
- :func:`warp_sim_backward` ``(..., g_in_prod, g_sim) -> (d_src (H,W,C),
  d_ref (C,h,w))``: with ``g = g_in_prod[c] + g_sim`` per plane, ``d_ref[c]
  = Σ_d g·warped[c]`` and ``d_src[corner] += w_k·g·ref[c]``; corners out of
  bounds contribute nothing. The depth and the cameras get no gradient: the
  reference builds its sweep grid under ``no_grad``.
- :class:`FusedWarpTrain` ties the two. It saves ``(src, ref, depth, rt)``
  and no ``(C, D, h, w)`` volume: the backward recomputes the gather.

Bound on the H100: memory. The forward writes ``in_prod``, 15.7 / 21.0 /
10.5 MB per launch at stages 1/2/3 of the 512x640 train path (B·(V−1)
sweeps and as many one-plane GT warps per stage); the backward reads a
cotangent of the same size. Design of the backward: one thread per
reference pixel loops over the planes as the forward does, recomputes the
four corners, weights and the bf16 warped value, keeps ``d_ref`` in
registers (no atomics), and adds ``w_k·g·ref`` into an fp32 ``d_src`` with
16-byte vector atomics, which the source map (0.3-2.6 MB) keeps in L2; a
second small kernel rounds ``d_src`` to bf16. Both kernels project, weight
and gather with the plain version's fp32 roundings (``csrc/warp.cuh``;
K1 fuses its gather's multiply-adds), so the forward's ``in_prod`` and the
backward's warped values equal the plain version's bit for bit: at random
weights the train step's gradients move by 0.13 relative L2 when 2e-5 of the
warped values sit one bf16 ulp off, which would hide a faulty backward from
the card's step check. Atomics make
the order of additions, and so the last bits of ``d_src``, vary from run to
run: the card check compares with the plain version within a tolerance, not
bit for bit.
"""

from __future__ import annotations

import torch

from . import _build
from ._launch import I, P, entry, on_card, ptr, require, stream
from .warp import _chunk, check_inputs, project, warp_sim_plain

__all__ = [
    "FusedWarpTrain",
    "fused_warp_train",
    "warp_sim",
    "warp_sim_plain",
    "warp_sim_backward",
    "warp_sim_backward_plain",
]


def warp_sim(src: torch.Tensor, ref: torch.Tensor, depth: torch.Tensor, rt: torch.Tensor):
    """K5's forward for one source view.

    Args:
      src: ``(H, W, C)`` bf16 channels-last source features, C in 8/16/32.
      ref: ``(C, h, w)`` bf16 reference features.
      depth: ``(D,)`` planes or ``(D, h, w)`` per-pixel hypotheses, fp32.
      rt: ``(12,)`` fp32, the row-major rotation then the translation of
        ``ops.geometry.relative_warp_transform``.
    Returns:
      ``(in_prod (C, D, h, w) bf16, sim (D, h, w) fp32)``.
    """
    check_inputs("warp_sim", src, ref, depth, rt)
    if not on_card("warp_sim", src, ref, depth, rt):
        return warp_sim_plain(src, ref, depth, rt)
    require(src.data_ptr() % 16 == 0, "warp_sim: src must be 16-byte aligned")
    H, W, C = src.shape
    _, h, w = ref.shape
    D = depth.shape[0]
    in_prod = torch.empty((C, D, h, w), dtype=torch.bfloat16, device=src.device)
    sim = torch.empty((D, h, w), dtype=torch.float32, device=src.device)
    lib, fn = entry("warp", "warp_sim_launch", [P, P, P, I, P, P, P, I, I, I, I, I, I, P])
    err = fn(ptr(src), ptr(ref), ptr(depth), int(depth.ndim == 3), ptr(rt), ptr(in_prod), ptr(sim),
             C, H, W, D, h, w, stream(src.device))
    _build.check(lib, err, "warp_sim")
    warp_sim.launches += 1
    return in_prod, sim


def warp_sim_backward_plain(src, ref, depth, rt, g_in_prod, g_sim):
    """Plain version of :func:`warp_sim_backward`: the gather recomputed,
    then ``index_add_`` of the weighted cotangents into an fp32 ``d_src``."""
    H, W, C = src.shape
    _, h, w = ref.shape
    D = depth.shape[0]
    src_flat = src.float().reshape(H * W, C)
    ref_t = ref.float().permute(1, 2, 0)  # (h, w, C)
    d_src = torch.zeros((H * W, C), dtype=torch.float32, device=src.device)
    d_ref = torch.zeros((h, w, C), dtype=torch.float32, device=src.device)
    step = _chunk(D, h, w, C)
    for d0 in range(0, D, step):
        px, py = project(rt, depth[d0 : d0 + step], h, w)
        n = px.numel()
        x0, y0 = torch.floor(px), torch.floor(py)
        tx, ty = px - x0, py - y0
        g = (g_in_prod[:, d0 : d0 + step].float() + g_sim[None, d0 : d0 + step].float()).permute(1, 2, 3, 0)
        gw = (g * ref_t).reshape(n, C)  # cotangent of the warped value
        warped = torch.zeros((n, C), dtype=torch.float32, device=src.device)
        for ox, oy, wk in ((0, 0, (1 - tx) * (1 - ty)), (1, 0, tx * (1 - ty)),
                           (0, 1, (1 - tx) * ty), (1, 1, tx * ty)):
            xi, yi = x0 + ox, y0 + oy
            inb = ((xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)).reshape(n)
            idx = torch.where(inb, (yi * W + xi).reshape(n), 0).to(torch.int64)
            wk = torch.where(inb, wk.reshape(n), 0)[:, None]
            warped += src_flat[idx] * wk
            d_src.index_add_(0, idx, gw * wk)
        warped = warped.to(src.dtype).float().reshape(g.shape)  # as the forward rounded it
        d_ref += (g * warped).sum(0)
    return d_src.reshape(H, W, C).to(src.dtype), d_ref.permute(2, 0, 1).contiguous().to(ref.dtype)


def warp_sim_backward(src, ref, depth, rt, g_in_prod, g_sim):
    """K5's backward: ``(d_src (H, W, C), d_ref (C, h, w))``, bf16, from the
    forward's inputs and the cotangents ``g_in_prod (C, D, h, w)`` bf16 and
    ``g_sim (D, h, w)`` fp32."""
    check_inputs("warp_sim_backward", src, ref, depth, rt)
    H, W, C = src.shape
    _, h, w = ref.shape
    D = depth.shape[0]
    require(tuple(g_in_prod.shape) == (C, D, h, w) and g_in_prod.dtype == torch.bfloat16,
            f"warp_sim_backward: g_in_prod {tuple(g_in_prod.shape)} {g_in_prod.dtype}")
    require(tuple(g_sim.shape) == (D, h, w) and g_sim.dtype == torch.float32,
            f"warp_sim_backward: g_sim {tuple(g_sim.shape)} {g_sim.dtype}")
    require(g_in_prod.is_contiguous() and g_sim.is_contiguous(), "warp_sim_backward: inputs must be contiguous")
    if not on_card("warp_sim_backward", src, ref, depth, rt, g_in_prod, g_sim):
        return warp_sim_backward_plain(src, ref, depth, rt, g_in_prod, g_sim)
    require(src.data_ptr() % 16 == 0, "warp_sim_backward: src must be 16-byte aligned")
    acc = torch.zeros((H, W, C), dtype=torch.float32, device=src.device)
    d_src = torch.empty((H, W, C), dtype=torch.bfloat16, device=src.device)
    d_ref = torch.empty((C, h, w), dtype=torch.bfloat16, device=src.device)
    lib, fn = entry("warp_vjp", "warp_sim_backward_launch",
                    [P, P, P, I, P, P, P, P, P, P, I, I, I, I, I, I, P])
    err = fn(ptr(src), ptr(ref), ptr(depth), int(depth.ndim == 3), ptr(rt), ptr(g_in_prod), ptr(g_sim),
             ptr(acc), ptr(d_src), ptr(d_ref), C, H, W, D, h, w, stream(src.device))
    _build.check(lib, err, "warp_sim_backward")
    warp_sim_backward.launches += 1
    return d_src, d_ref


warp_sim.launches = 0
warp_sim_backward.launches = 0


class FusedWarpTrain(torch.autograd.Function):
    """:func:`warp_sim` with :func:`warp_sim_backward` as its gradient, in
    ``src`` and ``ref`` only. CUDA tensors launch the kernels, CPU tensors
    take the plain versions; anything else raises."""

    @staticmethod
    def forward(ctx, src, ref, depth, rt):
        ctx.save_for_backward(src, ref, depth, rt)
        return warp_sim(src, ref, depth, rt)

    @staticmethod
    def backward(ctx, g_in_prod, g_sim):
        src, ref, depth, rt = ctx.saved_tensors
        d_src, d_ref = warp_sim_backward(src, ref, depth, rt, g_in_prod.contiguous(), g_sim.contiguous())
        return d_src, d_ref, None, None


def fused_warp_train(src, ref, depth, rt):
    """Differentiable :func:`warp_sim` (arguments as there)."""
    return FusedWarpTrain.apply(src, ref, depth, rt)
