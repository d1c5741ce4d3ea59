"""K5: the fused plane-sweep warp for training, forward and backward.

Replaces ``cds_mvsnet_tpu/ops/pallas/warp_vjp.py::fused_warp_train``
(custom_vjp :74-107). Its forward is K1's TPU kernel in sim mode
(``warp_pallas_v8(..., emit_entropy=False)`` :53-56, ``pl.pallas_call`` at
``warp.py:1419``); its backward (:92-104) is the VJP of the bilinear gather,
which the JAX package leaves to XLA. Kernel sources: ``csrc/warp.cu``
(forward, ``warp_kernel<C>``) and ``csrc/warp_vjp.cu`` (backward,
``warp_sim_backward_kernel<C>`` and a finishing kernel); both include
``csrc/warp.cuh``.

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
10.5 MB per launch at the sweeps of stages 1/2/3 of the 512x640 train path
(B·(V−1) sweeps and as many one-plane GT warps per stage); the backward
reads a cotangent of the same size. Design (:func:`launch_plan`): the grid
is pixel tiles × plane chunks, so that the train shapes (5,120 to 81,920
pixels) fill the card: a block of 256 threads owns consecutive pixels of
the flattened reference, a pixel's channels split over lanes (16 channels a
lane in the forward, as K1, and 8 in the backward), and a chunk holds as
many planes as still leave two waves of blocks (528) where D allows. Both
kernels project, weight and gather with the plain version's fp32 roundings
(``csrc/warp.cuh``: ``gather_lane<V, true>`` rounds op by op, K1's fuses),
so the forward's ``in_prod`` and the backward's warped values equal the
plain version's bit for bit: at random weights the train step's gradients
move by 0.13 relative L2 when 2e-5 of the warped values sit one bf16 ulp
off, which would hide a faulty backward from the card's step check.
``in_prod`` leaves through shared memory in 16-byte evict-first stores (as
K1's), and its cotangent arrives the same way in 16-byte streaming loads;
``sim`` is the shuffle sum of a pixel's lanes. The backward keeps each
chunk's ``d_ref`` partial sums in registers and writes them to an fp32
scratch ``(chunks, C, h, w)``; a finishing kernel sums the partials in
chunk order and rounds them to bf16, so ``d_ref`` does not vary from run to
run. ``d_src`` takes ``w_k·g·ref`` from every pixel tile whose projections
land on a source pixel, so its sums cross blocks; global atomics, at about
80 G a second on the H100, set the pace of a kernel that adds every term
(PERF.md). But a pixel's projection moves by a fraction of a source pixel
from one plane to the next, so each lane sums its four corners in registers
while they stay put, adds them to ``d_src`` only when they move, and at the
chunk's end hands the corners it shares with the pixel to its right to that
pixel's lane. The adds are in fixed point, so that ``d_src`` is the same in
every run, as the JAX package's XLA gather VJP is: a first pass reduces
``max|g_in_prod|``, ``max|g_sim|`` and ``max|ref|`` on the card, which
bound every source value's sum of ``|terms|`` by ``B = D·h·w·(max|g_in_prod|
+ max|g_sim|)·max|ref|``; each flushed fp32 sum is scaled by ``2^S``, ``S =
61 − ilogb(B)`` (the largest with ``B·2^S < 2^62``, chosen on the card with
no host sync), rounded to an int64 and added with 64-bit integer atomics,
whose order does not change the bits; the finishing kernel turns each int64
to fp32 (one rounding), scales it by ``2^-S`` and rounds it to bf16
(``tests/test_torch_k5_fixed_point.py`` models the arithmetic in plain
PyTorch). Non-finite inputs or
sums give a NaN ``d_src``. The card check compares with the plain version
within a tolerance: the plain version's fp32 ``index_add_`` rounds each add.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import I, P, entry, on_card, ptr, require, stream
from .warp import CHANNELS, _chunk, check_inputs, project, warp_sim_plain

__all__ = [
    "FusedWarpTrain",
    "fused_warp_train",
    "launch_plan",
    "card_plan",
    "warp_sim",
    "warp_sim_plain",
    "warp_sim_backward",
    "warp_sim_backward_plain",
]

THREADS = 256  # a block of K5's kernels (lanes::kThreads in csrc/warp.cuh)
TARGET_BLOCKS = 2 * 2 * 132  # k5::kTargetBlocks: two waves of two blocks on 132 SMs


def launch_plan(C: int, D: int, h: int, w: int, kernel: str) -> dict:
    """K5's launch plan for ``kernel`` ("forward" or "backward") as
    ``csrc/warp.cuh`` (``lanes``, ``k5``) and ``csrc/warp_vjp.cu``
    (``k5::BwdTile``) make it: ``lanes`` a pixel (channels in lanes of 16,
    of 8 at C = 8 and in the backward), the ``pixels`` of a block
    (consecutive in the flattened reference) and of each of its warps
    (``warp_pixels``), the pixel ``tiles`` and the last one's ``tail``, the
    ``chunk`` of planes a block and the ``chunks`` of D (the last one
    ``last_chunk`` planes), the ``blocks``, the ``shared_bytes`` of a block
    (two buffers of one plane's ``(C, warp_pixels)`` bf16 sub-tile a warp),
    the backward's fp32 ``d_ref`` scratch (``scratch_bytes``, 0 in the
    forward), and whether the ``(c, d)`` rows of ``in_prod`` and its
    cotangent take 16-byte vectors (``vector_io``)."""
    require(kernel in ("forward", "backward"), f"launch_plan: kernel {kernel!r}")
    require(C in CHANNELS, f"launch_plan: C={C} not in {CHANNELS}")
    require(D >= 1 and h * w >= 1, f"launch_plan: D={D}, h x w = {h} x {w}")
    lanes = C // (8 if kernel == "backward" or C == 8 else 16)
    pixels = THREADS // lanes
    tiles = -(-h * w // pixels)
    want = min(D, -(-TARGET_BLOCKS // tiles))  # chunks wanted
    chunk = D // want
    chunks = -(-D // chunk)
    return {"lanes": lanes, "pixels": pixels, "warp_pixels": 32 // lanes, "tiles": tiles,
            "tail": h * w - (tiles - 1) * pixels, "chunk": chunk, "chunks": chunks,
            "last_chunk": D - (chunks - 1) * chunk, "blocks": tiles * chunks, "shared_bytes": 2 * C * pixels * 2,
            "scratch_bytes": chunks * C * h * w * 4 if kernel == "backward" else 0, "vector_io": h * w % 8 == 0}


def card_plan(kernel: str, C: int, D: int, h: int, w: int) -> dict:
    """The launcher's own plan on the card (``warp_sim_plan`` or
    ``warp_sim_backward_plan``, by ``kernel`` "forward" or "backward"): the
    keys of :func:`launch_plan` that it sets, the ``registers`` a thread and
    the resident ``blocks_per_sm``."""
    keys = ["lanes", "pixels", "chunk", "chunks", "blocks", "registers", "blocks_per_sm", "shared_bytes"]
    lib_name, fn_name = {"forward": ("warp", "warp_sim_plan"),
                         "backward": ("warp_vjp", "warp_sim_backward_plan")}[kernel]
    if kernel == "backward":
        keys.append("scratch_bytes")
    out = (ctypes.c_int * len(keys))()
    lib, fn = entry(lib_name, fn_name, [I, I, I, I, P])
    _build.check(lib, fn(C, D, h, w, ctypes.cast(out, P)), fn_name)
    return dict(zip(keys, list(out)))


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
    chunks = launch_plan(C, D, h, w, "backward")["chunks"]
    # d_src's fixed-point sums and the launcher's four 32-bit words, zeroed by the launcher
    acc = torch.empty((H * W * C + 2,), dtype=torch.int64, device=src.device)
    part = torch.empty((chunks, C, h, w), dtype=torch.float32, device=src.device)
    d_src = torch.empty((H, W, C), dtype=torch.bfloat16, device=src.device)
    d_ref = torch.empty((C, h, w), dtype=torch.bfloat16, device=src.device)
    lib, fn = entry("warp_vjp", "warp_sim_backward_launch",
                    [P, P, P, I, P, P, P, P, P, I, P, P, I, I, I, I, I, I, P])
    err = fn(ptr(src), ptr(ref), ptr(depth), int(depth.ndim == 3), ptr(rt), ptr(g_in_prod), ptr(g_sim),
             ptr(acc), ptr(part), chunks, ptr(d_src), ptr(d_ref), C, H, W, D, h, w, stream(src.device))
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
