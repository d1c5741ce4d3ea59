"""K8: the fused plane-sweep warp from precomputed source-pixel coordinates.

- :func:`warp_sim_coords` ``(src (H,W,C), ref (C,h,w), px, py (D,h,w)) ->
  (in_prod (C,D,h,w) bf16, sim (D,h,w) fp32)`` for one source view: the
  bilinear sample ``warped`` of the source at ``(px, py)`` (K9's gather,
  zeros padding), rounded to bf16, then ``in_prod = ref ⊙ warped`` and
  ``sim = Σ_C f32(warped)·f32(ref)``.
- :func:`warp_sim_coords_batched`: the same with a leading view axis on all
  four inputs and both outputs, in one launch (the view is ``blockIdx.z``;
  the same body, so each view equals the per-view call bit for bit).

Replaces the px/py readers of the JAX package's fused warp family
(``cds_mvsnet_tpu/ops/pallas/warp.py``): ``warp_pallas_v6s`` (:1451 →
``pallas_call`` :1503; routes ``v6s`` and, with its DMA window cache,
``v6sc``), ``warp_pallas_v6sd`` (:764 → :791; route ``v6sd``, equal to
``v6s`` bit for bit) and ``warp_pallas_v6s_batched`` (:431 → :479; routes
``v6sb`` and ``v6sball``), bodies ``_warp_kernel_v6s`` (:276-398) and
``_warp_kernel_v6s_batched`` (:401-428). The members that compute their
coordinates in the kernel, ``warp_pallas_v7m`` (:1032 → :1090) and
``warp_pallas_v6sdc`` (:818 → :868), share K5's forward contract and run
``warp_vjp.warp_sim`` (``csrc/warp.cu``). Kernel source:
``csrc/warp_coords.cu``.

Bound on the H100: memory. Per view it reads px and py (fp32) and writes
``in_prod`` (bf16) and ``sim`` (fp32): about 235 / 366 / 255 MB per launch
at stages 1/2/3 of the 1152x864 main path (70 / 109 / 76 µs at 3.35 TB/s).
Design (:func:`launch_plan`): the grid is pixel tiles × plane chunks ×
views (the view on ``blockIdx.z``). A block of 128 threads owns 128
consecutive pixels of the flattened reference, one thread a pixel, and a
chunk holds as many planes as still leave 64 blocks an SM over all views,
but at least 8 where D allows (K5's ``k5::chunk_planes`` rule with a larger
target). A thread loads its pixel's px and py a plane ahead, picks the
corners and weights with ``footprint()`` (``csrc/warp.cuh``, op by op as the
plain version), gathers the C channels of each corner in 16-byte loads and
sums them op by op (``gather_lane<C / 8, true>``), so ``warped`` equals K9's
plain version bit for bit; a pair of warped values, and of ``in_prod``
values, is rounded to bf16 by one ``cvt.rn.bf16x2.f32``. A warp's threads
are 32 consecutive pixels, so each 2-byte evict-first ``in_prod`` store of
a warp writes 64 contiguous bytes of a ``(c, d)`` row. Both entry points
run this one body, so each view of the batched call equals the per-view
call bit for bit. Measured against that form on the card (``PERF.md``):
channel lanes with ``in_prod`` staged through shared memory (K1's and K5's
forward tile) ran 7-25 % slower, 256-thread blocks up to 5 %, evict-first
px/py loads 1-4 %, chunks of two waves 1-9 %. The TPU's x-pair bit
packing, band DMA, ``ky``/``kd`` tiling and window cache (``dma_cache``,
``tag_ref``) are Mosaic mechanics and are not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import I, P, entry, on_card, ptr, require, stream
from .gather import warp_gather_plain

__all__ = ["warp_sim_coords", "warp_sim_coords_plain", "warp_sim_coords_batched", "warp_sim_coords_batched_plain",
           "launch_plan", "card_plan"]

CHANNELS = (8, 16, 32)
# csrc/warp_coords.cu, namespace k8: a block's threads (one a pixel); the
# chunk rule's target, 64 blocks on each of 132 SMs, and its least planes
THREADS = 128
TARGET_BLOCKS = 64 * 132
MIN_PLANES = 8


def launch_plan(V: int, C: int, D: int, h: int, w: int) -> dict:
    """K8's launch plan over ``V`` views as ``csrc/warp_coords.cu`` (``k8``,
    ``coords_grid``) makes it: the ``pixels`` of a block (consecutive in the
    flattened reference, one thread each), the pixel ``tiles`` of a view and
    the last one's ``tail``, the ``chunk`` of planes a block
    (``k8::chunk_planes`` over the tiles of every view: as many chunks as
    give ``TARGET_BLOCKS`` blocks, but at least 8 planes each where D
    allows), the ``chunks`` of D (the last one ``last_chunk`` planes) and
    the ``blocks`` over all views."""
    require(C in CHANNELS, f"launch_plan: C={C} not in {CHANNELS}")
    require(V >= 1 and D >= 1 and h * w >= 1, f"launch_plan: V={V}, D={D}, h x w = {h} x {w}")
    tiles = -(-h * w // THREADS)
    want = min(D, -(-TARGET_BLOCKS // (tiles * V)))  # chunks wanted
    chunk = max(D // want, min(D, MIN_PLANES))
    chunks = -(-D // chunk)
    return {"pixels": THREADS, "tiles": tiles, "tail": h * w - (tiles - 1) * THREADS, "chunk": chunk,
            "chunks": chunks, "last_chunk": D - (chunks - 1) * chunk, "blocks": tiles * chunks * V}


def card_plan(V: int, C: int, D: int, h: int, w: int) -> dict:
    """The launcher's own plan on the card (``warp_sim_coords_plan``): the
    keys of :func:`launch_plan` that it sets, the ``registers`` a thread and
    the resident ``blocks_per_sm``."""
    keys = ["pixels", "chunk", "chunks", "blocks", "registers", "blocks_per_sm"]
    out = (ctypes.c_int * len(keys))()
    lib, fn = entry("warp_coords", "warp_sim_coords_plan", [I, I, I, I, I, P])
    _build.check(lib, fn(V, C, D, h, w, ctypes.cast(out, P)), "warp_sim_coords_plan")
    return dict(zip(keys, list(out)))


def warp_sim_coords_plain(src, ref, px, py):
    """Plain version: :func:`warp_gather_plain`, the product with ``ref``
    and the C-sum of the fp32 products."""
    warped = warp_gather_plain(src, px, py)  # (C, D, h, w) in src's dtype
    return ref[:, None] * warped, (warped.float() * ref.float()[:, None]).sum(0)


def warp_sim_coords_batched_plain(src, ref, px, py):
    """Plain version of :func:`warp_sim_coords_batched`, view by view."""
    outs = [warp_sim_coords_plain(*args) for args in zip(src, ref, px, py)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _check(name: str, src, ref, px, py) -> None:
    """Both entry points' contract, on tensors with a leading view axis."""
    require(src.ndim == 4 and src.shape[3] in CHANNELS, f"{name}: src {tuple(src.shape)} (C in {CHANNELS})")
    V, _, _, C = src.shape
    require(ref.ndim == 4 and ref.shape[:2] == (V, C), f"{name}: ref {tuple(ref.shape)} for C={C}")
    h, w = ref.shape[2:]
    require(px.ndim == 4 and px.shape[0] == V and px.shape[2:] == (h, w) and px.shape == py.shape,
            f"{name}: px {tuple(px.shape)}, py {tuple(py.shape)} for ref {tuple(ref.shape)}")
    require(src.dtype == ref.dtype == torch.bfloat16, f"{name}: src and ref must be bf16")
    require(px.dtype == py.dtype == torch.float32, f"{name}: px and py must be fp32")
    require(all(t.is_contiguous() for t in (src, ref, px, py)), f"{name}: inputs must be contiguous")


def _launch(name: str, src, ref, px, py):
    V, H, W, C = src.shape
    D, h, w = px.shape[1:]
    require(src.data_ptr() % 16 == 0, f"{name}: src must be 16-byte aligned")
    in_prod = torch.empty((V, C, D, h, w), dtype=torch.bfloat16, device=src.device)
    sim = torch.empty((V, D, h, w), dtype=torch.float32, device=src.device)
    lib, fn = entry("warp_coords", "warp_sim_coords_launch", [P, P, P, P, P, P, I, I, I, I, I, I, I, P])
    err = fn(ptr(src), ptr(ref), ptr(px), ptr(py), ptr(in_prod), ptr(sim), V, C, H, W, D, h, w, stream(src.device))
    _build.check(lib, err, name)
    return in_prod, sim


def warp_sim_coords(src: torch.Tensor, ref: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """One source view: ``src (H, W, C)`` bf16 channels-last, C in 8/16/32,
    ``ref (C, h, w)`` bf16, ``px, py (D, h, w)`` fp32 source-pixel
    coordinates -> ``(in_prod (C, D, h, w) bf16, sim (D, h, w) fp32)``."""
    _check("warp_sim_coords", src[None], ref[None], px[None], py[None])
    if not on_card("warp_sim_coords", src, ref, px, py):
        return warp_sim_coords_plain(src, ref, px, py)
    in_prod, sim = _launch("warp_sim_coords", src[None], ref[None], px[None], py[None])
    warp_sim_coords.launches += 1
    return in_prod[0], sim[0]


def warp_sim_coords_batched(src: torch.Tensor, ref: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """All source views of a stage in one launch: the arguments of
    :func:`warp_sim_coords` with a leading view axis -> ``(in_prod (V, C, D,
    h, w), sim (V, D, h, w))``."""
    _check("warp_sim_coords_batched", src, ref, px, py)
    if not on_card("warp_sim_coords_batched", src, ref, px, py):
        return warp_sim_coords_batched_plain(src, ref, px, py)
    in_prod, sim = _launch("warp_sim_coords_batched", src, ref, px, py)
    warp_sim_coords_batched.launches += 1
    return in_prod, sim


warp_sim_coords.launches = 0
warp_sim_coords_batched.launches = 0
