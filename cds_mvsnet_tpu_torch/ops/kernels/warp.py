"""K1: fused plane-sweep warp, ref inner product and similarity entropy.

Replaces ``cds_mvsnet_tpu/ops/pallas/warp.py::warp_pallas_v8`` (:1342, body
``_warp_kernel_v8`` :1101) in its default entropy-emitting mode. Kernel
source: ``csrc/warp.cu``.

Per reference pixel and depth plane it projects the pixel into the source
view from the 12 homography scalars ``rt`` and the plane depth
(``z = L2·d + t2 + 1e-6``, exactly as the TPU kernel), samples the source
features bilinearly with zeros padding, writes ``in_prod = ref ⊙ warped``
``(C, D, h, w)`` in bf16, and folds ``sim = Σ_C ref·warped`` into an online
``(m, s, u)`` so that the entropy of ``softmax_D(sim)`` is
``m + log s − u/s`` without a ``(D, h, w)`` buffer. K5's forward
(``ops/kernels/warp_vjp.py``) keeps the one-thread-a-pixel body with ``sim``
stored instead (``warp_kernel<C>``); the projection and the gathers live in
``csrc/warp.cuh``.

Bound on the H100: memory. The ``in_prod`` write dominates: about
199 / 304 / 195 MB per launch at stages 1/2/3 of the 1152x864 main path
(59 / 91 / 58 µs at 3.35 TB/s). Design (``warp_entropy_kernel<C>``, see
:func:`launch_plan`): a block of 256 threads owns P consecutive pixels of
the flattened ``(h, w)`` grid, so a ragged w wastes no lane; a pixel's C
channels go to C/16 lanes of 16 (one lane of 8 at C = 8; P = 128 / 256 /
256 at C = 32 / 16 / 8). Each lane projects its pixel, gathers its channels
of each bilinear corner in 16-byte loads of the channels-last source
(served by L1/L2: the source map is 4-16 MB) and keeps its ref values and
the online state in registers; ``sim`` is the xor-shuffle sum over a
pixel's lanes. ``in_prod`` leaves through shared memory: each warp writes a
plane's ``(C, 32/lanes)`` bf16 sub-tile to one of two buffers and stores it
as 16-byte evict-first vectors, rows of 16 or 32 pixels (one or two whole
32-byte sectors); a warp waits only for itself. The TPU's band cache,
selection matmuls and tiling are Mosaic mechanics and are not carried over.
Numerics: bilinear weights are fp32 (the TPU kernel rounds the x-weights to
bf16), the warped value is rounded to bf16 before the product and the
similarity, as on the TPU. The projection and the weights round each
operation as the plain version does (no FMA contraction), so both pick the
same corners and weights; the gather fuses its multiply-adds, in corner
order from 0, as the one-thread-a-pixel K1 of earlier commits did, whose
``in_prod`` this one equals bit for bit (``tools/time_warp.py``); a warped
value, and with it ``in_prod``, may sit one bf16 ulp from the plain
version's (about 2e-5 of the values on the card; K5's forward gathers op by
op instead, see ``warp_vjp.py``); ``sim`` sums its C products in another
order.
"""

from __future__ import annotations

import ctypes

import torch

from ..grid_sample import grid_sample_pixel
from . import _build
from ._launch import I, P, entry, on_card, ptr, require, stream

__all__ = ["launch_plan", "warp_entropy", "warp_entropy_card_plan", "warp_entropy_plain", "warp_sim_plain"]

CHANNELS = (8, 16, 32)
K1_THREADS = 256  # warp_entropy_kernel's block (k1::kThreads in csrc/warp.cu)
# elements of one chunk of planes in the plain versions (K1, K5), to bound their temporaries
PLAIN_CHUNK_ELEMS = 1 << 25


def project(rt: torch.Tensor, depth: torch.Tensor, h: int, w: int):
    """Source-pixel coordinates ``(px, py)``, each ``(D, h, w)`` fp32, of
    every (plane, ref pixel), as the kernels compute them."""
    r = rt.float()
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=rt.device),
        torch.arange(w, dtype=torch.float32, device=rt.device),
        indexing="ij",
    )
    L0 = r[0] * xs + r[1] * ys + r[2]
    L1 = r[3] * xs + r[4] * ys + r[5]
    L2 = r[6] * xs + r[7] * ys + r[8]
    dep = depth.float()
    if dep.ndim == 1:
        dep = dep[:, None, None]
    z = L2 * dep + r[11] + 1e-6
    return (L0 * dep + r[9]) / z, (L1 * dep + r[10]) / z


def _chunk(D: int, h: int, w: int, C: int) -> int:
    return max(1, min(D, PLAIN_CHUNK_ELEMS // (h * w * C)))


def check_inputs(name: str, src, ref, depth, rt) -> None:
    """The argument contract of K1 and of K5's forward and backward."""
    require(src.ndim == 3 and src.shape[2] in CHANNELS, f"{name}: src {tuple(src.shape)}")
    C = src.shape[2]
    require(ref.ndim == 3 and ref.shape[0] == C, f"{name}: ref {tuple(ref.shape)} for C={C}")
    _, h, w = ref.shape
    require(depth.ndim in (1, 3) and depth.shape[0] >= 1, f"{name}: depth {tuple(depth.shape)}")
    require(depth.ndim == 1 or depth.shape[1:] == (h, w), f"{name}: depth {tuple(depth.shape)}")
    require(tuple(rt.shape) == (12,), f"{name}: rt {tuple(rt.shape)}")
    require(src.dtype == ref.dtype == torch.bfloat16, f"{name}: src and ref must be bf16")
    require(depth.dtype == rt.dtype == torch.float32, f"{name}: depth and rt must be fp32")
    require(all(t.is_contiguous() for t in (src, ref, depth, rt)), f"{name}: inputs must be contiguous")


def warp_sim_plain(src, ref, depth, rt):
    """Plain PyTorch version of K5's forward (``warp_vjp.warp_sim``), any
    float dtype, and differentiable in ``src`` and ``ref`` through autograd
    of the gather."""
    H, W, C = src.shape
    _, h, w = ref.shape
    D = depth.shape[0]
    ref_t = ref.permute(1, 2, 0)  # (h, w, C)
    step = _chunk(D, h, w, C)
    prods, sims = [], []
    for d0 in range(0, D, step):
        px, py = project(rt, depth[d0 : d0 + step], h, w)
        warped = grid_sample_pixel(src.float()[None], px[None], py[None])[0].to(src.dtype)
        prods.append(ref_t * warped)  # (d, h, w, C)
        sims.append((warped.float() * ref_t.float()).sum(-1))
    return torch.cat(prods).permute(3, 0, 1, 2).contiguous(), torch.cat(sims)


def warp_entropy_plain(src, ref, depth, rt):
    """Plain PyTorch version of :func:`warp_entropy`, any float dtype."""
    in_prod, sim = warp_sim_plain(src, ref, depth, rt)
    entropy = -(torch.softmax(sim, 0) * torch.log_softmax(sim, 0)).sum(0)
    return in_prod, entropy


def launch_plan(C: int, h: int, w: int) -> dict:
    """K1's launch plan at C channels and an ``h x w`` reference, as
    ``csrc/warp.cu`` makes it: ``lanes`` a pixel, the ``pixels`` of a block
    (consecutive in the flattened reference) and of each of its warps
    (``warp_pixels``), the ``shared_bytes`` of a block (two buffers of one
    plane's ``(C, warp_pixels)`` bf16 sub-tile a warp), the ``blocks`` over
    ``h*w`` and the last one's ``tail`` pixels, and whether ``in_prod``'s rows
    allow 16-byte stores (``vector_stores``)."""
    require(C in CHANNELS, f"launch_plan: C={C} not in {CHANNELS}")
    lanes = C // 16 if C >= 16 else 1
    pixels = K1_THREADS // lanes
    blocks = -(-h * w // pixels)
    return {"lanes": lanes, "pixels": pixels, "warp_pixels": 32 // lanes, "shared_bytes": 2 * C * pixels * 2,
            "blocks": blocks, "tail": h * w - (blocks - 1) * pixels, "vector_stores": h * w % 8 == 0}


def warp_entropy_card_plan(C: int, h: int, w: int) -> dict:
    """The launcher's own plan on the card (``warp_entropy_plan``): the
    keys of :func:`launch_plan` that it sets, the ``registers`` a thread and
    the resident ``blocks_per_sm``."""
    out = (ctypes.c_int * 6)()
    lib, fn = entry("warp", "warp_entropy_plan", [I, I, I, P])
    _build.check(lib, fn(C, h, w, ctypes.cast(out, P)), "warp_entropy_plan")
    return dict(zip(("lanes", "pixels", "shared_bytes", "blocks", "registers", "blocks_per_sm"), list(out)))


def warp_entropy(src: torch.Tensor, ref: torch.Tensor, depth: torch.Tensor, rt: torch.Tensor):
    """One source view of the plane sweep.

    Args:
      src: ``(H, W, C)`` bf16 channels-last source features, C in 8/16/32.
      ref: ``(C, h, w)`` bf16 reference features.
      depth: ``(D,)`` planes or ``(D, h, w)`` per-pixel hypotheses, fp32.
      rt: ``(12,)`` fp32, the row-major rotation then the translation of
        ``ops.geometry.relative_warp_transform``.
    Returns:
      ``(in_prod (C, D, h, w) bf16, entropy (h, w) fp32)``.
    """
    check_inputs("warp_entropy", src, ref, depth, rt)
    if not on_card("warp_entropy", src, ref, depth, rt):
        return warp_entropy_plain(src, ref, depth, rt)
    require(src.data_ptr() % 16 == 0, "warp_entropy: src must be 16-byte aligned")
    H, W, C = src.shape
    _, h, w = ref.shape
    D = depth.shape[0]
    in_prod = torch.empty((C, D, h, w), dtype=torch.bfloat16, device=src.device)
    entropy = torch.empty((h, w), dtype=torch.float32, device=src.device)
    lib, fn = entry("warp", "warp_entropy_launch", [P, P, P, I, P, P, P, I, I, I, I, I, I, P])
    err = fn(ptr(src), ptr(ref), ptr(depth), int(depth.ndim == 3), ptr(rt), ptr(in_prod),
             ptr(entropy), C, H, W, D, h, w, stream(src.device))
    _build.check(lib, err, "warp_entropy")
    warp_entropy.launches += 1
    return in_prod, entropy


warp_entropy.launches = 0
