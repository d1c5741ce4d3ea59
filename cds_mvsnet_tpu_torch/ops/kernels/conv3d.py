"""K2 and K7: ``relu(conv3d_3x3x3(vol) + b)`` with eval BatchNorm folded into
``(w, b)``, padding 1, 8 or 16 output channels, on a bf16 volume (the bf16
route) or an fp32 one (the fp32 route); the output has the volume's dtype.

- :func:`conv3d_bn_relu` (K2), stride 1: cost-regularisation conv0 (O = 8)
  and, under the ``pallas3``/``pallasf3`` fronts, conv2 (16 -> 16 at half
  resolution). Replaces ``cds_mvsnet_tpu/ops/pallas/conv3d.py::conv3d_front``
  (:159, body ``_conv3d_kernel`` :68).
- :func:`conv3d_down` (K7), stride 2: conv1 (8 -> 16) under the
  ``pallas2``/``pallas3`` fronts. Replaces ``conv3d.py::conv3d_down`` (:490,
  the same body at ``stride=2``); D, h and w must be even.

Kernel sources: ``csrc/conv3d.cu``, ``csrc/conv3d_mma.cuh`` and ``csrc/conv3d_tf32.cuh``.

Bound on the H100: memory. K2 reads the ``(C, D, h, w)`` volume and writes
``(O, D, h, w)``: about 239 / 382 / 255 MB per launch at stages 1/2/3 of the
1152x864 main path (71 / 114 / 76 µs at 3.35 TB/s) for 41 / 55 / 28 GFLOP
(42 / 56 / 28 µs at the dense bf16 rate, twice that with the hi/lo split
below).

K2 in bf16 (``conv3d_mma_kernel``) is an implicit GEMM on the tensor cores
(``mma.sync.m16n8k16``, bf16 in, fp32 sums): M = output voxels, N = O, K =
27·C. A block of 8 warps owns 4x4x32 output voxels at a time (32 M-tiles of
16 voxels along x), stays resident and walks the tiles of the volume. It
stages the input halo (6x6x36 voxels, x from two before the tile so that
pairs of voxels stay 4-byte aligned) 8 channels at a time into shared
memory, channel-innermost (16 bytes per voxel), through registers, one
four-byte load per channel and pair of voxels where w is even: the next
chunk's loads are issued before the current chunk's MMAs. ldmatrix reads
each step's A fragment (two taps of 8 channels), so the 27-fold reuse of an
input comes from shared memory, not L1. The fp32 weights are split as they are
staged, hi = bf16(w) and lo = bf16(w - hi), and every K-step runs two MMAs,
hi and lo, into one fp32 accumulator: bf16 x bf16 products are exact in
fp32, so the result keeps one bf16 ulp of the fp32 conv, which bf16 weights
alone do not where outputs are small (``tests/test_torch_conv3d_split.py``).
The TPU kernel rounds its weights to bf16 (``conv3d.py:187,198``), its
matrix unit's input format; the port does not. C must be a multiple of 8.
The body (``csrc/conv3d_mma.cuh``) is shared with K6's conv0. The TPU
kernel's three pre-shifted volume copies (the x taps at lane-aligned DMA
windows) are Mosaic mechanics; here ldmatrix takes any voxel row.

K2 in fp32 (``conv3d_tf32_kernel``) is the same implicit GEMM in 3xTF32 on
``mma.sync.m16n8k8``: every fp32 operand x, activation and weight, is split
into hi = tf32(x) and lo = tf32(x - hi) (``cvt.rna``), and each K-step runs
hi·hi, hi·lo and lo·hi into one fp32 sum, which keeps about 22 bits of each
term: within the fp32 route's tolerance, where one TF32 product or two are
not (``tests/test_torch_conv3d_tf32.py``). The tile walk, the 4x4x32 output
tile and the register-staged halo are K2-bf16's; the halo is fp32, 32 bytes
a voxel, its halves swapped where bit 2 of the halo x is set so that
``ldmatrix`` (which reads a 16 x 8 fp32 A fragment as four 8x8 b16
matrices) meets no bank twice. The weights are split as they are staged;
an activation fragment is split after ``ldmatrix`` and feeds the three
depth taps of a warp's four z-stacked M-tiles, so it is loaded and split
once per three products. Any C: a ragged chunk of 8 channels is padded
with zeros. Bound: the three TF32 products at the dense TF32 rate, about
1.8x the bytes at the DTU protocol's stage 1. The TPU kernel rounds an fp32
volume to bf16 for its matrix unit (``conv3d.py:186-187,198``); the port's
fp32 route keeps fp32 accuracy.

K7 in bf16 (``conv3d_down_mma_kernel``) is the same implicit GEMM at
stride 2, with K2's arithmetic (``mma_step_s2`` in ``csrc/conv3d_mma.cuh``:
the hi and lo MMAs of every K-step, in K2's order), so it keeps one bf16
ulp of the fp32 conv. Bound: memory, 60 / 159 / 159 MB at stages 1/2/3 of
the serve point (18 / 48 / 48 µs); its hi and lo MMAs come to 5 / 14 / 14
GFLOP. A block of 8 warps owns 2x4x32 output voxels at a time (16 M-tiles
of 16 along x, two a warp), stays resident and walks the tiles. The input
box of a tile and chunk (5x9 rows of 66 voxels, x from two before 2·x0) is
stored channel-innermost, 16 bytes a voxel, split by x parity
(``[row][parity][x/2][8]``, each row padded to an odd number of 16-byte
slots): the 8 rows of an ``ldmatrix`` at stride 2 (input x 2·ox + kx - 1
for 8 consecutive ox) are then 8 consecutive rows of one parity and meet
no bank twice. Where w is a multiple of 8 (every route shape) it is loaded
in 16-byte loads, 8 voxels along x of one channel plane, transposed 8 x 8
in registers and stored as voxel rows; otherwise in two-byte loads. The box
is double-buffered in shared memory: the next (tile, chunk)'s loads are
issued before the current MMAs, one barrier a step. A tile's outputs leave
through the box just read, a warp's 32 x of each channel as 16-byte
stores. C must be a multiple of 8. :func:`launch_plan` mirrors its tiles
and box.

K7 in fp32 (``conv3d_down_tf32_kernel``) is the implicit GEMM at stride 2
in 3xTF32 (``down_step`` in ``csrc/conv3d_tf32.cuh``: K2-fp32's three
products and order, so it meets K2-fp32's tolerance, ``|d| <= 1e-5·Σ|terms|
+ 1e-7``). The tile walk is K7-bf16's: a resident block of 8 warps walks
2x4x32 output tiles, a warp owning one (y, 16-x) column with its two output
planes stacked along z, so that an A fragment of input plane hz is loaded
and split once for the taps 2m + kd = hz. The box of a tile and chunk (5x9
rows of 65 voxels) is fp32, 32 bytes a voxel, kept as two half-boxes
(channels 0-3 and 4-7, 16 bytes a voxel), each row split by x parity and
padded to an odd number of 16-byte slots: an ``ldmatrix`` phase reads 8
consecutive slots of one half-row. It is loaded in 16-byte loads, 4 voxels
along x of one channel plane, where w is a multiple of 4, and double
buffered as K7-bf16's; the outputs leave from the fragments, 32 contiguous
bytes a channel and 8 lanes. Two boxes and the weight fragments take 215 KB
at C = 8, O = 16: one block an SM. Where the fragments of every chunk and
n-tile exceed two (C > 8 at O = 16), the tile is 2x2x32 and a warp owns one
M-tile. Bound: bytes, 40 a voxel of input (8 fp32 channels in, 16 out at an
eighth of the voxels): 0.036 / 0.095 / 0.095 ms at the serve stages of the
mixed path (``cost_dtype=float32``), its three TF32 products 0.016 / 0.042 /
0.042 ms. :func:`launch_plan_fp32` mirrors its tiles and box. K6's conv1
runs the same step on its conv0 tile in both dtypes, so K6's out1 equals
this form on ``out0`` (in bf16 on ``out0.float()``, rounded).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._launch import I, P, entry, on_card, ptr, require, stream

__all__ = ["conv3d_bn_relu", "conv3d_bn_relu_plain", "conv3d_down", "conv3d_down_plain", "fold_bn_into_conv3d",
           "launch_plan", "box_offset", "row_offset", "tap_offset", "load_task", "launch_plan_fp32",
           "fp32_slot_offset", "fp32_lane_offset", "fp32_load_task"]

OUT_CHANNELS = (8, 16)

# K7 in bf16 (csrc/conv3d.cu, namespace k7): a block's output tile (z, y, x)
# and threads; the input box's rows (2·MZ+1 planes of 2·MY+1 rows), the
# voxels of a parity sub-row (box x from 2·x0-2 over 2·MX+2) and a row's
# bytes (both parities, padded to an odd number of 16-byte slots)
K7_TILE = (2, 4, 32)
K7_THREADS = 256
K7_HY = 2 * K7_TILE[1] + 1
K7_ROWS = (2 * K7_TILE[0] + 1) * K7_HY
K7_PX = K7_TILE[2] + 1
K7_ROW_BYTES = (2 * K7_PX + 1) * 16
K7_VECTOR_SLOTS = -(-K7_ROWS // 4) * 32  # a warp's 32 vector tasks: 4 rows x 8 vectors
K7_OUT_STAGE = 16 * 80  # a warp's outputs on their way out: 16 channels x (32 x, 16 bytes of padding)

# K7 in fp32 (csrc/conv3d.cu, namespace k7f): 8 warps, output tiles of 2 x MY
# x 32 (MY = 4, or 2 where the weight fragments exceed two chunk-n-tiles);
# a half-row (16 bytes a voxel: channels 0-3 or 4-7) holds both parities of
# 33 slots, padded to an odd number of 16-byte slots
K7F_THREADS = 256
K7F_PX = K7_TILE[2] + 1
K7F_ROW_BYTES = (2 * K7F_PX + 1) * 16
K7F_MAX_SMEM = 227 * 1024


def fold_bn_into_conv3d(weight, bn_weight, bn_bias, running_mean, running_var, eps: float = 1e-5):
    """Fold eval BatchNorm into a bias-free conv: ``(w (O,C,3,3,3), b (O,))``
    in fp32."""
    inv = bn_weight.float() / torch.sqrt(running_var.float() + eps)
    w = weight.float() * inv[:, None, None, None, None]
    b = bn_bias.float() - running_mean.float() * inv
    return w.contiguous(), b.contiguous()


def conv3d_bn_relu_plain(vol: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Plain version: fp32 conv of the volume, bias, ReLU, back to its dtype."""
    y = F.conv3d(vol.float()[None], w.float(), stride=stride, padding=1)[0] + b.float()[:, None, None, None]
    return torch.relu(y).to(vol.dtype)


def conv3d_down_plain(vol: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`conv3d_down`."""
    return conv3d_bn_relu_plain(vol, w, b, stride=2)


def check_conv(name: str, vol, w, b, out_channels=OUT_CHANNELS, tensor_cores: bool = False) -> None:
    """The argument contract of K2, K7 and each of K6's two convs;
    ``tensor_cores``: the conv runs on the tensor-core body in bf16 (K2, K7,
    K6's conv0), which takes C in chunks of 8 channels."""
    require(vol.ndim == 4, f"{name}: vol {tuple(vol.shape)}")
    C = vol.shape[0]
    O = w.shape[0] if w.ndim == 5 else -1
    require(O in out_channels and tuple(w.shape) == (O, C, 3, 3, 3),
            f"{name}: w {tuple(w.shape)} for C={C} (O in {out_channels})")
    require(tuple(b.shape) == (O,), f"{name}: b {tuple(b.shape)}")
    require(C * 27 * O * 4 <= 48 * 1024, f"{name}: C={C}, O={O} weights exceed shared memory")
    require(vol.dtype in (torch.bfloat16, torch.float32), f"{name}: vol must be bf16 or fp32")
    require(w.dtype == b.dtype == torch.float32, f"{name}: w and b must be fp32")
    require(all(t.is_contiguous() for t in (vol, w, b)), f"{name}: inputs must be contiguous")
    if tensor_cores and vol.dtype == torch.bfloat16:
        require(C % 8 == 0, f"{name}: bf16 takes C in multiples of 8, got C={C}")


def launch_plan(C: int, D: int, h: int, w: int, O: int = 16) -> dict:
    """K7-bf16's plan for an input ``(C, D, h, w)`` as ``csrc/conv3d.cu``
    (``k7``, ``conv3d_down_plan``) makes it: the output ``tile`` (z, y, x),
    the output shape ``out``, the tiles along each axis and in all, the
    M-tiles of 16 voxels a warp, the input box's ``box_rows``, ``row_bytes``
    and one buffer's ``box_bytes``, the ``shared_bytes`` of the weight
    fragments and two buffers, the load task slots (``tasks``, see
    :func:`load_task`) and a thread's share, and whether the loads are
    16-byte (``vector_loads``: w a multiple of 8)."""
    require(O in OUT_CHANNELS and C > 0 and C % 8 == 0, f"launch_plan: C={C}, O={O}")
    require(min(D, h, w) >= 1, f"launch_plan: D, h, w = {D}, {h}, {w}")
    MZ, MY, MX = K7_TILE
    out = ((D - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1)
    tiles = tuple(-(-n // t) for n, t in zip(out, K7_TILE))
    tasks = K7_VECTOR_SLOTS + K7_ROWS
    weights = C // 8 * 14 * (O // 8) * 32 * 16  # 14 K-steps of 32 lanes' hi/lo fragments an n-tile and chunk
    return {"tile": K7_TILE, "out": out, "tiles_zyx": tiles, "tiles": tiles[0] * tiles[1] * tiles[2],
            "m_tiles_per_warp": MZ * MY * (MX // 16) // (K7_THREADS // 32), "box_rows": K7_ROWS,
            "row_bytes": K7_ROW_BYTES, "box_bytes": K7_ROWS * K7_ROW_BYTES,
            "shared_bytes": weights + 2 * K7_ROWS * K7_ROW_BYTES, "tasks": tasks,
            "tasks_per_thread": -(-tasks // K7_THREADS), "vector_loads": w % 8 == 0}


def box_offset(row: int, bx: int) -> int:
    """Byte offset in K7's box of the voxel at box row ``row`` (plane
    ``row // (2·MY+1)``, row ``row % (2·MY+1)``) and box x ``bx`` (input x
    ``2·x0 - 2 + bx``): parity ``bx % 2``, slot ``bx // 2``."""
    return row * K7_ROW_BYTES + ((bx % 2) * K7_PX + bx // 2) * 16


def row_offset(m: int, lane: int) -> int:
    """Byte offset of lane ``lane``'s ldmatrix row of M-tile ``m`` at tap (0,
    0, parity 0): box plane 2·mz, row 2·my, slot ox."""
    MY = K7_TILE[1]
    mz, my, mx = m // (2 * MY), (m // 2) % MY, (m % 2) * 16
    ox = mx + (lane & 7) + ((lane >> 3) & 1) * 8
    return (2 * mz * K7_HY + 2 * my) * K7_ROW_BYTES + ox * 16


def tap_offset(kd: int, ky: int, kx: int) -> int:
    """The byte offset a tap adds to :func:`row_offset`: kx = 0 parity 1 at
    the row's slot, kx = 1 parity 0 one slot on, kx = 2 parity 1 one slot
    on."""
    return kd * K7_HY * K7_ROW_BYTES + ky * K7_ROW_BYTES + (K7_PX * 16, 16, K7_PX * 16 + 16)[kx]


def load_task(v: int) -> tuple[int, int] | None:
    """Load task slot ``v``'s box row and first box x: a 16-byte vector of
    all 8 channels (box x 2 + 8·j, the 8 voxels from it), then a row's left
    pair (box x 0, of which box x 1 is stored); None for a slot without a
    task. A warp's 32 vector slots are 4 rows x 8 vectors, a store phase's
    8 lanes 4 rows x 2 neighbouring vectors."""
    if v < K7_VECTOR_SLOTS:
        lane = v % 32
        row, hx = v // 32 * 4 + lane % 8 // 2, 2 + 8 * (2 * (lane // 8) + lane % 2)
    else:
        row, hx = v - K7_VECTOR_SLOTS, 0
    return (row, hx) if row < K7_ROWS else None


def _fp32_rows(C: int, O: int) -> int:
    """K7-fp32's tile rows: 4 where the weight fragments are at most two
    chunk-n-tiles, else 2."""
    return 4 if -(-C // 8) * (O // 8) <= 2 else 2


def launch_plan_fp32(C: int, D: int, h: int, w: int, O: int = 16) -> dict:
    """K7-fp32's plan for an input ``(C, D, h, w)`` as ``csrc/conv3d.cu``
    (``k7f``, ``conv3d_down_tf32_plan``) makes it: the output ``tile`` (z, y,
    x), the output shape ``out``, the tiles along each axis and in all, the
    z-stacked M-tiles a warp, the box's ``box_rows``, ``row_bytes`` (a
    half-row) and one buffer's ``box_bytes`` (both half-boxes), the
    ``shared_bytes`` of the weight fragments and two buffers, the load task
    slots (:func:`fp32_load_task`) and a thread's share, and whether the
    loads are 16-byte (``vector_loads``: w a multiple of 4)."""
    require(O in OUT_CHANNELS and C > 0, f"launch_plan_fp32: C={C}, O={O}")
    require(min(D, h, w) >= 1, f"launch_plan_fp32: D, h, w = {D}, {h}, {w}")
    MY = _fp32_rows(C, O)
    tile = (2, MY, K7_TILE[2])
    out = ((D - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1)
    tiles = tuple(-(-n // t) for n, t in zip(out, tile))
    rows = 5 * (2 * MY + 1)
    box = 2 * rows * K7F_ROW_BYTES
    vector_slots = -(-rows // 2) * 32
    tasks = vector_slots + rows
    weights = -(-C // 8) * 27 * (O // 8) * 32 * 16  # 27 taps of 32 lanes' hi/lo fragments a chunk and n-tile
    return {"tile": tile, "out": out, "tiles_zyx": tiles, "tiles": tiles[0] * tiles[1] * tiles[2],
            "m_tiles_per_warp": 2 * MY * 2 // (K7F_THREADS // 32), "box_rows": rows, "row_bytes": K7F_ROW_BYTES,
            "box_bytes": box, "shared_bytes": weights + 2 * box, "vector_slots": vector_slots, "tasks": tasks,
            "tasks_per_thread": -(-tasks // K7F_THREADS), "vector_loads": w % 4 == 0}


def fp32_slot_offset(bx: int) -> int:
    """Byte offset in a half-row of K7-fp32's box of box x ``bx`` (input x
    ``2·x0 - 2 + bx``): parity ``bx % 2``, slot ``bx // 2``."""
    return ((bx % 2) * K7F_PX + bx // 2) * 16


def fp32_lane_offset(lane: int, warp: int, kx: int, MY: int = 4) -> int:
    """Byte offset in K7-fp32's box of lane ``lane``'s ldmatrix row of warp
    ``warp``'s column at tap ``kx``, input plane 2·zw and row 2·my (output x
    mx + row, channels 4·(lane // 16) ..), as the kernel's ``lane_off``."""
    cols = MY * 2
    col, zw = warp % cols, warp // cols * (2 * cols // (K7F_THREADS // 32))
    my, mx = col // 2, (col % 2) * 16
    mrow = (lane & 7) + ((lane >> 3) & 1) * 8
    rows = 5 * (2 * MY + 1)
    return ((lane >> 4) * rows * K7F_ROW_BYTES + (2 * zw * (2 * MY + 1) + 2 * my) * K7F_ROW_BYTES
            + fp32_slot_offset(2 * (mx + mrow) + kx + 1))


def fp32_load_task(v: int, MY: int = 4) -> tuple[int, int] | None:
    """K7-fp32's load task slot ``v``: its box row and vector j (box x
    2 + 4j .. 5 + 4j), j = -1 for the row's left voxel (box x 1); None for a
    slot without a task. A warp's 32 vector slots are 2 rows x 16 vectors, a
    store phase's 8 lanes 2 rows x 4 neighbouring vectors."""
    rows = 5 * (2 * MY + 1)
    vector_slots = -(-rows // 2) * 32
    if v < vector_slots:
        lane = v % 32
        row, j = v // 32 * 2 + lane % 8 // 4, lane // 8 * 4 + lane % 4
    else:
        row, j = v - vector_slots, -1
    return (row, j) if row < rows else None


def _launch(name: str, fn_name: str, vol, w, b, stride: int) -> torch.Tensor:
    C, D, h, wd = vol.shape
    O = w.shape[0]
    out = torch.empty((O, (D - 1) // stride + 1, (h - 1) // stride + 1, (wd - 1) // stride + 1),
                      dtype=vol.dtype, device=vol.device)
    lib, fn = entry("conv3d", fn_name, [P, P, P, P, I, I, I, I, I, I, P])
    err = fn(ptr(vol), ptr(w), ptr(b), ptr(out), int(vol.dtype == torch.float32), O, C, D, h, wd,
             stream(vol.device))
    _build.check(lib, err, name)
    return out


def conv3d_bn_relu(vol: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K2: ``vol (C, D, h, w)`` bf16 or fp32 -> ``(O, D, h, w)`` in vol's
    dtype, O in 8/16; ``w (O, C, 3, 3, 3)`` and ``b (O,)`` fp32 with BN folded
    (:func:`fold_bn_into_conv3d`); in bf16 C is a multiple of 8."""
    check_conv("conv3d_bn_relu", vol, w, b, tensor_cores=True)
    if not on_card("conv3d_bn_relu", vol, w, b):
        return conv3d_bn_relu_plain(vol, w, b)
    out = _launch("conv3d_bn_relu", "conv3d_bn_relu_launch", vol, w, b, 1)
    conv3d_bn_relu.launches += 1
    return out


def conv3d_down(vol: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K7: :func:`conv3d_bn_relu` at stride 2, ``(C, D, h, w) -> (O, D/2,
    h/2, w/2)``; D, h and w even; in bf16 C is a multiple of 8."""
    check_conv("conv3d_down", vol, w, b, tensor_cores=True)
    require(all(n % 2 == 0 for n in vol.shape[1:]), f"conv3d_down: D, h, w {tuple(vol.shape[1:])} must be even")
    if not on_card("conv3d_down", vol, w, b):
        return conv3d_down_plain(vol, w, b)
    out = _launch("conv3d_down", "conv3d_down_launch", vol, w, b, 2)
    conv3d_down.launches += 1
    return out


conv3d_bn_relu.launches = 0
conv3d_down.launches = 0
