"""K7's tile geometry in bf16 (``ops/kernels/conv3d.py``: ``launch_plan``,
``box_offset``, ``row_offset``, ``tap_offset``, ``load_task``, made as
``csrc/conv3d.cu``'s ``k7`` makes them) at the route shapes and at ragged
ones, on the CPU.

K7 runs conv3d_mma.cuh's implicit GEMM at stride 2: a block of 8 warps owns
2x4x32 output voxels at a time, two M-tiles of 16 along x a warp, and stages
the input box of a tile (5x9 rows of 66 voxels of 8 channels) split by x
parity, so that the 8 rows of an ``ldmatrix`` meet no bank twice. These
tests hold that geometry to the convolution it must compute: every output
voxel in one tile, every tap of every output read from the box slot that
holds its input voxel, that slot written by exactly one load task, no
bank met twice, and the shared memory of two blocks within an SM's.

K7 in fp32 (``launch_plan_fp32``, ``fp32_slot_offset``,
``fp32_lane_offset``, ``fp32_load_task``; ``csrc/conv3d.cu``'s ``k7f``):
the same tiles (2x2x32 where its weight fragments exceed two chunk-n-tiles),
a warp's z-stacked M-tiles, a box of fp32 kept as two half-boxes of 16
bytes a voxel, loaded in 4-voxel vectors; held to the same properties at
one block an SM.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.ops.kernels import conv3d as k7

torch.set_num_threads(2)

SM_SHARED, BLOCK_RESERVED, BLOCK_MAX = 228 * 1024, 1024, 227 * 1024  # an H100 SM's shared memory
# the input (C, D, h, w) of conv1 under the pallas2/pallas3 fronts at the
# serve point (1152x864, ndepths 48/32/8): conv0's output
ROUTES = [(8, 48, 216, 288), (8, 32, 432, 576), (8, 8, 864, 1152)]
RAGGED = [(8, 6, 10, 46), (16, 4, 14, 30), (8, 2, 2, 2), (8, 10, 18, 70), (24, 8, 26, 38), (8, 4, 8, 72)]
MZ, MY, MX = k7.K7_TILE
M_TILES = MZ * MY * (MX // 16)
LANES = np.arange(32)
TAPS = [(kd, ky, kx) for kd in range(3) for ky in range(3) for kx in range(3)]


def tile_origins(plan: dict) -> np.ndarray:
    """(tiles, 3) output origins (z0, y0, x0) in the kernel's walk order, x fastest."""
    tz, ty, tx = plan["tiles_zyx"]
    t = np.arange(plan["tiles"])
    return np.stack([t // (tx * ty) * MZ, (t // tx) % ty * MY, t % tx * MX], 1)


@pytest.mark.parametrize("shape", ROUTES + RAGGED, ids=[f"{C}x{D}x{h}x{w}" for C, D, h, w in ROUTES + RAGGED])
def test_tiles_cover_every_output_voxel_once(shape):
    C, D, h, w = shape
    plan = k7.launch_plan(C, D, h, w)
    Do, ho, wo = plan["out"]
    assert (Do, ho, wo) == ((D - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1)
    hits = np.zeros((Do, ho, wo), np.int64)
    for z0, y0, x0 in tile_origins(plan):
        hits[z0 : z0 + MZ, y0 : y0 + MY, x0 : x0 + MX] += 1
    assert (hits == 1).all()
    assert plan["vector_loads"] == (w % 8 == 0)


def test_every_tap_reads_its_input_voxel():
    """For each M-tile, lane and tap: the ldmatrix row address (row_offset +
    tap_offset) is the box slot of input voxel (2z-1+kd, 2y-1+ky, 2x-1+kx)
    of the lane's output voxel, box row (2·mz+kd)·HY + 2·my+ky, box x
    2·ox+kx+1 (the box starts at 2·z0-1, 2·y0-1, 2·x0-2)."""
    for m in range(M_TILES):
        mz, my, mx = m // (2 * MY), (m // 2) % MY, (m % 2) * 16
        for lane in LANES:
            ox = mx + (lane & 7) + ((lane >> 3) & 1) * 8
            for kd, ky, kx in TAPS:
                row = (2 * mz + kd) * k7.K7_HY + 2 * my + ky
                assert k7.row_offset(m, lane) + k7.tap_offset(kd, ky, kx) == k7.box_offset(row, 2 * ox + kx + 1)


def test_each_read_slot_is_written_by_one_task():
    """The load tasks (16-byte vectors: box x 2 + 8j .. 9 + 8j of a row; a
    row's left pair, of which box x 1 is stored) write every box voxel a
    tap reads exactly once, at distinct slots inside one buffer."""
    plan = k7.launch_plan(8, 48, 216, 288)
    assert plan["tasks"] <= plan["tasks_per_thread"] * k7.K7_THREADS
    writes = {}
    for v in range(plan["tasks_per_thread"] * k7.K7_THREADS):
        task = k7.load_task(v)
        if task is None:
            continue
        row, hx = task
        for bx in (range(hx, hx + 8) if hx else (1,)):
            writes[(row, bx)] = writes.get((row, bx), 0) + 1
    read = {((2 * mz + kd) * k7.K7_HY + 2 * my + ky, 2 * ox + kx + 1)
            for mz in range(MZ) for my in range(MY) for ox in range(MX) for kd, ky, kx in TAPS}
    assert read <= set(writes) and all(n == 1 for n in writes.values())
    offsets = [k7.box_offset(*key) for key in writes]
    assert len(set(offsets)) == len(offsets)
    assert min(offsets) >= 0 and max(offsets) + 16 <= plan["box_bytes"]


def test_ldmatrix_rows_meet_no_bank_twice():
    """An ldmatrix.x4 phase: 8 lanes' 16-byte rows, one per bank group of
    the 128-byte row of banks."""
    for m in range(M_TILES):
        for kd, ky, kx in TAPS:
            for first in range(0, 32, 8):
                slots = [(k7.row_offset(m, lane) + k7.tap_offset(kd, ky, kx)) // 16 % 8
                         for lane in range(first, first + 8)]
                assert sorted(slots) == list(range(8))


def test_box_stores_meet_no_bank_twice():
    """A store phase (8 consecutive lanes, one 16-byte voxel row each): the
    row of an odd number of 16-byte slots puts 4 rows x 2 neighbouring
    vectors on 8 bank groups."""
    phases = 0
    for first in range(0, k7.K7_VECTOR_SLOTS, 8):
        tasks = [t for t in (k7.load_task(v) for v in range(first, first + 8)) if t is not None]
        for k in range(8 if tasks else 0):
            slots = [k7.box_offset(row, hx + k) // 16 % 8 for row, hx in tasks]
            phases += 1
            assert len(set(slots)) == len(slots)
    assert phases == k7.K7_VECTOR_SLOTS // 8 * 8  # every phase holds a vector task


def test_a_warps_loads_are_whole_lines():
    """A warp's 32 vector tasks: 4 rows x the 8 vectors of a row, 128
    contiguous bytes of each row's channel plane."""
    for warp in range(k7.K7_VECTOR_SLOTS // 32):
        rows = {}
        for t in (k7.load_task(warp * 32 + lane) for lane in range(32)):
            if t is not None:
                rows.setdefault(t[0], set()).add((t[1] - 2) // 8)
        assert rows and all(js == set(range(8)) for js in rows.values()) and len(rows) <= 4


@pytest.mark.parametrize("C,O", [(8, 16), (8, 8), (16, 16), (24, 16)])
def test_shared_memory_fits(C, O):
    """The weight fragments (14 K-steps of 32 lanes' 16 bytes an n-tile and
    chunk) and two box buffers: two blocks an SM at the route's C = 8."""
    plan = k7.launch_plan(C, 8, 16, 64, O)
    assert plan["shared_bytes"] == C // 8 * 14 * (O // 8) * 32 * 16 + 2 * plan["box_bytes"] <= BLOCK_MAX
    assert k7.K7_THREADS // 32 * k7.K7_OUT_STAGE <= plan["box_bytes"]  # the outputs leave through a box
    if C == 8:
        assert 2 * (plan["shared_bytes"] + BLOCK_RESERVED) <= SM_SHARED


def test_plan_at_route_shapes():
    plans = [k7.launch_plan(*shape) for shape in ROUTES]
    assert [p["tiles"] for p in plans] == [1620, 3888, 3888]
    assert all(p["m_tiles_per_warp"] == 2 and p["tasks_per_thread"] == 2 and p["vector_loads"] for p in plans)
    assert plans[0]["tasks"] == 12 * 32 + 45


def test_wrapper_refuses_a_ragged_chunk_in_bf16():
    """The tensor-core body takes C in chunks of 8 in bf16; fp32 (3xTF32,
    a ragged chunk padded with zeros) takes any C."""
    w, b = torch.zeros(16, 12, 3, 3, 3), torch.zeros(16)
    with pytest.raises(ValueError, match="multiples of 8"):
        K.conv3d_down(torch.zeros(12, 4, 6, 10, dtype=torch.bfloat16), w, b)
    assert tuple(K.conv3d_down(torch.zeros(12, 4, 6, 10), w, b).shape) == (16, 2, 3, 5)
    with pytest.raises(ValueError, match="C=12"):
        k7.launch_plan(12, 4, 6, 10)


FP32_CASES = [(8, 16), (16, 8), (12, 16), (28, 16), (3, 16)]  # (C, O): MY = 4, 4, 2, 2, 4


def fp32_geometry(C: int, O: int):
    plan = k7.launch_plan_fp32(C, 8, 16, 64, O)
    MYf = plan["tile"][1]
    return plan, MYf, 2 * MYf + 1, plan["box_bytes"] // 2


@pytest.mark.parametrize("C,O", FP32_CASES)
@pytest.mark.parametrize("shape", ROUTES + RAGGED, ids=[f"{C}x{D}x{h}x{w}" for C, D, h, w in ROUTES + RAGGED])
def test_fp32_tiles_cover_every_output_voxel_once(shape, C, O):
    _, D, h, w = shape
    plan = k7.launch_plan_fp32(C, D, h, w, O)
    tz_, ty_, tx_ = plan["tile"]
    Do, ho, wo = plan["out"]
    hits = np.zeros((Do, ho, wo), np.int64)
    nz, ny, nx = plan["tiles_zyx"]
    for t in range(plan["tiles"]):
        z0, y0, x0 = t // (nx * ny) * tz_, (t // nx) % ny * ty_, t % nx * tx_
        hits[z0 : z0 + tz_, y0 : y0 + ty_, x0 : x0 + tx_] += 1
    assert (hits == 1).all() and plan["vector_loads"] == (w % 4 == 0)


def fp32_warp_tiles(warp: int, MYf: int):
    """Warp ``warp``'s column (my, mx) and its output planes, as the kernel's."""
    cols = MYf * 2
    mzw = 2 * cols // 8
    col, zw = warp % cols, warp // cols * mzw
    return col // 2, (col % 2) * 16, [zw + m for m in range(mzw)]


@pytest.mark.parametrize("C,O", [(8, 16), (12, 16)])
def test_fp32_every_tap_reads_its_input_voxel(C, O):
    """Each warp's lane at each (ky, kx) and input plane hz of its column:
    the ldmatrix row address is the half-box slot (channels 4·(lane // 16)
    ..) of input voxel box row (2·zw + hz)·HY + 2·my + ky, box x 2·ox+kx+1,
    and the planes hz = 2m + kd of its output planes m are the taps kd."""
    plan, MYf, HY, HALF = fp32_geometry(C, O)
    for warp in range(8):
        my, mx, planes = fp32_warp_tiles(warp, MYf)
        for lane in LANES:
            ox = mx + (lane & 7) + ((lane >> 3) & 1) * 8
            for kx in range(3):
                for ky in range(3):
                    for hz in range(2 * len(planes) + 1):
                        got = k7.fp32_lane_offset(lane, warp, kx, MYf) + (hz * HY + ky) * k7.K7F_ROW_BYTES
                        row = (2 * planes[0] + hz) * HY + 2 * my + ky
                        want = (lane >> 4) * HALF + row * k7.K7F_ROW_BYTES + k7.fp32_slot_offset(2 * ox + kx + 1)
                        assert got == want


@pytest.mark.parametrize("C,O", [(8, 16), (12, 16)])
def test_fp32_each_read_slot_is_written_by_one_task(C, O):
    """The load tasks (4-voxel vectors, box x 2 + 4j .. 5 + 4j of a row; a
    row's left voxel, box x 1) write every box voxel a tap reads exactly
    once, at distinct slots inside a half-box."""
    plan, MYf, HY, HALF = fp32_geometry(C, O)
    assert plan["tasks"] <= plan["tasks_per_thread"] * k7.K7F_THREADS
    writes = {}
    for v in range(plan["tasks_per_thread"] * k7.K7F_THREADS):
        task = k7.fp32_load_task(v, MYf)
        if task is None:
            continue
        row, j = task
        for bx in (range(2 + 4 * j, 6 + 4 * j) if j >= 0 else (1,)):
            writes[(row, bx)] = writes.get((row, bx), 0) + 1
    read = {((2 * z + kd) * HY + 2 * my + ky, 2 * (mx + x) + kx + 1)
            for warp in range(8) for my, mx, planes in [fp32_warp_tiles(warp, MYf)] for z in planes
            for x in range(16) for kd, ky, kx in TAPS}
    assert read <= set(writes) and all(n == 1 for n in writes.values())
    offsets = [row * k7.K7F_ROW_BYTES + k7.fp32_slot_offset(bx) for row, bx in writes]
    assert len(set(offsets)) == len(offsets) and min(offsets) >= 0 and max(offsets) + 16 <= HALF


@pytest.mark.parametrize("C,O", [(8, 16), (12, 16)])
def test_fp32_ldmatrix_rows_meet_no_bank_twice(C, O):
    """An ldmatrix.x4 phase of any warp, tap and plane: 8 lanes' 16-byte
    rows on the 8 bank groups of a 128-byte row of banks."""
    plan, MYf, HY, HALF = fp32_geometry(C, O)
    for warp in range(8):
        planes = fp32_warp_tiles(warp, MYf)[2]
        for kx in range(3):
            for ky in range(3):
                for hz in range(2 * len(planes) + 1):
                    for first in range(0, 32, 8):
                        slots = [(k7.fp32_lane_offset(lane, warp, kx, MYf) + (hz * HY + ky) * k7.K7F_ROW_BYTES)
                                 // 16 % 8 for lane in range(first, first + 8)]
                        assert sorted(slots) == list(range(8))


@pytest.mark.parametrize("C,O", [(8, 16), (12, 16)])
def test_fp32_box_stores_meet_no_bank_twice(C, O):
    """A store phase (8 consecutive task slots, one 16-byte half-voxel each):
    2 rows x 4 neighbouring vectors, or 8 rows' left voxels, on 8 bank
    groups; a half-row of an odd number of 16-byte slots makes it so."""
    plan, MYf, HY, HALF = fp32_geometry(C, O)
    assert k7.K7F_ROW_BYTES // 16 % 2 == 1
    for first in range(0, plan["tasks_per_thread"] * k7.K7F_THREADS, 8):
        tasks = [t for t in (k7.fp32_load_task(v, MYf) for v in range(first, first + 8)) if t is not None]
        for k in range(4 if tasks else 0):
            slots = [(row * k7.K7F_ROW_BYTES + k7.fp32_slot_offset(2 + 4 * j + k if j >= 0 else 1)) // 16 % 8
                     for row, j in tasks]
            assert len(set(slots)) == len(slots)


def test_fp32_a_warps_loads_are_whole_lines():
    """A warp's 32 vector tasks: 2 rows x the 16 vectors of a row, 256
    contiguous bytes of each row's channel plane."""
    plan = k7.launch_plan_fp32(8, 48, 216, 288)
    for warp in range(plan["vector_slots"] // 32):
        rows = {}
        for t in (k7.fp32_load_task(warp * 32 + lane) for lane in range(32)):
            if t is not None:
                rows.setdefault(t[0], set()).add(t[1])
        assert rows and all(js == set(range(16)) for js in rows.values()) and len(rows) <= 2


@pytest.mark.parametrize("C,O", FP32_CASES + [(56, 8)])
def test_fp32_shared_memory_fits(C, O):
    """The weight fragments of every chunk (27 taps of 32 lanes' hi/lo
    fragments an n-tile) and two boxes in one block's 227 KB; 2x4x32 tiles
    where the fragments are at most two chunk-n-tiles, as at the routes'
    C = 8, O = 16, else 2x2x32."""
    plan = k7.launch_plan_fp32(C, 8, 16, 64, O)
    chunk_tiles = -(-C // 8) * (O // 8)
    assert plan["tile"] == ((2, 4, 32) if chunk_tiles <= 2 else (2, 2, 32))
    assert plan["shared_bytes"] == chunk_tiles * 27 * 32 * 16 + 2 * plan["box_bytes"] <= BLOCK_MAX


def test_fp32_plan_at_route_shapes():
    plans = [k7.launch_plan_fp32(*shape) for shape in ROUTES]
    assert [p["tiles"] for p in plans] == [1620, 3888, 3888]
    assert all(p["m_tiles_per_warp"] == 2 and p["tasks_per_thread"] == 4 and p["vector_loads"] for p in plans)
    assert plans[0]["tasks"] == 23 * 32 + 45 and plans[0]["shared_bytes"] == 220_608
