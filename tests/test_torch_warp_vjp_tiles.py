"""K5's launch plan (``ops/kernels/warp_vjp.py::launch_plan``, made as
``csrc/warp.cuh`` makes it) at every shape the train step and route R3 hand
K5, and at ragged ones, on the CPU.

K5's forward and backward take one kind of grid: pixel tiles (256 threads
over consecutive pixels of the flattened reference, a pixel's channels in
lanes of 16 in the forward, of 8 at C = 8 and in the backward) by plane
chunks, as many chunks as give two waves of blocks where D allows. The
backward writes each chunk's fp32 ``d_ref`` partial sums to a scratch
``(chunks, C, h, w)``. ``tests/test_torch_cuda.py`` holds the launchers' own
plans on the card to this one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.ops.kernels.warp_vjp import TARGET_BLOCKS, THREADS, launch_plan

torch.set_num_threads(2)

STATIC_SMEM = 48 * 1024  # a block's static shared memory on the card

# (C, D, h, w) per batch element and source view: the train step at 512x640
# under refinement (the cascade at 256x320, ndepths 48/32/8) sweeps and warps
# its ground truth at D = 1 (models/stage_net.py::stage_net_train); route R3
# (v7m) runs K5's forward at the serve point (1152x864)
TRAIN_SWEEP = [(32, 48, 64, 80), (16, 32, 128, 160), (8, 8, 256, 320)]
TRAIN_GT = [(C, 1, h, w) for C, _, h, w in TRAIN_SWEEP]
R3 = [(32, 48, 216, 288), (16, 32, 432, 576), (8, 8, 864, 1152)]
# (kernel, point, stage, shape): the backward runs only in training
ENTRY_SHAPES = [(kernel, point, s + 1, shape)
                for point, shapes in (("sweep", TRAIN_SWEEP), ("gt", TRAIN_GT), ("r3", R3))
                for kernel in (("forward",) if point == "r3" else ("forward", "backward"))
                for s, shape in enumerate(shapes)]


def check_plan(C: int, D: int, h: int, w: int, kernel: str) -> dict:
    plan = launch_plan(C, D, h, w, kernel)
    lanes, pixels, wp = plan["lanes"], plan["pixels"], plan["warp_pixels"]
    assert lanes == (C // 8 if kernel == "backward" else max(C // 16, 1))
    assert lanes * pixels == THREADS and wp * lanes == 32
    # a warp moves a plane's (C, wp) sub-tile as whole 16-byte vectors a
    # lane, each row of wp pixels one or more 16-byte vectors
    assert (C * wp * 2) % (16 * 32) == 0 and (wp * 2) % 16 == 0
    assert plan["shared_bytes"] == 2 * C * pixels * 2 <= STATIC_SMEM
    tiles, chunk, chunks = plan["tiles"], plan["chunk"], plan["chunks"]
    assert plan["blocks"] == tiles * chunks
    # every pixel and every plane in exactly one block
    pix_hits = np.zeros(h * w, np.int64)
    for t in range(tiles):
        pix_hits[t * pixels : min(h * w, (t + 1) * pixels)] += 1
    plane_hits = np.zeros(D, np.int64)
    for c in range(chunks):
        first, last = c * chunk, min(D, (c + 1) * chunk)
        assert last > first  # no block without planes
        plane_hits[first:last] += 1
    assert (pix_hits == 1).all() and (plane_hits == 1).all()
    assert 0 < plan["tail"] <= pixels and (tiles - 1) * pixels + plan["tail"] == h * w
    assert 0 < plan["last_chunk"] <= chunk and (chunks - 1) * chunk + plan["last_chunk"] == D
    # two waves where D allows: either the blocks reach the target or every
    # chunk is one plane
    assert plan["blocks"] >= TARGET_BLOCKS or chunk == 1
    assert plan["scratch_bytes"] == (chunks * C * h * w * 4 if kernel == "backward" else 0)
    assert plan["vector_io"] == (h * w % 8 == 0)
    return plan


@pytest.mark.parametrize("kernel,point,stage,shape", ENTRY_SHAPES,
                         ids=[f"{k}-{p}{s}" for k, p, s, _ in ENTRY_SHAPES])
def test_plan_at_entry_point_shapes(kernel, point, stage, shape):
    C, D, h, w = shape
    plan = check_plan(C, D, h, w, kernel)
    assert plan["pixels"] == ({32: 128, 16: 256, 8: 256} if kernel == "forward" else {32: 64, 16: 128, 8: 256})[C]
    assert plan["vector_io"]  # every entry point's rows take 16-byte vectors
    # the plans the design was timed at (PERF.md): chunk and chunks; the
    # backward's d_ref scratch (fp32 partial sums of each chunk)
    want = {("forward", "sweep", 1): (3, 16), ("forward", "sweep", 2): (4, 8), ("forward", "sweep", 3): (4, 2),
            ("backward", "sweep", 1): (6, 8), ("backward", "sweep", 2): (8, 4), ("backward", "sweep", 3): (4, 2),
            ("forward", "r3", 1): (24, 2), ("forward", "r3", 2): (32, 1), ("forward", "r3", 3): (8, 1)}
    assert (plan["chunk"], plan["chunks"]) == want.get((kernel, point, stage), (1, 1))
    if kernel == "backward" and point == "sweep":
        assert plan["scratch_bytes"] == {1: 5242880, 2: 5242880, 3: 5242880}[stage]


@pytest.mark.parametrize("kernel", ["forward", "backward"])
@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("D", [1, 2, 7, 13, 48, 200])
@pytest.mark.parametrize("h,w", [(19, 37), (3, 7), (5, 288), (12, 288), (1, 1), (41, 67)])
def test_plan_covers_ragged_grids(C, D, h, w, kernel):
    """hw no multiple of a block's pixels, hw below them, hw odd; D below,
    at and above the chunk count, prime, and 1."""
    check_plan(C, D, h, w, kernel)


def test_chunks_grow_as_tiles_shrink():
    """Fewer pixel tiles take more plane chunks, until every chunk is one plane."""
    chunks = [launch_plan(32, 48, h, 80, "forward")["chunks"] for h in (256, 64, 16, 2)]
    assert chunks == sorted(chunks) and chunks[-1] == 48


@pytest.mark.parametrize("C", [4, 12, 24, 64])
def test_wrapper_refuses_other_channel_counts(C):
    src = torch.zeros(6, 7, C, dtype=torch.bfloat16)
    ref = torch.zeros(C, 5, 6, dtype=torch.bfloat16)
    depth, rt = torch.linspace(1.0, 2.0, 3), torch.zeros(12)
    with pytest.raises(ValueError, match="src"):
        K.warp_sim(src, ref, depth, rt)
    with pytest.raises(ValueError, match="src"):
        K.warp_sim_backward(src, ref, depth, rt, torch.zeros(C, 3, 5, 6, dtype=torch.bfloat16), torch.zeros(3, 5, 6))
    with pytest.raises(ValueError, match="C="):
        launch_plan(C, 3, 5, 6, "backward")


def test_plan_refuses_empty_shapes_and_other_kernels():
    with pytest.raises(ValueError, match="D=0"):
        launch_plan(8, 0, 5, 6, "forward")
    with pytest.raises(ValueError, match="0 x 6"):
        launch_plan(8, 3, 0, 6, "backward")
    with pytest.raises(ValueError, match="kernel"):
        launch_plan(8, 3, 5, 6, "entropy")
