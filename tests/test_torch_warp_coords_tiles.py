"""K8's launch plan (``ops/kernels/warp_coords.py::launch_plan``, made as
``csrc/warp_coords.cu`` makes it) at the routes' shapes, per view and over
the 4 source views of a stage, and at ragged ones, on the CPU.

K8's grid is pixel tiles (128 threads over consecutive pixels of the
flattened reference, one thread a pixel) by plane chunks (as many as give
64 blocks an SM over all views, at least 8 planes each where D allows) by
views. ``tests/test_torch_cuda.py`` holds the launcher's own plan on the
card to this one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.ops.kernels.warp_coords import MIN_PLANES, TARGET_BLOCKS, THREADS, launch_plan

torch.set_num_threads(2)

# (C, D, h, w) of the routes' stages at the serve point (1152x864, ndepths 48/32/8)
SERVE = [(32, 48, 216, 288), (16, 32, 432, 576), (8, 8, 864, 1152)]


def check_plan(V: int, C: int, D: int, h: int, w: int) -> dict:
    plan = launch_plan(V, C, D, h, w)
    pixels, tiles, chunk, chunks = plan["pixels"], plan["tiles"], plan["chunk"], plan["chunks"]
    assert pixels == THREADS and plan["blocks"] == tiles * chunks * V
    # every pixel, plane and view in exactly one block (x: tile, y: chunk, z: view)
    hits = np.zeros((V, D, h * w), np.int64)
    for t in range(tiles):
        for c in range(chunks):
            first, last = c * chunk, min(D, (c + 1) * chunk)
            assert last > first  # no block without planes
            hits[:, first:last, t * pixels : min(h * w, (t + 1) * pixels)] += 1
    assert (hits == 1).all()
    assert 0 < plan["tail"] <= pixels and (tiles - 1) * pixels + plan["tail"] == h * w
    assert 0 < plan["last_chunk"] <= chunk and (chunks - 1) * chunk + plan["last_chunk"] == D
    # the target's blocks over all views, or chunks of the least planes
    assert plan["blocks"] >= TARGET_BLOCKS or chunk == min(D, MIN_PLANES)
    assert chunk >= min(D, MIN_PLANES)
    return plan


@pytest.mark.parametrize("V", [1, 4])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_plan_at_serve_shapes(V, stage):
    """Per view (routes v6s, v6sd, v6sc) and over the 4 source views (v6sb)."""
    C, D, h, w = SERVE[stage - 1]
    plan = check_plan(V, C, D, h, w)
    # the plans the design was timed at (PERF.md): chunk and chunks
    want = {(1, 1): (8, 6), (1, 2): (8, 4), (1, 3): (8, 1), (4, 1): (9, 6), (4, 2): (16, 2), (4, 3): (8, 1)}
    assert (plan["chunk"], plan["chunks"]) == want[(V, stage)]


@pytest.mark.parametrize("V", [1, 4])
@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("D", [1, 2, 7, 48])
@pytest.mark.parametrize("h,w", [(19, 37), (3, 7), (5, 288), (1, 1), (41, 67)])
def test_plan_covers_ragged_grids(V, C, D, h, w):
    """hw no multiple of a block's pixels, hw below them, hw odd; D = 1,
    below, at and above the chunk count."""
    check_plan(V, C, D, h, w)


def test_chunks_grow_as_tiles_shrink_and_views_grow():
    """More chunks as the pixel tiles shrink, down to the least planes; fewer
    as the views grow."""
    chunks = [launch_plan(1, 32, 48, h, 128)["chunks"] for h in (16384, 8192, 4096, 2048, 2)]
    assert chunks == sorted(chunks) and chunks[0] == 1 and chunks[-1] == 48 // MIN_PLANES
    assert launch_plan(4, 32, 48, 1024, 128)["chunks"] < launch_plan(1, 32, 48, 1024, 128)["chunks"]


@pytest.mark.parametrize("C", [4, 12, 24, 64])
def test_wrapper_and_plan_refuse_other_channel_counts(C):
    src = torch.zeros(6, 7, C, dtype=torch.bfloat16)
    ref = torch.zeros(C, 5, 6, dtype=torch.bfloat16)
    px = torch.zeros(3, 5, 6)
    with pytest.raises(ValueError, match="C in"):
        K.warp_sim_coords(src, ref, px, px)
    with pytest.raises(ValueError, match="C in"):
        K.warp_sim_coords_batched(src[None], ref[None], px[None], px[None])
    with pytest.raises(ValueError, match="C="):
        launch_plan(1, C, 3, 5, 6)


def test_plan_refuses_empty_shapes():
    with pytest.raises(ValueError, match="V=0"):
        launch_plan(0, 8, 3, 5, 6)
    with pytest.raises(ValueError, match="D=0"):
        launch_plan(1, 8, 0, 5, 6)
    with pytest.raises(ValueError, match="0 x 6"):
        launch_plan(1, 8, 3, 0, 6)


@pytest.mark.parametrize("C", [8, 32])
def test_plain_at_one_plane_and_a_ragged_grid(C):
    """The CPU path of both entry points (the plain version) at D = 1 and an
    odd h·w: the shapes and the batched call's views."""
    rng = np.random.default_rng(C)
    src = torch.as_tensor(rng.uniform(-1, 1, (2, 9, 11, C)).astype(np.float32)).to(torch.bfloat16)
    ref = torch.as_tensor(rng.uniform(-1, 1, (2, C, 7, 13)).astype(np.float32)).to(torch.bfloat16)
    px = torch.as_tensor(rng.uniform(-2, 12, (2, 1, 7, 13)).astype(np.float32))
    py = torch.as_tensor(rng.uniform(-2, 10, (2, 1, 7, 13)).astype(np.float32))
    ip, sim = K.warp_sim_coords_batched(src, ref, px, py)
    assert tuple(ip.shape) == (2, C, 1, 7, 13) and tuple(sim.shape) == (2, 1, 7, 13)
    for v in range(2):
        ip_v, sim_v = K.warp_sim_coords(src[v], ref[v], px[v], py[v])
        assert torch.equal(ip[v], ip_v) and torch.equal(sim[v], sim_v)
