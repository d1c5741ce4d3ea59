"""K1's launch plan (``ops/kernels/warp.py::launch_plan``, made as
``csrc/warp.cu`` makes it) at every shape the entry points hand K1, on the
CPU.

K1 gives a pixel C/16 lanes (one at C = 8) and a block of 256 threads
256/lanes consecutive pixels of the flattened reference; each warp stages
one plane's bf16 ``in_prod`` sub-tile of its 32/lanes pixels in each of two
shared-memory buffers; the blocks cover h*w with a ragged last one. ``tests/test_torch_cuda.py`` holds the
launcher's own plan on the card to this one.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.models import build_model, to_tensors
from cds_mvsnet_tpu_torch.models.stage_net import PLAIN_OPS
from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.ops.kernels.warp import K1_THREADS, launch_plan
from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

torch.set_num_threads(2)

STATIC_SMEM = 48 * 1024  # a block's static shared memory on the card
CHANNELS = (32, 16, 8)  # the FeatureNet's output channels at stages 1-3

# (entry point, cascade input H x W, planes per stage): the serve point
# (bench.py, 1152x864) and the custom scene (test_cli --dataset general at
# 864x1152, no refinement) share shapes; the DTU protocol point runs its
# cascade at half of 1152x1536 under refinement; the stream at 480x640 with
# 512 planes split 128/32/8
POINTS = [("serve", 864, 1152, (48, 32, 8)), ("custom", 864, 1152, (48, 32, 8)),
          ("protocol", 576, 768, (48, 32, 8)), ("stream", 480, 640, (128, 32, 8))]


def stage_shapes(H: int, W: int, ndepths) -> list[tuple[int, int, int, int]]:
    """(C, D, h, w) of K1 at each stage of a cascade on H x W."""
    return [(C, D, H // 2 ** (2 - s), W // 2 ** (2 - s)) for s, (C, D) in enumerate(zip(CHANNELS, ndepths))]


ENTRY_SHAPES = [(point, s + 1, shape) for point, H, W, nd in POINTS for s, shape in enumerate(stage_shapes(H, W, nd))]


def check_plan(C: int, h: int, w: int) -> dict:
    plan = launch_plan(C, h, w)
    lanes, pixels, wp = plan["lanes"], plan["pixels"], plan["warp_pixels"]
    assert lanes == max(C // 16, 1) and lanes * pixels == K1_THREADS and wp * lanes == 32
    # a warp stores a plane's (C, wp) sub-tile as whole 16-byte vectors a
    # lane, each row of wp pixels whole 32-byte sectors
    assert (C * wp * 2) % (16 * 32) == 0 and (wp * 2) % 32 == 0
    assert plan["shared_bytes"] == 2 * C * pixels * 2 <= STATIC_SMEM
    blocks, tail = plan["blocks"], plan["tail"]
    assert (blocks - 1) * pixels < h * w <= blocks * pixels
    assert 0 < tail <= pixels and (blocks - 1) * pixels + tail == h * w
    assert plan["vector_stores"] == (h * w % 8 == 0)
    return plan


@pytest.mark.parametrize("point,stage,shape", ENTRY_SHAPES, ids=[f"{p}{s}" for p, s, _ in ENTRY_SHAPES])
def test_plan_at_entry_point_shapes(point, stage, shape):
    C, D, h, w = shape
    plan = check_plan(C, h, w)
    assert plan["pixels"] == {32: 128, 16: 256, 8: 256}[C]
    # every entry point's in_prod rows take 16-byte stores
    assert plan["vector_stores"]


@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("h,w", [(19, 37), (3, 7), (5, 288), (9, 288), (12, 288), (1, 1)])
def test_plan_covers_ragged_grids(C, h, w):
    """hw no multiple of a block's pixels, hw below them, w = 288 (serve
    stage 1's), hw odd."""
    check_plan(C, h, w)


def test_cascade_hands_k1_the_stage_shapes():
    """The shapes ``stage_shapes`` predicts are the ones the cascade gives
    its warp site, here at 64x128 with the stream's plane split."""
    model = build_model(ModelConfig(refine=False, ndepths=(16, 8, 8)), seed=0, device="cpu")
    b = to_tensors(textured_plane_batch(V=3, H=64, W=128, D=64, seed=0), "cpu")
    seen = []

    def warp(src, ref, depth, rt):
        seen.append((ref.shape[0], depth.shape[0], *ref.shape[1:]))
        return K.warp_entropy_plain(src, ref, depth, rt)

    with torch.no_grad():
        model._cascade(b["imgs"], b["proj_matrices"], b["depth_values"], 0.001, torch.bfloat16,
                       ops=dataclasses.replace(PLAIN_OPS, warp=warp))
    want = stage_shapes(64, 128, (16, 8, 8))
    assert seen == [shape for shape in want for _ in range(2)]  # V - 1 = 2 source views a stage


@pytest.mark.parametrize("C", [4, 12, 24, 64])
def test_wrapper_refuses_other_channel_counts(C):
    src = torch.zeros(6, 7, C, dtype=torch.bfloat16)
    ref = torch.zeros(C, 5, 6, dtype=torch.bfloat16)
    rt = torch.zeros(12)
    with pytest.raises(ValueError, match="src"):
        K.warp_entropy(src, ref, torch.linspace(1.0, 2.0, 3), rt)
    with pytest.raises(ValueError, match="C="):
        launch_plan(C, 5, 6)
