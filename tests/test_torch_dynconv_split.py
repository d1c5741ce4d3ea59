"""The numerical contract of K4, on the CPU: why the kernel keeps the plain
version's fp32 FMA chain instead of the tensor cores' hi/lo split.

A tensor-core form of K4 would split each fp32 branch weight into ``hi =
bf16(w)`` and ``lo = bf16(w - hi)``, run both through bf16 MMAs with fp32
sums and add the two sums before it rounds once to bf16 (the scheme of K2's
``csrc/conv3d_mma.cuh``). Such a form stays within one bf16 ulp of
``dynconv_branches_plain``, but the bf16 cascade needs more: its
DynamicConv mixes the branches with a softmax of the curvature at
temperature 0.001, so rounding a few outputs to the neighbouring bf16 value
moves the stage-3 depth map past the serve gate that ``chip_smoke.py`` holds
the kernel path to. ``split_model`` below, the hi/lo arithmetic in plain
PyTorch, is the witness. The kernel (``csrc/dynconv.cu``) therefore sums
each output in the plain version's order. The plain version itself is held
against the JAX ``sparse_s2d_conv`` in interpret mode in
``tests/test_torch_feature_net.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.models import build_model, to_tensors
from cds_mvsnet_tpu_torch.models.stage_net import PLAIN_OPS
from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.ops.kernels.dynconv import SMEM_LIMIT, shared_bytes, tile_rows
from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

torch.set_num_threads(2)


def split_model(x, ws) -> torch.Tensor:
    """The tensor-core form's arithmetic: exact bf16 products of ``hi =
    bf16(w)`` and ``lo = bf16(w - hi)`` summed in fp32, the two sums added,
    one rounding to bf16 per branch."""
    xf = x.float()
    outs = []
    for w in ws:
        hi = w.to(torch.bfloat16).float()
        lo = (w - hi).to(torch.bfloat16).float()
        pad = w.shape[-1] // 2
        outs.append(F.conv2d(xf, hi, padding=pad) + F.conv2d(xf, lo, padding=pad))
    return torch.cat(outs, 1).to(torch.bfloat16)


@pytest.fixture(scope="module")
def cascade():
    """The bf16 cascade on its plain path at 192x256 (V = 5, D = 192,
    ndepths 48/32/8, temperature 0.001, seeded random weights) and its
    stage-3 depth, with K4's site replaceable."""
    model = build_model(ModelConfig(refine=False, ndepths=(48, 32, 8)), seed=0, device="cpu")
    b = to_tensors(textured_plane_batch(V=5, H=192, W=256, D=192, seed=0), "cpu")
    interval = float(b["depth_values"][0, 1] - b["depth_values"][0, 0])

    def depth(dynconv):
        ops = dataclasses.replace(PLAIN_OPS, dynconv=dynconv)
        with torch.no_grad():
            return model._cascade(b["imgs"], b["proj_matrices"], b["depth_values"], 0.001, torch.bfloat16,
                                  ops=ops)["stage3"]["depth"]

    return depth, depth(K.dynconv_branches_plain), interval


def flipped(n_flips: int, seed: int = 0):
    """The plain version with ``n_flips`` of its outputs one bf16 ulp up."""
    def dynconv(x, ws):
        y = K.dynconv_branches_plain(x, ws)
        flat = y.view(-1)
        idx = torch.from_numpy(np.random.default_rng(seed).choice(flat.numel(), n_flips, replace=False))
        flat[idx] = (flat[idx].view(torch.int16) + 1).view(torch.bfloat16)
        return y
    return dynconv


def test_cascade_needs_the_plain_rounding(cascade):
    """The serve gate (stage-3 depth: median within 1 % and p99 within 25 %
    of the plane interval of the plain bf16 path) needs K4 to round as the
    plain version rounds: the split model, which stays within one ulp,
    misses it, and so do 100 one-ulp flips among K4's 13 M outputs; the same
    outputs give the same depth map."""
    depth, ref, interval = cascade

    def gate(got):
        d = (got - ref).abs().flatten() / interval
        return float(d.median()) <= 0.01 and float(torch.quantile(d, 0.99)) <= 0.25

    assert torch.equal(depth(lambda x, ws: K.dynconv_branches_plain(x, ws).clone()), ref)
    assert not gate(depth(split_model))
    assert not gate(depth(flipped(100)))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 8, 9, 20, dtype=torch.bfloat16)
    w3 = torch.zeros(11, 8, 3, 3)
    with pytest.raises(ValueError, match="OA=12"):
        K.dynconv_branches(x, [torch.zeros(12, 8, 3, 3)])
    with pytest.raises(ValueError, match="weight"):  # even k
        K.dynconv_branches(x, [torch.zeros(11, 8, 4, 4)])
    with pytest.raises(ValueError, match="weight"):  # I of the weight is not x's
        K.dynconv_branches(x, [torch.zeros(11, 16, 3, 3)])
    with pytest.raises(ValueError, match="fp32"):
        K.dynconv_branches(x, [w3.to(torch.bfloat16)])
    with pytest.raises(ValueError, match="bf16"):
        K.dynconv_branches(x.float(), [w3])
    with pytest.raises(ValueError, match="shared memory"):
        K.dynconv_branches(torch.zeros(1, 32, 9, 20, dtype=torch.bfloat16), [torch.zeros(35, 32, 7, 7)] * 4)
    # the CPU takes the plain version for what the kernel takes
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(1, 8, 9, 20, generator=g) * 2 - 1).to(torch.bfloat16)
    ws = [torch.rand(11, 8, k, k, generator=g) - 0.5 for k in (3, 5)]
    assert torch.equal(K.dynconv_branches(x, ws), K.dynconv_branches_plain(x, ws))


@pytest.mark.parametrize("I_,OA,ks", [(8, 11, (3, 5, 7)), (8, 11, (1, 3, 5, 7)), (8, 11, (1,)), (16, 19, (1, 3)),
                                      (16, 19, (5, 1)), (16, 19, (1, 3, 5)), (32, 35, (1, 3)), (32, 35, (1, 5)),
                                      (32, 35, (3,))])
def test_card_shapes_fit_shared_memory(I_, OA, ks):
    """The layers the card tests run fit one block's shared memory."""
    assert shared_bytes(I_, ks, OA) <= SMEM_LIMIT


def test_conv01_tile_shares_an_sm():
    """conv01 (I = 8, k = 3, 5, 7, OA = 11) runs blocks of 32 rows, two to
    an SM: the 38 x 39 fp32 tile of 8 channels and 83 taps x 12 weight slots
    of 8 channels."""
    assert tile_rows(8, (3, 5, 7), 11) == 32
    assert shared_bytes(8, (3, 5, 7), 11) == 4 * (8 * 38 * 39 + 8 * 83 * 12)
    assert 2 * (shared_bytes(8, (3, 5, 7), 11) + 1024) <= SMEM_LIMIT


@pytest.mark.parametrize("layer,I_,ks,OA,stride,rows", [
    ("conv00", 3, (3, 7, 11), 11, 1, 32), ("downsample1", 8, (3,), 16, 2, 16), ("conv10", 16, (3, 5), 19, 1, 16),
    ("downsample2", 16, (3,), 32, 2, 8), ("conv20", 32, (1, 3), 35, 1, 8), ("inner1", 48, (1,), 16, 1, 16),
    ("out2", 16, (1, 3), 19, 1, 32), ("inner2", 24, (1,), 8, 1, 32), ("out3", 8, (1, 3), 11, 1, 32),
])
def test_feature_route_forms_share_an_sm(layer, I_, ks, OA, stride, rows):
    """Every form of the feature route runs two blocks to an SM, at the rows
    ``pick_rows`` gives it: conv00's tile has a halo of 5; a stride-2 tile
    reads a (2·rows + 1) x 65 input box; inner1's 48 channels fit 16 rows."""
    assert tile_rows(I_, ks, OA, stride) == rows
    r = max(ks) // 2
    th, tws = stride * (rows - 1) + 2 * r + 1, (stride * 31 + 2 * r + 1) | 1
    slots = -(-OA // 12) * 12
    tile = -(-I_ * th * tws // 4) * 4
    assert shared_bytes(I_, ks, OA, stride) == 4 * (tile + sum(I_ * k * k * slots for k in ks))
    assert 2 * (shared_bytes(I_, ks, OA, stride) + 1024) <= SMEM_LIMIT
    if stride == 2:
        assert (th, tws) == (2 * rows + 1, 65)
