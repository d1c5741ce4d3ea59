"""The numerical design of K2's and K7's tensor-core form, on the CPU.

K2 and K7 in bf16 (``csrc/conv3d_mma.cuh``) split each fp32 weight into
``hi = bf16(w)`` and ``lo = bf16(w - hi)`` and sum both products of the bf16
volume in fp32. A plain PyTorch model of that arithmetic, ``conv3d(vol, hi)
+ conv3d(vol, lo)`` in fp32 at the kernel's stride (1 for K2, 2 for K7),
must stay within the one-bf16-ulp tolerance of the plain version
(``|d| <= 2^-7 |plain| + 1e-3``, the card gate of ``chip_smoke.py`` and
``tests/test_torch_cuda.py``); the same model with bf16 weights alone must
not, on the cancellation case (mixed-sign weights at 4x the usual
magnitude, no bias, so many outputs sit near 0). The plain version itself
is held against the JAX package's ``conv3d_front`` in interpret mode (K7's
against ``conv3d_down`` in ``tests/test_torch_costreg_front.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cds_mvsnet_tpu.ops.pallas.conv3d import conv3d_front
from cds_mvsnet_tpu_torch.ops import kernels as K
from test_torch_ops import N, T

torch.set_num_threads(2)

SHAPE = (6, 12, 37)  # D, h, w: no multiple of the kernel's 4x4x32 tile


def split_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's weight staging: hi = bf16(w), lo = bf16(w - hi), as fp32."""
    hi = w.to(torch.bfloat16).float()
    return hi, (w - hi).to(torch.bfloat16).float()


def tensor_core_model(vol, w, b, split: bool = True, stride: int = 1) -> torch.Tensor:
    """K2's (stride 1) or K7's (stride 2) bf16 arithmetic in plain PyTorch:
    exact bf16 products summed in fp32 over hi and, with ``split``, lo;
    bias, ReLU, one rounding to bf16."""
    hi, lo = split_weights(w)
    x = vol.float()[None]
    y = F.conv3d(x, hi, stride=stride, padding=1)[0]
    if split:
        y = y + F.conv3d(x, lo, stride=stride, padding=1)[0]
    return torch.relu(y + b[:, None, None, None]).to(torch.bfloat16)


def excess_over_one_ulp(got, want) -> float:
    """max(|d| - (2^-7 |want| + 1e-3)): <= 0 within K2's tolerance."""
    d = (got.float() - want.float()).abs()
    return float((d - (2 ** -7 * want.float().abs() + 1e-3)).max())


def rig(seed: int, C: int, O: int = 8, cancel: bool = False, shape=SHAPE):
    """A bf16 volume in [-1, 1) and folded weights as the card checks draw
    them (bound (27C)^-1/2, bias in +-0.1); ``cancel``: 4x the bound, no bias."""
    rng = np.random.default_rng(seed)
    vol = T(rng.uniform(-1, 1, (C, *shape)).astype(np.float32)).to(torch.bfloat16)
    bound = (4.0 if cancel else 1.0) * (27 * C) ** -0.5
    w = T(rng.uniform(-bound, bound, (O, C, 3, 3, 3)).astype(np.float32))
    b = T(np.zeros(O, np.float32) if cancel else rng.uniform(-0.1, 0.1, O).astype(np.float32))
    return vol, w, b


def test_split_is_exact_to_two_bf16_terms():
    w = T(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split_weights(w)
    assert torch.equal(hi.to(torch.bfloat16).float(), hi) and torch.equal(lo.to(torch.bfloat16).float(), lo)
    # w - hi is exact in fp32; lo rounds it once: |w - hi - lo| <= 2^-16 |w|
    assert bool(((w - hi - lo).abs() <= 2 ** -16 * w.abs()).all())


@pytest.mark.parametrize("cancel", [False, True])
@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_model_within_one_ulp_of_plain(seed, C, cancel):
    vol, w, b = rig(seed, C, cancel=cancel)
    assert excess_over_one_ulp(tensor_core_model(vol, w, b), K.conv3d_bn_relu_plain(vol, w, b)) <= 0


@pytest.mark.parametrize("seed", [0, 1])
def test_split_model_at_sixteen_outputs(seed):
    """conv2 of the ``3`` fronts: 16 -> 16."""
    vol, w, b = rig(seed, 16, O=16, cancel=True)
    assert excess_over_one_ulp(tensor_core_model(vol, w, b), K.conv3d_bn_relu_plain(vol, w, b)) <= 0


@pytest.mark.parametrize("C", [8, 16, 32])
def test_bf16_weights_alone_miss_the_tolerance(C):
    """Why the kernel splits: bf16 weights alone err by more than 1e-3
    where outputs are near 0."""
    vol, w, b = rig(0, C, cancel=True)
    plain = K.conv3d_bn_relu_plain(vol, w, b)
    assert excess_over_one_ulp(tensor_core_model(vol, w, b, split=False), plain) > 0
    assert excess_over_one_ulp(tensor_core_model(vol, w, b), plain) <= 0


DOWN_SHAPE = (6, 12, 38)  # D, h, w even (K7's contract); w no multiple of 8 nor of the 2x4x32 tile


@pytest.mark.parametrize("cancel", [False, True])
@pytest.mark.parametrize("C,O", [(8, 16), (16, 16), (16, 8)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_model_within_one_ulp_of_plain_at_stride_two(seed, C, O, cancel):
    """K7: conv1 of the ``pallas2``/``pallas3`` fronts (8 -> 16) and the
    other channel counts the wrapper takes in bf16."""
    vol, w, b = rig(seed, C, O=O, cancel=cancel, shape=DOWN_SHAPE)
    got = tensor_core_model(vol, w, b, stride=2)
    assert tuple(got.shape) == (O, 3, 6, 19)
    assert excess_over_one_ulp(got, K.conv3d_down_plain(vol, w, b)) <= 0


@pytest.mark.parametrize("C", [8, 16])
def test_bf16_weights_alone_miss_the_tolerance_at_stride_two(C):
    vol, w, b = rig(0, C, O=16, cancel=True, shape=DOWN_SHAPE)
    plain = K.conv3d_down_plain(vol, w, b)
    assert excess_over_one_ulp(tensor_core_model(vol, w, b, split=False, stride=2), plain) > 0
    assert excess_over_one_ulp(tensor_core_model(vol, w, b, stride=2), plain) <= 0


@pytest.mark.parametrize("C", [8, 32])
def test_plain_matches_conv3d_front(C):
    """The plain version against the TPU conv0 kernel in interpret mode, as
    ``tests/test_torch_cost_reg.py`` does at C = 16."""
    rng = np.random.default_rng(10 + C)
    D, h, w = 4, 8, 24
    vol = rng.uniform(-1, 1, (C, D, h, w)).astype(np.float32)
    vol = np.asarray(jnp.asarray(vol).astype(jnp.bfloat16).astype(jnp.float32))
    wj = (rng.standard_normal((3, 3, 3, C, 8)) / np.sqrt(27 * C)).astype(np.float32)  # (kd, ky, kx, in, out)
    bj = (0.1 * rng.standard_normal(8)).astype(np.float32)
    want = conv3d_front(jnp.asarray(vol).astype(jnp.bfloat16), jnp.asarray(wj), jnp.asarray(bj), kd=4, tr=8,
                        interpret=True)
    want = N(want.astype(jnp.float32))[:, :, :h, :w]
    wt = T(np.transpose(wj, (4, 3, 0, 1, 2))).contiguous()
    got = K.conv3d_bn_relu_plain(T(vol).to(torch.bfloat16), wt, T(bj))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (8, D, h, w)
    # both round one fp32 sum to bf16 (2^-7 relative covers one ulp); the TPU
    # kernel also rounds its weights to bf16: 2^-9 of sum|w||x| (~0.05 here)
    np.testing.assert_allclose(N(got), want, rtol=2 ** -7, atol=2e-2)
