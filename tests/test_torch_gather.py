"""K9's plain version (``warp_gather_plain``, what the wrapper runs on CPU
tensors) against the JAX package's gather kernels in interpret mode:
``warp_pallas_v3`` on an fp32 source and ``warp_pallas_v6`` on a bf16 one,
both through ``warp_pallas_padded``, which pads the output columns to 128
lanes with ``-1e6`` coordinates and crops them."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.ops.pallas.warp import warp_pallas_padded, warp_pallas_v3
from cds_mvsnet_tpu_torch.ops import kernels as K

torch.set_num_threads(2)

H, W, D, h, w = 21, 45, 3, 16, 100


def coords(seed: int):
    """Coordinates of a plane sweep that leave the image, hit its edges,
    and, where z is near 0, are huge (kept within int32, which the TPU
    kernels convert to)."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(-4.0, W + 3.0, (D, h, w)).astype(np.float32)
    py = rng.uniform(-4.0, H + 3.0, (D, h, w)).astype(np.float32)
    px[0, :4, :6] = [0.0, W - 1.0, W - 1.0 + 2 ** -10, -1.0, -1.0 + 2 ** -10, W - 2.0]
    py[0, 4:8, :6] = [0.0, H - 1.0, H - 1.0 + 2 ** -10, -1.0, -1.0 + 2 ** -10, H - 2.0]
    z = rng.uniform(-1.0, 1.0, (w,)).astype(np.float32) * 1e-6  # z near 0
    px[1, 3] = np.clip(rng.uniform(1, 50, w).astype(np.float32) / z, -1e9, 1e9)
    py[1, 5] = np.clip(rng.uniform(1, 50, w).astype(np.float32) / z, -1e9, 1e9)
    return px, py


@pytest.mark.parametrize("C", [8, 16, 32])
def test_plain_matches_v3_fp32(C):
    rng = np.random.default_rng(C)
    src = rng.standard_normal((H, W, C)).astype(np.float32)
    px, py = coords(C)
    want = np.asarray(warp_pallas_padded(jnp.asarray(src), jnp.asarray(px), jnp.asarray(py), variant="v3",
                                         interpret=True))
    got = K.warp_gather(torch.tensor(src), torch.tensor(px), torch.tensor(py))
    assert got.dtype == torch.float32 and tuple(got.shape) == (C, D, h, w)
    # the same four fp32 terms summed in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(src).max())


def test_plain_matches_v3_on_aligned_widths():
    """No padding: 128 output columns go to v3 directly."""
    rng = np.random.default_rng(5)
    src = rng.standard_normal((H, W, 8)).astype(np.float32)
    px = rng.uniform(-2.0, W + 1.0, (2, 8, 128)).astype(np.float32)
    py = rng.uniform(-2.0, H + 1.0, (2, 8, 128)).astype(np.float32)
    want = np.asarray(warp_pallas_v3(jnp.asarray(src), jnp.asarray(px), jnp.asarray(py), interpret=True))
    got = K.warp_gather(torch.tensor(src), torch.tensor(px), torch.tensor(py)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(src).max())


@pytest.mark.parametrize("C", [8, 16, 32])
def test_plain_matches_v6_bf16(C):
    rng = np.random.default_rng(10 + C)
    src = torch.tensor(rng.standard_normal((H, W, C)).astype(np.float32)).bfloat16()
    px, py = coords(10 + C)
    want = warp_pallas_padded(jnp.asarray(src.float().numpy()).astype(jnp.bfloat16), jnp.asarray(px),
                              jnp.asarray(py), variant="v6", ky=8, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = K.warp_gather(src, torch.tensor(px), torch.tensor(py))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # fp32 sums of the same terms in another order (v6 lerps in x, then y),
    # each rounded once to bf16: one bf16 ulp of the result, plus the fp32
    # rounding of a sum that cancels near 0
    assert np.all(np.abs(got - want) <= 2 ** -7 * np.abs(want) + 1e-6 * float(src.float().abs().max()))
    assert (got == want).mean() > 0.99


def test_padding_and_nonfinite_coordinates_give_zeros():
    src = torch.ones(4, 5, 8)
    px = torch.tensor([[[-1e6, float("nan"), float("inf"), -float("inf"), 1e30, 2.0]]])
    py = torch.tensor([[[-1e6, 1.0, 1.0, 1.0, 1.0, float("nan")]]])
    out = K.warp_gather(src, px, py)
    assert torch.equal(out, torch.zeros(8, 1, 1, 6))
    # half a pixel past the last column: one corner left, weight 0.5
    out = K.warp_gather(src, torch.tensor([[[4.5, 4.0]]]), torch.tensor([[[1.0, 3.0]]]))
    assert torch.equal(out[:, 0, 0], torch.tensor([[0.5, 1.0]] * 8))


def test_wrapper_checks_and_cpu_route():
    src = torch.zeros(6, 7, 16)
    px = torch.zeros(2, 3, 4)
    before = K.warp_gather.launches
    assert K.warp_gather(src, px, px).shape == (16, 2, 3, 4)
    assert K.warp_gather.launches == before  # the CPU takes the plain version
    with pytest.raises(ValueError, match="src"):
        K.warp_gather(torch.zeros(6, 7, 12), px, px)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        K.warp_gather(src.half(), px, px)
    with pytest.raises(ValueError, match="px and py must be fp32"):
        K.warp_gather(src, px.double(), px.double())
    with pytest.raises(ValueError, match="py"):
        K.warp_gather(src, px, torch.zeros(2, 3, 5))
    with pytest.raises(ValueError, match="contiguous"):
        K.warp_gather(src, px.transpose(1, 2), px.transpose(1, 2))
