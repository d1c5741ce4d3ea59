"""K5, the fused warp for training, on the CPU: the plain forward against
the JAX package's ``fused_warp_train`` (its Pallas kernel in interpret mode)
and the autograd Function's plain backward against that function's
``jax.vjp``, on the rig of ``tests/test_train_warp_vjp.py`` at C = 8, 16
and 32."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.ops.pallas.warp_vjp import fused_warp_train as jax_fused_warp_train
from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.ops.geometry import relative_warp_transform
from test_torch_ops import N, T

torch.set_num_threads(2)

H, W, D = 16, 40, 4


def rig(C, seed=0):
    """``tests/test_train_warp_vjp.py``'s rig with C channels: smooth
    features, a 0.4 baseline along x, per-pixel depths 8 .. 12."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    feats = np.stack(
        [np.sin(xx / (3.0 + c) + k) * np.cos(yy / (4.0 + c)) for k in range(2) for c in range(C)]
    ).reshape(2, C, H, W).astype(np.float32)
    src, ref = (np.asarray(jnp.asarray(f).astype(jnp.bfloat16).astype(jnp.float32)) for f in feats)
    K_ = np.eye(4, dtype=np.float32)
    K_[0, 0] = K_[1, 1] = 50.0
    K_[0, 2], K_[1, 2] = W / 2, H / 2
    ref_cam = np.zeros((2, 4, 4), np.float32)
    src_cam = np.zeros((2, 4, 4), np.float32)
    ref_cam[0] = np.eye(4)
    E = np.eye(4, dtype=np.float32)
    E[0, 3] = 0.4
    src_cam[0] = E
    ref_cam[1] = K_
    src_cam[1] = K_
    dep = np.broadcast_to(np.linspace(8.0, 12.0, D, dtype=np.float32)[:, None, None], (D, H, W)).copy()
    rng = np.random.default_rng(seed + C)
    w_ip = rng.standard_normal((C, D, H, W)).astype(np.float32)
    w_sim = rng.standard_normal((D, H, W)).astype(np.float32)
    return src, ref, dep, ref_cam, src_cam, w_ip, w_sim


def port_args(src, ref, dep, ref_cam, src_cam):
    """The port's layout: channels-last bf16 source, bf16 reference, fp32
    depth and the 12 homography scalars."""
    rot, trans = relative_warp_transform(T(ref_cam)[None], T(src_cam)[None])
    rt = torch.cat([rot.reshape(9), trans.reshape(3)]).contiguous()
    s = T(src, torch.bfloat16).permute(1, 2, 0).contiguous()
    r = T(ref, torch.bfloat16).contiguous()
    return s, r, T(dep).contiguous(), rt


def jax_call(src, ref, dep, ref_cam, src_cam):
    C = src.shape[0]
    return lambda s, r: jax_fused_warp_train(s, r, jnp.asarray(dep), jnp.asarray(ref_cam), jnp.asarray(src_cam),
                                             8 if C <= 8 else 16, 4, True)


@pytest.mark.parametrize("C", [8, 16, 32])
def test_plain_forward_matches_the_tpu_kernel(C):
    src, ref, dep, ref_cam, src_cam, _, _ = rig(C)
    f = jax_call(src, ref, dep, ref_cam, src_cam)
    ip_j, sim_j = f(jnp.asarray(src).astype(jnp.bfloat16), jnp.asarray(ref).astype(jnp.bfloat16))
    s, r, d, rt = port_args(src, ref, dep, ref_cam, src_cam)
    ip, sim = K.warp_sim_plain(s, r, d, rt)
    assert ip.dtype == torch.bfloat16 and ip.shape == (C, D, H, W)
    assert sim.dtype == torch.float32 and sim.shape == (D, H, W)
    # the TPU kernel rounds its bilinear x-weights to bf16, the port keeps
    # them fp32 and rounds the warped value: tests/test_train_warp_vjp.py's
    # tolerances, except that sim sums C products, each off by up to 2^-9
    # through that rounding, so at C = 32 it may be off by 32 * 2^-9 = 0.0625
    np.testing.assert_allclose(N(ip), N(ip_j), atol=2e-2)
    np.testing.assert_allclose(N(sim), N(sim_j), atol=max(5e-2, 1.5 * C * 2 ** -9))
    # the wrapper takes the plain version for CPU tensors, and so does the
    # Function, without a launch
    before = (K.warp_sim.launches, K.warp_sim_backward.launches)
    for fn in (K.warp_sim, K.fused_warp_train):
        ip2, sim2 = fn(s, r, d, rt)
        assert torch.equal(ip2, ip) and torch.equal(sim2, sim)
    assert (K.warp_sim.launches, K.warp_sim_backward.launches) == before


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("C", [8, 16, 32])
def test_backward_matches_jax_vjp(C):
    """A loss linear in (in_prod, sim): the Function's backward against
    ``jax.grad`` through ``fused_warp_train``'s custom VJP."""
    src, ref, dep, ref_cam, src_cam, w_ip, w_sim = rig(C)
    f = jax_call(src, ref, dep, ref_cam, src_cam)

    def loss(s, r):
        ip, sim = f(s, r)
        return jnp.sum(ip * w_ip) + jnp.sum(sim * w_sim)

    gs_j, gr_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(src).astype(jnp.bfloat16),
                                                jnp.asarray(ref).astype(jnp.bfloat16))
    s, r, d, rt = port_args(src, ref, dep, ref_cam, src_cam)
    s.requires_grad_()
    r.requires_grad_()
    ip, sim = K.fused_warp_train(s, r, d, rt)
    ((ip.float() * T(w_ip)).sum() + (sim * T(w_sim)).sum()).backward()
    assert s.grad.dtype == r.grad.dtype == torch.bfloat16
    # the port's in_prod is bf16, so its cotangent is w_ip rounded to bf16,
    # and each side rounds d_src/d_ref to bf16 once: well within 1e-2
    assert rel_l2(N(s.grad.permute(2, 0, 1)), N(gs_j)) <= 1e-2
    assert rel_l2(N(r.grad), N(gr_j)) <= 1e-2


@pytest.mark.parametrize("C", [8, 32])
def test_function_backward_matches_autograd_of_the_plain_forward(C):
    src, ref, dep, ref_cam, src_cam, w_ip, w_sim = rig(C, seed=1)
    grads = []
    for fn in (K.fused_warp_train, K.warp_sim_plain):
        s, r, d, rt = port_args(src, ref, dep, ref_cam, src_cam)
        s.requires_grad_()
        r.requires_grad_()
        ip, sim = fn(s, r, d, rt)
        ((ip.float() * T(w_ip)).sum() + (sim * T(w_sim)).sum()).backward()
        grads.append((N(s.grad), N(r.grad)))
    # autograd rounds its partial sums of d_ref to bf16, the explicit
    # backward sums in fp32 and rounds once
    for a, b in zip(*grads):
        assert rel_l2(a, b) <= 1e-2


def test_plane_and_per_pixel_depths_agree():
    """``depth (D,)`` is the same sweep as ``(D, h, w)`` with each plane
    constant, forward and backward."""
    src, ref, dep, ref_cam, src_cam, _, _ = rig(16)
    s, r, d, rt = port_args(src, ref, dep, ref_cam, src_cam)
    planes = d[:, 0, 0].contiguous()
    a, b = K.warp_sim_plain(s, r, planes, rt), K.warp_sim_plain(s, r, d, rt)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    g_ip = torch.ones_like(a[0])
    g_sim = torch.ones_like(a[1])
    for x, y in zip(K.warp_sim_backward_plain(s, r, planes, rt, g_ip, g_sim),
                    K.warp_sim_backward_plain(s, r, d, rt, g_ip, g_sim)):
        assert torch.equal(x, y)


def test_out_of_view_corners_contribute_nothing():
    """A sweep whose every sample lands outside the source image: zero
    in_prod and sim, zero gradients, and no NaN from far-off coordinates
    (a plane at z = 0 projects to inf, and its bilinear weights are NaN)."""
    src, ref, dep, ref_cam, src_cam, _, _ = rig(8)
    s, r, _, _ = port_args(src, ref, dep, ref_cam, src_cam)
    # 1e4 px along x at depth 5; depth 0 gives z = -1e-6 + 1e-6 = 0
    rt = torch.tensor([1.0, 0, 1e4, 0, 1.0, 0, 0, 0, 1.0, 1.0, 1.0, -1e-6])
    far = torch.tensor([5.0, 0.0])
    ip, sim = K.warp_sim_plain(s, r, far, rt)
    assert not bool(ip.float().any()) and not bool(sim.any())
    d_src, d_ref = K.warp_sim_backward_plain(s, r, far, rt, torch.ones_like(ip), torch.ones_like(sim))
    assert not bool(d_src.float().any()) and not bool(d_ref.float().any())
    s.requires_grad_()
    ip, sim = K.warp_sim_plain(s, r, far, rt)
    (ip.float().sum() + sim.sum()).backward()
    assert bool(torch.isfinite(s.grad.float()).all()) and not bool(s.grad.float().any())


def test_saves_no_volume():
    """The Function's context holds ``(src, ref, depth, rt)`` and nothing of
    the ``(C, D, h, w)`` size: the backward recomputes the gather."""
    src, ref, dep, ref_cam, src_cam, _, _ = rig(8)
    s, r, d, rt = port_args(src, ref, dep, ref_cam, src_cam)
    s.requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        ip, _ = K.fused_warp_train(s, r, d, rt)
    assert sorted(saved) == sorted([tuple(s.shape), tuple(r.shape), tuple(d.shape), tuple(rt.shape)])
    assert all(np.prod(shape) < ip.numel() for shape in saved)


def test_refuses_what_the_kernel_cannot_take():
    src, ref, dep, ref_cam, src_cam, _, _ = rig(8)
    s, r, d, rt = port_args(src, ref, dep, ref_cam, src_cam)
    with pytest.raises(ValueError, match="bf16"):
        K.fused_warp_train(s.float(), r.float(), d, rt)
    with pytest.raises(ValueError, match="src"):
        K.fused_warp_train(torch.zeros(H, W, 12, dtype=torch.bfloat16), r, d, rt)
    ip, sim = K.warp_sim(s, r, d, rt)
    with pytest.raises(ValueError, match="g_in_prod"):
        K.warp_sim_backward(s, r, d, rt, ip.float(), sim)
    with pytest.raises(ValueError, match="g_sim"):
        K.warp_sim_backward(s, r, d, rt, ip, sim[:1])
