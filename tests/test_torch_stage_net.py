"""Stage net (warp, visibility, cost volume, UNet, tail) and K1 vs the JAX package."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.models.cost_reg import init_cost_reg_net
from cds_mvsnet_tpu.models.stage_net import init_vis_heads
from cds_mvsnet_tpu.models.stage_net import stage_net as jax_stage_net
from cds_mvsnet_tpu.ops.geometry import homography_warp, relative_warp_transform
from cds_mvsnet_tpu.ops.pallas.warp import warp_pallas_v8
from cds_mvsnet_tpu.ops.sampling import softmax_entropy
from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.models import Routes, build_model, to_tensors
from cds_mvsnet_tpu_torch.models.cost_reg import CostRegNet
from cds_mvsnet_tpu_torch.models.stage_net import KERNEL_OPS, PLAIN_OPS, VisHead, stage_net
from cds_mvsnet_tpu_torch.ops.kernels import warp_entropy, warp_entropy_plain
from cds_mvsnet_tpu_torch.utils.synthetic import synthetic_batch
from test_torch_ops import N, T, jax_highest, load_module, numpy_params, random_cams

torch.set_num_threads(2)


def _features(rng, B, V, C, h, w):
    def one():
        feat = np.tanh(rng.standard_normal((B, h, w, C))).astype(np.float32)
        nc = rng.uniform(0, 1, (B, h, w)).astype(np.float32)
        return feat, (nc**2).astype(np.float32), nc

    return [{"ref": one(), "src": one()} for _ in range(V - 1)]


def _cams(rng, B, V, h, w):
    """Reference plus V-1 sources a few degrees and ~20 units away."""
    cams = np.stack([random_cams(rng, B, h, w, tz=0.2) for _ in range(V)], 1)
    cams[:, 0, 0] = np.eye(4)
    return cams


@pytest.mark.parametrize("stage_idx,C,per_pixel", [(0, 32, False), (2, 8, True)])
def test_stage_net_matches_jax_xla_form(stage_idx, C, per_pixel):
    rng = np.random.default_rng(stage_idx)
    B, V, D, h, w = 2, 3, 8, 16, 24
    vis_p = numpy_params(init_vis_heads, 3, seed=1)
    cr_p = numpy_params(init_cost_reg_net, C, 8, seed=2)
    feats = _features(rng, B, V, C, h, w)
    cams = _cams(rng, B, V, h, w)
    if per_pixel:
        dv = (600 + 40 * rng.standard_normal((B, 1, h, w)) + 12.0 * np.arange(D)[None, :, None, None])
    else:
        dv = np.tile(np.linspace(425, 905, D), (B, 1))
    dv = dv.astype(np.float32)
    with jax_highest():
        want = jax_stage_net(vis_p, cr_p, feats, jnp.asarray(cams), jnp.asarray(dv), stage_idx)

    vis = VisHead()
    load_module(vis, vis_p[str(stage_idx)], f"stage_net.vis.{stage_idx}")
    cr = CostRegNet(C, 8)
    load_module(cr, cr_p, "cost_regularization.0")
    tfeats = [
        {k: (T(f[0]).permute(0, 3, 1, 2).contiguous(), T(f[1]), T(f[2])) for k, f in pair.items()}
        for pair in feats
    ]
    got = stage_net(vis, cr, tfeats, T(cams), T(dv), PLAIN_OPS)
    # fp32 on both sides, summed in other orders; the softmax over D of the
    # UNet logits turns 1e-5 logit differences into ~1e-3 mm of depth
    np.testing.assert_allclose(N(got["depth"]), N(want["depth"]), rtol=0, atol=2e-2)
    np.testing.assert_allclose(N(got["photometric_confidence"]), N(want["photometric_confidence"]), atol=1e-4)
    np.testing.assert_allclose(N(got["norm_curv"]), N(want["norm_curv"]), atol=1e-6)


@pytest.mark.parametrize("stage_idx,C,per_pixel,route", [(0, 32, False, None), (2, 8, True, None),
                                                        (2, 8, False, "v6sb")])
def test_stage_net_batch_equals_each_element_alone(stage_idx, C, per_pixel, route):
    """The stage at B = 3, V = 4, whose volume is built over the whole batch
    (one pose transform and one vis head call over the nine pairs), against
    the same stage run on each element alone: plain fp32 at a per-plane and a
    per-pixel stage, and bf16 under ``v6sb`` (one K8 launch an element)."""
    rng = np.random.default_rng(10 + stage_idx)
    B, V, D, h, w = 3, 4, 8, 16, 24
    vis_p = numpy_params(init_vis_heads, 3, seed=1)
    cr_p = numpy_params(init_cost_reg_net, C, 8, seed=2)
    feats = _features(rng, B, V, C, h, w)
    cams = T(_cams(rng, B, V, h, w))
    if per_pixel:
        dv = (600 + 40 * rng.standard_normal((B, 1, h, w)) + 12.0 * np.arange(D)[None, :, None, None])
    else:
        dv = np.tile(np.linspace(425, 905, D), (B, 1))
    dv = T(dv.astype(np.float32))
    vis = VisHead()
    load_module(vis, vis_p[str(stage_idx)], f"stage_net.vis.{stage_idx}")
    cr = CostRegNet(C, 8)
    load_module(cr, cr_p, "cost_regularization.0")
    dtype, ops = (torch.float32, PLAIN_OPS) if route is None else (torch.bfloat16, KERNEL_OPS)
    tfeats = [
        {k: (T(f[0]).permute(0, 3, 1, 2).contiguous().to(dtype), T(f[1]).to(dtype), T(f[2]).to(dtype))
         for k, f in pair.items()}
        for pair in feats
    ]
    with torch.no_grad():
        got = stage_net(vis, cr, tfeats, cams, dv, ops, route)
        for b in range(B):
            one = [{k: tuple(t[b : b + 1] for t in f) for k, f in pair.items()} for pair in tfeats]
            want = stage_net(vis, cr, one, cams[b : b + 1], dv[b : b + 1], ops, route)
            np.testing.assert_allclose(N(got["depth"][b]), N(want["depth"][0]), rtol=0, atol=1e-5)
            np.testing.assert_allclose(N(got["photometric_confidence"][b]),
                                       N(want["photometric_confidence"][0]), rtol=0, atol=1e-6)
            np.testing.assert_allclose(N(got["norm_curv"][b]), N(want["norm_curv"][0]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("B,V,routes", [(1, 3, None), (3, 4, None), (3, 4, Routes({2: "v6sb"}))])
def test_vis_head_runs_once_a_stage(B, V, routes):
    """An eval forward calls each stage's vis head once, on all B·(V−1)
    (element, source view) pairs: ``(B·(V−1), 2, h, w)``."""
    cfg = ModelConfig()
    model = build_model(cfg, seed=0, device="cpu")
    batch = to_tensors(synthetic_batch(B=B, V=V, H=64, W=64, D=48, seed=1), "cpu")
    calls = {s: [] for s in model.stage_net.vis}
    for s, head in model.stage_net.vis.items():
        head.register_forward_hook(lambda m, args, out, s=s: calls[s].append(tuple(args[0].shape)))
    dtype = torch.float32 if routes is None else torch.bfloat16
    out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"], compute_dtype=dtype, kernels=True,
                routes=routes)
    assert calls == {str(s): [(B * (V - 1), 2, *out[f"stage{s + 1}"]["depth"].shape[1:])]
                     for s in range(cfg.num_stages)}


def _warp_inputs(rng, C, D, H, W):
    rot = (np.eye(3) + 0.02 * rng.standard_normal((3, 3))).astype(np.float32)
    rot[2, :2] *= 0.02
    trans = (50.0 * rng.standard_normal(3)).astype(np.float32)
    rt = np.concatenate([rot.ravel(), trans]).astype(np.float32)
    dep = rng.uniform(400.0, 600.0, (D, H, W)).astype(np.float32)
    src = rng.standard_normal((C, H, W)).astype(np.float32)
    ref = rng.standard_normal((C, H, W)).astype(np.float32)
    return src, ref, dep, rt


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def test_k1_plain_matches_warp_pallas_v8():
    """K1's plain version against the TPU kernel in interpret mode (C8 D8
    16x128: the kernel tiles w by 128)."""
    rng = np.random.default_rng(17)
    C, D, H, W = 8, 8, 16, 128
    src, ref, dep, rt = _warp_inputs(rng, C, D, H, W)
    src, ref = _bf16(src), _bf16(ref)
    ip_j, ent_j = warp_pallas_v8(
        jnp.asarray(src).astype(jnp.bfloat16), jnp.asarray(ref).astype(jnp.bfloat16),
        jnp.asarray(dep), jnp.asarray(rt), w_valid=W, interpret=True,
    )
    src_t = T(src).permute(1, 2, 0).contiguous().to(torch.bfloat16)
    ref_t = T(ref).to(torch.bfloat16)
    ip_t, ent_t = warp_entropy_plain(src_t, ref_t, T(dep), T(rt))
    assert ip_t.dtype == torch.bfloat16 and ip_t.shape == (C, D, H, W)
    # the TPU kernel rounds its bilinear x-weights to bf16 (relative 2^-9),
    # then both round warped and the product to bf16: |d| <= 2^-7 |v| plus
    # 2^-9 of the |src|·|ref| scale (~16 for N(0,1) data)
    ip_j = N(ip_j)
    np.testing.assert_allclose(N(ip_t), ip_j, rtol=2 ** -7, atol=2 ** -9 * 16)
    # the x-weight rounding moves each sim by up to C·2^-9·|ref||src|
    # (~0.03 here); the entropy moves by at most ~log(D)/D·|d sim| per plane
    np.testing.assert_allclose(N(ent_t), N(ent_j), atol=2e-2)
    # the wrapper takes the plain version for CPU tensors
    ip_w, ent_w = warp_entropy(src_t, ref_t, T(dep), T(rt))
    assert torch.equal(ip_w, ip_t) and torch.equal(ent_w, ent_t)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_k1_plain_matches_xla_warp_fp32(per_pixel):
    """In fp32, K1's plain version is homography_warp, the ref product, the
    C-sum and softmax_entropy of the JAX XLA form."""
    rng = np.random.default_rng(5)
    C, D, h, w = 4, 6, 12, 20
    cams = _cams(rng, 1, 2, h, w)
    src = rng.standard_normal((1, h, w, C)).astype(np.float32)
    ref = rng.standard_normal((1, h, w, C)).astype(np.float32)
    if per_pixel:
        dv = rng.uniform(400, 900, (1, D, h, w)).astype(np.float32)
    else:
        dv = np.linspace(400, 900, D, dtype=np.float32)[None]
    with jax_highest():
        warped = homography_warp(jnp.asarray(src), jnp.asarray(cams[:, 0]), jnp.asarray(cams[:, 1]), jnp.asarray(dv))
        want_ip = jnp.asarray(ref)[:, None] * warped  # (1, D, h, w, C)
        sim = jnp.einsum("bhwc,bdhwc->bdhw", jnp.asarray(ref), warped, precision=jax.lax.Precision.HIGHEST)
        want_ent = softmax_entropy(sim, axis=1)[0, 0]
        rot, trans = relative_warp_transform(jnp.asarray(cams[:, 0]), jnp.asarray(cams[:, 1]))
    rt = np.concatenate([np.asarray(rot[0]).ravel(), np.asarray(trans[0]).ravel()])
    ip, ent = warp_entropy_plain(T(src[0]), T(ref[0]).permute(2, 0, 1).contiguous(), T(dv[0]), T(rt))
    assert ip.dtype == torch.float32
    # coordinates from the kernel's per-row form vs a 3x3 product: ~1e-4 px
    np.testing.assert_allclose(N(ip.permute(1, 2, 3, 0)), N(want_ip[0]), atol=1e-3)
    np.testing.assert_allclose(N(ent), N(want_ent), atol=1e-3)


def test_k1_wrapper_checks_its_inputs():
    src = torch.zeros(8, 16, 8, dtype=torch.bfloat16)
    ref = torch.zeros(8, 8, 16, dtype=torch.bfloat16)
    dep = torch.ones(4)
    rt = torch.zeros(12)
    with pytest.raises(ValueError, match="bf16"):
        warp_entropy(src.float(), ref, dep, rt)
    with pytest.raises(ValueError, match="src"):
        warp_entropy(torch.zeros(8, 16, 12, dtype=torch.bfloat16), ref, dep, rt)
    with pytest.raises(ValueError, match="depth"):
        warp_entropy(src, ref, torch.ones(4, 3, 3), rt)
    with pytest.raises(ValueError, match="rt"):
        warp_entropy(src, ref, dep, torch.zeros(9))
    with pytest.raises(ValueError, match="contiguous"):
        warp_entropy(src, ref.transpose(1, 2).contiguous().transpose(1, 2), dep, rt)
