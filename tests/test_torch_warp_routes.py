"""The warp routes: K8's plain version (``warp_sim_coords``, what the wrapper
runs on CPU tensors) against the JAX package's px/py fused warps in
interpret mode (``warp_pallas_v6s``, ``warp_pallas_v6sd``,
``warp_pallas_v6s_batched``), and the route grammar with what each route
runs. The slice as a whole is ``tests/test_torch_routed_stage.py``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.ops.pallas.warp import warp_pallas_v6s, warp_pallas_v6s_batched, warp_pallas_v6sd
from cds_mvsnet_tpu_torch.models import Routes
from cds_mvsnet_tpu_torch.models.stage_net import KERNEL_OPS, route_warp
from cds_mvsnet_tpu_torch.models.warp_routes import FRONTS, WARP_ROUTES, parse_route
from cds_mvsnet_tpu_torch.ops import kernels as K
from test_torch_ops import N

torch.set_num_threads(2)

H, W, D, h, w = 21, 45, 4, 8, 128  # the TPU kernels tile w by 128 and h by 8


def coords(rng):
    """Coordinates that leave the image, hit its edges, and, where z is near
    0, are huge (kept within int32, which the TPU kernels convert to)."""
    px = rng.uniform(-4.0, W + 3.0, (D, h, w)).astype(np.float32)
    py = rng.uniform(-4.0, H + 3.0, (D, h, w)).astype(np.float32)
    px[0, :4, :6] = [0.0, W - 1.0, W - 1.0 + 2 ** -10, -1.0, -1.0 + 2 ** -10, W - 2.0]
    py[0, 4:8, :6] = [0.0, H - 1.0, H - 1.0 + 2 ** -10, -1.0, -1.0 + 2 ** -10, H - 2.0]
    z = rng.uniform(-1.0, 1.0, (w,)).astype(np.float32) * 1e-6  # z near 0
    px[1, 3] = np.clip(rng.uniform(1, 50, w).astype(np.float32) / z, -1e9, 1e9)
    py[1, 5] = np.clip(rng.uniform(1, 50, w).astype(np.float32) / z, -1e9, 1e9)
    return px, py


def views(C, V, seed):
    """V source/reference pairs: bf16 ``src (V, H, W, C)``, ``ref (V, C, h,
    w)`` and fp32 ``px, py (V, D, h, w)`` as tensors."""
    rng = np.random.default_rng(seed)
    src = torch.tensor(rng.standard_normal((V, H, W, C)).astype(np.float32)).bfloat16()
    ref = torch.tensor(rng.standard_normal((V, C, h, w)).astype(np.float32)).bfloat16()
    pxy = [coords(rng) for _ in range(V)]
    return src, ref, torch.tensor(np.stack([p[0] for p in pxy])), torch.tensor(np.stack([p[1] for p in pxy]))


def jnp16(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def assert_close(got, want, scale):
    """in_prod: one bf16 ulp of the product (v6s lerps in y, then x: the same
    fp32 terms in another order, so warped may sit one ulp away), exact at
    nearly every element; sim: 1e-3 of the sum of its |terms|."""
    ip, sim = (N(t) for t in got)
    ip_w, sim_w = (N(t) for t in want)
    assert np.all(np.abs(ip - ip_w) <= 2 ** -7 * np.abs(ip_w) + 1e-6 * scale)
    assert (ip == ip_w).mean() > 0.99
    assert np.all(np.abs(sim - sim_w) <= 1e-3 * np.abs(ip_w).sum(-4) + 1e-6 * scale)


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("variant", ["v6s", "v6sd"])
def test_plain_matches_v6s_and_v6sd(C, variant):
    src, ref, px, py = views(C, 1, seed=C)
    args = (jnp16(src[0].permute(2, 0, 1)), jnp16(ref[0]), jnp.asarray(px[0].numpy()), jnp.asarray(py[0].numpy()))
    if variant == "v6s":
        want = warp_pallas_v6s(*args, ky=8 if C <= 8 else 16, interpret=True)
    else:
        want = warp_pallas_v6sd(*args, ky=8 if C <= 8 else 16, kd=2, interpret=True)
    got = K.warp_sim_coords(src[0].contiguous(), ref[0].contiguous(), px[0].contiguous(), py[0].contiguous())
    assert got[0].dtype == torch.bfloat16 and tuple(got[0].shape) == (C, D, h, w)
    assert got[1].dtype == torch.float32 and tuple(got[1].shape) == (D, h, w)
    scale = float(src.float().abs().max() * ref.float().abs().max())
    assert_close(got, want, scale)


def test_batched_plain_matches_v6s_batched_and_per_view():
    C, V = 8, 3
    src, ref, px, py = views(C, V, seed=21)
    want = warp_pallas_v6s_batched(jnp16(src.permute(0, 3, 1, 2)), jnp16(ref), jnp.asarray(px.numpy()),
                                   jnp.asarray(py.numpy()), ky=8, interpret=True)
    got = K.warp_sim_coords_batched(src, ref, px, py)
    assert tuple(got[0].shape) == (V, C, D, h, w) and tuple(got[1].shape) == (V, D, h, w)
    assert_close(got, want, float(src.float().abs().max() * ref.float().abs().max()))
    for v in range(V):  # the batched form is the per-view function, view by view
        ip, sim = K.warp_sim_coords(src[v], ref[v], px[v], py[v])
        assert torch.equal(ip, got[0][v]) and torch.equal(sim, got[1][v])


def test_plain_matches_k9_then_product():
    """K8 is K9's gather, the bf16 product with ref and the fp32 C-sum."""
    src, ref, px, py = views(32, 1, seed=3)
    ip, sim = K.warp_sim_coords(src[0], ref[0], px[0], py[0])
    warped = K.warp_gather_plain(src[0], px[0], py[0])
    assert torch.equal(ip, ref[0][:, None] * warped)
    assert torch.equal(sim, (warped.float() * ref[0].float()[:, None]).sum(0))


def test_wrappers_check_their_inputs():
    src, ref, px, py = views(8, 2, seed=1)
    before = [k.launches for k in K.ROUTE_KERNELS]
    K.warp_sim_coords(src[0], ref[0], px[0], py[0])
    assert [k.launches for k in K.ROUTE_KERNELS] == before  # the CPU takes the plain version
    with pytest.raises(ValueError, match="C in"):
        K.warp_sim_coords(torch.zeros(H, W, 12, dtype=torch.bfloat16), torch.zeros(12, h, w, dtype=torch.bfloat16),
                          px[0], py[0])
    with pytest.raises(ValueError, match="bf16"):
        K.warp_sim_coords(src[0].float(), ref[0].float(), px[0], py[0])
    with pytest.raises(ValueError, match="fp32"):
        K.warp_sim_coords(src[0], ref[0], px[0].double(), py[0].double())
    with pytest.raises(ValueError, match="px"):
        K.warp_sim_coords(src[0], ref[0], px[0, :, :4], py[0, :, :4])
    with pytest.raises(ValueError, match="ref"):
        K.warp_sim_coords_batched(src, ref[:1], px, py)
    with pytest.raises(ValueError, match="contiguous"):
        K.warp_sim_coords(src[0], ref[0].transpose(1, 2).contiguous().transpose(1, 2), px[0], py[0])


# every route name of the JAX package's grammar (cds_mvsnet_tpu/models/
# warp_routes.py, stage_net.py:339-509, cost_reg.py:151-252) and the port
# function that runs it
JAX_WARP_ROUTES = {
    "v8": "warp_entropy", "v8s": "warp_sim", "v7m": "warp_sim", "v6sdc": "warp_sim",
    "v6s": "warp_sim_coords", "v6sc": "warp_sim_coords", "v6sd": "warp_sim_coords",
    "v6sb": "warp_sim_coords_batched", "v6sball": "warp_sim_coords_batched",
    "v6": "warp_gather", "v3": "warp_gather", "xla": "warp_gather_plain",
}


def test_route_grammar_parse():
    """Counterpart of ``tests/test_stage_batch.py::test_route_grammar_parse``:
    every JAX route name maps to the port entry point that runs it; the
    tile suffixes the JAX grammar takes, and unknown names, raise."""
    assert WARP_ROUTES == JAX_WARP_ROUTES
    assert set(FRONTS) == {"pallas", "pallasf", "pallasf3", "pallas2", "pallas3", "s2d"}
    for name in FRONTS:
        assert parse_route(name, FRONTS) == name
    for name in JAX_WARP_ROUTES:
        assert parse_route(name, WARP_ROUTES) == name
    for name in ("v8s2y12t16", "v8r", "v8q4", "v8t24", "v7m2y12", "v6sdco4y12", "v6sdcg", "v6sd8", "v6sky12",
                 "v6ky16"):
        with pytest.raises(ValueError, match="tile geometry"):
            parse_route(name, WARP_ROUTES)
    for name in ("pallas_interp", "pallasf3_interp"):
        with pytest.raises(ValueError, match="interpret mode"):
            parse_route(name, FRONTS)
    for name in ("v9", "gather", ""):
        with pytest.raises(ValueError, match="unknown route"):
            parse_route(name, WARP_ROUTES)
    r = Routes({1: "v6s", 3: "v6sb"}, front="pallasf3")
    assert (r.warp, r.front, r.stage(1), r.stage(2), r.stage(3)) == ({1: "v6s", 3: "v6sb"}, "pallasf3", "v6s",
                                                                     "v8", "v6sb")
    with pytest.raises(ValueError, match="tile geometry"):
        Routes({2: "v8s4"})
    with pytest.raises(ValueError, match="stages"):
        Routes({4: "v8"})
    with pytest.raises(ValueError, match="interpret"):
        Routes(front="pallas2_interp")
    # what each route's per-view warp calls, on CPU tensors
    assert route_warp(None, KERNEL_OPS) is KERNEL_OPS.warp and route_warp("v8", KERNEL_OPS) is K.warp_entropy


@pytest.mark.parametrize("warp_route", sorted(JAX_WARP_ROUTES))
def test_every_route_runs_its_function(monkeypatch, warp_route):
    """Each route's warp calls the port function ``WARP_ROUTES`` names, and
    its ``(in_prod, entropy)`` agrees with K1's plain warp on one view."""
    calls = []
    for name in set(JAX_WARP_ROUTES.values()):
        fn = getattr(K, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)

        monkeypatch.setattr(K, name, spy)
    rng = np.random.default_rng(8)
    C, Hs, Ws, hs, ws, Ds = 8, 12, 20, 10, 16, 6
    src = torch.tensor(rng.standard_normal((Hs, Ws, C)).astype(np.float32)).bfloat16()
    ref = torch.tensor(rng.standard_normal((C, hs, ws)).astype(np.float32)).bfloat16()
    rt = torch.tensor([1.01, 0.02, -1.5, -0.015, 0.99, 2.0, 1e-4, -2e-4, 1.0, 3.0, -2.0, 0.05])
    depth = torch.linspace(2.0, 40.0, Ds)
    ip, ent = route_warp(warp_route, KERNEL_OPS)(src, ref, depth, rt)
    expected = JAX_WARP_ROUTES[warp_route]
    if expected == "warp_sim_coords_batched":  # per view, as the JAX v6sb runs at V = 2
        expected = "warp_sim_coords"
    assert calls == [expected]
    ip_p, ent_p = K.warp_entropy_plain(src, ref, depth, rt)
    # coordinates from sweep_coords' 3x3 product against K1's per-row form:
    # ~1e-4 px, so a warped value may move by a bf16 ulp or two
    assert ip.dtype == torch.bfloat16 and tuple(ip.shape) == (C, Ds, hs, ws)
    np.testing.assert_allclose(N(ip), N(ip_p), rtol=2 ** -6, atol=2e-2)
    np.testing.assert_allclose(N(ent), N(ent_p), atol=2e-2)
