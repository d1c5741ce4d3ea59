"""The plain reference of CDS-MVSNet's cascade: eval and train forward.

Plain PyTorch, written as functions of a flat parameter dict whose keys are
the model's ``state_dict`` keys, so the benchmark hands both sides the same
tensors. It imports nothing of the program and takes nothing the program
made: the epipoles, the plane-sweep homographies, the hypotheses and the
folded BatchNorm of the cost volume's first conv are all worked out here
again, by other means where one exists (epipoles as the projection of the
other camera's centre, homographies from the 4x4 projections in fp64, the
bilinear warp with ``F.grid_sample``, resizes with ``F.interpolate``).

Precision: every tensor is held in fp32, and a :class:`Rounding` rounds
what the configuration stores in its compute dtype (activations after each
layer, the conv weights it casts) to that dtype and back; geometry,
softmaxes, entropies and regressions stay fp32, as the configuration
states. ``Rounding(torch.float32)`` is exact fp32; the control of
``correct`` is the same reference at the next precision down (fp8).

The layer equations follow the published description (CDS-MVSNet, Giang et
al., ICLR 2022: curvature-guided dynamic-scale features, a visibility-
weighted cascade cost volume, a 3-D UNet, soft-argmin, depth refinement).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["Rounding", "eval_cascade", "eval_chain", "eval_features", "eval_stage", "stage_hypotheses",
           "train_cascade", "eval_feature_block", "eval_feature_heads", "eval_refine_block", "DYN_KERNELS",
           "FEATURE_BLOCKS", "REFINE_BLOCKS"]

EPS_BN = 1e-5
DYN_KERNELS = {"conv00": (3, 7, 11), "conv01": (3, 5, 7), "conv10": (3, 5), "conv11": (3, 5), "conv20": (1, 3),
               "conv21": (1, 3), "out1": (1, 3), "out2": (1, 3), "out3": (1, 3)}
STAGE_SCALES = (4, 2, 1)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype, grad_dtype):
        ctx.grad_dtype = grad_dtype
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.grad_dtype).to(g.dtype), None, None


class Rounding:
    """Rounds fp32 tensors to ``dtype`` (values) and their gradients to
    ``grad_dtype`` (default: ``dtype``; fp8 trains e4m3 values with e5m2
    gradients)."""

    def __init__(self, dtype: torch.dtype, grad_dtype: torch.dtype | None = None):
        self.dtype = dtype
        self.grad_dtype = grad_dtype or (torch.float8_e5m2 if dtype == torch.float8_e4m3fn else dtype)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return x
        return _Round.apply(x, self.dtype, self.grad_dtype)


class _Ctx:
    """The parameters, the rounding and, in training, where the BN
    statistics go (``bn_calls``: one record a BN call, in call order)."""

    def __init__(self, P: dict, q: Rounding, train: bool, record: dict | None = None):
        self.P, self.q, self.train = P, q, train
        self.bn_calls: list = []
        self.record = record  # FeatureNet block -> [(input, epipole, output)], when asked
        self.margins = None  # dynamic conv -> its branch logits' top-2 gap over T, when asked

    def w(self, key):
        return self.q(self.P[key])


# ---------------------------------------------------------------- layers

def _conv(c: _Ctx, x, key, stride=1, bias=None):
    w = c.w(key)
    pad = (w.shape[-1] - 1) // 2
    conv = F.conv2d if w.ndim == 4 else F.conv3d
    y = conv(x, w, None, stride=stride, padding=pad)
    if bias is not None:
        y = c.q(y) + c.w(bias).reshape(1, -1, *([1] * (y.ndim - 2)))
    return c.q(y)


def _deconv(c: _Ctx, x, key):
    conv = F.conv_transpose2d if x.ndim == 4 else F.conv_transpose3d
    return c.q(conv(x, c.w(key), stride=2, padding=1, output_padding=1))


def _bn(c: _Ctx, x, prefix, groups: int = 1):
    """BatchNorm over channel 1. Eval: the running statistics. Train: the
    statistics of each of ``groups`` equal parts of the batch (one part per
    upstream module call), each call recorded for the running update."""
    P = c.P
    shape = (1, -1) + (1,) * (x.ndim - 2)
    weight, bias = P[prefix + ".weight"].reshape(shape), P[prefix + ".bias"].reshape(shape)
    if not c.train:
        mean, var = P[prefix + ".running_mean"].reshape(shape), P[prefix + ".running_var"].reshape(shape)
        return c.q((x - mean) / torch.sqrt(var + EPS_BN) * weight + bias)
    outs = []
    for part in x.chunk(groups, 0):
        dims = (0, *range(2, x.ndim))
        mean = part.mean(dims, keepdim=True)
        var = part.var(dims, unbiased=False, keepdim=True)
        n = part.numel() // part.shape[1]
        c.bn_calls.append((prefix, mean.detach().reshape(-1), var.detach().reshape(-1) * n / max(n - 1, 1)))
        outs.append((part - mean) / torch.sqrt(var + EPS_BN) * weight + bias)
    return c.q(torch.cat(outs, 0))


def _instance_norm(c: _Ctx, x):
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dims, keepdim=True)
    var = x.var(dims, unbiased=False, keepdim=True)
    return c.q((x - mean) / torch.sqrt(var + EPS_BN))


def _leaky(x):
    return F.leaky_relu(x, 0.1)


def _conv_bn_relu(c, x, prefix, stride=1, groups=1):
    return torch.relu(_bn(c, _conv(c, x, prefix + ".conv.weight", stride), prefix + ".bn", groups))


def _deconv_bn_relu(c, x, prefix):
    return torch.relu(_bn(c, _deconv(c, x, prefix + ".conv.weight"), prefix + ".bn"))


# ---------------------------------------------------------------- geometry

def _project_centre(cam, other):
    """The pixel at which ``cam (B,2,4,4)`` sees ``other``'s centre, fp64:
    the epipole of the pair in ``cam``'s image."""
    E, K = cam[:, 0].double(), cam[:, 1, :3, :3].double()
    Eo = other[:, 0].double()
    centre = -torch.linalg.solve(Eo[:, :3, :3], Eo[:, :3, 3:])  # (B, 3, 1)
    p = K @ (E[:, :3, :3] @ centre + E[:, :3, 3:])
    z = p[:, 2]
    z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8) * torch.where(z < 0, -1.0, 1.0), z)
    return (p[:, :2] / z[:, None])[..., 0]


def _homography(ref_cam, src_cam):
    """``(rot (B,3,3), trans (B,3,1))`` fp64 from the 4x4 projections:
    ``src_proj @ inv(ref_proj)``, as the upstream ``homo_warping``."""

    def proj(cam):
        P = cam[:, 0].double().clone()
        P[:, :3, :4] = cam[:, 1, :3, :3].double() @ cam[:, 0, :3, :4].double()
        return P

    M = proj(src_cam) @ torch.linalg.inv(proj(ref_cam))
    return M[:, :3, :3], M[:, :3, 3:4]


def _sweep(c: _Ctx, src, ref, depth, rot, trans):
    """One source view at one batch element: ``src (C,H,W)``, ``ref
    (C,h,w)``, ``depth (D,)`` or ``(D,h,w)`` -> ``(in_prod (C,D,h,w),
    sim (D,h,w) fp32)``: bilinear with zeros outside the source, the warped
    value held in the compute dtype."""
    C, h, w = ref.shape
    H, W = src.shape[1:]
    D = depth.shape[0]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=ref.device),
                            torch.arange(w, dtype=torch.float64, device=ref.device), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
    ray = (rot @ pix).reshape(3, 1, h, w)
    d = depth.double().reshape(D, 1, 1) if depth.ndim == 1 else depth.double()
    pts = ray * d[None] + trans.reshape(3, 1, 1, 1)
    px = pts[0] / (pts[2] + 1e-6)
    py = pts[1] / (pts[2] + 1e-6)
    grid = torch.stack([px / ((W - 1) / 2) - 1, py / ((H - 1) / 2) - 1], -1).float()  # (D, h, w, 2)
    warped = F.grid_sample(src[None], grid.reshape(1, D * h, w, 2), mode="bilinear", padding_mode="zeros",
                           align_corners=True)[0].reshape(C, D, h, w)
    warped = c.q(warped)
    return c.q(ref[:, None] * warped), (ref[:, None] * warped).sum(0)


def _entropy(sim, dim):
    logp = torch.log_softmax(sim.detach(), dim)
    return -(logp.exp() * logp).sum(dim)


# ---------------------------------------------------------------- features

def _direction_quad(epipole, h, w):
    xs = torch.arange(w, dtype=torch.float32, device=epipole.device)
    ys = torch.arange(h, dtype=torch.float32, device=epipole.device)
    u = xs[None, None, :] - epipole[:, 0, None, None].float()
    v = ys[None, :, None] - epipole[:, 1, None, None].float()
    u, v = torch.broadcast_tensors(u, v)
    n = torch.sqrt(u * u + v * v) + 1e-6
    u, v = u / n, v / n
    return torch.stack([u * u, 2 * u * v, v * v], 1)


def _dynamic_conv(c: _Ctx, x, epipole, T, name, bias: bool, groups: int):
    pre = f"feature.{name}" + ("" if name.startswith("out") else ".conv")
    quad = c.q(_direction_quad(epipole, *x.shape[-2:]))
    results, curvs = [], []
    for i, _ in enumerate(DYN_KERNELS[name]):
        res = _conv(c, x, f"{pre}.convs.{i}.weight", bias=f"{pre}.convs.{i}.bias" if bias else None)
        coef = _conv(c, x, f"{pre}.att_convs.{i}.weight")
        results.append(res)
        curvs.append(c.q((coef * quad).sum(1, keepdim=True)))
    curv = torch.cat(curvs, 1)
    a = _conv(c, curv, f"{pre}.att_weights.0.weight")
    a = torch.relu(_bn(c, a, f"{pre}.att_weights.1", groups))
    a = _conv(c, a, f"{pre}.att_weights.3.weight")
    att = c.q(torch.softmax(a / T, 1))
    if c.margins is not None:
        top = (a / T).float().topk(2, dim=1).values
        c.margins[name] = top[:, 0] - top[:, 1]
    out = c.q(sum(r * att[:, i : i + 1] for i, r in enumerate(results)))
    return out, c.q((curv * att).sum(1))


def _up2(x):
    return x.repeat_interleave(2, -2).repeat_interleave(2, -1)


def feature_net(c: _Ctx, x, epipole, T, groups: int = 1):
    """``x (N,3,h,w)`` (rounded), ``epipole (N,2)`` -> per stage ``(feat,
    mean squared curvature, |curvature|)``."""

    def keep(name, x, e, out):
        if c.record is not None:
            c.record.setdefault(name, []).append((x, e, out))
        return out

    def dyn(name, x, e):
        y, nc = _dynamic_conv(c, x, e, T, name, False, groups)
        return keep(name, x, e, (_leaky(_instance_norm(c, y)), nc))

    def head(name, x, e):
        y, nc = keep(name, x, e, _dynamic_conv(c, x, e, T, name, True, groups))
        return c.q(torch.tanh(_instance_norm(c, y))), nc

    def plain(name, x, stride):
        return keep(name, x, None, _leaky(_instance_norm(c, _conv(c, x, f"feature.{name}.conv.weight", stride))))

    c00, n00 = dyn("conv00", x, epipole)
    c01, n01 = dyn("conv01", c00, epipole)
    e1, e2 = epipole / 2, epipole / 4
    c10, n10 = dyn("conv10", plain("downsample1", c01, 2), e1)
    c11, n11 = dyn("conv11", c10, e1)
    c20, n20 = dyn("conv20", plain("downsample2", c11, 2), e2)
    c21, n21 = dyn("conv21", c20, e2)
    out = {}
    f1, n22 = head("out1", c21, e2)
    out["stage1"] = (f1, c.q((n20**2 + n21**2 + n22**2) / 3), n22.abs())
    i1 = plain("inner1", torch.cat([_up2(c21), c11], 1), 1)
    f2, n12 = head("out2", i1, e1)
    out["stage2"] = (f2, c.q((n10**2 + n11**2 + n12**2) / 3), n12.abs())
    i2 = plain("inner2", torch.cat([_up2(f2), c01], 1), 1)
    f3, n02 = head("out3", i2, epipole)
    out["stage3"] = (f3, c.q((n00**2 + n01**2 + n02**2) / 3), n02.abs())
    return out


# ---------------------------------------------------------------- heads

def vis_head(c: _Ctx, x, s):
    pre = f"stage_net.vis.{s}"
    for i in range(3):
        x = _conv_bn_relu(c, x, f"{pre}.{i}")
    return c.q(torch.sigmoid(_conv(c, x, f"{pre}.3.weight", bias=f"{pre}.3.bias")))


def cost_reg(c: _Ctx, vol, s):
    """``vol (B,C,D,h,w)`` -> the UNet exit ``(B,8,D,h,w)``. Eval: conv0 in
    fp32 weights with its BN (the program folds them; the sum is the
    same)."""
    pre = f"cost_regularization.{s}"
    if c.train:
        x = _conv_bn_relu(c, vol, pre + ".conv0")
    else:
        P = c.P
        shape = (1, -1, 1, 1, 1)
        g = P[pre + ".conv0.bn.weight"] / torch.sqrt(P[pre + ".conv0.bn.running_var"] + EPS_BN)
        y = F.conv3d(vol, P[pre + ".conv0.conv.weight"], padding=1)
        x = c.q(torch.relu((y - P[pre + ".conv0.bn.running_mean"].reshape(shape)) * g.reshape(shape)
                           + P[pre + ".conv0.bn.bias"].reshape(shape)))
    conv2 = _conv_bn_relu(c, _conv_bn_relu(c, x, pre + ".conv1", 2), pre + ".conv2")
    conv4 = _conv_bn_relu(c, _conv_bn_relu(c, conv2, pre + ".conv3", 2), pre + ".conv4")
    y = _conv_bn_relu(c, _conv_bn_relu(c, conv4, pre + ".conv5", 2), pre + ".conv6")
    y = c.q(conv4 + _deconv_bn_relu(c, y, pre + ".conv7"))
    y = c.q(conv2 + _deconv_bn_relu(c, y, pre + ".conv9"))
    return c.q(x + _deconv_bn_relu(c, y, pre + ".conv11"))


def _confidence(prob):
    """Mass in ``[idx-1, idx+2]`` around the truncated expected plane index."""
    D = prob.shape[1]
    j = torch.arange(D, dtype=prob.dtype, device=prob.device).reshape(1, D, 1, 1)
    idx = (prob * j).sum(1, keepdim=True).long().clamp(0, D - 1)
    total = 0.0
    for off in (-1, 0, 1, 2):
        k = idx + off
        ok = (k >= 0) & (k < D)
        total = total + torch.where(ok, prob.gather(1, k.clamp(0, D - 1)), torch.zeros_like(idx, dtype=prob.dtype))
    return total[:, 0]


def refine(c: _Ctx, img, depth, dmin, dmax):
    """``img (B,3,H,W)`` rounded, ``depth (B,H/2,W/2)`` fp32 in plane
    intervals, the range ``(B,)`` in plane intervals -> ``(B,H,W)``."""
    def keep(name, x, out):
        if c.record is not None:
            c.record.setdefault("refine", {})[name] = (x, out)
        return out

    rng = (dmax - dmin)[:, None, None, None]
    d = (depth[:, None] - dmin[:, None, None, None]) / rng * 10
    c0 = keep("conv0", img, _conv_bn_relu(c, img, "refine_network.conv0"))
    y = keep("conv1", c.q(d), _conv_bn_relu(c, c.q(d), "refine_network.conv1"))
    y = keep("conv2", y, _conv_bn_relu(c, y, "refine_network.conv2"))
    y = _deconv(c, y, "refine_network.deconv.weight")
    y = torch.relu(keep("bn", y, _bn(c, y, "refine_network.bn")))
    x3 = torch.cat([y, c0], 1)
    x3 = keep("conv3", x3, _conv_bn_relu(c, x3, "refine_network.conv3"))
    return keep("out", x3, refine_tail(c, x3, depth, dmin, dmax, img.shape[-2:]))


def refine_tail(c: _Ctx, x3, depth, dmin, dmax, hw):
    """The refinement's last conv on ``x3``, added to the bilinear upsample
    (corners aligned) of the depth normalised to [0, 10] over the range."""
    rng = (dmax - dmin)[:, None, None, None]
    d = (depth[:, None] - dmin[:, None, None, None]) / rng * 10
    res = _conv(c, x3, "refine_network.res.weight")
    up = F.interpolate(d, size=tuple(hw), mode="bilinear", align_corners=True)
    return (((up + res) / 10) * rng + dmin[:, None, None, None])[:, 0]


# ---------------------------------------------------------------- cascade

def _hypotheses(depth_values, prev, ndepth, ratio, interval, out_hw, work_hw):
    dmin, dmax = depth_values[:, 0], depth_values[:, -1]
    if prev is None:
        j = torch.arange(ndepth, device=dmin.device, dtype=torch.float32)
        return dmin[:, None] + j[None] * ((dmax - dmin) / (ndepth - 1))[:, None]
    cur = F.interpolate(prev[:, None], size=work_hw, mode="bilinear", align_corners=False)[:, 0]
    step = (ratio * interval)[:, None, None, None]
    j = torch.arange(ndepth, device=cur.device, dtype=torch.float32).reshape(1, -1, 1, 1)
    samples = cur[:, None] - (ndepth - 1) // 2 * step + j * step
    samples = torch.minimum(torch.maximum(samples, dmin[:, None, None, None]), dmax[:, None, None, None])
    if tuple(out_hw) != tuple(work_hw):
        samples = F.interpolate(samples, size=out_hw, mode="bilinear", align_corners=False)
    return samples


def _stage(c: _Ctx, s: int, pairs, cams, hyp, gt=None) -> dict:
    """Stage ``s`` (0-based) from its features: ``pairs[v-1] = (ref (feat,
    nc_sum, nc), src (feat, nc_sum, nc))`` for each source view, ``cams
    (B,V,2,4,4)`` at the stage's resolution, ``hyp (B,D)`` or
    ``(B,D,h,w)``."""
    B, V = cams.shape[:2]
    vol = vis_sum = fd = gt_fd = None
    for v in range(1, V):
        ref_f, _, ref_nc = pairs[v - 1][0]
        src_f = pairs[v - 1][1][0]
        rot, trans = _homography(cams[:, 0], cams[:, v])
        prods, sims, gsims = [], [], []
        for b in range(B):
            ip, sim = _sweep(c, src_f[b], ref_f[b], hyp[b], rot[b], trans[b])
            prods.append(ip)
            sims.append(sim)
            if gt is not None:
                gsims.append(_sweep(c, src_f[b], ref_f[b], gt[b][None].float(), rot[b], trans[b])[1])
        sim = torch.stack(sims)
        vis = vis_head(c, torch.stack([c.q(_entropy(sim, 1)), ref_nc], 1), s)[:, 0]
        term = c.q(torch.stack(prods) * vis[:, None, None])
        vol = term if vol is None else c.q(vol + term)
        vis_sum = vis if vis_sum is None else c.q(vis_sum + vis)
        if c.train:
            fd = sim * vis[:, None] if fd is None else fd + sim * vis[:, None]
            if gt is not None:
                g = torch.stack(gsims) * vis[:, None]
                gt_fd = g if gt_fd is None else gt_fd + g
    denom = vis_sum[:, None] + 1e-6
    y = cost_reg(c, c.q(vol / denom[:, None]), s)
    key = f"cost_regularization.{s}.prob.weight"
    logits = F.conv3d(y, c.w(key) if c.train else c.P[key], padding=1)[:, 0]
    if c.train:
        logits = c.q(logits)
    prob = torch.softmax(logits.float(), 1)
    hyp_b = hyp[:, :, None, None] if hyp.ndim == 2 else hyp
    out = {"depth": (prob * hyp_b).sum(1), "photometric_confidence": _confidence(prob.detach()),
           "norm_curv": sum((p[0][1] + p[1][1]) / 2 for p in pairs) / (V - 1)}
    if c.train:
        out["feat_distance"] = fd / denom if gt is None else torch.cat([fd / denom, gt_fd / denom], 1)
    return out


def _pair_features(c: _Ctx, imgs, cams3, T, refine_on: bool):
    """Upstream's 2(V-1) FeatureNet calls: per source view v, the reference
    image with the pair's epipole and view v with its own."""
    V = imgs.shape[1]
    work = imgs[:, :, ::2, ::2] if refine_on else imgs
    pairs = []
    for v in range(1, V):
        e_ref = _project_centre(cams3[:, 0], cams3[:, v]).float()
        e_src = _project_centre(cams3[:, v], cams3[:, 0]).float()
        pairs.append(tuple(feature_net(c, c.q(x.permute(0, 3, 1, 2).float()), e, T)
                           for x, e in ((work[:, 0], e_ref), (work[:, v], e_src))))
    return pairs


def _refine_full(c: _Ctx, imgs, depth3, depth_values):
    interval = depth_values[:, 1] - depth_values[:, 0]
    img = c.q(imgs[:, 0].permute(0, 3, 1, 2).float())
    return refine(c, img, depth3 / interval[:, None, None], depth_values[:, 0] / interval,
                  depth_values[:, -1] / interval) * interval[:, None, None]


def stage_hypotheses(depth_values, prev, s: int, model_cfg: dict, work_hw):
    """Stage ``s``'s hypotheses: stage 1 respans the range, later stages
    window the previous depth (``None`` at stage 1)."""
    dv = depth_values.float()
    sc = STAGE_SCALES[s]
    return _hypotheses(dv, prev, model_cfg["ndepths"][s], model_cfg["depth_intervals_ratio"][s],
                       dv[:, 1] - dv[:, 0], (work_hw[0] // sc, work_hw[1] // sc), work_hw)


def _cascade(c: _Ctx, imgs, proj, depth_values, T, model_cfg, gt=None):
    pairs = _pair_features(c, imgs, proj["stage3"].float(), T, model_cfg["refine"])
    return _chain(c, imgs, pairs, proj, depth_values, model_cfg, gt)


def _chain(c: _Ctx, imgs, pairs, proj, depth_values, model_cfg, gt=None):
    """The stages from their features on, each on its previous stage's
    depth, then the refinement on stage 3's."""
    H, W = imgs.shape[2:4]
    refine_on = model_cfg["refine"]
    work_hw = (H // 2, W // 2) if refine_on else (H, W)
    depth_values = depth_values.float()
    interval = depth_values[:, 1] - depth_values[:, 0]
    out, prev = {}, None
    for s in range(3):
        name = f"stage{s + 1}"
        hyp = stage_hypotheses(depth_values, prev, s, model_cfg, work_hw)
        st = _stage(c, s, [(r[name], x[name]) for r, x in pairs], proj[name].float(), hyp,
                    None if gt is None else gt[name])
        if c.train and gt is not None:
            hyp_b = hyp[:, :, None, None] if hyp.ndim == 2 else hyp
            st["feat_target"] = _feat_target(hyp_b, gt[name].float(), interval * STAGE_SCALES[s], STAGE_SCALES[s])
        out[name] = st
        prev = st["depth"].detach()
    out["refined_depth"] = _refine_full(c, imgs, prev, depth_values) if refine_on else prev
    return out


def _feat_target(hyp, gt, interval, scale):
    B, h, w = gt.shape
    near = ((hyp - gt[:, None]).abs() / interval[:, None, None, None]) < (0.5 / scale)
    near = near.expand(B, hyp.shape[1], h, w).float()
    return torch.cat([near, torch.ones((B, 1, h, w), device=gt.device)], 1)


@torch.no_grad()
def eval_cascade(P: dict, imgs, proj, depth_values, temperature: float, model_cfg: dict, q: Rounding,
                 record: dict | None = None) -> dict:
    """The eval forward: ``imgs (B,V,H,W,3)`` fp32, ``proj[stage]
    (B,V,2,4,4)``, ``depth_values (B,D)``; every BN on its running
    statistics. Returns per stage ``depth`` and ``photometric_confidence``,
    and ``refined_depth``; ``record`` collects the FeatureNet's blocks (as
    :func:`eval_features`) and, under ``"refine"``, each refinement
    piece's ``(input, output)``."""
    return _cascade(_Ctx(P, q, False, record), imgs, proj, depth_values, temperature, model_cfg)


def train_cascade(P: dict, batch: dict, temperature: float, model_cfg: dict, q: Rounding):
    """The train forward on batch statistics: ``(outputs, bn_calls)``, the
    BN records ``(prefix, mean, unbiased var)`` in call order."""
    c = _Ctx(P, q, True)
    out = _cascade(c, batch["imgs"], batch["proj_matrices"], batch["depth_values"], temperature, model_cfg,
                   gt=batch["depth"])
    return out, c.bn_calls


@torch.no_grad()
def eval_features(P: dict, imgs, proj, temperature: float, model_cfg: dict, q: Rounding,
                  record: dict | None = None) -> list:
    """The FeatureNet's outputs of every (ref, src) pair: a list over the
    source views of ``(ref, src)``, each ``{stage: (feat, nc_sum, |nc|)}``.
    ``record`` collects each block's ``(input, epipole, output)`` per call,
    in call order (per source view: the reference image, then view v)."""
    return _pair_features(_Ctx(P, q, False, record), imgs, proj["stage3"].float(), temperature, model_cfg["refine"])


@torch.no_grad()
def eval_chain(P: dict, pairs, imgs, proj, depth_values, model_cfg: dict, q: Rounding) -> dict:
    """The cascade from the given features on (``pairs`` as
    :func:`eval_features` gives them), each stage on the reference's own
    previous depth and the refinement on its own stage-3 depth: per stage
    ``depth`` and ``photometric_confidence``, and ``refined_depth``."""
    return _chain(_Ctx(P, q, False), imgs, pairs, proj, depth_values, model_cfg)


@torch.no_grad()
def eval_stage(P: dict, s: int, pairs, cams, hyp, q: Rounding) -> dict:
    """Stage ``s`` (0-based) on the given features (``pairs`` as
    :func:`eval_features` gives them, at this stage) and hypotheses:
    ``depth`` and ``photometric_confidence``."""
    return _stage(_Ctx(P, q, False), s, pairs, cams.float(), hyp)


FEATURE_BLOCKS = ("conv00", "conv01", "downsample1", "conv10", "conv11", "downsample2", "conv20", "conv21", "out1",
                  "inner1", "out2", "inner2", "out3")


@torch.no_grad()
def eval_feature_block(P: dict, name: str, x, epipole, temperature: float, q: Rounding):
    """One FeatureNet block on the given input, as the model's module of
    that name returns it (a dynamic block ``(leaky(IN(y)), curvature)``, a
    plain block ``leaky(IN(conv))``, a head's dynamic conv ``(y,
    curvature)``), and for a dynamic conv the gap between its two largest
    branch logits over the temperature, per pixel (None for a plain
    block)."""
    c = _Ctx(P, q, False)
    x = x.float()
    if name.startswith("downsample") or name.startswith("inner"):
        stride = 2 if name.startswith("downsample") else 1
        return _leaky(_instance_norm(c, _conv(c, x, f"feature.{name}.conv.weight", stride))), None
    c.margins = {}
    y, nc = _dynamic_conv(c, x, epipole.float(), temperature, name, name.startswith("out"), 1)
    if name.startswith("out"):
        return (y, nc), c.margins[name]
    return (_leaky(_instance_norm(c, y)), nc), c.margins[name]


@torch.no_grad()
def eval_feature_heads(heads, curvatures, q: Rounding) -> dict:
    """The FeatureNet's outputs from its heads' dynamic convs: ``heads =
    (y_out1, y_out2, y_out3)``, ``curvatures[stage] = (nc_a, nc_b, nc_head)``
    -> ``{stage: (tanh(IN(y)), mean squared curvature, |head curvature|)}``."""
    c = _Ctx({}, q, False)
    out = {}
    for i, y in enumerate(heads):
        a, b, h = (t.float() for t in curvatures[f"stage{i + 1}"])
        out[f"stage{i + 1}"] = (c.q(torch.tanh(_instance_norm(c, y.float()))), c.q((a**2 + b**2 + h**2) / 3), h.abs())
    return out


REFINE_BLOCKS = ("conv0", "conv1", "conv2", "deconv", "bn", "conv3", "out")


@torch.no_grad()
def eval_refine_block(P: dict, name: str, x, q: Rounding, depth=None, dmin=None, dmax=None, hw=None):
    """One piece of the refinement on the given input: a ConvBnReLU
    (``conv0`` .. ``conv3``), the transposed conv (``deconv``), its BN
    (``bn``), or ``out``, the last conv and the upsampled depth it is added
    to (``depth``, ``dmin``, ``dmax`` in plane intervals, ``hw`` the
    output's size)."""
    c = _Ctx(P, q, False)
    x = x.float()
    if name == "deconv":
        return _deconv(c, x, "refine_network.deconv.weight")
    if name == "bn":
        return _bn(c, x, "refine_network.bn")
    if name == "out":
        return refine_tail(c, x, depth.float(), dmin.float(), dmax.float(), hw)
    return _conv_bn_relu(c, x, f"refine_network.{name}")
