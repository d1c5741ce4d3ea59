"""One cascade stage: plane-sweep cost volume with learned visibility,
regularisation, and the soft-argmin tail.

Counterpart of the XLA form of ``cds_mvsnet_tpu/models/stage_net.py::stage_net``
(:171-296). Per source view, the warp returns ``in_prod = ref ⊙ warped`` and
the similarity ``sim = Σ_C in_prod`` (or, at eval, K1 returns the entropy of
``softmax_D(sim)`` directly); the vis head maps (entropy, ref |curvature|) to
a weight in (0, 1), and ``volume_sum += in_prod · vis``. Then ``volume_mean
= volume_sum / (vis_sum + 1e-6)`` goes through the cost-regularisation UNet
and the softmax/regression tail.

- :func:`stage_net`, eval: each stage's volume over the whole batch, with
  one pose transform and one vis head call over its B·(V−1) (element,
  source view) pairs and the warp per pair; then the regularisation and the
  exit per batch element. It runs through one of three :class:`Ops`:
  ``KERNEL_OPS`` (bf16: K1 warps, K2 runs the UNet's conv0 and
  K3, ``ops/kernels/regress.py``, the exit), ``FP32_OPS`` (fp32: K9 gathers,
  :func:`warp_entropy_gather`, and K2 runs conv0) or ``PLAIN_OPS``.
  ``cost_dtype`` (the JAX package's ``cost_dtype``,
  ``_stage_net_pallas_tail`` :524-530) casts the visibility-weighted mean,
  taken in the features' dtype, before the regularisation: the warp and the
  vis head keep the features' dtype, conv0 and the front follow the
  volume's, and so does the exit (:func:`cost_tail`: K3 takes a bf16
  volume, an fp32 one the plain tail, as the JAX package's fp32 evals keep
  the XLA tail, :544). A warp
  route and a cost-reg front (``models/warp_routes.py``, the JAX package's
  ``_stage_net_pallas`` dispatch at :332-509) put other kernels in the
  warp's and conv0's place: :func:`route_warp`, and for ``v6sb``/``v6sball``
  with V > 2 one K8 launch per element over all its source views and
  ``volume_sum = Σ_v in_prod·vis`` in one sum (:339-398).
- :func:`stage_net_train`, train (``train=True`` there): the warp is K5
  (``ops/kernels/warp_vjp.py``) or its plain version, launched per batch
  element and source view, once over the hypotheses and once at the GT depth
  (the same function at D=1, :267-270). Everything else sees the whole batch,
  so each BN's batch statistics and its one EMA step are those of the JAX
  package. The stage also returns ``feat_distance = Σ_v sim·vis / (vis_sum
  + 1e-6)``, with the GT similarity as its last plane.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch import nn

from ..ops import kernels as K
from ..ops.geometry import relative_warp_transform, sweep_coords
from ..ops.sampling import confidence_regression, depth_regression, softmax_entropy
from ..utils.profiling import span
from .cost_reg import CostRegNet
from .layers import ConvBnReLU2d, conv2d
from .warp_routes import BATCHED_ROUTES, WARP_ROUTES, parse_route

__all__ = ["VisHead", "StageNet", "Ops", "stage_net", "stage_net_train", "warp_entropy_gather", "route_warp",
           "cost_tail", "KERNEL_OPS", "FP32_OPS", "PLAIN_OPS"]


@dataclass(frozen=True)
class Ops:
    """The four kernel sites of the cascade: the wrappers or their plain
    versions. ``dynconv`` runs the FeatureNet convs of the feature route
    (conv01 unless a ``Routes`` names others)."""

    warp: object
    conv0: object
    exit: object
    dynconv: object


def stage_coords(ref, depth, rt):
    """``(px, py)``, each ``(D, h, w)`` fp32: ``plane_sweep_coords``'
    arithmetic from the pair's 12 scalars ``rt``, as the JAX package feeds its
    px/py kernels (``stage_net.py:405``)."""
    C, h, w = ref.shape
    D = depth.shape[0]
    px, py = sweep_coords(rt[:9].reshape(1, 3, 3), rt[9:].reshape(1, 3, 1), depth[None], h, w)
    return px.reshape(D, h, w), py.reshape(D, h, w)


def warp_entropy_gather(src, ref, depth, rt, gather=K.warp_gather):
    """The fp32 route's warp, ``warp_entropy``'s contract: source-pixel
    coordinates from :func:`stage_coords`, K9's gather, then ``in_prod = ref
    ⊙ warped``, ``sim = Σ_C f32(warped)·f32(ref)`` and the entropy of
    ``softmax_D(sim)`` in plain PyTorch, as the JAX package's unfused routes
    (``stage_net.py:405``, ``:480-507``). It runs K9 at every stage; the JAX
    package's C ≤ 8 crossover (``:412-427``) was measured on its TPU. The
    bf16 routes ``v6``/``v3`` run it too, and ``xla`` with the plain
    ``gather``."""
    warped = gather(src, *stage_coords(ref, depth, rt))  # (C, D, h, w)
    in_prod = ref[:, None] * warped
    sim = (warped.float() * ref.float()[:, None]).sum(0)
    return in_prod, softmax_entropy(sim[None], dim=1)[0, 0]


def _sim_entropy(warp):
    """A warp that returns ``(in_prod, sim)`` as one that returns ``(in_prod,
    entropy of softmax_D(sim))``."""

    def run(src, ref, depth, rt):
        in_prod, sim = warp(src, ref, depth, rt)
        return in_prod, softmax_entropy(sim[None], dim=1)[0, 0]

    return run


def _coords_warp(src, ref, depth, rt):
    return K.warp_sim_coords(src, ref, *stage_coords(ref, depth, rt))


def route_warp(route: str | None, ops: "Ops"):
    """The per-view warp ``(src, ref, depth, rt) -> (in_prod, entropy)`` of
    a warp route (``models/warp_routes.py``); ``None`` is ``ops.warp``. The
    batched routes, where they run per view (V = 2), are K8 per view, as the
    JAX package's ``v6sb`` falls to ``v6s`` there."""
    if route is None:
        return ops.warp
    entry = WARP_ROUTES[parse_route(route, WARP_ROUTES)]
    return {
        "warp_entropy": K.warp_entropy,
        "warp_sim": _sim_entropy(K.warp_sim),
        "warp_sim_coords": _sim_entropy(_coords_warp),
        "warp_sim_coords_batched": _sim_entropy(_coords_warp),
        "warp_gather": functools.partial(warp_entropy_gather, gather=K.warp_gather),
        "warp_gather_plain": functools.partial(warp_entropy_gather, gather=K.warp_gather_plain),
    }[entry]


KERNEL_OPS = Ops(K.warp_entropy, K.conv3d_bn_relu, K.exit_softargmin, K.dynconv_branches)
FP32_OPS = Ops(warp_entropy_gather, K.conv3d_bn_relu, K.exit_softargmin_plain, K.dynconv_branches_plain)
PLAIN_OPS = Ops(K.warp_entropy_plain, K.conv3d_bn_relu_plain, K.exit_softargmin_plain,
                K.dynconv_branches_plain)


def cost_tail(ops: Ops, dtype) -> Ops:
    """The Ops whose ``conv0`` and ``exit`` run a cost volume of ``dtype``:
    the kernel sets take the dtype's (``KERNEL_OPS`` for bf16, K3 at the
    exit; ``FP32_OPS`` for fp32, the plain tail); any other set, the plain
    one included, stays as it is."""
    if ops in (KERNEL_OPS, FP32_OPS):
        return KERNEL_OPS if dtype == torch.bfloat16 else FP32_OPS
    return ops


class VisHead(nn.Sequential):
    """(entropy, ref |curvature|) -> visibility: 2->16->16->16 ConvBnReLU,
    then a 1x1 conv with bias and a sigmoid."""

    def __init__(self):
        super().__init__(
            ConvBnReLU2d(2, 16), ConvBnReLU2d(16, 16), ConvBnReLU2d(16, 16),
            nn.Conv2d(16, 1, 1, bias=True),
        )

    def forward(self, x, stats=None):
        if stats is None and x.device.type == "cpu" and x.shape[0] > 1:
            # PyTorch's CPU conv picks its algorithm by batch size (oneDNN
            # above 1, its own for a small input at 1), so at eval, where no
            # sample's weight depends on another, take them one at a time:
            # a pair's visibility then does not depend on the pairs beside it.
            return torch.cat([self._head(x[i : i + 1]) for i in range(x.shape[0])])
        return self._head(x, stats)

    def _head(self, x, stats=None):
        for i in range(3):
            x = self[i](x, stats)
        return torch.sigmoid(conv2d(x, self[3].weight, self[3].bias))


class StageNet(nn.Module):
    def __init__(self, num_stages: int):
        super().__init__()
        self.vis = nn.ModuleDict({str(s): VisHead() for s in range(num_stages)})


def _pair_transforms(cams):
    """``rt (B, V−1, 12)`` fp32 of every (element, source view) pair from one
    :func:`relative_warp_transform` call: a row holds the pair's rotation,
    row-major, then its translation."""
    B, V = cams.shape[:2]
    cam = cams.shape[2:]
    ref = cams[:, :1].expand(B, V - 1, *cam).reshape(-1, *cam)
    rot, trans = relative_warp_transform(ref, cams[:, 1:].reshape(-1, *cam))
    return torch.cat([rot.reshape(B, V - 1, 9), trans.reshape(B, V - 1, 3)], -1).float()


def _visibility(vis_head, entropy, features):
    """One vis head call over every pair: ``entropy (B, V−1, h, w)`` and each
    view's ``ref_nc`` -> ``vis (B, V−1, h, w)``. Eval BN normalises with its
    running statistics, so a pair's weight does not depend on the others."""
    B, n, h, w = entropy.shape
    ref_nc = torch.stack([f["ref"][2] for f in features], 1)
    x = torch.stack([entropy.to(ref_nc.dtype), ref_nc], 2).view(B * n, 2, h, w)
    return vis_head(x).view(B, n, h, w)


def _view_volume(vis_head, warp, features, cams, hyps):
    """``(volume_sum (B, C, D, h, w), vis_sum (B, h, w))``: the warp per
    (element, source view) pair, then ``volume_sum[b] += in_prod·vis`` in view
    order, a product rounded and then a sum rounded, as one element at a time
    would."""
    B, V = cams.shape[:2]
    rts = _pair_transforms(cams)
    srcs = [f["src"][0].permute(0, 2, 3, 1).contiguous() for f in features]  # (B, H, W, C)
    prods, entropies = [], []
    for b in range(B):
        for v, f in enumerate(features):
            in_prod, entropy = warp(srcs[v][b], f["ref"][0][b].contiguous(), hyps[b], rts[b, v])
            prods.append(in_prod)
            entropies.append(entropy)
    vis = _visibility(vis_head, torch.stack(entropies).view(B, V - 1, *entropies[0].shape), features)
    volume_sum = prods[0].new_empty((B, *prods[0].shape))
    for i, in_prod in enumerate(prods):
        b, v = divmod(i, V - 1)
        if v == 0:
            torch.mul(in_prod, vis[b, v], out=volume_sum[b])
        else:
            volume_sum[b] += in_prod * vis[b, v]
    vis_sum = vis[:, 0]
    for v in range(1, V - 1):
        vis_sum = vis_sum + vis[:, v]
    return volume_sum, vis_sum


def _batched_volume(vis_head, features, cams, hyps):
    """``(volume_sum, vis_sum)`` as :func:`_view_volume`, from one K8 launch an
    element over all its V−1 source views (routes ``v6sb``/``v6sball``)."""
    B, V = cams.shape[:2]
    rts = _pair_transforms(cams)
    prods, entropies = [], []
    for b in range(B):
        refs = [f["ref"][0][b] for f in features]
        pxs, pys = zip(*(stage_coords(ref, hyps[b], rts[b, v]) for v, ref in enumerate(refs)))
        srcs = [f["src"][0][b].permute(1, 2, 0) for f in features]
        in_prod, sim = K.warp_sim_coords_batched(*(torch.stack(t).contiguous() for t in (srcs, refs, pxs, pys)))
        prods.append(in_prod)
        entropies.append(softmax_entropy(sim, dim=1)[:, 0])  # (V-1, h, w)
    vis = _visibility(vis_head, torch.stack(entropies), features)
    volume_sum = torch.stack([(in_prod * vis[b][:, None, None]).sum(0) for b, in_prod in enumerate(prods)])
    return volume_sum, vis.sum(1)


@torch.no_grad()
def stage_net(vis_head: VisHead, cost_reg: CostRegNet, features, cams, depth_values, ops: Ops,
              warp_route: str | None = None, front: str = "pallas", cost_dtype=None, span_name: str = "cds.stage"):
    """Run one stage in eval, without autograd (the volume sum is written in
    place, slice by slice).

    Args:
      features: per source view v, ``{"ref": (feat, nc_sum, nc), "src": (...)}``
        with ``feat (B, C, h, w)`` and ``nc_sum, nc (B, h, w)``.
      cams: ``(B, V, 2, 4, 4)`` stage cameras, view 0 the reference.
      depth_values: ``(B, D)`` planes or ``(B, D, h, w)`` hypotheses, fp32.
      warp_route: a warp route of ``models/warp_routes.py``, or ``None`` for
        ``ops.warp``.
      front: the cost-regularisation front (``CostRegNet.front``).
      cost_dtype: the dtype of the regularisation (the volume mean cast to
        it); None: the features' dtype.
      span_name: the prefix of the spans ``<span_name>.volume`` (one a stage:
        the pose transforms, the warps, the vis head call and the sums) and
        ``<span_name>.cost_reg`` (one per batch element).
    Returns:
      ``{"depth", "photometric_confidence", "norm_curv"}``, each ``(B, h, w)``.
    """
    B, V = cams.shape[:2]
    hyps = depth_values.float().contiguous()
    with span(f"{span_name}.volume"):
        if warp_route in BATCHED_ROUTES and V > 2:
            volume_sum, vis_sum = _batched_volume(vis_head, features, cams, hyps)
        else:
            volume_sum, vis_sum = _view_volume(vis_head, route_warp(warp_route, ops), features, cams, hyps)
    volume_mean = volume_sum / (vis_sum + 1e-6)[:, None, None]  # (B, C, D, h, w)
    if cost_dtype is not None:
        volume_mean = volume_mean.to(cost_dtype)
    tail = cost_tail(ops, volume_mean.dtype)
    depths, confs = [], []
    for b in range(B):
        with span(f"{span_name}.cost_reg"):
            y = cost_reg(volume_mean[b], tail.conv0, front)
        depth, conf = tail.exit(y, cost_reg.prob.weight.float().contiguous(), hyps[b])
        depths.append(depth)
        confs.append(conf)
    nc_sum = sum((f["ref"][1] + f["src"][1]) / 2 for f in features)
    return {
        "depth": torch.stack(depths),
        "photometric_confidence": torch.stack(confs),
        "norm_curv": nc_sum / (V - 1),
    }


def stage_net_train(vis_head: VisHead, cost_reg: CostRegNet, features, cams, depth_values, warp, stats,
                    gt_depth=None, span_name: str = "cds.stage"):
    """Run one stage in training.

    Args:
      features, cams, depth_values: as :func:`stage_net`; the features carry
        autograd history.
      warp: ``(src (H,W,C), ref (C,h,w), depth, rt) -> (in_prod, sim)``:
        ``ops.kernels.fused_warp_train`` (K5) or ``warp_sim_plain``.
      stats: the ``layers.StatsCollector`` every BN records into.
      gt_depth: ``(B, h, w)`` ground truth, for the GT similarity plane.
      span_name: the prefix of the spans ``<span_name>.volume`` (the loop
        over views) and ``<span_name>.cost_reg`` (``train_logits``).
    Returns:
      ``{"depth", "photometric_confidence", "norm_curv"}``, each ``(B, h, w)``,
      and ``feat_distance (B, D(+1), h, w)``.
    """
    B, V = cams.shape[:2]
    volume_sum = vis_sum = fd_sum = gt_sum = 0.0
    with span(f"{span_name}.volume"):
        for v in range(1, V):
            ref_feat, _, ref_nc = features[v - 1]["ref"]
            src_feat = features[v - 1]["src"][0]
            rot, trans = relative_warp_transform(cams[:, 0], cams[:, v])
            rts = torch.cat([rot.reshape(B, 9), trans.reshape(B, 3)], 1).float()
            prods, sims, gt_sims = [], [], []
            for b in range(B):
                src_b = src_feat[b].permute(1, 2, 0).contiguous()
                ref_b = ref_feat[b].contiguous()
                rt = rts[b].contiguous()
                in_prod, sim = warp(src_b, ref_b, depth_values[b].float().contiguous(), rt)
                prods.append(in_prod)
                sims.append(sim)
                if gt_depth is not None:
                    gt_sims.append(warp(src_b, ref_b, gt_depth[b][None].float().contiguous(), rt)[1])
            sim = torch.stack(sims)  # (B, D, h, w) fp32
            entropy = softmax_entropy(sim, dim=1)[:, 0]
            vis = vis_head(torch.stack([entropy.to(ref_nc.dtype), ref_nc], 1), stats)[:, 0]  # (B, h, w)
            volume_sum = volume_sum + torch.stack(prods) * vis[:, None, None]
            vis_sum = vis_sum + vis
            fd_sum = fd_sum + sim * vis[:, None]
            if gt_depth is not None:
                gt_sum = gt_sum + torch.stack(gt_sims) * vis[:, None]
    denom = vis_sum[:, None] + 1e-6
    volume_mean = volume_sum / denom[:, None]
    with span(f"{span_name}.cost_reg"):
        cost = cost_reg.train_logits(volume_mean, stats)  # (B, D, h, w)
    prob = torch.softmax(cost.float(), dim=1)
    depth = depth_regression(prob, depth_values.float())
    with torch.no_grad():
        conf = confidence_regression(prob)
    feat_distance = fd_sum / denom
    if gt_depth is not None:
        feat_distance = torch.cat([feat_distance, gt_sum / denom], 1)
    nc_sum = sum((f["ref"][1] + f["src"][1]) / 2 for f in features)
    return {"depth": depth, "photometric_confidence": conf, "norm_curv": nc_sum / (V - 1),
            "feat_distance": feat_distance}
