"""CDS-MVSNet: the three-stage cascaded plane-sweep depth network.

Counterpart of ``cds_mvsnet_tpu/models/cds_mvsnet.py::apply_cds_mvsnet``:
:meth:`CDSMVSNet.forward` is its eval form (``train=False``) and
:meth:`CDSMVSNet.forward_train` its train form (``train=True`` with
``gt_depths``). Public layouts are the JAX package's: ``imgs (B, V, H, W,
3)``, ``proj_matrices[stage] (B, V, 2, 4, 4)``, ``depth_values (B, D)``; the
output holds per-stage dicts (``depth``, ``photometric_confidence``,
``norm_curv``, and in training ``feat_distance`` and ``feat_target``) and
``refined_depth``. With ``refine`` the cascade runs at half resolution and
the refinement head (``models/refinement.py``) brings stage 3's depth to the
input resolution.

The 2·(V−1) FeatureNet calls of the upstream model (one per (ref, src) pair,
since the reference image's epipole differs per pair) run as one batch in the
order ``[ref × (V−1), src × (V−1)]``. InstanceNorm is per sample; in
training each attention BN keeps statistics per call (``bn_groups``) and
moves its running statistics in the upstream call order (``bn_order``).

Geometry, softmaxes, entropy and regression stay fp32 whatever
``compute_dtype`` is. With ``kernels=True`` (the default) the kernel sites
run the hand-written kernels, as the JAX package runs its Pallas kernels on
its device:
- bf16 eval (``KERNEL_OPS``): K1 warps (``warp_pallas_v8`` there), K2 runs
  cost-reg conv0 (``conv3d_front``), K3 the exit (``exit_softargmin``) and
  K4 the FeatureNet's conv01 (``sparse_s2d_conv``, the JAX default of
  ``CDS_FEAT_SPARSE``);
- fp32 eval (``FP32_OPS``): K9 gathers the plane sweep (``warp_pallas_v3``,
  which the JAX fp32 route runs at C ≤ 8, ``stage_net.py:427,476-484``) and
  K2 runs conv0 on the fp32 volume (``conv3d_front``, ``cost_reg.py:151-198``);
  the exit and conv01 stay plain, as the JAX fp32 route keeps the XLA tail
  (``stage_net.py:544``) and the dense FeatureNet;
- training in bf16: K5 (``fused_warp_train``); in fp32 the plain warp.
``kernels=False`` runs every site's plain version (``PLAIN_OPS``).

``cost_dtype`` (``forward(..., cost_dtype=...)``, the JAX package's
``apply_cds_mvsnet(..., cost_dtype=...)``, ``cds_mvsnet.py:85,331``) runs
the cost regularisation of every stage at another precision than the rest
(``models/stage_net.py``): in bf16 with ``cost_dtype=torch.float32`` the
warps, vis heads and FeatureNet stay bf16 (K1, K4) and conv0, the fronts
(K2, K6, K7 in fp32) and the UNet run fp32, with the plain tail at the
exit; in fp32 with bf16 cost, K9 warps and K2 and K3 run bf16.
``kernels=False`` gives each such path its plain twin.

A :class:`~.warp_routes.Routes` (``forward(..., routes=...)``) picks each
stage's warp, the cost-reg front and the FeatureNet convs on K4 among the
JAX package's routes (``CDS_WARP_ROUTE``, ``CDS_COSTREG_FRONT``,
``CDS_FEAT_SPARSE``): K6, K7 and K8 run only there, and K4 on any conv but
conv01. Routes take ``kernels=True``. In bf16 every route runs; in fp32
the six fronts and the warps ``v6``/``v3`` (K9 in fp32) and ``xla`` (the
plain gather) run, a stage not named takes the fp32 route's K9, and the
fused warps raise (the JAX package's fp32 features reach its variant table
with their names, ``ops/pallas/warp.py:1592-1600``, which has none of
them); the FeatureNet stays as on the fp32 path whatever ``Routes.feature``
names (the JAX package keeps fp32 features dense, ``_want_sparse``,
``feature_net_s2d.py:67``): K4 launches 0 times.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..ops import kernels as K
from ..ops.geometry import epipole_from_fundamental, fundamental_matrix
from ..ops.resize import resize_linear, resize_nearest
from ..ops.sampling import initial_depth_hypotheses, refined_depth_hypotheses
from .convert import load_into
from .cost_reg import CostRegNet
from .feature_net import FEATURE_OUT_CHANNELS, FeatureNet
from .layers import StatsCollector, reset_parameters
from .refinement import RefineNet
from .stage_net import FP32_OPS, KERNEL_OPS, PLAIN_OPS, StageNet, stage_net, stage_net_train
from .warp_routes import DEFAULT_FEATURE_ROUTE, Routes

__all__ = ["CDSMVSNet", "build_model", "feat_target", "pairwise_epipoles", "resolve_device", "strict_fp32",
           "to_tensors"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless device='cpu' is passed")
    return dev


def strict_fp32() -> None:
    """Keep fp32 convolutions and products in full fp32 on the card (cuDNN
    turns TF32 on by default), and hold cuDNN to deterministic algorithms,
    chosen without benchmarking, so that a request or a train step repeats
    bit for bit as the JAX package's do on XLA: left free, cuDNN picks an
    fp32 algorithm whose result differs between two requests of one process.
    Not ``torch.use_deterministic_algorithms``: that global switch raises
    for operations with no deterministic form; the port's differentiable
    gathers repeat by themselves (``ops/index.py``, K5's fixed-point
    ``d_src``)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def pairwise_epipoles(ref_cams: torch.Tensor, src_cams: torch.Tensor):
    """Epipoles of (ref, src) pairs: ``ref_cams (B,2,4,4)``, ``src_cams
    (B,Vs,2,4,4)`` -> ``(ref_epi, src_epi)``, each ``(B, Vs, 2)``."""
    B, Vs = src_cams.shape[:2]
    ref_flat = ref_cams[:, None].expand(B, Vs, 2, 4, 4).reshape(B * Vs, 2, 4, 4)
    src_flat = src_cams.reshape(B * Vs, 2, 4, 4)
    F = fundamental_matrix(ref_flat, src_flat)
    ref_epi = epipole_from_fundamental(F).reshape(B, Vs, 2)
    src_epi = epipole_from_fundamental(F.transpose(1, 2)).reshape(B, Vs, 2)
    return ref_epi, src_epi


class CDSMVSNet(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig(refine=False)):
        super().__init__()
        self.cfg = cfg
        self.feature = FeatureNet()
        self.stage_net = StageNet(cfg.num_stages)
        if cfg.share_cr:
            self.cost_regularization = CostRegNet(FEATURE_OUT_CHANNELS[0], 8)
        else:
            self.cost_regularization = nn.ModuleDict({
                str(i): CostRegNet(FEATURE_OUT_CHANNELS[i], cfg.cr_base_chs[i])
                for i in range(cfg.num_stages)
            })
        if cfg.refine:
            self.refine_network = RefineNet()

    @torch.no_grad()
    def forward(self, imgs, proj_matrices, depth_values, temperature: float = 0.001,
                compute_dtype=torch.float32, kernels: bool = True, routes: Routes | None = None,
                cost_dtype=None):
        """Eval: every BN on its running statistics. The kernel sites run
        ``KERNEL_OPS`` in bf16, ``FP32_OPS`` in fp32, ``PLAIN_OPS`` without
        ``kernels``; ``routes`` (``kernels`` only; in fp32 the fronts and
        the warps of ``FP32_WARP_ROUTES``) picks each stage's warp, the
        cost-reg front and the FeatureNet convs on K4; ``cost_dtype`` (bf16
        or fp32; None: ``compute_dtype``) the dtype of every stage's cost
        regularisation."""
        if routes is not None:
            if not kernels:
                raise ValueError("routes take kernels=True: they name kernels")
            if compute_dtype == torch.float32:
                routes.check_fp32()
        if cost_dtype not in (None, torch.bfloat16, torch.float32):
            raise ValueError(f"cost_dtype {cost_dtype}: bf16, fp32 or None")
        if not kernels:
            ops = PLAIN_OPS
        elif compute_dtype == torch.bfloat16:
            ops = KERNEL_OPS
        elif compute_dtype == torch.float32:
            ops = FP32_OPS
        else:
            raise ValueError(f"compute_dtype {compute_dtype}: bf16 or fp32")
        return self._cascade(imgs, proj_matrices, depth_values, temperature, compute_dtype, ops=ops, routes=routes,
                             cost_dtype=cost_dtype)

    def forward_train(self, imgs, proj_matrices, depth_values, gt_depths, stats: StatsCollector,
                      temperature: float = 0.01, compute_dtype=torch.float32, kernels: bool = True,
                      remat_features: bool = False):
        """Train: every BN on batch statistics, recorded into ``stats`` (the
        caller applies them after its optimizer step); ``gt_depths[stage]
        (B, h, w)`` give each stage's GT similarity plane and
        ``feat_target``. ``remat_features`` recomputes the FeatureNet in the
        backward (``torch.utils.checkpoint``)."""
        warp = K.fused_warp_train if kernels and compute_dtype == torch.bfloat16 else K.warp_sim_plain
        return self._cascade(imgs, proj_matrices, depth_values, temperature, compute_dtype, warp=warp,
                             stats=stats, gt_depths=gt_depths, remat_features=remat_features)

    def _features(self, stacked, epis, temperature, ops, stats, remat_features, V, feature):
        if stats is None:
            return self.feature(stacked, epis, temperature, branches=dict.fromkeys(feature, ops.dynconv))
        # stack group kind·(V−1)+v is upstream call 2v+kind (ref_v, then src_v)
        bn = {"bn_groups": 2 * (V - 1), "bn_order": tuple(2 * v + kind for kind in (0, 1) for v in range(V - 1))}
        if not remat_features:
            return self.feature(stacked, epis, temperature, stats=stats, **bn)
        # The recompute in the backward runs the FeatureNet again; its BN
        # records go to a collector of its own and are dropped, so the
        # running statistics move once.
        first = []

        def run(x, e):
            local = StatsCollector(stats.group)
            out = self.feature(x, e, temperature, stats=local, **bn)
            first.append(local)
            return out

        feats = checkpoint(run, stacked, epis, use_reentrant=False)
        stats.calls.extend(first[0].calls)
        return feats

    def _cascade(self, imgs, proj_matrices, depth_values, temperature, compute_dtype, ops=PLAIN_OPS,
                 warp=None, stats=None, gt_depths=None, remat_features=False, routes=None, cost_dtype=None):
        cfg = self.cfg
        B, V, H, W, _ = imgs.shape
        height, width = (H // 2, W // 2) if cfg.refine else (H, W)
        depth_values = depth_values.float()
        depth_min = depth_values[:, 0]
        depth_max = depth_values[:, -1]
        depth_interval = depth_values[:, 1] - depth_values[:, 0]

        cams3 = proj_matrices["stage3"].float()
        ref_epi, src_epi = pairwise_epipoles(cams3[:, 0], cams3[:, 1:])
        work = imgs if (height, width) == (H, W) else resize_nearest(imgs, (height, width), dims=(2, 3))
        ref_rep = work[:, 0][None].expand(V - 1, B, height, width, 3)
        srcs = work[:, 1:].transpose(0, 1)
        stacked = torch.cat([ref_rep, srcs]).reshape(2 * (V - 1) * B, height, width, 3)
        stacked = stacked.permute(0, 3, 1, 2).to(compute_dtype).contiguous()
        epis = torch.cat([ref_epi.transpose(0, 1), src_epi.transpose(0, 1)]).reshape(-1, 2)
        feature = DEFAULT_FEATURE_ROUTE if routes is None or compute_dtype == torch.float32 else routes.feature
        feats = self._features(stacked, epis, temperature, ops, stats, remat_features, V, feature)

        outputs = {}
        depth = None
        for s in range(cfg.num_stages):
            name = f"stage{s + 1}"
            scale = int(cfg.stage_scales[s])
            h_s, w_s = height // scale, width // scale
            ndepth = cfg.ndepths[s]
            per = [t.reshape(2, V - 1, B, *t.shape[1:]) for t in feats[name]]
            features = [
                {"ref": tuple(t[0, v] for t in per), "src": tuple(t[1, v] for t in per)}
                for v in range(V - 1)
            ]
            if depth is None:
                hyp = initial_depth_hypotheses(depth_values, ndepth)
            else:
                cur = depth.detach() if cfg.grad_method == "detach" else depth
                cur = resize_linear(cur[:, None], (height, width), dims=(2, 3))[:, 0]
                hyp = refined_depth_hypotheses(
                    cur, ndepth,
                    (cfg.depth_intervals_ratio[s] * depth_interval)[:, None, None],
                    depth_min[:, None, None, None],
                    depth_max[:, None, None, None],
                    out_hw=(h_s, w_s),
                )
            cost_reg = self.cost_regularization if cfg.share_cr else self.cost_regularization[str(s)]
            vis_head = self.stage_net.vis[str(s)]
            cams = proj_matrices[name].float()
            if stats is None:
                route = (None, "pallas") if routes is None else (routes.warp.get(s + 1), routes.front)
                out = stage_net(vis_head, cost_reg, features, cams, hyp, ops, *route, cost_dtype=cost_dtype)
            else:
                gt = None if gt_depths is None else gt_depths[name].float()
                out = stage_net_train(vis_head, cost_reg, features, cams, hyp, warp, stats, gt)
                if gt is not None:
                    out["feat_target"] = feat_target(hyp, gt, depth_interval * cfg.stage_scales[s],
                                                     cfg.stage_scales[s])
            depth = out["depth"]
            outputs[name] = out

        if cfg.refine:
            scale = depth_interval[:, None, None]
            img = imgs[:, 0].permute(0, 3, 1, 2).to(compute_dtype)
            refined = self.refine_network(img, depth.detach() / scale, depth_min / depth_interval,
                                          depth_max / depth_interval, stats)
            outputs["refined_depth"] = refined * scale
        else:
            outputs["refined_depth"] = depth
        return outputs


def feat_target(hyp, gt, interval, scale: float) -> torch.Tensor:
    """The BCE target of ``feat_distance``: 1 where a hypothesis lies within
    ``0.5 / scale`` stage intervals of the GT depth, then the GT plane's 1s:
    ``hyp (B, D[, h, w])``, ``gt (B, h, w)``, ``interval (B,)`` ->
    ``(B, D + 1, h, w)``."""
    B, h, w = gt.shape
    samples = hyp[:, :, None, None] if hyp.ndim == 2 else hyp
    near = ((samples - gt[:, None]).abs() / interval[:, None, None, None]) < (0.5 / scale)
    near = near.expand(B, hyp.shape[1], h, w).float()
    return torch.cat([near, torch.ones((B, 1, h, w), device=gt.device)], 1)


def to_tensors(batch: dict, device) -> dict:
    """A batch of numpy arrays (``imgs``, ``proj_matrices``, ``depth_values``
    and, for training, the ``depth`` and ``mask`` pyramids) as fp32 tensors
    on ``device``."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    out = {"imgs": t(batch["imgs"]), "depth_values": t(batch["depth_values"])}
    for key in ("proj_matrices", "depth", "mask"):
        if key in batch:
            out[key] = {k: t(v) for k, v in batch[key].items()}
    return out


def build_model(cfg: ModelConfig = ModelConfig(refine=False), params=None, seed: int = 0,
                device="cuda") -> CDSMVSNet:
    """The model on ``device``: weights from ``params`` (a JAX param tree or
    an ``.npz`` from ``save_params``, see ``models.convert``), else a seeded
    init from ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        strict_fp32()
    model = CDSMVSNet(cfg)
    if params is None:
        reset_parameters(model, torch.Generator().manual_seed(seed))
    else:
        load_into(model, params)
    return model.to(dev).eval()
