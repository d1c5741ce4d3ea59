"""CDS-MVSNet: the three-stage cascaded plane-sweep depth network, eval.

Counterpart of ``cds_mvsnet_tpu/models/cds_mvsnet.py::apply_cds_mvsnet`` with
``train=False`` and ``refine=False``. Public layouts are the JAX package's:
``imgs (B, V, H, W, 3)``, ``proj_matrices[stage] (B, V, 2, 4, 4)``,
``depth_values (B, D)``; the output holds per-stage dicts (``depth``,
``photometric_confidence``, ``norm_curv``) and ``refined_depth``.

The 2·(V−1) FeatureNet calls of the upstream model (one per (ref, src) pair,
since the reference image's epipole differs per pair) run as one batch in the
order ``[ref × (V−1), src × (V−1)]``; InstanceNorm is per sample and BN uses
running statistics, so batching changes nothing at eval.

Geometry, softmaxes, entropy and regression stay fp32 whatever
``compute_dtype`` is. In bf16 the four kernel sites run the hand-written
kernels (``kernels=True``, the default) or their plain versions; fp32 always
runs the plain versions, as the JAX package keeps its fp32 evals off the
Pallas kernels.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.geometry import epipole_from_fundamental, fundamental_matrix
from ..ops.resize import resize_linear
from ..ops.sampling import initial_depth_hypotheses, refined_depth_hypotheses
from .convert import load_into
from .cost_reg import CostRegNet
from .feature_net import FEATURE_OUT_CHANNELS, FeatureNet
from .layers import reset_parameters
from .stage_net import KERNEL_OPS, PLAIN_OPS, StageNet, stage_net

__all__ = ["CDSMVSNet", "build_model", "pairwise_epipoles", "resolve_device", "strict_fp32", "to_tensors"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless device='cpu' is passed")
    return dev


def strict_fp32() -> None:
    """Keep fp32 convolutions and products in full fp32 on the card (cuDNN
    turns TF32 on by default)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


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

    @torch.no_grad()
    def forward(self, imgs, proj_matrices, depth_values, temperature: float = 0.001,
                compute_dtype=torch.float32, kernels: bool = True):
        cfg = self.cfg
        if cfg.refine:
            raise NotImplementedError("refinement is not ported yet: use ModelConfig(refine=False)")
        ops = KERNEL_OPS if kernels and compute_dtype == torch.bfloat16 else PLAIN_OPS
        B, V, H, W, _ = imgs.shape
        depth_values = depth_values.float()
        depth_min = depth_values[:, 0]
        depth_max = depth_values[:, -1]
        depth_interval = depth_values[:, 1] - depth_values[:, 0]

        cams3 = proj_matrices["stage3"].float()
        ref_epi, src_epi = pairwise_epipoles(cams3[:, 0], cams3[:, 1:])
        ref_rep = imgs[:, 0][None].expand(V - 1, B, H, W, 3)
        srcs = imgs[:, 1:].transpose(0, 1)
        stacked = torch.cat([ref_rep, srcs]).reshape(2 * (V - 1) * B, H, W, 3)
        stacked = stacked.permute(0, 3, 1, 2).to(compute_dtype).contiguous()
        epis = torch.cat([ref_epi.transpose(0, 1), src_epi.transpose(0, 1)]).reshape(-1, 2)
        feats = self.feature(stacked, epis, temperature, conv01_branches=ops.dynconv)

        outputs = {}
        depth = None
        for s in range(cfg.num_stages):
            name = f"stage{s + 1}"
            scale = int(cfg.stage_scales[s])
            h_s, w_s = H // scale, W // scale
            ndepth = cfg.ndepths[s]
            per = [t.reshape(2, V - 1, B, *t.shape[1:]) for t in feats[name]]
            features = [
                {"ref": tuple(t[0, v] for t in per), "src": tuple(t[1, v] for t in per)}
                for v in range(V - 1)
            ]
            if depth is None:
                hyp = initial_depth_hypotheses(depth_values, ndepth)
            else:
                cur = resize_linear(depth[:, None], (H, W), dims=(2, 3))[:, 0]
                hyp = refined_depth_hypotheses(
                    cur, ndepth,
                    (cfg.depth_intervals_ratio[s] * depth_interval)[:, None, None],
                    depth_min[:, None, None, None],
                    depth_max[:, None, None, None],
                    out_hw=(h_s, w_s),
                )
            cost_reg = self.cost_regularization if cfg.share_cr else self.cost_regularization[str(s)]
            out = stage_net(self.stage_net.vis[str(s)], cost_reg, features,
                            proj_matrices[name].float(), hyp, ops)
            depth = out["depth"]
            outputs[name] = out
        outputs["refined_depth"] = depth
        return outputs


def to_tensors(batch: dict, device) -> dict:
    """A batch of numpy arrays (``imgs``, ``proj_matrices``, ``depth_values``)
    as fp32 tensors on ``device``."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    return {
        "imgs": t(batch["imgs"]),
        "proj_matrices": {k: t(v) for k, v in batch["proj_matrices"].items()},
        "depth_values": t(batch["depth_values"]),
    }


def build_model(cfg: ModelConfig = ModelConfig(refine=False), params=None, seed: int = 0,
                device="cuda") -> CDSMVSNet:
    """The eval model on ``device``: weights from ``params`` (a JAX param tree
    or an ``.npz`` from ``save_params``, see ``models.convert``), else a
    seeded init from ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        strict_fp32()
    model = CDSMVSNet(cfg)
    if params is None:
        reset_parameters(model, torch.Generator().manual_seed(seed))
    else:
        load_into(model, params)
    return model.to(dev).eval()
