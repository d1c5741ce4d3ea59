"""One cascade stage, eval: plane-sweep cost volume with learned visibility,
regularisation, and the soft-argmin tail.

Counterpart of the XLA form of ``cds_mvsnet_tpu/models/stage_net.py::stage_net``
(:171-296). Per source view, K1 (``ops/kernels/warp.py``) returns
``in_prod = ref ⊙ warped`` and the entropy of the similarity softmax; the vis
head maps (entropy, ref |curvature|) to a weight in (0, 1), and
``volume_sum += in_prod · vis``. Then ``volume_mean = volume_sum /
(vis_sum + 1e-6)`` goes through the cost-regularisation UNet (K2 runs its
conv0) and K3 (``ops/kernels/regress.py``) turns the UNet exit into depth and
photometric confidence.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops import kernels as K
from ..ops.geometry import relative_warp_transform
from .cost_reg import CostRegNet
from .layers import ConvBnReLU2d, conv2d

__all__ = ["VisHead", "StageNet", "Ops", "stage_net", "KERNEL_OPS", "PLAIN_OPS"]


@dataclass(frozen=True)
class Ops:
    """The four kernel sites of the cascade: the wrappers or their plain
    versions."""

    warp: object
    conv0: object
    exit: object
    dynconv: object


KERNEL_OPS = Ops(K.warp_entropy, K.conv3d_bn_relu, K.exit_softargmin, K.dynconv_branches)
PLAIN_OPS = Ops(K.warp_entropy_plain, K.conv3d_bn_relu_plain, K.exit_softargmin_plain,
                K.dynconv_branches_plain)


class VisHead(nn.Sequential):
    """(entropy, ref |curvature|) -> visibility: 2->16->16->16 ConvBnReLU,
    then a 1x1 conv with bias and a sigmoid."""

    def __init__(self):
        super().__init__(
            ConvBnReLU2d(2, 16), ConvBnReLU2d(16, 16), ConvBnReLU2d(16, 16),
            nn.Conv2d(16, 1, 1, bias=True),
        )

    def forward(self, x):
        for i in range(3):
            x = self[i](x)
        return torch.sigmoid(conv2d(x, self[3].weight, self[3].bias))


class StageNet(nn.Module):
    def __init__(self, num_stages: int):
        super().__init__()
        self.vis = nn.ModuleDict({str(s): VisHead() for s in range(num_stages)})


def stage_net(vis_head: VisHead, cost_reg: CostRegNet, features, cams, depth_values, ops: Ops):
    """Run one stage.

    Args:
      features: per source view v, ``{"ref": (feat, nc_sum, nc), "src": (...)}``
        with ``feat (B, C, h, w)`` and ``nc_sum, nc (B, h, w)``.
      cams: ``(B, V, 2, 4, 4)`` stage cameras, view 0 the reference.
      depth_values: ``(B, D)`` planes or ``(B, D, h, w)`` hypotheses, fp32.
    Returns:
      ``{"depth", "photometric_confidence", "norm_curv"}``, each ``(B, h, w)``.
    """
    B, V = cams.shape[:2]
    depths, confs = [], []
    for b in range(B):
        hyp = depth_values[b].float().contiguous()
        volume_sum = vis_sum = None
        for v in range(1, V):
            ref_feat, _, ref_nc = features[v - 1]["ref"]
            src_feat = features[v - 1]["src"][0]
            rot, trans = relative_warp_transform(cams[b : b + 1, 0], cams[b : b + 1, v])
            rt = torch.cat([rot.reshape(9), trans.reshape(3)]).float().contiguous()
            in_prod, entropy = ops.warp(
                src_feat[b].permute(1, 2, 0).contiguous(), ref_feat[b].contiguous(), hyp, rt
            )
            x = torch.stack([entropy.to(ref_nc.dtype), ref_nc[b]])[None]
            vis = vis_head(x)[0, 0]  # (h, w)
            term = in_prod * vis
            volume_sum = term if volume_sum is None else volume_sum + term
            vis_sum = vis if vis_sum is None else vis_sum + vis
        volume_mean = volume_sum / (vis_sum + 1e-6)  # (C, D, h, w)
        y = cost_reg(volume_mean, ops.conv0)
        depth, conf = ops.exit(y, cost_reg.prob.weight.float().contiguous(), hyp)
        depths.append(depth)
        confs.append(conf)
    nc_sum = sum((f["ref"][1] + f["src"][1]) / 2 for f in features)
    return {
        "depth": torch.stack(depths),
        "photometric_confidence": torch.stack(confs),
        "norm_curv": nc_sum / (V - 1),
    }
