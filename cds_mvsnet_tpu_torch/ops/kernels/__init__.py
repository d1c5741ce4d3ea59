"""Hand-written Hopper kernels of the cascade, one module each.

Every module holds the wrapper (a CUDA tensor launches the kernel or raises;
a CPU tensor takes the plain version), the plain PyTorch version of the same
function, and the wrapper's launch count (``<wrapper>.launches``, a plain
int that grows by one per launch and nowhere else).
"""

from .conv3d import conv3d_bn_relu, conv3d_bn_relu_plain, conv3d_down, conv3d_down_plain, fold_bn_into_conv3d
from .conv3d_fused import conv3d_front_fused, conv3d_front_fused_plain
from .gather import warp_gather, warp_gather_plain
from .gather16 import int16_arith, int16_arith_plain, row_gather, row_gather_plain
from .lane_slice import lane_slice_sum, lane_slice_sum_plain
from .dynconv import dynconv_branches, dynconv_branches_plain
from .regress import exit_softargmin, exit_softargmin_plain
from .warp import warp_entropy, warp_entropy_plain
from .warp_coords import (
    warp_sim_coords,
    warp_sim_coords_batched,
    warp_sim_coords_batched_plain,
    warp_sim_coords_plain,
)
from .warp_vjp import (
    FusedWarpTrain,
    fused_warp_train,
    warp_sim,
    warp_sim_backward,
    warp_sim_backward_plain,
    warp_sim_plain,
)

# the eval cascade's kernels (bf16 route), the train step's, the fp32 eval
# route's (K2 serves both eval routes), and those only the explicit routes
# of models/warp_routes.py run (K6, K7, K8; the routes also run K2, K5's
# forward and K9), and the probes' (P1, P2; tools/probe_*.py)
KERNELS = (warp_entropy, conv3d_bn_relu, exit_softargmin, dynconv_branches)
TRAIN_KERNELS = (warp_sim, warp_sim_backward)
FP32_KERNELS = (warp_gather, conv3d_bn_relu)
ROUTE_KERNELS = (conv3d_front_fused, conv3d_down, warp_sim_coords, warp_sim_coords_batched)
PROBE_KERNELS = (lane_slice_sum, row_gather, int16_arith)

__all__ = [
    "KERNELS",
    "TRAIN_KERNELS",
    "FP32_KERNELS",
    "ROUTE_KERNELS",
    "PROBE_KERNELS",
    "FusedWarpTrain",
    "fused_warp_train",
    "conv3d_bn_relu",
    "conv3d_bn_relu_plain",
    "conv3d_down",
    "conv3d_down_plain",
    "conv3d_front_fused",
    "conv3d_front_fused_plain",
    "dynconv_branches",
    "dynconv_branches_plain",
    "exit_softargmin",
    "exit_softargmin_plain",
    "fold_bn_into_conv3d",
    "int16_arith",
    "int16_arith_plain",
    "lane_slice_sum",
    "lane_slice_sum_plain",
    "row_gather",
    "row_gather_plain",
    "warp_entropy",
    "warp_entropy_plain",
    "warp_gather",
    "warp_gather_plain",
    "warp_sim",
    "warp_sim_backward",
    "warp_sim_backward_plain",
    "warp_sim_coords",
    "warp_sim_coords_batched",
    "warp_sim_coords_batched_plain",
    "warp_sim_coords_plain",
    "warp_sim_plain",
]
