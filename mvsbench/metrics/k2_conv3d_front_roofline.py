"""K2's share of its roofline (bf16, the cost volume's conv0): the least
time of the traced maps' K2 launches over the device time of
``conv3d_mma_kernel`` in the trace."""

from mvsbench.roofline.kernels import KERNELS


def read(t, cfg):
    names, least = KERNELS["k2_conv3d_front"]
    s = t.kernel_seconds(*names)
    return None if not s or not t.units else 100 * least(cfg) * t.units / s
