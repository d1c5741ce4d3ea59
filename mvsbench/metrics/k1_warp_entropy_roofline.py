"""K1's share of its roofline: the least time of the traced maps' K1
launches (``roofline/kernels.py``) over the device time of
``warp_entropy_kernel`` in the trace."""

from mvsbench.roofline.kernels import KERNELS


def read(t, cfg):
    names, least = KERNELS["k1_warp_entropy"]
    s = t.kernel_seconds(*names)
    return None if not s or not t.units else 100 * least(cfg) * t.units / s
