"""K4's share of its roofline: the least time of the traced maps' K4
calls (``roofline/k4.py``: conv01 over a map's 2(V-1) images) over the
device time of ``dynconv_kernel`` in the trace."""

from mvsbench.roofline.k4 import KERNEL_NAMES, least_seconds_per_map


def read(t, cfg):
    s = t.kernel_seconds(*KERNEL_NAMES)
    return None if not s or not t.units else 100 * least_seconds_per_map(cfg) * t.units / s
