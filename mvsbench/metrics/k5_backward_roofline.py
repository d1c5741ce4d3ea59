"""K5's backward share of its roofline: the least time of the traced
steps' backward launches (sweeps and ground-truth warps of every sample,
stage and source view) over the device time of the ``warp_sim_backward``
kernels in the trace."""

from mvsbench.roofline.kernels import KERNELS


def read(t, cfg):
    names, least = KERNELS["k5_backward"]
    s = t.kernel_seconds(*names)
    return None if not s or not t.units else 100 * least(cfg) * cfg["batch_size"] * t.units / s
