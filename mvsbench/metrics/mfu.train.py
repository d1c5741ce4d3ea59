"""The whole train step's share of the card's bf16 peak: forward and
backward FLOPs a sample (``roofline/flops.py``, recompute not counted)
times the traced samples over the traced window's seconds and 989
TFLOP/s."""

from mvsbench.roofline import peaks
from mvsbench.roofline.flops import train_flops_per_sample


def read(t, cfg):
    if not t.units or not t.window_s or not t.busy_s:
        return None
    return 100 * train_flops_per_sample(cfg) * cfg["batch_size"] * t.units / (t.window_s * peaks.BF16_FLOPS)
