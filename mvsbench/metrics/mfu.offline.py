"""The whole forward's share of the card's bf16 peak: the model's FLOPs a
map (``roofline/flops.py``) times the traced maps over the traced window's
seconds and 989 TFLOP/s."""

from mvsbench.roofline import peaks
from mvsbench.roofline.flops import eval_flops_per_map


def read(t, cfg):
    if not t.units or not t.window_s or not t.busy_s:
        return None
    return 100 * eval_flops_per_map(cfg) * t.units / (t.window_s * peaks.BF16_FLOPS)
