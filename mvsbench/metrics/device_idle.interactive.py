"""The card's idle share of the traced window: 100 x (1 - busy / window),
busy the union of its kernels, copies and fills."""


def read(t, cfg):
    return None if not t.window_s or not t.busy_s else 100 * (1 - t.busy_s / t.window_s)
