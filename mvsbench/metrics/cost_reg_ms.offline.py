"""Device time of the cost regularisation a map: kernels launched inside
the ``mvsbench.cost_reg.s<i>`` spans (forward hooks on each CostRegNet)."""


def read(t, cfg):
    s = sum(v for k, v in t.spans.items() if k.startswith("mvsbench.cost_reg."))
    return None if not s or not t.units else s / t.units * 1e3
