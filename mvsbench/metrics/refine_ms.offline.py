"""Device time of the refinement a map: kernels launched inside the
``mvsbench.refine`` span (a forward hook on ``model.refine_network``)."""


def read(t, cfg):
    s = t.spans.get("mvsbench.refine")
    return None if not s or not t.units else s / t.units * 1e3
