"""Device time of the backward a step: kernels launched under the autograd
engine's ranges (``autograd::engine::evaluate_function``), the
FeatureNet's recompute included."""


def read(t, cfg):
    s = t.spans.get("autograd")
    return None if not s or not t.units else s / t.units * 1e3
