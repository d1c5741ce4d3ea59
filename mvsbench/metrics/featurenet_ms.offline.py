"""Device time of the FeatureNet a map: kernels launched inside the
``mvsbench.feature`` span (a forward hook on ``model.feature``)."""


def read(t, cfg):
    s = t.spans.get("mvsbench.feature")
    return None if not s or not t.units else s / t.units * 1e3
