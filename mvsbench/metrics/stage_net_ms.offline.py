"""Device time of the stage net a map: the forward's (``mvsbench.forward``)
outside the FeatureNet, CostRegNet and RefineNet spans: the per-view warps
(K1), the vis heads, the volume mean, the exit (K3), the hypotheses."""


def read(t, cfg):
    fwd = t.spans.get("mvsbench.forward")
    if not fwd or not t.units:
        return None
    inner = sum(v for k, v in t.spans.items()
                if k in ("mvsbench.feature", "mvsbench.refine") or k.startswith("mvsbench.cost_reg."))
    return (fwd - inner) / t.units * 1e3
