"""The model's FLOPs by configuration: every convolution of the cascade,
counted from the configuration's shapes as ``torch.utils.flop_counter``
counts them (2 x output positions x input channels x output channels x
taps; a transposed conv over its input positions), so that the count is the
same whatever kernel computes the layer. Training adds each conv's weight
gradient and, where its input carries a gradient, its input gradient; the
FeatureNet's recompute in the backward is not counted. The rest of the work
(warps, softmaxes, norms) is left out, as a FLOP counter leaves it."""

from __future__ import annotations

from .shapes import FEATURE_CHANNELS, STAGE_SCALES

__all__ = ["eval_flops_per_map", "train_flops_per_sample"]

# (name, in, out, kernel sizes, stride, input scale, bias) of the FeatureNet's convs
_FEATURE = (
    ("conv00", 3, 8, (3, 7, 11), 1, 1), ("conv01", 8, 8, (3, 5, 7), 1, 1), ("downsample1", 8, 16, None, 2, 1),
    ("conv10", 16, 16, (3, 5), 1, 2), ("conv11", 16, 16, (3, 5), 1, 2), ("downsample2", 16, 32, None, 2, 2),
    ("conv20", 32, 32, (1, 3), 1, 4), ("conv21", 32, 32, (1, 3), 1, 4), ("out1", 32, 32, (1, 3), 1, 4),
    ("inner1", 48, 16, 1, 1, 2), ("out2", 16, 16, (1, 3), 1, 2), ("inner2", 24, 8, 1, 1, 1),
    ("out3", 8, 8, (1, 3), 1, 1),
)


def _conv(cin, cout, taps, positions):
    return 2 * cin * cout * taps * positions


def _half(n):
    return -(-n // 2)


def _feature_convs(h, w):
    """``[(flops, input carries a gradient)]`` of one image's FeatureNet."""
    out = []
    for name, cin, cout, ks, stride, sc in _FEATURE:
        hw = (h // sc) * (w // sc)
        grad_in = name != "conv00"
        if ks is None:  # a 3x3 stride-2 downsample
            out.append((_conv(cin, cout, 9, _half(h // sc) * _half(w // sc)), True))
        elif isinstance(ks, int):
            out.append((_conv(cin, cout, ks * ks, hw), True))
        else:
            for k in ks:
                out.append((_conv(cin, cout, k * k, hw), grad_in))  # the branch's conv
                out.append((_conv(cin, 3, k * k, hw), grad_in))  # its curvature coefficients
            nk = len(ks)
            out += [(_conv(nk, 4, 1, hw), True), (_conv(4, nk, 1, hw), True)]
    return out


def _stage_convs(C, D, h, w, views):
    vis = [(_conv(2, 16, 9, h * w), True), (_conv(16, 16, 9, h * w), True), (_conv(16, 16, 9, h * w), True),
           (_conv(16, 1, 1, h * w), True)] * (views - 1)
    n1 = _half(D) * _half(h) * _half(w)
    n2 = _half(_half(D)) * _half(_half(h)) * _half(_half(w))
    n3 = _half(_half(_half(D))) * _half(_half(_half(h))) * _half(_half(_half(w)))
    reg = [(_conv(C, 8, 27, D * h * w), True), (_conv(8, 16, 27, n1), True), (_conv(16, 16, 27, n1), True),
           (_conv(16, 32, 27, n2), True), (_conv(32, 32, 27, n2), True), (_conv(32, 64, 27, n3), True),
           (_conv(64, 64, 27, n3), True), (_conv(64, 32, 27, n3), True), (_conv(32, 16, 27, n2), True),
           (_conv(16, 8, 27, n1), True), (_conv(8, 1, 27, D * h * w), True)]
    return vis + reg


def _refine_convs(H, W):
    h, w = H // 2, W // 2
    return [(_conv(3, 8, 9, H * W), False), (_conv(1, 8, 9, h * w), False), (_conv(8, 8, 9, h * w), True),
            (_conv(8, 8, 9, h * w), True), (_conv(16, 8, 9, H * W), True), (_conv(8, 1, 9, H * W), True)]


def _convs(cfg: dict) -> list:
    H, W, V = cfg["height"], cfg["width"], cfg["views"]
    refine = cfg["model"]["refine"]
    h, w = (H // 2, W // 2) if refine else (H, W)
    convs = _feature_convs(h, w) * (2 * (V - 1))
    for C, D, sc in zip(FEATURE_CHANNELS, cfg["model"]["ndepths"], STAGE_SCALES):
        convs += _stage_convs(C, D, h // sc, w // sc, V)
    if refine:
        convs += _refine_convs(H, W)
    return convs


def eval_flops_per_map(cfg: dict) -> int:
    return sum(f for f, _ in _convs(cfg))


def train_flops_per_sample(cfg: dict) -> int:
    """Forward, each weight gradient, and each input gradient that the
    backward needs."""
    return sum(f * (3 if grad_in else 2) for f, grad_in in _convs(cfg))


if __name__ == "__main__":
    import json
    import sys
    from pathlib import Path

    for path in sys.argv[1:]:
        cfg = json.loads(Path(path).read_text())
        print(path, f"eval {eval_flops_per_map(cfg) / 1e9:.2f} GFLOP/map",
              f"train {train_flops_per_sample(cfg) / 1e9:.2f} GFLOP/sample")
