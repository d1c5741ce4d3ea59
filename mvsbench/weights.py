"""Seeded weights for both sides, made on the device in two calls.

The rules are the port's own initialisation (conv weights and biases
``U(±1/sqrt(fan_in))``, where a transposed conv's fan-in counts its
outputs; the curvature-coefficient convs ``N(0, 0.1)``), with the
BatchNorm leaves drawn too (scale ``U(0.5, 1.5)``, shift and running mean
``U(±0.1)``, running variance ``U(0.5, 1.5)``), so that every BN, and the
fold of the cost volume's first BN into its conv, does work.
"""

from __future__ import annotations

import math

import torch

__all__ = ["seeded_state"]


def _is_bn(key: str, shapes: dict) -> bool:
    base = key.rsplit(".", 1)[0]
    return base + ".running_mean" in shapes


def seeded_state(shapes: dict, gen: torch.Generator) -> dict:
    """``{key: fp32 tensor}`` for ``shapes`` (``{key: shape}`` in a fixed
    order), drawn from ``gen`` on its device: one uniform and one normal
    draw, cut and scaled leaf by leaf."""
    dev = gen.device
    keys = [k for k in shapes if not k.endswith("num_batches_tracked")]
    normal_keys = [k for k in keys if ".att_convs." in k]
    uniform_keys = [k for k in keys if k not in normal_keys]
    sizes = [math.prod(shapes[k]) for k in uniform_keys]
    u = torch.rand((sum(sizes),), generator=gen, device=dev).split(sizes)
    nsizes = [math.prod(shapes[k]) for k in normal_keys]
    z = torch.randn((sum(nsizes),), generator=gen, device=dev).split(nsizes)
    out = {}
    for k, x in zip(normal_keys, z):
        out[k] = (0.1 * x).reshape(shapes[k])
    for k, x in zip(uniform_keys, u):
        shape = shapes[k]
        if _is_bn(k, shapes):
            if k.endswith((".weight", ".running_var")):
                x = 0.5 + x
            else:
                x = 0.2 * (x - 0.5)
        else:
            w_shape = shapes[k] if len(shape) >= 3 else shapes[k.rsplit(".", 1)[0] + ".weight"]
            bound = 1.0 / math.sqrt(w_shape[1] * math.prod(w_shape[2:]))
            x = (2 * x - 1) * bound
        out[k] = x.reshape(shape)
    return {k: out[k] for k in keys}
