"""Routes of the eval cascade: which kernel warps each stage and which runs
the cost-regularisation UNet's first layers.

Counterpart of ``cds_mvsnet_tpu/models/warp_routes.py`` and of the two
environment variables the JAX package reads at trace time,
``CDS_WARP_ROUTE`` (per stage, dispatched at ``models/stage_net.py:332-509``)
and ``CDS_COSTREG_FRONT`` (``models/cost_reg.py:151-252``). The port reads
no environment variable: a :class:`Routes` is an explicit argument of
``CDSMVSNet.forward`` (bf16 eval only, as the JAX package routes bf16
features).

Warp routes (``WARP_ROUTES``: the port's function for each JAX name):

- ``v8``: K1 (``warp_entropy``), the default;
- ``v8s``, ``v7m``, ``v6sdc``: K5's forward (``warp_sim``, coordinates in
  the kernel, sim out), then the plain entropy;
- ``v6s``, ``v6sc``, ``v6sd``: K8 per view (``warp_sim_coords``) on
  ``sweep_coords``' px/py, then the plain entropy;
- ``v6sb``, ``v6sball``: K8 once over the V−1 views
  (``warp_sim_coords_batched``), where V > 2, else K8 per view;
- ``v6``, ``v3``: K9 in bf16 (``warp_gather``), then the product and the
  C-sum in plain PyTorch;
- ``xla``: the plain gather (``warp_gather_plain``), no kernel.

Fronts (``FRONTS``): ``pallas`` (the default: conv0 on K2), ``pallasf``
(conv0 and conv1 on K6), ``pallasf3`` (K6, then conv2 on K2 at O=16),
``pallas2`` (conv0 on K2, conv1 on K7), ``pallas3`` (``pallas2``, then conv2
on K2 at O=16) and ``s2d`` (conv0 on cuDNN: the JAX ``s2d`` front runs no
Pallas kernel). The rest of the UNet runs on cuDNN in every front.

The JAX route strings also carry tile suffixes (``<kd>``, ``y<ky>``,
``t<tr>``, ``q<slots>``, ``r``, ``g``/``o``, ``ky<N>``, ``_interp``): they set
the TPU kernels' tile geometry or interpret mode, which the port's kernels
do not have, and :func:`parse_route` refuses them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Routes", "WARP_ROUTES", "FRONTS", "BATCHED_ROUTES", "parse_route"]

WARP_ROUTES = {
    "v8": "warp_entropy",
    "v8s": "warp_sim",
    "v7m": "warp_sim",
    "v6sdc": "warp_sim",
    "v6s": "warp_sim_coords",
    "v6sc": "warp_sim_coords",
    "v6sd": "warp_sim_coords",
    "v6sb": "warp_sim_coords_batched",
    "v6sball": "warp_sim_coords_batched",
    "v6": "warp_gather",
    "v3": "warp_gather",
    "xla": "warp_gather_plain",
}
BATCHED_ROUTES = ("v6sb", "v6sball")
FRONTS = ("pallas", "pallasf", "pallasf3", "pallas2", "pallas3", "s2d")


def parse_route(name: str, table) -> str:
    """``name`` if ``table`` has it; a ``ValueError`` for a JAX name with a
    tile suffix, or for an unknown name."""
    if name in table:
        return name
    base = max((k for k in table if name.startswith(k)), key=len, default=None)
    if base is not None:
        raise ValueError(
            f"route {name!r}: the suffix {name[len(base):]!r} of {base!r} is TPU tile geometry or interpret mode, "
            "which the port's kernels do not have; pass the route's base name")
    raise ValueError(f"unknown route {name!r}; known: {sorted(table)}")


@dataclass(frozen=True)
class Routes:
    """``warp``: stage (1, 2, 3) -> warp route (stages not named run ``v8``);
    ``front``: the cost-regularisation front of every stage."""

    warp: dict[int, str] = field(default_factory=dict)
    front: str = "pallas"

    def __post_init__(self):
        for stage, name in self.warp.items():
            if stage not in (1, 2, 3):
                raise ValueError(f"warp route for stage {stage}: stages are 1, 2, 3")
            parse_route(name, WARP_ROUTES)
        parse_route(self.front, FRONTS)

    def stage(self, s: int) -> str:
        """The warp route of stage ``s`` (1-based)."""
        return self.warp.get(s, "v8")
