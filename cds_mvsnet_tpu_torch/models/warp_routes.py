"""Routes of the eval cascade: which kernel warps each stage, which runs
the cost-regularisation UNet's first layers and which FeatureNet convs run
on K4.

Counterpart of ``cds_mvsnet_tpu/models/warp_routes.py`` and of the three
environment variables the JAX package reads at trace time,
``CDS_WARP_ROUTE`` (per stage, dispatched at ``models/stage_net.py:332-509``),
``CDS_COSTREG_FRONT`` (``models/cost_reg.py:151-252``) and
``CDS_FEAT_SPARSE`` (``models/feature_net_s2d.py:42-72``). The port reads
no environment variable: a :class:`Routes` is an explicit argument of
``CDSMVSNet.forward`` (eval with kernels, bf16 or fp32).

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

In fp32 (``FP32_WARP_ROUTES``) only ``v6``/``v3`` (K9 in fp32) and ``xla``
run, as in the JAX package, whose fp32 features take ``warp_pallas_padded``
with the route's name as the variant (``models/stage_net.py:474-480``):
its table (``ops/pallas/warp.py:1592-1600``) has ``v3`` and ``v6`` and none
of the fused names, so :meth:`Routes.check_fp32` refuses them. A stage not
named takes the fp32 path's warp (K9), as ``v8`` is the bf16 path's.

Fronts (``FRONTS``): ``pallas`` (the default: conv0 on K2), ``pallasf``
(conv0 and conv1 on K6), ``pallasf3`` (K6, then conv2 on K2 at O=16),
``pallas2`` (conv0 on K2, conv1 on K7), ``pallas3`` (``pallas2``, then conv2
on K2 at O=16) and ``s2d`` (conv0 on cuDNN: the JAX ``s2d`` front runs no
Pallas kernel). The rest of the UNet runs on cuDNN in every front.

Feature route (``feature``): the FeatureNet convs that run through K4
(``dynconv_branches``), the port's counterpart of the JAX package's
``CDS_FEAT_SPARSE`` (``models/feature_net_s2d.py:42-72``): any of the 13
names of ``FEATURE_LAYERS``, default ``conv01`` as there. The JAX package
routes only bf16 features (``_want_sparse``, :67): in fp32 the FeatureNet
runs as on the fp32 path whatever the route names, and K4 does not launch.
Its TPU row-alignment test (``Wp % 8``) is Mosaic's limit, which the port's
kernel does not have.
:func:`parse_feature_route` reads the JAX grammar: a comma list, ``all``,
or ``off``/``none``/``0``/empty for none.

The JAX route strings also carry tile suffixes (``<kd>``, ``y<ky>``,
``t<tr>``, ``q<slots>``, ``r``, ``g``/``o``, ``ky<N>``, ``_interp``): they set
the TPU kernels' tile geometry or interpret mode, which the port's kernels
do not have, and :func:`parse_route` refuses them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Routes", "WARP_ROUTES", "FP32_WARP_ROUTES", "FRONTS", "BATCHED_ROUTES", "FEATURE_LAYERS",
           "DEFAULT_FEATURE_ROUTE", "parse_route", "parse_feature_route"]

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
# the warp routes of fp32 features: the JAX variant table's (ops/pallas/warp.py:1592-1600) and the XLA gather
FP32_WARP_ROUTES = ("v6", "v3", "xla")
FRONTS = ("pallas", "pallasf", "pallasf3", "pallas2", "pallas3", "s2d")
# the JAX package's _SPARSE_ALL and _FEAT_SPARSE_DEFAULT
FEATURE_LAYERS = ("conv00", "conv01", "conv10", "conv11", "conv20", "conv21", "out1", "out2", "out3",
                  "downsample1", "downsample2", "inner1", "inner2")
DEFAULT_FEATURE_ROUTE = frozenset({"conv01"})


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


def parse_feature_route(value) -> frozenset:
    """The FeatureNet layers a feature route names: a string in the JAX
    grammar of ``CDS_FEAT_SPARSE`` (a comma list of layer names, ``all``,
    or ``off``/``none``/``0``/empty), or an iterable of layer names. A
    ``ValueError`` for a name that is not one of ``FEATURE_LAYERS``."""
    if isinstance(value, str):
        v = value.strip().lower()
        names = [] if v in ("", "0", "off", "none") else [n.strip() for n in v.split(",")]
    else:
        names = list(value)
    if "all" in names:
        return frozenset(FEATURE_LAYERS)
    unknown = sorted(set(names) - set(FEATURE_LAYERS))
    if unknown:
        raise ValueError(f"feature route: unknown layers {unknown}; known: {list(FEATURE_LAYERS)}, or 'all'")
    return frozenset(names)


@dataclass(frozen=True)
class Routes:
    """``warp``: stage (1, 2, 3) -> warp route (stages not named run ``v8``);
    ``front``: the cost-regularisation front of every stage; ``feature``:
    the FeatureNet layers on K4 (a string or names, :func:`parse_feature_route`;
    held as a frozenset)."""

    warp: dict[int, str] = field(default_factory=dict)
    front: str = "pallas"
    feature: frozenset = DEFAULT_FEATURE_ROUTE

    def __post_init__(self):
        object.__setattr__(self, "feature", parse_feature_route(self.feature))
        for stage, name in self.warp.items():
            if stage not in (1, 2, 3):
                raise ValueError(f"warp route for stage {stage}: stages are 1, 2, 3")
            parse_route(name, WARP_ROUTES)
        parse_route(self.front, FRONTS)

    def stage(self, s: int) -> str:
        """The warp route of stage ``s`` (1-based) in bf16."""
        return self.warp.get(s, "v8")

    def check_fp32(self) -> None:
        """A ``ValueError`` for a warp route that fp32 features cannot take:
        the fused names, which the JAX package's fp32 features reach its
        variant table with (``ops/pallas/warp.py:1592-1600``: ``v3``, ``v6``
        and the archive's), which has none of them. Every front runs."""
        bad = {s: name for s, name in sorted(self.warp.items()) if name not in FP32_WARP_ROUTES}
        if bad:
            raise ValueError(
                f"warp routes {bad} fuse the warp for bf16 features; fp32 features take {list(FP32_WARP_ROUTES)}: "
                "the JAX package sends fp32 features to warp_pallas_padded, whose variant table "
                "(ops/pallas/warp.py:1592-1600) has v3 and v6 and none of the fused routes")
