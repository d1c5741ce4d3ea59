"""Per-stage and per-component times of the eval cascade on the card.

    python -m cds_mvsnet_tpu_torch.tools.profile_stages [--reps 5] [--skip-prefix | --prefix-only | --marginals]

Counterpart of the JAX package's ``tools/profile_stages.py``, at its point
(``H, W, V, D``: 1152x864, 5 views, 192 depths, no refinement, bf16,
temperature 0.01, on ``textured_plane_batch``), with its attribution:

- cascade prefixes (1, 2 and 3 stages, ``PREFIXES``) give each stage's
  marginal cost with everything around it as the full request runs it; a
  prefix runs the full model's weights with the missing stages' dropped;
- components give the split inside a stage, at ``stage_shapes``: the
  FeatureNet over the 2·(V−1) stacked images (K4 on conv01, the default
  route), per single view the coordinate gather (K9 in bf16 from px/py, the
  counterpart of ``warp_pallas_padded``) and K1 (``warp_entropy_*``, which
  the default path runs per view; a key the JAX tool lacks), the cost
  regularisation (K2 and the channels-last cuDNN UNet), and sim + entropy +
  vis head + weighted accumulation;
- ``dispatch``: a one-op call, host to barrier.

Times are host clock around a call that ends in ``torch.cuda.synchronize``,
medians of ``--reps``; one JSON line under the JAX tool's keys, in ms.
``--marginals`` runs the prefixes at V = 2 and V = 5 and splits each
stage's marginal into a per-source-view and a fixed part
(:func:`marginal_split`), with ``MARGINAL_REPS`` calls each as the JAX tool.

Weights: seed 0 (``build_model``), as the JAX tool's ``main`` takes where
the upstream checkpoint is not on disk; the port reads no checkpoint
outside its checkout. ``main`` returns the printed line with, besides,
each prefix's kernel launches in one request and whether its stages equal
the full cascade's bit for bit, for a caller to hold to the launches it
expects.
"""

from __future__ import annotations

import argparse
import functools
import json

import torch

from ..config import ModelConfig
from ._common import count_launches, timed

H, W, V, D = 864, 1152, 5, 192
TEMPERATURE = 0.01
PREFIXES = {
    1: ModelConfig(refine=False, ndepths=(48,), depth_intervals_ratio=(4.0,), cr_base_chs=(8,), stage_scales=(4.0,)),
    2: ModelConfig(refine=False, ndepths=(48, 32), depth_intervals_ratio=(4.0, 2.0), cr_base_chs=(8, 8),
                   stage_scales=(4.0, 2.0)),
    3: ModelConfig(refine=False),
}
MARGINAL_VIEWS = (2, 5)
MARGINAL_REPS = 5
# the JSON line's keys: fixed, then per stage ("{}": the stage's name); the
# K1 key is the port's own
FIXED_KEYS = ("dispatch", *(f"prefix{n}" for n in PREFIXES), "stage2_marginal", "stage3_marginal", "features")
STAGE_KEYS = ("warp_{}_1view", "costreg_{}", "simvis_{}")
PORT_STAGE_KEYS = ("warp_entropy_{}_1view",)


def stage_shapes(h: int, w: int) -> dict[str, tuple[int, int, int, int]]:
    """``(planes, h, w, channels)`` of each stage at an ``h x w`` input."""
    return {"stage1": (48, h // 4, w // 4, 32), "stage2": (32, h // 2, w // 2, 16), "stage3": (8, h, w, 8)}


def line_keys() -> list[str]:
    """The keys of a full run's JSON line, in order."""
    per_stage = (STAGE_KEYS[0], *PORT_STAGE_KEYS, *STAGE_KEYS[1:])
    return [*FIXED_KEYS, *(k.format(s) for s in stage_shapes(H, W) for k in per_stage)]


def marginal_split(res: dict[str, float]) -> dict[str, float]:
    """From ``res["p{n}V{views}"]`` (seconds of prefix ``n`` at 2 and 5
    views): stage k's per-source-view cost, ``[(pk − pk−1)(V5) − (pk −
    pk−1)(V2)] / 3``, and its fixed cost, ``(pk − pk−1)(V2) − per-view``, in
    ms rounded to 0.1, as the JAX tool computes them."""
    out = {}
    for k in (2, 3):
        m5 = res[f"p{k}V5"] - res[f"p{k-1}V5"]
        m2 = res[f"p{k}V2"] - res[f"p{k-1}V2"]
        per_view = (m5 - m2) / 3
        out[f"stage{k}_per_src_view_ms"] = round(per_view * 1e3, 1)
        out[f"stage{k}_fixed_ms"] = round((m2 - per_view) * 1e3, 1)
    return out


def prefix_model(full, cfg: ModelConfig):
    """A ``cfg`` cascade on ``full``'s weights, the stages it lacks dropped."""
    from ..models.cds_mvsnet import CDSMVSNet

    model = CDSMVSNet(cfg)
    state = full.state_dict()
    model.load_state_dict({k: state[k] for k in model.state_dict()})
    return model.to(next(full.parameters()).device).eval()


def _batch(views: int, dev):
    from ..models import to_tensors
    from ..utils.synthetic import textured_plane_batch

    return to_tensors(textured_plane_batch(V=views, H=H, W=W, D=D, refine=False), dev)


def _request(model, batch):
    return model(batch["imgs"], batch["proj_matrices"], batch["depth_values"], temperature=TEMPERATURE,
                 compute_dtype=torch.bfloat16)


def _prefixes(models, batch, reps, dev, results, report) -> None:
    outs = {}
    for n, model in models.items():
        request = functools.partial(_request, model, batch)
        outs[n], report["launches"][f"prefix{n}"] = count_launches(request)
        results[f"prefix{n}"] = timed(request, reps, f"prefix {n} stages", dev)
    results["stage2_marginal"] = results["prefix2"] - results["prefix1"]
    results["stage3_marginal"] = results["prefix3"] - results["prefix2"]
    full = outs[max(outs)]
    report["prefix_equal"] = {
        f"prefix{n}": all(torch.equal(out[f"stage{k}"][key], full[f"stage{k}"][key])
                          for k in range(1, n + 1) for key in ("depth", "photometric_confidence"))
        for n, out in outs.items()}


def _components(full, batch, reps, dev, results) -> None:
    from ..models.cds_mvsnet import pairwise_epipoles
    from ..models.warp_routes import DEFAULT_FEATURE_ROUTE
    from ..ops import kernels as K
    from ..ops.geometry import plane_sweep_coords, relative_warp_transform
    from ..ops.sampling import softmax_entropy

    bf16 = torch.bfloat16
    # feature extraction (the batched 2(V-1) stack, channels first)
    imgs = batch["imgs"]
    cams3 = batch["proj_matrices"]["stage3"]
    ref_epi, src_epi = pairwise_epipoles(cams3[:, 0], cams3[:, 1:])
    ref_rep = imgs[:, 0][None].expand(V - 1, 1, H, W, 3)
    srcs = imgs[:, 1:].transpose(0, 1)
    stacked = torch.cat([ref_rep, srcs]).reshape(2 * (V - 1), H, W, 3).permute(0, 3, 1, 2).to(bf16).contiguous()
    epis = torch.cat([ref_epi.transpose(0, 1), src_epi.transpose(0, 1)]).reshape(2 * (V - 1), 2)
    branches = dict.fromkeys(DEFAULT_FEATURE_ROUTE, K.dynconv_branches)
    results["features"] = timed(lambda: full.feature(stacked, epis, TEMPERATURE, branches=branches), reps,
                                "feature net (8 imgs)", dev)

    # per-stage warp, cost-reg and sim/vis timings (per single view)
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=bf16)

    for sname, (d, h, w, c) in stage_shapes(H, W).items():
        # coherent plane-sweep coords from the real cameras at this scale
        scams = batch["proj_matrices"][sname]
        hyp = (600.0 + torch.linspace(-50, 50, d, device=dev)[:, None, None]).expand(d, h, w).contiguous()
        px, py = (t.reshape(d, h, w) for t in plane_sweep_coords(scams[:, 0], scams[:, 1], hyp[None], h, w))
        rot, trans = relative_warp_transform(scams[:, 0], scams[:, 1])
        rt = torch.cat([rot.reshape(9), trans.reshape(3)]).float().contiguous()
        src_feat = normal(h, w, c)
        ref_feat = normal(c, h, w)
        results[f"warp_{sname}_1view"] = timed(lambda: K.warp_gather(src_feat, px, py), reps,
                                               f"warp kernel {sname} (1 view)", dev)
        results[f"warp_entropy_{sname}_1view"] = timed(lambda: K.warp_entropy(src_feat, ref_feat, hyp, rt), reps,
                                                       f"warp+entropy {sname} (1 view)", dev)

        vol = normal(c, d, h, w)
        cr = full.cost_regularization[str(int(sname[-1]) - 1)]
        results[f"costreg_{sname}"] = timed(lambda: cr(vol, K.conv3d_bn_relu), reps, f"cost reg {sname}", dev)

        # sim + entropy + vis + weighted accumulate at stage shapes
        warped = normal(c, d, h, w)
        reff = normal(c, h, w)
        nc = normal(1, h, w)
        vis_head = full.stage_net.vis[str(int(sname[-1]) - 1)]

        def simvis():
            sim = (warped.float() * reff[:, None].float()).sum(0)[None]
            entropy = softmax_entropy(sim, dim=1)[:, 0]
            vis = vis_head(torch.stack([entropy.to(nc.dtype), nc], 1))[:, 0]
            return reff[:, None] * warped * vis[0][None, None], vis

        results[f"simvis_{sname}"] = timed(simvis, reps, f"sim+vis {sname} (1 view)", dev)


def marginals(dev, reps: int = MARGINAL_REPS) -> dict:
    """Prefix x views matrix: separates each stage's per-source-view cost
    (warp + sim/vis) from its fixed cost (cost reg + regression)."""
    from ..models import build_model

    full = build_model(PREFIXES[3], seed=0, device=dev)
    models = {n: prefix_model(full, cfg) for n, cfg in PREFIXES.items()}
    res = {}
    for views in MARGINAL_VIEWS:
        batch = _batch(views, dev)
        for n, model in models.items():
            res[f"p{n}V{views}"] = timed(functools.partial(_request, model, batch), reps, f"prefix{n} V={views}",
                                         dev)
    out = {k: round(v * 1e3, 1) for k, v in res.items()}
    out.update(marginal_split(res))
    print(json.dumps(out), flush=True)
    return out


def main(argv=None, device=None) -> dict:
    """Run the tool on ``device`` (None: the card, which must be present);
    returns ``{"line": the printed JSON, "launches": {prefix: counts},
    "prefix_equal": {prefix: bool}, "device"}`` (``--marginals``: the
    printed JSON under ``"line"``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--skip-prefix", action="store_true", help="components only")
    ap.add_argument("--prefix-only", action="store_true", help="cascade prefixes only")
    ap.add_argument("--marginals", action="store_true", help="prefix x views matrix")
    args = ap.parse_args(argv)

    from ..models import build_model
    from ..models.cds_mvsnet import resolve_device

    dev = resolve_device(device or "cuda")
    report = {"device": dev.type, "launches": {}, "prefix_equal": {}}
    with torch.no_grad():
        if args.marginals:
            report["line"] = marginals(dev)
            return report
        full = build_model(PREFIXES[3], seed=0, device=dev)
        batch = _batch(V, dev)
        results = {}
        x = torch.ones((8, 128), device=dev)
        results["dispatch"] = timed(lambda: x + 1.0, args.reps, "noop dispatch", dev)
        if not args.skip_prefix:
            models = {n: full if n == max(PREFIXES) else prefix_model(full, cfg) for n, cfg in PREFIXES.items()}
            _prefixes(models, batch, args.reps, dev, results, report)
        if not args.prefix_only:
            _components(full, batch, args.reps, dev, results)
    report["line"] = {k: round(v * 1e3, 2) for k, v in results.items()}
    print(json.dumps(report["line"]), flush=True)
    return report


if __name__ == "__main__":
    main()
