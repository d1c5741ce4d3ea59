"""Scan-level end-to-end throughput: depth inference -> filter -> fusion -> .ply.

    python -m cds_mvsnet_tpu_torch.tools.bench_scan [--views 10 --h 864 --w 1152 --nviews 5 --ndepths 192] [--out DIR]

Counterpart of the JAX package's ``tools/bench_scan.py``, with its point,
flags, ``CDS_SCAN_SMALL`` and JSON line. A rendered scan (closed-form
``sphere_scene``, written in the eval layout) goes through the product's
steps:

  save_depths (the cascade on the card, one-view-ahead copies, writer
    thread; bf16 on the card, fp32 on the CPU, by ``resolve_fast_path``)
    -> fuse_scan        (the fusion.py-parity path, each view's math on the card)
    -> fuse_scan_native (the C++ fusibile-equivalent on the host)

and one JSON line gives scans/s for each fusion path and the fusion's share
of the total. Both fusion paths include their file IO, as the reference's
pipeline reads depth, confidence and cameras back from disk.

Both depth legs are timed alike: a warm run's wall clock over the whole
scan (the model's build, the loader's start and, for ``save_depths``, the
writer's tail included), after a first run that builds the kernels
(``depth_wall_first_s``). ``depth_s_per_scan`` is ``save_depths``;
``depth_checksum_s_per_scan`` is the same cascade and loader with the same
one-view-ahead order (view i reduced after view i+1's forward is queued)
and each view's outputs reduced to one scalar, whose transfer is the
barrier. The key ``relay_transfer_share_of_depth`` (1 − checksum / depth)
keeps the JAX tool's name; on the card it is the share of the depth leg
that the output copies to the host, their conversion and the writer take,
beside whatever of them overlaps the dispatch. The JAX tool takes
``save_depths``' median interval a view times the views instead; that
interval runs from a view's start to its drain, which comes after the
next view's fetch and forward, so on a host-bound path it spans about two
views' dispatch, and it is not used here. ``depth_maps_per_sec`` and
``depth_maps_per_sec_checksum`` are the views over each leg's time.
``backend`` is ``cuda`` or ``cpu``.

Weights: seed 0 (``build_model``); the JAX tool reads the upstream
checkpoint unconditionally and fails without it, and the port reads no
checkpoint outside its checkout. ``main(device="cpu")`` takes the place of
the JAX tool's ``--cpu``; the run is then on the kernels' plain versions.
``main`` returns the printed line with each leg's kernel launches and the
vertex counts of the written ``.ply`` files, for a caller to hold to what
it expects.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

from ._common import count_launches

SMALL = (5, 256, 320, 64)  # CDS_SCAN_SMALL: views, h, w, ndepths
INTERVAL_SCALE = 1.0
NUM_WORKERS = 2
TEMPERATURE = 0.01
CONF_THRESHOLDS = (0.0, 0.0, 0.3)
DISP_THRESH = 0.1
NUM_CONSISTENT = 2


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=10, help="ref views in the scan")
    ap.add_argument("--h", type=int, default=864)
    ap.add_argument("--w", type=int, default=1152)
    ap.add_argument("--nviews", type=int, default=5, help="views per inference")
    ap.add_argument("--ndepths", type=int, default=192)
    ap.add_argument("--out", default=None, help="keep outputs here (default: tmp)")
    return ap


def ply_vertices(path: str) -> int:
    """The vertex count in a ``.ply`` header."""
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"element vertex"):
                return int(line.split()[2])
            if line.startswith(b"end_header"):
                break
    raise ValueError(f"{path}: no vertex element")


def _checksum_leg(cfg, datapath: str, args, dev) -> None:
    """The cascade over the scan, fed by the same loader in ``save_depths``'
    order, each view's outputs reduced to one scalar after the next view's
    forward has been queued."""
    from ..data.eval_set import EvalDataset
    from ..data.loader import DataLoader
    from ..eval.depth_inference import resolve_fast_path
    from ..models import build_model

    dtype, _, _ = resolve_fast_path("auto", "auto", "auto", max_h=args.h, max_w=args.w, device=dev)
    model = build_model(cfg, seed=0, device=dev)
    ds = EvalDataset(datapath, ["scan1"], nviews=args.nviews, ndepths=args.ndepths, interval_scale=INTERVAL_SCALE,
                     max_h=args.h, max_w=args.w, dataset="general", refine=cfg.refine)

    def checksum(out):
        s = out["refined_depth"].float().sum()
        for i in range(cfg.num_stages):
            s = s + out[f"stage{i + 1}"]["photometric_confidence"].float().sum()
        float(s)  # one-scalar barrier

    prev = None
    for batch in DataLoader(ds, batch_size=1, shuffle=False, num_workers=NUM_WORKERS, device=dev):
        out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"], temperature=TEMPERATURE,
                    compute_dtype=dtype)
        if prev is not None:
            checksum(prev)
        prev = out
    checksum(prev)


def main(argv=None, device=None) -> dict:
    """Run the tool on ``device`` (None: the card, which must be present);
    returns ``{"line": the printed JSON, "launches": {"depth", "checksum"},
    "ply_vertices": {"points_jit", "points_native"}, "views", "nviews",
    "device"}``."""
    args = parser().parse_args(argv)
    if os.environ.get("CDS_SCAN_SMALL"):
        args.views, args.h, args.w, args.ndepths = SMALL

    from ..config import ModelConfig
    from ..eval.depth_inference import save_depths
    from ..fusion.pipeline import FusionConfig, fuse_scan, fuse_scan_native
    from ..models.cds_mvsnet import resolve_device
    from ..utils.synthetic import sphere_scene, write_eval_scene

    dev = resolve_device(device or "cuda")
    cfg = ModelConfig(refine=False)
    report = {"device": dev.type, "views": args.views, "nviews": args.nviews, "launches": {}, "ply_vertices": {}}

    keep = contextlib.nullcontext(args.out) if args.out else tempfile.TemporaryDirectory(prefix="bench_scan_")
    with keep as root:
        data = os.path.join(root, "data")
        scene = sphere_scene(V=args.views, H=args.h, W=args.w)
        write_eval_scene(data, "scan1", scene, ndepths=args.ndepths)

        # -- step 1: depth inference over the scan (incl. pfm/cam/jpg writes) --
        outdir = os.path.join(root, "out")

        def depth_leg():
            return save_depths(None, cfg, datapath=data, scans=["scan1"], outdir=outdir, nviews=args.nviews,
                               ndepths=args.ndepths, interval_scale=INTERVAL_SCALE, max_h=args.h, max_w=args.w,
                               dataset="general", verbose=False, num_workers=NUM_WORKERS, device=dev)

        t0 = time.perf_counter()
        depth_leg()
        depth_wall_first = time.perf_counter() - t0  # includes the kernels' build and cuDNN's set-up
        t0 = time.perf_counter()
        _, report["launches"]["depth"] = count_launches(depth_leg)
        depth_s = time.perf_counter() - t0

        # -- step 1b: the same cascade and loader, outputs reduced to one scalar --
        t0 = time.perf_counter()
        _, report["launches"]["checksum"] = count_launches(lambda: _checksum_leg(cfg, data, args, dev))
        depth_ck_s = time.perf_counter() - t0

        scan_dir = os.path.join(outdir, "scan1")
        fcfg = FusionConfig(n_src_views=args.nviews - 1, conf_thresholds=CONF_THRESHOLDS)
        jit_ply = os.path.join(root, "fused_jit.ply")
        native_ply = os.path.join(root, "fused_native.ply")

        # -- step 2a: the fusion.py-parity path (run twice: the 2nd is warm) --
        fuse_scan(os.path.join(data, "scan1"), scan_dir, jit_ply, fcfg, device=dev)
        t0 = time.perf_counter()
        n_pts = fuse_scan(os.path.join(data, "scan1"), scan_dir, jit_ply, fcfg, device=dev)
        fuse_jit_s = time.perf_counter() - t0

        # -- step 2b: native C++ fusibile-equivalent (published-protocol knobs) --
        t0 = time.perf_counter()
        n_pts_native = fuse_scan_native(scan_dir, native_ply, conf_thresholds=CONF_THRESHOLDS,
                                        disp_thresh=DISP_THRESH, num_consistent=NUM_CONSISTENT)
        fuse_native_s = time.perf_counter() - t0
        report["ply_vertices"] = {"points_jit": ply_vertices(jit_ply), "points_native": ply_vertices(native_ply)}

    total_jit = depth_s + fuse_jit_s
    total_native = depth_s + fuse_native_s
    report["line"] = {
        "metric": f"scan e2e (depth+filter+fusion+ply), {args.views} views at "
                  f"{args.w}x{args.h}, {args.nviews}-view inference, "
                  f"{args.ndepths} depths",
        "scans_per_sec_jit_fusion": round(1.0 / total_jit, 4),
        "scans_per_sec_native_fusion": round(1.0 / total_native, 4),
        "depth_s_per_scan": round(depth_s, 3),
        "depth_maps_per_sec": round(args.views / depth_s, 3),
        "depth_checksum_s_per_scan": round(depth_ck_s, 3),
        "depth_maps_per_sec_checksum": round(args.views / depth_ck_s, 3),
        "relay_transfer_share_of_depth": round(1.0 - depth_ck_s / depth_s, 3),
        "fuse_jit_s_per_scan": round(fuse_jit_s, 3),
        "fuse_native_s_per_scan": round(fuse_native_s, 3),
        "fusion_share_jit": round(fuse_jit_s / total_jit, 3),
        "fusion_share_native": round(fuse_native_s / total_native, 3),
        "points_jit": int(n_pts),
        "points_native": int(n_pts_native),
        "depth_wall_first_s": round(depth_wall_first, 1),
        "backend": dev.type,
    }
    print(json.dumps(report["line"]), flush=True)
    return report


if __name__ == "__main__":
    main()
