"""The eval product: predict depth maps, filter them and fuse a point cloud.

Counterpart of ``cds_mvsnet_tpu/cli/test_cli.py``, with the same options,
defaults and choices. It runs on the card unless the caller asks for the
CPU (``main(argv, device="cpu")``):

    python -m cds_mvsnet_tpu_torch.cli.test_cli --dataset dtu --testpath <scans> \\
        --resume <ckpt.npz|.pth> --outdir <out> --interval_scale 1.06 --num_view 5 \\
        --numdepth 192 --max_h 1152 --max_w 1536 --filter_method gipuma \\
        --prob_threshold 0.0,0.0,0.0 --disp_threshold 0.1 --num_consistent 2

``--feature_impl`` and ``--precision`` select TPU layouts and XLA precision
in the JAX package; the port accepts them and reports them, and they do not
change its result (one layout, fp32 products in fp32).
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Predict depth, filter, and fuse")
    p.add_argument("--dataset", default="dtu", choices=["dtu", "tt", "general"])
    p.add_argument("--testpath", required=True, help="data dir containing scans")
    p.add_argument("--testlist", default="all", help="scan list file or 'all'")
    p.add_argument("--resume", required=True, help="checkpoint (.npz ours or .pth/.ckpt torch)")
    p.add_argument("--outdir", default="./outputs")
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument(
        "--stage_ndepths", default=None,
        help="comma list of per-stage hypothesis counts, e.g. 32,16,8 "
             "(default 48,32,8, the reference operating point; each a multiple of 8)",
    )
    p.add_argument("--interval_scale", type=float, default=1.06)
    p.add_argument("--num_view", type=int, default=5)
    p.add_argument("--max_h", type=int, default=864)
    p.add_argument("--max_w", type=int, default=1152)
    p.add_argument("--fix_res", action="store_true")
    p.add_argument("--temperature", type=float, default=0.01)
    p.add_argument("--no_refinement", action="store_true")
    p.add_argument("--batch_size", type=int, default=1, help="ref views per forward")
    p.add_argument("--filter_method", default="normal", choices=["normal", "gipuma", "none"])
    p.add_argument("--conf", default="0.0,0.0,0.0", help="per-stage confidence thresholds")
    p.add_argument("--thres_view", type=int, default=3)
    p.add_argument("--thres_disp", type=float, default=1.0)
    p.add_argument("--num_src_fusion", type=int, default=10)
    # gipuma-path (native C++ fusion) knobs, reference defaults
    p.add_argument("--prob_threshold", default="0.0,0.0,0.0")
    p.add_argument("--disp_threshold", type=float, default=0.2)
    p.add_argument("--num_consistent", type=int, default=3)
    p.add_argument("--skip_inference", action="store_true", help="fuse existing depth maps only")
    # compute-path knobs ("auto" = bf16 on the card, fp32 on the CPU)
    p.add_argument("--compute_dtype", default="auto", choices=["auto", "bf16", "fp32"])
    p.add_argument("--feature_impl", default="auto", choices=["auto", "plain", "s2d", "folded"],
                   help="a TPU layout in the JAX package; no effect on the port's result")
    p.add_argument("--precision", default="auto", choices=["auto", "default", "highest"],
                   help="XLA matmul precision in the JAX package; the port keeps fp32 in fp32")
    return p


def main(argv=None, device="cuda") -> dict:
    """Run the product; returns ``{"inference": stats or None, "points":
    {scan: fused points}}``. Raises without a card unless ``device="cpu"``."""
    args = build_parser().parse_args(argv)

    from ..config import ModelConfig
    from ..eval.depth_inference import save_depths
    from ..fusion.pipeline import FusionConfig, fuse_scan, fuse_scan_native
    from ..models.cds_mvsnet import resolve_device
    from ..models.convert import load_any_checkpoint

    dev = resolve_device(device)
    if args.testlist != "all":
        scans = [s for s in Path(args.testlist).read_text().split() if s]
    else:
        scans = sorted(e for e in os.listdir(args.testpath) if os.path.isdir(os.path.join(args.testpath, e)))

    model_cfg = ModelConfig(refine=not args.no_refinement)
    if args.stage_ndepths:
        nd = tuple(int(x) for x in args.stage_ndepths.split(","))
        # the cost-reg UNet strides the depth axis by 2 three times, so each
        # stage count must be a multiple of 8, as the reference's (48, 32, 8);
        # the JAX package also lets 0 and negative counts through
        if len(nd) != 3 or any(d <= 0 or d % 8 for d in nd):
            raise SystemExit(f"--stage_ndepths must be three positive multiples of 8, got {nd}")
        model_cfg = ModelConfig(refine=model_cfg.refine, ndepths=nd)
    params = load_any_checkpoint(args.resume)
    if not model_cfg.refine:
        params.pop("refine_network", None)

    stats = None
    if not args.skip_inference:
        stats = save_depths(
            params, model_cfg,
            datapath=args.testpath, scans=scans, outdir=args.outdir,
            nviews=args.num_view, ndepths=args.numdepth,
            interval_scale=args.interval_scale, max_h=args.max_h, max_w=args.max_w,
            fix_res=args.fix_res, dataset=args.dataset,
            temperature=args.temperature, batch_size=args.batch_size,
            compute_dtype=args.compute_dtype, feature_impl=args.feature_impl,
            precision=args.precision, device=dev,
        )
        print(json.dumps({"inference": stats}))

    points = {}
    if args.filter_method == "gipuma":
        thresholds = tuple(float(x) for x in args.prob_threshold.split(","))
        for scan in scans:
            points[scan] = fuse_scan_native(
                os.path.join(args.outdir, scan), os.path.join(args.outdir, f"{scan}.ply"),
                conf_thresholds=thresholds, disp_thresh=args.disp_threshold, num_consistent=args.num_consistent,
            )
            print(f"{scan}: {points[scan]} fused points (native)")
    elif args.filter_method == "normal":
        fcfg = FusionConfig(
            n_src_views=args.num_src_fusion,
            conf_thresholds=tuple(float(x) for x in args.conf.split(",")),
            img_dist_thresh=args.thres_disp,
            depth_thresh=0.01,
            vthresh=args.thres_view,
        )
        for scan in scans:
            points[scan] = fuse_scan(
                os.path.join(args.testpath, scan), os.path.join(args.outdir, scan),
                os.path.join(args.outdir, f"{scan}.ply"), fcfg, verbose=True, device=dev,
            )
            print(f"{scan}: {points[scan]} fused points")
    return {"inference": stats, "points": points}


if __name__ == "__main__":
    main()
