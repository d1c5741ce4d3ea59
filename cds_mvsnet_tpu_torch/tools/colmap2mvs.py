"""Convert a COLMAP dense workspace into the MVS scene layout that
``cli/test_cli.py --dataset general`` reads.

    python -m cds_mvsnet_tpu_torch.tools.colmap2mvs --dense_folder WS --save_folder SCENE

Counterpart of the JAX package's ``tools/colmap2mvs.py`` (the reference's
``colmap2mvsnet.py`` CLI), with its flags, through the port's own
``data/colmap.py::convert_scene``. Host code only.
"""

from __future__ import annotations

import argparse

from ..data.colmap import convert_scene


def main(argv=None) -> int:
    """Convert one workspace; returns the number of images."""
    p = argparse.ArgumentParser(description="COLMAP -> MVS scene converter")
    p.add_argument("--dense_folder", required=True, help="COLMAP workspace (images/ + sparse/)")
    p.add_argument("--save_folder", required=True)
    p.add_argument("--max_d", type=int, default=192, help="0 = derive from inverse depth")
    p.add_argument("--interval_scale", type=float, default=1.0)
    p.add_argument("--model_ext", default=".bin", choices=[".bin", ".txt"])
    p.add_argument("--theta0", type=float, default=5.0)
    p.add_argument("--sigma1", type=float, default=1.0)
    p.add_argument("--sigma2", type=float, default=10.0)
    args = p.parse_args(argv)
    n = convert_scene(
        args.dense_folder, args.save_folder, args.max_d, args.interval_scale,
        args.model_ext, args.theta0, args.sigma1, args.sigma2,
    )
    print(f"converted {n} images -> {args.save_folder}")
    return n


if __name__ == "__main__":
    main()
