"""Time K1 and K5's forward as built from several kernel source directories,
in one process on one card, against the plain version.

    python -m cds_mvsnet_tpu_torch.tools.time_warp DIR [DIR ...] [--rounds N]

Each ``DIR`` holds a ``warp.cu`` (and the headers it includes), such as the
``cds_mvsnet_tpu_torch/csrc`` of this checkout and of a parent commit
unpacked beside it. Every ``warp.cu`` is built with the flags of
``ops/kernels/_build.py`` (all ``nvcc`` runs at once) and its
``warp_entropy_launch`` (K1) is timed at the three stage shapes of the eval
main path (1152x864, V=5, ndepths 48/32/8), of the DTU protocol point
(576x768 under refinement) and of the stream point (480x640, ndepths
128/32/8), and its ``warp_sim_launch`` (K5's forward), where the source has
one, at the three of the train point (512x640 with refinement, per batch
element), on inputs shaped and drawn as in ``chip_smoke.py``'s kernels
phase. Rounds alternate the order of the sources (A B C, C B A, ...); a
time is the median over rounds of the mean of ``--reps`` launches between
CUDA events (``tools/_timing.py``). One JSON line per source, kernel and
stage, with ``in_prod``'s share of values equal to the plain version's,
its largest difference, whether it equals the first source's bit for bit
and the largest entropy (or sim) difference to the plain version; the
card's ``nvidia-smi`` name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import tempfile
from pathlib import Path

import torch

from ..models import strict_fp32, to_tensors
from ..ops import kernels as K
from ..ops.geometry import relative_warp_transform
from ..utils.synthetic import synthetic_batch, textured_plane_batch
from ._timing import I, P, alternate, build, card, stream_ptr, typed

ARGTYPES = [P, P, P, I, P, P, P, I, I, I, I, I, I, P]
NDEPTHS = (48, 32, 8)
D_FULL = 192


def cases(dev) -> list[tuple]:
    """``(kernel, point, stage, src, ref, hyp, rt)`` at the shapes of
    chip_smoke.py's kernels phase: K1 at the serve, protocol and stream
    points', K5's forward at the train point's."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, lo=-1.0, hi=1.0, dtype=torch.bfloat16):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo).to(dtype).contiguous()

    def rt_of(cams):
        rot, trans = relative_warp_transform(cams[:1, 0], cams[:1, 1])
        return torch.cat([rot.reshape(9), trans.reshape(3)]).float().contiguous()

    def hyp_of(s, D, h, w, ratio, interval):
        if s == 1:
            return torch.linspace(425.0, 905.0, D, device=dev).contiguous()
        centre = uniform((h, w), 560.0, 640.0, torch.float32)
        steps = torch.arange(D, device=dev, dtype=torch.float32) - (D - 1) // 2
        return (centre[None] + steps[:, None, None] * ratio * interval).contiguous()

    interval = 480.0 / (D_FULL - 1)
    out = []
    for point, H, W, ndepths in (("serve", 864, 1152, NDEPTHS), ("protocol", 576, 768, NDEPTHS),
                                 ("stream", 480, 640, (128, 32, 8))):
        cams = to_tensors(textured_plane_batch(V=2, H=H, W=W, D=D_FULL, seed=0), dev)["proj_matrices"]
        for s, (C, D) in enumerate(zip((32, 16, 8), ndepths), start=1):
            h, w = H // 2 ** (3 - s), W // 2 ** (3 - s)
            hyp = hyp_of(s, D, h, w, (0.0, 2.0, 1.0)[s - 1], interval)
            out.append(("warp_entropy", point, s, uniform((h, w, C)), uniform((C, h, w)), hyp,
                        rt_of(cams[f"stage{s}"])))
    train = to_tensors(synthetic_batch(B=2, V=5, H=512, W=640, D=D_FULL, refine=True, with_gt=True, seed=0), dev)
    for s, (C, D) in enumerate(zip((32, 16, 8), NDEPTHS), start=1):
        scale = 2 ** (3 - s)
        h, w = 256 // scale, 320 // scale
        rt = rt_of(train["proj_matrices"][f"stage{s}"])
        hyp = hyp_of(s, D, h, w, 4.0 / scale, interval)
        out.append(("warp_sim", "train", s, uniform((h, w, C)), uniform((C, h, w)), hyp, rt))
    return out


def launcher(lib, kernel, src, ref, hyp, rt):
    """A closure launching ``kernel`` of ``lib`` on the case, its ``in_prod``
    and its entropy (or sim); None where the source has no such entry
    point."""
    if not hasattr(lib, f"{kernel}_launch"):
        return None
    fn = typed(lib, f"{kernel}_launch", ARGTYPES)
    H, W, C = src.shape
    _, h, w = ref.shape
    D = hyp.shape[0]
    in_prod = torch.empty((C, D, h, w), dtype=torch.bfloat16, device=src.device)
    out = torch.empty((D, h, w) if kernel == "warp_sim" else (h, w), dtype=torch.float32, device=src.device)
    args = [P(t.data_ptr()) for t in (src, ref, hyp)] + [int(hyp.ndim == 3)]
    args += [P(t.data_ptr()) for t in (rt, in_prod, out)] + [C, H, W, D, h, w, stream_ptr()]

    def run():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{kernel}: CUDA error {err}")

    return run, in_prod, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_warp: no CUDA device", file=sys.stderr)
        return 2
    strict_fp32()
    print(json.dumps({"card": card(), "sources": [str(d) for d in args.dirs]}), flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = [lib["warp"] for lib in build(args.dirs, ("warp",), Path(tmp))]
        for d, lib in zip(args.dirs, libs):  # K1's launch plan, where the source reports one
            if hasattr(lib, "warp_entropy_plan"):
                for C, h, w in ((32, 216, 288), (16, 432, 576), (8, 864, 1152)):
                    out = (ctypes.c_int * 6)()
                    if typed(lib, "warp_entropy_plan", [I, I, I, P])(C, h, w, ctypes.cast(out, P)) == 0:
                        keys = ("lanes", "pixels", "shared_bytes", "blocks", "registers", "blocks_per_sm")
                        print(json.dumps({"source": str(d), "plan": [C, h, w], **dict(zip(keys, out))}), flush=True)
        for kernel, point, stage, src, ref, hyp, rt in cases(dev):
            want, want_out = (K.warp_entropy_plain if kernel == "warp_entropy" else K.warp_sim_plain)(
                src, ref, hyp, rt)
            runs = {i: r for i, r in enumerate(launcher(lib, kernel, src, ref, hyp, rt) for lib in libs)
                    if r is not None}
            times = alternate({i: r[0] for i, r in runs.items()}, args.rounds, args.reps)
            first = min(runs)
            for i in runs:
                d = (runs[i][1].float() - want.float()).abs()
                print(json.dumps({
                    "source": str(args.dirs[i]), "kernel": kernel, "point": point, "stage": stage,
                    "shape": list(runs[i][1].shape), "ms": statistics.median(times[i]), "ms_rounds": times[i],
                    "in_prod_exact_frac": float((d == 0).float().mean()), "in_prod_max_abs_diff": float(d.max()),
                    "in_prod_equals_first": torch.equal(runs[i][1], runs[first][1]),
                    "out_max_abs_diff": float((runs[i][2] - want_out).abs().max()),
                }), flush=True)
            del runs, want, want_out
    return 0


if __name__ == "__main__":
    sys.exit(main())
