"""Time K9 and K4 as built from several kernel source directories, in one
process on one card, beside their library calls.

    python -m cds_mvsnet_tpu_torch.tools.time_gather_dynconv DIR [DIR ...] [--rounds N] [--feature]

Each ``DIR`` holds a ``gather.cu`` and a ``dynconv.cu`` (and the headers they
include), such as the ``cds_mvsnet_tpu_torch/csrc`` of this checkout and of
a parent commit unpacked beside it. Both are built with the flags of
``ops/kernels/_build.py`` (all ``nvcc`` runs at once). Cases, on inputs drawn
as in ``chip_smoke.py``'s kernels phase: K9 in fp32 and bf16 at the three
stage shapes of the DTU protocol point (a plane sweep between two views of
``textured_plane_batch`` at 1152x1536, the cascade at 576x768), beside
``F.grid_sample`` on the NCHW source (fp32); K4 on conv01 (8 images, I = 8,
k = 3, 5, 7, OA = 11) at the serve (864x1152), stream (480x640) and
protocol (576x768) inputs, beside three bf16 ``F.conv2d`` calls; K4 reads
the caller's ``(OA, I, k, k)`` weights in place (its C entry took no
stride before the feature route; such sources are called without it).
Rounds alternate the order of the sources (A B, B A, ...); a time is the median
over rounds of the mean of ``--reps`` launches between CUDA events. One JSON
line per case and source, with the largest difference to the plain
version and its checks (K9: bit for bit; K4: one bf16 ulp, and bit for
bit); the card's ``nvidia-smi`` name and power limit come first. With
``--feature``, K4 instead at each of the FeatureNet's 13 convs as the feature
route runs them at the serve point, for the sources that take a stride. The
harness is ``tools/_timing.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from ..models import strict_fp32
from ..ops import kernels as K
from ..ops.geometry import relative_warp_transform, sweep_coords
from ..utils.synthetic import textured_plane_batch
from ._timing import I, L, P, build, card, medians, stream_ptr, typed

DTU_H, DTU_W, D_FULL = 1152, 1536, 192
PROTOCOL = [(32, 48, DTU_H // 8, DTU_W // 8), (16, 32, DTU_H // 4, DTU_W // 4), (8, 8, DTU_H // 2, DTU_W // 2)]
CONV01 = {"serve": (864, 1152), "stream": (480, 640), "protocol": (DTU_H // 2, DTU_W // 2)}
KS, OA = (3, 5, 7), 11


def gather(lib, src, px, py):
    fn = typed(lib["gather"], "warp_gather_launch", [P, P, P, P, I, I, I, I, L, P])
    H, W, C = src.shape
    out = torch.empty((C, *px.shape), dtype=src.dtype, device=src.device)
    err = fn(*(P(t.data_ptr()) for t in (src, px, py, out)), int(src.dtype == torch.float32), C, H, W, px.numel(),
             stream_ptr())
    if err:
        raise RuntimeError(f"warp_gather_launch: CUDA error {err}")
    return out


def strided(src_dir: Path) -> bool:
    """Whether ``DIR/dynconv.cu`` takes a stride (the feature route's K4)."""
    return "int stride, void* stream" in (src_dir / "dynconv.cu").read_text()


def dynconv_runner(lib, x, ws, src_dir: Path, stride: int = 1):
    """A closure that launches K4 of ``lib`` on ``(x, ws)`` through
    ``dynconv_launch``, which reads the caller's weights in place; a source
    from before the feature route (no ``stride`` argument) takes the entry
    without it."""
    N, I_, H, W = x.shape
    OA = ws[0].shape[0]
    kbuf = (ctypes.c_int * 4)(*(w.shape[-1] for w in ws))
    wbuf = (ctypes.c_void_p * 4)(*(w.data_ptr() for w in ws))
    new = strided(src_dir)
    fn = typed(lib["dynconv"], "dynconv_launch", [P, P, P, I, I, I, I, I, I, P, *([I] if new else []), P])
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1

    def run():
        out = torch.empty((N, len(ws) * OA, Ho, Wo), dtype=torch.bfloat16, device=x.device)
        err = fn(P(x.data_ptr()), ctypes.cast(wbuf, P), P(out.data_ptr()), N, I_, H, W, OA, len(ws),
                 ctypes.cast(kbuf, P), *([stride] if new else []), stream_ptr())
        if err:
            raise RuntimeError(f"K4: CUDA error {err}")
        return out

    return run


def feature_layers(libs, args, uniform, emit) -> None:
    """``--feature``: K4 of each source that takes a stride at each of the
    FeatureNet's 13 convs as the feature route runs them at the serve point
    (8 images at 864x1152, ``feature_net.k4_forms``), beside the layer's
    cuDNN bf16 ``F.conv2d`` calls; bit for bit against the plain version."""
    from ..models.feature_net import k4_forms

    dirs = [(i, d) for i, d in enumerate(args.dirs) if strided(d)]
    for layer, I_, OA, ks, stride, h, w in k4_forms(864, 1152):
        x = uniform((8, I_, h, w))
        ws = [uniform((OA, I_, k, k), -(I_ * k * k) ** -0.5, (I_ * k * k) ** -0.5, torch.float32) for k in ks]
        wsb = [w_.to(torch.bfloat16) for w_ in ws]
        want = K.dynconv_branches_plain(x, ws, stride)
        runs = {i: dynconv_runner(libs[i], x, ws, d, stride) for i, d in dirs}
        equal = {i: torch.equal(runs[i](), want) for i, _ in dirs}
        runs["conv2d"] = lambda: [F.conv2d(x, w_, stride=stride, padding=w_.shape[-1] // 2) for w_ in wsb]
        med = medians(runs, args.rounds, args.reps)
        for i, d in dirs:
            emit({"kernel": "k4", "point": "feature", "layer": layer, "dir": str(d), "ms": med[i],
                  "conv2d_ms": med["conv2d"], "bit_for_bit": equal[i]})
        del x, want, runs
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--feature", action="store_true",
                    help="K4 at the FeatureNet's 13 convs at the serve point instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_gather_dynconv: needs the card", file=sys.stderr)
        return 2
    strict_fp32()
    print(json.dumps({"card": card(), "dirs": [str(d) for d in args.dirs]}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, lo=-1.0, hi=1.0, dtype=torch.bfloat16):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo).to(dtype).contiguous()

    def emit(row):
        print(json.dumps(row), flush=True)

    if args.feature:
        with tempfile.TemporaryDirectory() as tmp:
            feature_layers(build(args.dirs, ("dynconv",), Path(tmp)), args, uniform, emit)
        return 0
    rig = textured_plane_batch(V=2, H=DTU_H, W=DTU_W, D=D_FULL, refine=True, tz_step=4.0, seed=0)
    interval = 2.5 * 1.06
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(args.dirs, ("gather", "dynconv"), Path(tmp))
        for s, (C, D, h, w) in enumerate(PROTOCOL, start=1):
            cams = torch.as_tensor(rig["proj_matrices"][f"stage{s}"], device=dev)
            rot, trans = relative_warp_transform(cams[:, 0], cams[:, 1])
            if s == 1:
                hyp = torch.linspace(425.0, 425.0 + interval * (D_FULL - 1), D, device=dev)
            else:
                centre = uniform((h, w), 560.0, 640.0, torch.float32)
                steps = torch.arange(D, device=dev, dtype=torch.float32) - (D - 1) // 2
                hyp = centre[None] + steps[:, None, None] * (4.0 / 2 ** (s - 1)) * interval
            px, py = sweep_coords(rot, trans, hyp[None], h, w)
            px, py = px.reshape(D, h, w).contiguous(), py.reshape(D, h, w).contiguous()
            for dtype in (torch.float32, torch.bfloat16):
                src = uniform((h, w, C), dtype=dtype)
                want = K.warp_gather_plain(src, px, py)
                runs = {i: (lambda lib=lib: gather(lib, src, px, py)) for i, lib in enumerate(libs)}
                equal = {i: torch.equal(gather(lib, src, px, py), want) for i, lib in enumerate(libs)}
                if dtype == torch.float32:
                    src_nchw = src.permute(2, 0, 1)[None].contiguous()
                    grid = torch.stack([px * (2 / (w - 1)) - 1, py * (2 / (h - 1)) - 1], -1).reshape(1, D * h, w, 2)
                    runs["grid_sample"] = lambda: F.grid_sample(src_nchw, grid, mode="bilinear",
                                                                padding_mode="zeros", align_corners=True)
                med = medians(runs, args.rounds, args.reps)
                for i, d in enumerate(args.dirs):
                    emit({"kernel": "k9", "dtype": str(dtype).split(".")[-1], "stage": s, "shape": [C, D, h, w],
                          "dir": str(d), "ms": med[i], "grid_sample_ms": med.get("grid_sample"),
                          "bit_for_bit": equal[i]})
                del src, want, runs
            del px, py, hyp
            torch.cuda.empty_cache()
        for point, (H, W) in CONV01.items():
            x = uniform((8, 8, H, W))
            ws = [uniform((OA, 8, k, k), -(8 * k * k) ** -0.5, (8 * k * k) ** -0.5, torch.float32) for k in KS]
            wsb = [w_.to(torch.bfloat16) for w_ in ws]
            want = K.dynconv_branches_plain(x, ws).float()
            runs, checks = {}, {}
            for i, lib in enumerate(libs):
                runs[i] = dynconv_runner(lib, x, ws, args.dirs[i])
                d = (runs[i]().float() - want).abs()
                checks[i] = {"max_abs_err": float(d.max()), "one_ulp": bool((d <= 2 ** -7 * want.abs() + 1e-3).all()),
                             "bit_for_bit": bool((d == 0).all())}
            runs["conv2d"] = lambda: [F.conv2d(x, w_, padding=w_.shape[-1] // 2) for w_ in wsb]
            med = medians(runs, args.rounds, max(2, args.reps // 2))
            for i, d in enumerate(args.dirs):
                emit({"kernel": "k4", "point": point, "shape": [8, 8, H, W], "dir": str(d), "ms": med[i],
                      "conv2d_ms": med["conv2d"], **checks[i]})
            del x, want, runs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
