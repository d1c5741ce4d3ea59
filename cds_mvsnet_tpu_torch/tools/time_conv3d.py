"""Time K2 in bf16 and in fp32, K6 and K7 as built from several kernel source
directories, in one process on one card, beside cuDNN.

    python -m cds_mvsnet_tpu_torch.tools.time_conv3d DIR [DIR ...] [--rounds N] [--kernels ...] [--loads-only]

Each ``DIR`` holds a ``conv3d.cu`` and a ``conv3d_fused.cu`` (and the headers
they include), such as the ``cds_mvsnet_tpu_torch/csrc`` of this checkout
and of a parent commit unpacked beside it. Both are built with the flags of
``ops/kernels/_build.py`` (all ``nvcc`` runs at once). Cases, on inputs
drawn as in ``chip_smoke.py``'s kernels phase: K2 at O = 8 at the three
stage shapes of the serve point (1152x864, ndepths 48/32/8) and at the
stream point's stage 1 (D = 128, 120x160), K2 at O = 16 at the conv2 shapes
of the ``3`` fronts, K6 at the serve stage shapes, with K2 then K7 of
the same source beside it, and K2 in fp32 (the fp32 route's conv0, O = 8)
at the stage shapes of the DTU protocol point (576x768 under refinement),
the serve point and the stream point (480x640, ndepths 128/32/8), and K7
in bf16 (``k7``: conv1 of the ``pallas2``/``pallas3`` fronts, 8 -> 16 at
stride 2) on conv0's output shape at the serve stages; ``k6_fp32`` and
``k7_fp32`` (not in the default list): K6 and K7 in fp32, as the mixed
path (``cost_dtype=float32`` at the serve point, ``mixed<s>``) and the fp32
routes at the protocol point (``protocol<s>``) run them, by CUDA events and
by device time, beside cuDNN with TF32 off, the plain version, their bound
(3xTF32) and one conv's fp32 FMA floor; K6 also beside its K2 then K7
apart, with out0 equal to that K2 and out1 to that K7 on out0. Rounds alternate the
order of the sources (A B, B A, ...); a time is the median over rounds of
the mean of ``--reps`` launches between CUDA events (``tools/_timing.py``),
for K7 of the device time of a launch under ``torch.profiler``. cuDNN's call
(``F.conv3d`` + ReLU on bf16 weights, at stride 2 for K7; for K6 its two
calls) is timed in each round too; in fp32 on fp32 weights with TF32 off.
One JSON line per case and source, with the largest difference to the
plain version (K2 and K7: one bf16 ulp allowed, in fp32 1e-5 of the sum of
|terms| + 1e-7; K6: out0 equal to the same source's K2 and out1 to its K7
in fp32 on out0, rounded to bf16, bit for bit) and whether the output
equals the first source's bit for bit (``equals_first``); K7's rows also hold each
source's registers and spill bytes (ptxas ``-v``) and, where the source has
the entry, its launch plan (``conv3d_down_plan``). ``--loads-only`` adds
the first source built with ``-DCDS_K7_LOADS_ONLY``: K7 with its MMAs
skipped (its output is not checked). The card's ``nvidia-smi`` name and
power limit come first.
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
import torch.nn.functional as F

from ..models import strict_fp32
from ..ops import kernels as K
from ._timing import I, P, alternate_device, build, card, medians, ptxas_registers, stream_ptr, typed

H, W = 864, 1152
SERVE = [(32, 48, H // 4, W // 4), (16, 32, H // 2, W // 2), (8, 8, H, W)]
PROTOCOL = [(32, 48, 144, 192), (16, 32, 288, 384), (8, 8, 576, 768)]
STREAM = [(32, 128, 120, 160), (16, 32, 240, 320), (8, 8, 480, 640)]
K7_PLAN_KEYS = ("tile_z", "tile_y", "tile_x", "tiles", "blocks", "registers", "blocks_per_sm", "shared_bytes")


def conv(lib, entry: str, vol, w, b, stride: int):
    """K2 (``conv3d_bn_relu_launch``) or K7 (``conv3d_down_launch``) of one
    source."""
    fn = typed(lib["conv3d"], entry, [P, P, P, P, I, I, I, I, I, I, P])
    C, D, h, wd = vol.shape
    out = torch.empty((w.shape[0], (D - 1) // stride + 1, (h - 1) // stride + 1, (wd - 1) // stride + 1),
                      dtype=vol.dtype, device=vol.device)
    err = fn(*(P(t.data_ptr()) for t in (vol, w, b, out)), int(vol.dtype == torch.float32), w.shape[0], C, D, h,
             wd, stream_ptr())
    if err:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    return out


def fused(lib, vol, w0, b0, w1, b1):
    fn = typed(lib["conv3d_fused"], "conv3d_front_fused_launch", [P] * 7 + [I] * 5 + [P])
    C, D, h, w = vol.shape
    out0 = torch.empty((8, D, h, w), dtype=vol.dtype, device=vol.device)
    out1 = torch.empty((16, D // 2, h // 2, w // 2), dtype=vol.dtype, device=vol.device)
    err = fn(*(P(t.data_ptr()) for t in (vol, w0, b0, w1, b1, out0, out1)), int(vol.dtype == torch.float32), C, D,
             h, w, stream_ptr())
    if err:
        raise RuntimeError(f"conv3d_front_fused_launch: CUDA error {err}")
    return out0, out1


def k7_plan(lib, O: int, C: int, D: int, h: int, w: int) -> dict | None:
    """K7's launch plan in bf16 as the source's launcher makes it, None where
    the source has no ``conv3d_down_plan``."""
    if not hasattr(lib["conv3d"], "conv3d_down_plan"):
        return None
    out = (ctypes.c_int * len(K7_PLAN_KEYS))()
    if typed(lib["conv3d"], "conv3d_down_plan", [I] * 5 + [P])(O, C, D, h, w, ctypes.cast(out, P)):
        raise RuntimeError("conv3d_down_plan failed")
    return dict(zip(K7_PLAN_KEYS, out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--kernels", nargs="+", default=["k2", "k2_o16", "k6", "k2_fp32", "k7"],
                    help="cases to time: k2, k2_o16, k6, k2_fp32, k7, k6_fp32, k7_fp32")
    ap.add_argument("--loads-only", action="store_true",
                    help="also time K7 of the first source with its MMAs skipped")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_conv3d: needs the card", file=sys.stderr)
        return 2
    strict_fp32()
    print(json.dumps({"card": card(), "dirs": [str(d) for d in args.dirs]}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, lo=-1.0, hi=1.0, dtype=torch.bfloat16):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo).to(dtype).contiguous()

    def weights(o, c):
        bound = (27 * c) ** -0.5
        return uniform((o, c, 3, 3, 3), -bound, bound, torch.float32), uniform((o,), -0.1, 0.1, torch.float32)

    cases = [("k2", f"serve{s}", shape, 8) for s, shape in enumerate(SERVE, start=1)]
    cases.append(("k2", "stream1", (32, 128, 120, 160), 8))
    cases += [("k2_o16", f"serve{s}", (16, D // 2, h // 2, w // 2), 16) for s, (_, D, h, w) in enumerate(SERVE, 1)]
    cases += [("k6", f"serve{s}", shape, 8) for s, shape in enumerate(SERVE, start=1)]
    cases += [("k2_fp32", f"{point}{s}", shape, 8) for point, shapes in
              (("protocol", PROTOCOL), ("serve", SERVE), ("stream", STREAM)) for s, shape in enumerate(shapes, 1)]
    cases += [("k7", f"serve{s}", (8, D, h, w), 16) for s, (_, D, h, w) in enumerate(SERVE, start=1)]
    cases += [("k6_fp32", f"{point}{s}", shape, 8) for point, shapes in (("protocol", PROTOCOL), ("mixed", SERVE))
              for s, shape in enumerate(shapes, start=1)]
    cases += [("k7_fp32", f"{point}{s}", (8, D, h, w), 16) for point, shapes in (("protocol", PROTOCOL), ("mixed", SERVE))
              for s, (_, D, h, w) in enumerate(shapes, start=1)]
    cases = [case for case in cases if case[0] in args.kernels]
    sources = list(args.dirs) + ([(args.dirs[0], ("CDS_K7_LOADS_ONLY",))] if args.loads_only else [])
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, ("conv3d", "conv3d_fused"), Path(tmp))
        for i, lib in enumerate(libs):
            regs = {**ptxas_registers(lib["conv3d"].ptxas_log, "conv3d"),
                    **ptxas_registers(lib["conv3d_fused"].ptxas_log, "conv3d_fused")}
            print(json.dumps({"source": str(sources[i]), "registers_and_spill_bytes": regs}), flush=True)
        for kernel, point, shape, O in cases:
            if kernel == "k7":
                time_k7(libs, sources, point, shape, O, uniform, weights, args)
                continue
            if kernel in ("k6_fp32", "k7_fp32"):
                time_fp32_front(libs, args, kernel, point, shape, O, uniform, weights)
                continue
            fp32 = kernel == "k2_fp32"
            vol = uniform(shape, dtype=torch.float32 if fp32 else torch.bfloat16)
            wb = weights(O, shape[0])
            lw = list(wb) if fp32 else [t.bfloat16() for t in wb]
            w1b1 = weights(16, 8)
            lw1 = [t.bfloat16() for t in w1b1]
            runs, checks, first = {}, {}, None
            for i, lib in enumerate(libs):
                if kernel == "k6":
                    out0, out1 = fused(lib, vol, *wb, *w1b1)
                    k2 = conv(lib, "conv3d_bn_relu_launch", vol, *wb, 1)
                    # K6's conv1 runs K7-fp32's arithmetic in its order (in
                    # older sources its direct FMAs): K7 in fp32 on out0's
                    # values, rounded
                    k7_fp32 = conv(lib, "conv3d_down_launch", out0.float(), *w1b1, 2).to(torch.bfloat16)
                    first = first or (out0, out1)
                    checks[i] = {"equal_to_k2_then_k7": torch.equal(out0, k2) and torch.equal(out1, k7_fp32),
                                 "equals_first": torch.equal(out0, first[0]) and torch.equal(out1, first[1])}
                    runs[i] = lambda lib=lib: fused(lib, vol, *wb, *w1b1)
                    runs[f"k2_plus_k7_{i}"] = lambda lib=lib: conv(
                        lib, "conv3d_down_launch", conv(lib, "conv3d_bn_relu_launch", vol, *wb, 1), *w1b1, 2)
                else:
                    y = conv(lib, "conv3d_bn_relu_launch", vol, *wb, 1)
                    want = K.conv3d_bn_relu_plain(vol, *wb)
                    d = (y.float() - want.float()).abs()
                    first = first or (y,)
                    if fp32:
                        terms = F.conv3d(vol.abs()[None], wb[0].abs(), padding=1)[0] + wb[1].abs()[:, None, None, None]
                        checks[i] = {"max_abs_err": float(d.max()), "within_fp32_tol": bool(
                            (d <= 1e-5 * terms + 1e-7).all())}
                        del terms
                    else:
                        checks[i] = {"max_abs_err": float(d.max()),
                                     "one_ulp": bool((d <= 2 ** -7 * want.float().abs() + 1e-3).all())}
                    checks[i]["equals_first"] = torch.equal(y, first[0])
                    del y, want, d
                    runs[i] = lambda lib=lib: conv(lib, "conv3d_bn_relu_launch", vol, *wb, 1)
            if kernel == "k6":
                runs["cudnn"] = lambda: F.conv3d(F.conv3d(vol[None], *lw, padding=1).relu_(), *lw1, stride=2,
                                                 padding=1).relu_()
            else:
                runs["cudnn"] = lambda: F.conv3d(vol[None], *lw, padding=1).relu_()
            med = medians(runs, args.rounds, args.reps)
            for i, d in enumerate(args.dirs):
                row = {"kernel": kernel, "point": point, "shape": list(shape), "O": O, "dir": str(d),
                       "ms": med[i], "cudnn_ms": med["cudnn"], **checks[i]}
                if fp32 and hasattr(libs[i]["conv3d"], "conv3d_tf32_plan"):  # registers, blocks an SM, smem
                    out = (ctypes.c_int * 3)()
                    typed(libs[i]["conv3d"], "conv3d_tf32_plan", [I, I, P])(O, shape[0], ctypes.cast(out, P))
                    row.update(registers=out[0], blocks_per_sm=out[1], shared_bytes=out[2])
                if kernel == "k6":
                    row["k2_plus_k7_ms"] = med[f"k2_plus_k7_{i}"]
                print(json.dumps(row), flush=True)
            del vol
            torch.cuda.empty_cache()
    return 0


def fp32_err(got, want, vol, w, b, stride: int) -> dict:
    """The largest difference of an fp32 conv to its plain version, and
    whether it is within 1e-5 of the sum of |terms| + 1e-7."""
    d = (got - want).abs()
    terms = F.conv3d(vol.abs()[None], w.abs(), stride=stride, padding=1)[0] + b.abs()[:, None, None, None]
    return {"max_abs_err": float(d.max()), "within_fp32_tol": bool((d <= 1e-5 * terms + 1e-7).all())}


def time_fp32_front(libs, args, kernel, point, shape, O, uniform, weights) -> None:
    """K6 or K7 in fp32 at one shape, each source beside cuDNN in fp32 with
    TF32 off and the plain version, by CUDA events (``ms``) and by device
    time under ``torch.profiler`` (``device_ms``): a row per source with its
    bound (the three TF32 products of a 3xTF32 kernel, or bytes), one
    conv's fp32 FMA floor beside it, its check against the plain version
    (1e-5 of the sum of |terms| + 1e-7), whether the output equals the first
    source's, and for K6 whether out0 equals the same source's K2 and out1
    its K7 on out0 bit for bit and the time of that K2 then K7 apart."""
    C, D, h, w = shape
    vol = uniform(shape, dtype=torch.float32)
    wb = weights(O, C)
    runs, checks = {}, {}
    if kernel == "k7_fp32":
        want = K.conv3d_down_plain(vol, *wb)
        first = None
        for i, lib in enumerate(libs):
            y = conv(lib, "conv3d_down_launch", vol, *wb, 2)
            first = y if first is None else first
            checks[i] = {**fp32_err(y, want, vol, *wb, 2), "equals_first": torch.equal(y, first)}
            runs[i] = lambda lib=lib: conv(lib, "conv3d_down_launch", vol, *wb, 2)
        runs["cudnn"] = lambda: F.conv3d(vol[None], *wb, stride=2, padding=1).relu_()
        runs["plain"] = lambda: K.conv3d_down_plain(vol, *wb)
        out_elems = want.numel()
        flops = 2 * 27 * C * out_elems
        weights_bytes = sum(t.numel() * 4 for t in wb)
    else:
        w1b1 = weights(16, 8)
        want0 = K.conv3d_bn_relu_plain(vol, *wb)
        first = None
        for i, lib in enumerate(libs):
            out0, out1 = fused(lib, vol, *wb, *w1b1)
            first = (out0, out1) if first is None else first
            e0 = fp32_err(out0, want0, vol, *wb, 1)
            e1 = fp32_err(out1, K.conv3d_down_plain(out0, *w1b1), out0, *w1b1, 2)
            checks[i] = {"max_abs_err": max(e0["max_abs_err"], e1["max_abs_err"]),
                         "within_fp32_tol": e0["within_fp32_tol"] and e1["within_fp32_tol"],
                         "out0_equals_k2": torch.equal(out0, conv(lib, "conv3d_bn_relu_launch", vol, *wb, 1)),
                         "out1_equals_k7_on_out0": torch.equal(out1, conv(lib, "conv3d_down_launch", out0, *w1b1, 2)),
                         "equals_first": torch.equal(out0, first[0]) and torch.equal(out1, first[1])}
            runs[i] = lambda lib=lib: fused(lib, vol, *wb, *w1b1)
            runs[f"k2_plus_k7_{i}"] = lambda lib=lib: conv(
                lib, "conv3d_down_launch", conv(lib, "conv3d_bn_relu_launch", vol, *wb, 1), *w1b1, 2)
        runs["cudnn"] = lambda: F.conv3d(F.conv3d(vol[None], *wb, padding=1).relu_(), *w1b1, stride=2,
                                         padding=1).relu_()
        runs["plain"] = lambda: K.conv3d_front_fused_plain(vol, *wb, *w1b1)
        out_elems = want0.numel() + want0[0].numel() * 2  # out0, and out1's 16 channels at an eighth
        flops = 2 * 27 * C * want0.numel() + 2 * 27 * 8 * 16 * want0[0].numel() // 8
        weights_bytes = sum(t.numel() * 4 for t in (*wb, *w1b1))
    med = medians(runs, args.rounds, args.reps)
    dev = {k: statistics.median(t for t, _ in v) for k, v in alternate_device(
        {i: runs[i] for i in range(len(libs))}, args.rounds, args.reps).items()}
    io_bytes = (vol.numel() + out_elems) * 4 + weights_bytes
    bound = {"bytes": io_bytes / 3.35e12 * 1e3, "operations": 3 * flops / 495e12 * 1e3}
    for i, d in enumerate(args.dirs):
        row = {"kernel": kernel, "point": point, "shape": list(shape), "O": O, "dir": str(d), "ms": med[i],
               "device_ms": dev[i], "cudnn_ms": med["cudnn"], "plain_ms": med["plain"],
               "bound_ms": max(bound.values()), "bound_by": max(bound, key=bound.get), "bound_halves_ms": bound,
               "fma_floor_ms": flops / 67e12 * 1e3, **checks[i]}
        if kernel == "k6_fp32":
            row["k2_plus_k7_ms"] = med[f"k2_plus_k7_{i}"]
        print(json.dumps(row), flush=True)
    del vol
    torch.cuda.empty_cache()


def time_k7(libs, sources, point, shape, O, uniform, weights, args) -> None:
    """K7 in bf16 at one shape, each source by device time beside cuDNN's
    stride-2 call: a row per source with its check, registers and plan."""
    vol = uniform(shape)
    wb = weights(O, shape[0])
    lw = [t.bfloat16() for t in wb]
    want = K.conv3d_down_plain(vol, *wb)
    runs, checks = {}, {}
    for i, lib in enumerate(libs):
        loads_only = isinstance(sources[i], tuple)
        y = conv(lib, "conv3d_down_launch", vol, *wb, 2)
        d = (y.float() - want.float()).abs()
        checks[i] = {"loads_only": True} if loads_only else {
            "max_abs_err": float(d.max()), "one_ulp": bool((d <= 2 ** -7 * want.float().abs() + 1e-3).all()),
            "equals_first": torch.equal(y, conv(libs[0], "conv3d_down_launch", vol, *wb, 2))}
        runs[i] = lambda lib=lib: conv(lib, "conv3d_down_launch", vol, *wb, 2)
    runs["cudnn"] = lambda: F.conv3d(vol[None], *lw, stride=2, padding=1).relu_()
    times = alternate_device(runs, args.rounds, args.reps)
    C, D, h, w = shape
    io = (vol.numel() + O * want[0].numel()) * 2 + sum(t.numel() * 4 for t in wb)
    for i, src in enumerate(sources):
        d = src[0] if isinstance(src, tuple) else src
        print(json.dumps({
            "kernel": "k7", "point": point, "shape": list(shape), "O": O, "dir": str(d),
            "ms": statistics.median(t for t, _ in times[i]), "ms_rounds": [t for t, _ in times[i]],
            "cudnn_ms": statistics.median(t for t, _ in times["cudnn"]), "bound_ms": io / 3.35e12 * 1e3,
            **checks[i], "registers_and_spill_bytes": ptxas_registers(libs[i]["conv3d"].ptxas_log, "conv3d_down")
            or ptxas_registers(libs[i]["conv3d"].ptxas_log, "conv3d_bn_relu_kernel"),
            "plan": k7_plan(libs[i], O, C, D, h, w)}), flush=True)
    del vol, want
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
