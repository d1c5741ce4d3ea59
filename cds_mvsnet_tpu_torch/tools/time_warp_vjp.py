"""Time K5, the training warp, forward (``warp.cu``) and backward
(``warp_vjp.cu``), as built from several kernel source directories, by
device time, in one process on one card.

    python -m cds_mvsnet_tpu_torch.tools.time_warp_vjp DIR [DIR ...] [--rounds N] [--reps N]

Each ``DIR`` holds a ``warp.cu`` and a ``warp_vjp.cu`` (and the headers they
include), such as the ``cds_mvsnet_tpu_torch/csrc`` of this checkout and of a
parent commit unpacked beside it. Both are built with the flags of
``ops/kernels/_build.py`` (all ``nvcc`` runs at once). The shapes, per batch
element and source view, on inputs drawn as in ``chip_smoke.py``'s kernels
phase:

- ``sweep``: the train point's plane sweeps (512x640 under refinement, so
  the cascade at 256x320; C/D/h x w = 32/48/64x80, 16/32/128x160,
  8/8/256x320), forward and backward;
- ``gt``: the train step's ground-truth warps at D = 1 at the same stages,
  forward and backward;
- ``r3``: route R3 (``v7m``) at the serve point (1152x864: 32/48/216x288,
  16/32/432x576, 8/8/864x1152), forward only.

A time is the device time of one call (every kernel and memset it runs:
the one-pass backward of older sources also a ``torch.zeros`` fill of
its fp32 ``d_src``; the fixed-point backward its first pass, the maxima
that set its scale, too) under ``torch.profiler``, the median over ``--rounds``
rounds of ``--reps`` calls, the sources alternating (A B, B A, ...);
``main_ms`` is the main kernel's alone, ``bound_ms`` the least time of the
call as ``chip_smoke.py`` counts it. One JSON line per source, kernel and
shape, after the card's ``nvidia-smi`` name and power limit and each
source's registers and spills (ptxas ``-v``) and resident blocks an SM (from the
registers; the launcher's plan entry, where the source has one, adds its
own). Checks: ``in_prod`` equal to the first source's bit for bit, its values
unequal to the plain version's counted, ``sim`` within the smoke's tolerance; the
backward's ``d_src`` and ``d_ref`` within the card tests' tolerance of the
plain backward, whether ``d_src`` and ``d_ref`` are each identical in two
runs (the fixed-point ``d_src`` must be), and its recomputed warped
values (``d_ref`` of a one-plane call with ``g_in_prod = 1``, ``g_sim =
0``, at the first, middle and last plane) equal to the first source's and
the plain version's bit for bit.
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
from ._timing import I, P, alternate_device, blocks_per_sm, build, card, ptxas_registers, stream_ptr, typed

FWD_ARGS = [P, P, P, I, P, P, P, I, I, I, I, I, I, P]
BWD_ARGS = [P, P, P, I, P, P, P, P, P, I, P, P, I, I, I, I, I, I, P]
# the backward's C entry before the plane chunks: no scratch, d_src_f32 zeroed by the caller
BWD_ARGS_ONE_PASS = [P, P, P, I, P, P, P, P, P, P, I, I, I, I, I, I, P]
NDEPTHS = (48, 32, 8)
D_FULL = 192
MAIN_KERNELS = ("void warp_kernel", "void warp_sim_backward_kernel")
PEAK_BYTES_PER_S, PEAK_FP32_FLOPS = 3.35e12, 67e12  # H100 SXM: HBM3, fp32 outside the tensor cores
PLAN_KEYS = ("lanes", "pixels", "chunk", "chunks", "blocks", "registers", "blocks_per_sm", "shared_bytes",
             "scratch_bytes")


def cases(dev) -> list[tuple]:
    """``(point, stage, src, ref, hyp, rt)`` of the three points."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, lo=-1.0, hi=1.0, dtype=torch.bfloat16):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo).to(dtype).contiguous()

    def rt_of(cams):
        rot, trans = relative_warp_transform(cams[:1, 0], cams[:1, 1])
        return torch.cat([rot.reshape(9), trans.reshape(3)]).float().contiguous()

    def window(D, h, w, ratio):
        centre = uniform((h, w), 560.0, 640.0, torch.float32)
        steps = torch.arange(D, device=dev, dtype=torch.float32) - (D - 1) // 2
        return (centre[None] + steps[:, None, None] * ratio * interval).contiguous()

    interval = 480.0 / (D_FULL - 1)
    out = []
    train = to_tensors(synthetic_batch(B=2, V=5, H=512, W=640, D=D_FULL, refine=True, with_gt=True, seed=0), dev)
    for s, (C, D) in enumerate(zip((32, 16, 8), NDEPTHS), start=1):
        scale = 2 ** (3 - s)
        h, w = 256 // scale, 320 // scale
        rt = rt_of(train["proj_matrices"][f"stage{s}"])
        hyp = torch.linspace(425.0, 905.0, D, device=dev).contiguous() if s == 1 else window(D, h, w, 4.0 / scale)
        out.append(("sweep", s, uniform((h, w, C)), uniform((C, h, w)), hyp, rt))
        out.append(("gt", s, uniform((h, w, C)), uniform((C, h, w)), uniform((1, h, w), 560.0, 640.0, torch.float32),
                    rt))
    cams = to_tensors(textured_plane_batch(V=2, H=864, W=1152, D=D_FULL, seed=0), dev)["proj_matrices"]
    for s, (C, D) in enumerate(zip((32, 16, 8), NDEPTHS), start=1):
        h, w = 864 // 2 ** (3 - s), 1152 // 2 ** (3 - s)
        hyp = torch.linspace(425.0, 905.0, D, device=dev).contiguous() if s == 1 else window(D, h, w, (2.0, 1.0)[s - 2])
        out.append(("r3", s, uniform((h, w, C)), uniform((C, h, w)), hyp, rt_of(cams[f"stage{s}"])))
    return out


def forward_runner(lib, src, ref, hyp, rt):
    """A closure launching ``lib``'s forward on the case, its ``in_prod`` and ``sim``."""
    fn = typed(lib, "warp_sim_launch", FWD_ARGS)
    H, W, C = src.shape
    _, h, w = ref.shape
    D = hyp.shape[0]
    in_prod = torch.empty((C, D, h, w), dtype=torch.bfloat16, device=src.device)
    sim = torch.empty((D, h, w), dtype=torch.float32, device=src.device)
    args = [P(t.data_ptr()) for t in (src, ref, hyp)] + [int(hyp.ndim == 3)]
    args += [P(t.data_ptr()) for t in (rt, in_prod, sim)] + [C, H, W, D, h, w, stream_ptr()]

    def run():
        if fn(*args):
            raise RuntimeError("warp_sim_launch failed")

    return run, in_prod, sim


def plan_of(lib, entry: str, C, D, h, w) -> dict | None:
    """The launcher's plan (``warp_sim_plan`` or ``warp_sim_backward_plan``),
    None where the source has none."""
    if not hasattr(lib, entry):
        return None
    keys = PLAN_KEYS if entry == "warp_sim_backward_plan" else PLAN_KEYS[:-1]
    out = (ctypes.c_int * len(keys))()
    if typed(lib, entry, [I, I, I, I, P])(C, D, h, w, ctypes.cast(out, P)):
        raise RuntimeError(f"{entry} failed")
    return dict(zip(keys, out))


def backward_runner(lib, src, ref, hyp, rt, g_ip, g_sim):
    """A closure launching ``lib``'s backward on the case, its ``d_src`` and
    ``d_ref``; the C entry of sources before the plane chunks takes a zeroed
    fp32 ``d_src`` and no scratch, and the closure zeroes it as that
    wrapper did. The accumulator holds ``H·W·C + 2`` int64: the fixed-point
    sums and words where the source has them, and room for the fp32 sums of
    older sources."""
    H, W, C = src.shape
    _, h, w = ref.shape
    D = hyp.shape[0]
    acc = torch.zeros((H * W * C + 2,), dtype=torch.int64, device=src.device)
    d_src = torch.empty((H, W, C), dtype=torch.bfloat16, device=src.device)
    d_ref = torch.empty((C, h, w), dtype=torch.bfloat16, device=src.device)
    head = [P(t.data_ptr()) for t in (src, ref, hyp)] + [int(hyp.ndim == 3)]
    head += [P(t.data_ptr()) for t in (rt, g_ip, g_sim, acc)]
    tail = [P(d_src.data_ptr()), P(d_ref.data_ptr()), C, H, W, D, h, w, stream_ptr()]
    plan = plan_of(lib, "warp_sim_backward_plan", C, D, h, w)
    if plan is None:
        fn = typed(lib, "warp_sim_backward_launch", BWD_ARGS_ONE_PASS)

        def run():
            acc.zero_()
            if fn(*head, *tail):
                raise RuntimeError("warp_sim_backward_launch failed")
    else:
        fn = typed(lib, "warp_sim_backward_launch", BWD_ARGS)
        part = torch.empty((plan["chunks"], C, h, w), dtype=torch.float32, device=src.device)
        args = [*head, P(part.data_ptr()), plan["chunks"], *tail]

        def run():
            if fn(*args):
                raise RuntimeError("warp_sim_backward_launch failed")

    # the C entry holds raw pointers: the scratch lives as long as the closure
    run.scratch = (acc, *([] if plan is None else [part]))
    return run, d_src, d_ref


def warped_probe(lib, src, ref, hyp, rt) -> list[torch.Tensor]:
    """The backward's recomputed warped values at the first, middle and last
    plane: ``d_ref`` of a one-plane call with ``g_in_prod = 1``, ``g_sim = 0``."""
    C, h, w = ref.shape
    out = []
    for d in sorted({0, hyp.shape[0] // 2, hyp.shape[0] - 1}):
        one = hyp[d : d + 1].contiguous()
        g_ip = torch.ones((C, 1, h, w), dtype=torch.bfloat16, device=src.device)
        g_sim = torch.zeros((1, h, w), dtype=torch.float32, device=src.device)
        run, _, d_ref = backward_runner(lib, src, ref, one, rt, g_ip, g_sim)
        run()
        out.append(d_ref.clone())
    return out


def within(got, want, scale) -> bool:
    """The card tests' tolerance of the backward (tests/test_torch_cuda.py)."""
    return bool(((got.float() - want.float()).abs() <= 2 ** -7 * (want.float().abs() + scale.float()) + 1e-6).all())


def bound(kernel: str, src, ref, hyp) -> dict:
    """The least time of the call, as chip_smoke.py counts it: each input read
    and each output written once over the memory rate, or its fp32
    operations over the fp32 rate, the larger."""
    C, h, w = ref.shape
    D = hyp.shape[0]
    io = (src.numel() + ref.numel()) * 2 + hyp.numel() * 4 + 48 + C * D * h * w * 2 + D * h * w * 4
    if kernel == "backward":
        io += (src.numel() + ref.numel()) * 2  # d_src, d_ref
    t_mem = io / PEAK_BYTES_PER_S * 1e3
    t_ops = D * h * w * ((11 if kernel == "forward" else 20) * C + 12) / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_mem, t_ops), "bound_by": "bytes" if t_mem >= t_ops else "operations"}


def summary(results: list) -> dict:
    """The median device ms of a call over the rounds, and of its main kernel;
    every kernel's ms in the last round."""
    totals = [t for t, _ in results]
    mains = [sum(v for k, v in by.items() if k.startswith(MAIN_KERNELS)) for _, by in results]
    return {"ms": statistics.median(totals), "ms_rounds": totals, "main_ms": statistics.median(mains),
            "kernels_ms": {k[:60]: v for k, v in results[-1][1].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_warp_vjp: no CUDA device", file=sys.stderr)
        return 2
    strict_fp32()
    print(json.dumps({"card": card(), "sources": [str(d) for d in args.dirs]}), flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(args.dirs, ("warp", "warp_vjp"), Path(tmp))
        for d, lib in zip(args.dirs, libs):
            regs = {**ptxas_registers(lib["warp"].ptxas_log, "warp_kernel"),
                    **ptxas_registers(lib["warp_vjp"].ptxas_log, "warp_sim_backward")}
            print(json.dumps({"source": str(d), "registers_and_spill_bytes": regs,
                              "blocks_per_sm_by_registers": {
                                  k: {t: blocks_per_sm(v[0], t) for t in (128, 256)} for k, v in regs.items()}}),
                  flush=True)
        for point, stage, src, ref, hyp, rt in cases(dev):
            C, h, w = ref.shape
            D = hyp.shape[0]
            ip_p, sim_p = K.warp_sim_plain(src, ref, hyp, rt)
            fwd = [forward_runner(lib["warp"], src, ref, hyp, rt) for lib in libs]
            times = alternate_device({i: r[0] for i, r in enumerate(fwd)}, args.rounds, args.reps)
            for i, (run, ip, sim) in enumerate(fwd):
                d = (ip.float() - ip_p.float()).abs()
                sim_ok = bool(((sim - sim_p).abs() <= 2 ** -7 * ip_p.float().abs().sum(0) + 1e-5).all())
                print(json.dumps({
                    "source": str(args.dirs[i]), "kernel": "forward", "point": point, "stage": stage,
                    "shape": [C, D, h, w], **summary(times[i]), **bound("forward", src, ref, hyp),
                    "in_prod_equals_first": torch.equal(ip, fwd[0][1]),
                    "in_prod_mismatches_vs_plain": int((d != 0).sum()), "in_prod_max_abs_diff": float(d.max()),
                    "sim_max_abs_diff": float((sim - sim_p).abs().max()), "sim_ok": sim_ok,
                    "plan": plan_of(libs[i]["warp"], "warp_sim_plan", C, D, h, w)}), flush=True)
            del fwd, ip_p, sim_p
            if point == "r3":
                continue
            gen = torch.Generator(device=dev).manual_seed(stage)
            g_ip = (torch.rand((C, D, h, w), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
            g_sim = torch.rand((D, h, w), generator=gen, device=dev) * 2 - 1
            want = K.warp_sim_backward_plain(src, ref, hyp, rt, g_ip, g_sim)
            scale = K.warp_sim_backward_plain(src.abs(), ref.abs(), hyp, rt, g_ip.abs(), g_sim.abs())
            bwd = [backward_runner(lib["warp_vjp"], src, ref, hyp, rt, g_ip, g_sim) for lib in libs]
            times = alternate_device({i: r[0] for i, r in enumerate(bwd)}, args.rounds, args.reps)
            probe_plain = [K.warp_sim_backward_plain(
                src, ref, hyp[d : d + 1].contiguous(), rt, torch.ones((C, 1, h, w), dtype=torch.bfloat16, device=dev),
                torch.zeros((1, h, w), device=dev))[1] for d in sorted({0, D // 2, D - 1})]
            probe_first = warped_probe(libs[0]["warp_vjp"], src, ref, hyp, rt)
            for i, (run, d_src, d_ref) in enumerate(bwd):
                run()
                first_ref, first_src = d_ref.clone(), d_src.clone()
                run()
                probe = warped_probe(libs[i]["warp_vjp"], src, ref, hyp, rt)
                print(json.dumps({
                    "source": str(args.dirs[i]), "kernel": "backward", "point": point, "stage": stage,
                    "shape": [C, D, h, w], **summary(times[i]), **bound("backward", src, ref, hyp),
                    "d_src_ok": within(d_src, want[0], scale[0]), "d_ref_ok": within(d_ref, want[1], scale[1]),
                    "d_src_max_abs_diff": float((d_src.float() - want[0].float()).abs().max()),
                    "d_ref_max_abs_diff": float((d_ref.float() - want[1].float()).abs().max()),
                    "d_ref_same_in_two_runs": torch.equal(first_ref, d_ref),
                    "d_src_same_in_two_runs": torch.equal(first_src, d_src),
                    "warped_equals_first": all(torch.equal(a, b) for a, b in zip(probe, probe_first)),
                    "warped_equals_plain": all(torch.equal(a, b) for a, b in zip(probe, probe_plain)),
                    "plan": plan_of(libs[i]["warp_vjp"], "warp_sim_backward_plan", C, D, h, w)}), flush=True)
            del bwd, want, scale
    return 0


if __name__ == "__main__":
    sys.exit(main())
