"""Time K8, the plane-sweep warp from precomputed coordinates
(``warp_coords.cu``), per view and over 4 source views in one launch, as
built from several kernel source directories, by device time, in one
process on one card.

    python -m cds_mvsnet_tpu_torch.tools.time_warp_coords DIR [DIR ...] [--rounds N] [--reps N]

Each ``DIR`` holds a ``warp_coords.cu`` (and the headers it includes), such
as the ``cds_mvsnet_tpu_torch/csrc`` of this checkout and of a parent commit
unpacked beside it. All are built with the flags of ``ops/kernels/_build.py``
(all ``nvcc`` runs at once). The shapes are those of ``chip_smoke.py``'s
routes (1152x864, V = 5, ndepths 48/32/8: C/D/h x w = 32/48/216x288,
16/32/432x576, 8/8/864x1152), on inputs drawn as there: the plane sweep of
each stage's hypotheses from the reference to each source view of a
``textured_plane_batch``, random bf16 features.

A time is the device time of one call under ``torch.profiler``, the median
over ``--rounds`` rounds of ``--reps`` calls, the sources alternating (A B,
B A, ...); ``bound_ms`` is the least time of the call as ``chip_smoke.py``
counts it. One JSON line per source, entry (``view``: one source view;
``batched``: the 4 in one launch) and stage, after the card's ``nvidia-smi``
name and power limit and each source's registers and spills (ptxas ``-v``)
and resident blocks an SM (from the registers). Each row holds the
launcher's plan where the source has a plan entry, and its checks:
``in_prod`` equal to the first source's and to the plain version's bit for
bit, ``sim`` within the smoke's tolerance of the plain version's, two runs
identical and, batched, every view equal to its per-view call bit for bit.
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
from ..ops.geometry import relative_warp_transform, sweep_coords
from ..utils.synthetic import textured_plane_batch
from ._timing import I, P, alternate_device, blocks_per_sm, build, card, ptxas_registers, stream_ptr, typed

ARGS = [P, P, P, P, P, P, I, I, I, I, I, I, I, P]
H, W, V, D_FULL = 864, 1152, 5, 192
SHAPES = [(32, 48, H // 4, W // 4), (16, 32, H // 2, W // 2), (8, 8, H, W)]
PEAK_BYTES_PER_S, PEAK_FP32_FLOPS = 3.35e12, 67e12  # H100 SXM: HBM3, fp32 outside the tensor cores
PLAN_KEYS = ("pixels", "chunk", "chunks", "blocks", "registers", "blocks_per_sm")


def cases(dev) -> list[tuple]:
    """``(stage, src, ref, px, py)`` of each serve stage, the V - 1 source
    views stacked on a leading axis."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, lo=-1.0, hi=1.0, dtype=torch.bfloat16):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo).to(dtype).contiguous()

    cams = to_tensors(textured_plane_batch(V=V, H=H, W=W, D=D_FULL, seed=0), dev)["proj_matrices"]
    interval = 480.0 / (D_FULL - 1)
    out = []
    for s, (C, D, h, w) in enumerate(SHAPES, start=1):
        if s == 1:
            hyp = torch.linspace(425.0, 905.0, D, device=dev).contiguous()
        else:  # per-pixel windows around a smooth depth map, ratios 2 and 1
            centre = uniform((h, w), 560.0, 640.0, torch.float32)
            steps = torch.arange(D, device=dev, dtype=torch.float32) - (D - 1) // 2
            hyp = (centre[None] + steps[:, None, None] * (2.0, 1.0)[s - 2] * interval).contiguous()
        m = cams[f"stage{s}"]
        pxs, pys = [], []
        for v in range(1, V):
            rot, trans = relative_warp_transform(m[:, 0], m[:, v])
            px, py = sweep_coords(rot, trans, hyp[None], h, w)
            pxs.append(px.reshape(D, h, w))
            pys.append(py.reshape(D, h, w))
        out.append((s, uniform((V - 1, h, w, C)), uniform((V - 1, C, h, w)), torch.stack(pxs).contiguous(),
                    torch.stack(pys).contiguous()))
    return out


def runner(lib, src, ref, px, py):
    """A closure launching ``lib``'s K8 on views ``(Vn, ...)`` of the case,
    its ``in_prod`` and ``sim``."""
    fn = typed(lib, "warp_sim_coords_launch", ARGS)
    Vn, Hs, Ws, C = src.shape
    D, h, w = px.shape[1:]
    in_prod = torch.empty((Vn, C, D, h, w), dtype=torch.bfloat16, device=src.device)
    sim = torch.empty((Vn, D, h, w), dtype=torch.float32, device=src.device)
    args = [P(t.data_ptr()) for t in (src, ref, px, py, in_prod, sim)] + [Vn, C, Hs, Ws, D, h, w, stream_ptr()]

    def run():
        if fn(*args):
            raise RuntimeError("warp_sim_coords_launch failed")

    return run, in_prod, sim


def plan_of(lib, Vn, C, D, h, w) -> dict | None:
    """The launcher's plan (``warp_sim_coords_plan``), None where the source
    has none."""
    if not hasattr(lib, "warp_sim_coords_plan"):
        return None
    out = (ctypes.c_int * len(PLAN_KEYS))()
    if typed(lib, "warp_sim_coords_plan", [I, I, I, I, I, P])(Vn, C, D, h, w, ctypes.cast(out, P)):
        raise RuntimeError("warp_sim_coords_plan failed")
    return dict(zip(PLAN_KEYS, out))


def bound(src, ref, px, in_prod, sim) -> dict:
    """The least time of the call, as chip_smoke.py counts it: each input read
    and each output written once over the memory rate, or the fp32 operations
    over the fp32 rate, the larger."""
    io = (src.numel() + ref.numel()) * 2 + 2 * px.numel() * 4 + in_prod.numel() * 2 + sim.numel() * 4
    C = src.shape[-1]
    t_mem = io / PEAK_BYTES_PER_S * 1e3
    t_ops = px.numel() * (11 * C + 20) / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_mem, t_ops), "bound_by": "bytes" if t_mem >= t_ops else "operations"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_warp_coords: no CUDA device", file=sys.stderr)
        return 2
    strict_fp32()
    print(json.dumps({"card": card(), "sources": [str(d) for d in args.dirs]}), flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(args.dirs, ("warp_coords",), Path(tmp))
        for d, lib in zip(args.dirs, libs):
            regs = ptxas_registers(lib["warp_coords"].ptxas_log, "warp_coords")
            print(json.dumps({"source": str(d), "registers_and_spill_bytes": regs,
                              "blocks_per_sm_by_registers": {
                                  k: {t: blocks_per_sm(v[0], t) for t in (128, 256)} for k, v in regs.items()}}),
                  flush=True)
        for stage, src, ref, px, py in cases(dev):
            Vn, _, _, C = src.shape
            D, h, w = px.shape[1:]
            plain = [K.warp_sim_coords_plain(src[v], ref[v], px[v], py[v]) for v in range(Vn)]
            for entry, sl in (("view", slice(0, 1)), ("batched", slice(0, Vn))):
                args_e = (src[sl], ref[sl], px[sl], py[sl])
                runs = [runner(lib["warp_coords"], *args_e) for lib in libs]
                times = alternate_device({i: r[0] for i, r in enumerate(runs)}, args.rounds, args.reps)
                views = [runner(lib["warp_coords"], src[v : v + 1], ref[v : v + 1], px[v : v + 1], py[v : v + 1])
                         for lib in libs for v in range(Vn)] if entry == "batched" else []
                for i, (run, ip, sim) in enumerate(runs):
                    run()
                    first_ip, first_sim = ip.clone(), sim.clone()
                    run()
                    ip_p = torch.stack([plain[v][0] for v in range(sl.stop)])
                    sim_p = torch.stack([plain[v][1] for v in range(sl.stop)])
                    d_sim = (sim - sim_p).abs()
                    row = {"source": str(args.dirs[i]), "entry": entry, "stage": stage,
                           "shape": [sl.stop, C, D, h, w],
                           "ms": statistics.median(t for t, _ in times[i]), "ms_rounds": [t for t, _ in times[i]],
                           **bound(*args_e[:3], ip, sim),
                           "in_prod_equals_first": torch.equal(ip, runs[0][1]), "in_prod_equals_plain":
                           torch.equal(ip, ip_p), "sim_max_abs_diff": float(d_sim.max()),
                           "sim_ok": bool((d_sim <= 1e-5 * ip_p.float().abs().sum(1) + 1e-30).all()),
                           "same_in_two_runs": torch.equal(first_ip, ip) and torch.equal(first_sim, sim),
                           "plan": plan_of(libs[i]["warp_coords"], sl.stop, C, D, h, w)}
                    if entry == "batched":
                        per_view = views[i * Vn : (i + 1) * Vn]
                        for r, _, _ in per_view:
                            r()
                        row["equals_per_view"] = all(torch.equal(ip[v], pv[1][0]) and torch.equal(sim[v], pv[2][0])
                                                     for v, pv in enumerate(per_view))
                    print(json.dumps(row), flush=True)
                    del ip_p, sim_p, d_sim, first_ip, first_sim
                del runs, views
                torch.cuda.empty_cache()
            del plain
    return 0


if __name__ == "__main__":
    sys.exit(main())
