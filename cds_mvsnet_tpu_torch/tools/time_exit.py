"""Time K3 as built from several kernel source directories, in one process
on one card.

    python -m cds_mvsnet_tpu_torch.tools.time_exit DIR [DIR ...] [--rounds N]

Each ``DIR`` holds a ``regress.cu`` (and the headers it includes), such as
the ``cds_mvsnet_tpu_torch/csrc`` of this checkout and of a parent commit
unpacked beside it. Every ``regress.cu`` is built with the flags of
``ops/kernels/_build.py`` (all ``nvcc`` runs at once). Cases (``CASES``),
on inputs drawn as in ``chip_smoke.py``'s kernels phase: the three stage
shapes of the serve point (1152x864, ndepths 48/32/8), the stream point
(480x640, 128/32/8) and the DTU protocol point (the cascade at 576x768,
48/32/8); stage 1 on shared planes, stages 2 and 3 on per-pixel windows.
Rounds alternate the order of the sources (A B, B A, ...); a time is the
median over rounds of the mean of ``--reps`` launches between CUDA events
(``tools/_timing.py``). One JSON line per case and source, with the largest
depth difference to the plain version, the largest confidence difference
off truncation boundaries and whether both meet ``chip_smoke.py``'s
tolerances (1e-2 mm, 1e-4), and, for a source that reports it
(``exit_softargmin_tile``), the tile the launcher took with its shared
bytes, registers per thread and the blocks an SM holds at once; the card's
``nvidia-smi`` name and power limit come first.
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
from ._timing import I, P, build, card, medians, stream_ptr, typed

# (point, stage, D, h, w): the cascade's stage shapes at each point
CASES = [
    *(("serve", s, D, 864 // 2 ** (3 - s), 1152 // 2 ** (3 - s)) for s, D in zip((1, 2, 3), (48, 32, 8))),
    *(("stream", s, D, 480 // 2 ** (3 - s), 640 // 2 ** (3 - s)) for s, D in zip((1, 2, 3), (128, 32, 8))),
    *(("protocol", s, D, 576 // 2 ** (3 - s), 768 // 2 ** (3 - s)) for s, D in zip((1, 2, 3), (48, 32, 8))),
]


def exit_k3(lib, y, wp, hyp):
    """K3 of one source (``exit_softargmin_launch``, the same ABI in every
    form so far)."""
    fn = typed(lib["regress"], "exit_softargmin_launch", [P, P, P, I, P, P, I, I, I, P])
    _, D, h, w = y.shape
    depth = torch.empty((h, w), dtype=torch.float32, device=y.device)
    conf = torch.empty((h, w), dtype=torch.float32, device=y.device)
    err = fn(P(y.data_ptr()), P(wp.data_ptr()), P(hyp.data_ptr()), int(hyp.ndim == 3), P(depth.data_ptr()),
             P(conf.data_ptr()), D, h, w, stream_ptr())
    if err:
        raise RuntimeError(f"exit_softargmin_launch: CUDA error {err}")
    return depth, conf


def tile_k3(lib, D: int) -> dict | None:
    """The tile K3 of one source takes for D planes and its residency on
    this card; None for a source without ``exit_softargmin_tile``."""
    if not hasattr(lib["regress"], "exit_softargmin_tile"):
        return None
    out = (ctypes.c_int * 6)()
    err = typed(lib["regress"], "exit_softargmin_tile", [I, ctypes.POINTER(ctypes.c_int)])(D, out)
    if err:
        raise RuntimeError(f"exit_softargmin_tile: CUDA error {err}")
    return dict(zip(("cols", "rows", "planes_per_thread", "smem_bytes", "blocks_per_sm", "registers"), out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_exit: needs the card", file=sys.stderr)
        return 2
    strict_fp32()
    print(json.dumps({"card": card(), "dirs": [str(d) for d in args.dirs]}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, lo=-1.0, hi=1.0, dtype=torch.bfloat16):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo).to(dtype).contiguous()

    interval = 480.0 / 191
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(args.dirs, ("regress",), Path(tmp))
        for point, s, D, h, w in CASES:
            y = uniform((8, D, h, w), -2.0, 2.0)
            wp = uniform((1, 8, 3, 3, 3), -0.3, 0.3, torch.float32)
            if s == 1:
                hyp = torch.linspace(425.0, 905.0, D, device=dev)
            else:
                centre = uniform((h, w), 560.0, 640.0, torch.float32)
                steps = torch.arange(D, device=dev, dtype=torch.float32) - (D - 1) // 2
                hyp = (centre[None] + steps[:, None, None] * (2.0, 1.0)[s - 2] * interval).contiguous()
            dp, cp = K.exit_softargmin_plain(y, wp, hyp)
            logits = F.conv3d(y.float()[None], wp, padding=1)[0, 0]
            idx = (torch.softmax(logits, 0) * torch.arange(D, device=dev, dtype=torch.float32)[:, None, None]).sum(0)
            frac = idx - idx.floor()
            safe = (frac > 1e-3) & (frac < 1 - 1e-3)  # no truncation flip possible
            runs, checks = {}, {}
            for i, lib in enumerate(libs):
                dk, ck = exit_k3(lib, y, wp, hyp)
                d_dep, d_conf = float((dk - dp).abs().max()), float((ck - cp).abs()[safe].max())
                checks[i] = {"depth_max_abs_err": d_dep, "conf_max_abs_err_safe": d_conf,
                             "ok": d_dep <= 1e-2 and d_conf <= 1e-4}
                runs[i] = lambda lib=lib: exit_k3(lib, y, wp, hyp)
            med = medians(runs, args.rounds, args.reps)
            for i, d in enumerate(args.dirs):
                print(json.dumps({"kernel": "k3", "point": point, "stage": s, "shape": [8, D, h, w],
                                  "dir": str(d), "ms": med[i], **checks[i], "tile": tile_k3(libs[i], D)}),
                      flush=True)
            del y, hyp, logits, runs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
