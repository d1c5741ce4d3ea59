"""P1's entry point: the sum of dynamic 128-aligned lane slices of one band.

    python -m cds_mvsnet_tpu_torch.tools.probe_lane_slice

Counterpart of the JAX package's Mosaic probe ``tools/probe_lane_slice.py``:
the same input (``x = arange(8·128·4)`` as ``(8, 512)`` fp32, offsets
``128·i``), one ``lane_slice_sum`` (``ops/kernels/lane_slice.py``, a bulk
copy of the band into shared memory, then the slices at the offsets read on
the card), checked against the numpy sum of the slices, and the probe's
line ``dynamic 128-aligned lane slice: OK``. ``main(device="cpu")`` runs the
plain version; the default is the card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.cds_mvsnet import resolve_device
from ..ops.kernels import lane_slice_sum

ROWS, NSEG = 8, 4


def main(argv=None, device="cuda") -> dict:
    """Run the probe; returns ``{"ok", "max_abs_err", "nseg"}``."""
    argparse.ArgumentParser(description="P1: sum of dynamic 128-aligned lane slices").parse_args(argv)
    dev = resolve_device(device)
    x = np.arange(ROWS * 128 * NSEG, dtype=np.float32).reshape(ROWS, 128 * NSEG)
    offs = np.arange(NSEG, dtype=np.int32) * 128
    out = lane_slice_sum(torch.as_tensor(x, device=dev), torch.as_tensor(offs, device=dev))
    got = out.cpu().numpy()
    want = sum(x[:, i * 128:(i + 1) * 128] for i in range(NSEG))
    ok = bool(np.allclose(got, want))
    print("dynamic 128-aligned lane slice:", "OK" if ok else f"WRONG {got[0, :3]} vs {want[0, :3]}")
    return {"ok": ok, "max_abs_err": float(np.abs(got - want).max()), "nseg": NSEG}


if __name__ == "__main__":
    main()
