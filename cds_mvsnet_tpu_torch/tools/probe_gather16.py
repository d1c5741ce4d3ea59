"""P2's entry point: the row gather in its three type forms and the int16
arithmetic, one result line each.

    python -m cds_mvsnet_tpu_torch.tools.probe_gather16

Counterpart of the JAX package's Mosaic probe ``tools/probe_gather16.py``,
on the same seeded (64, 128) inputs (``default_rng(0)``: fp32 normal
values, int32 indices in [0, 128)):

  ctrl_fp32_i32   fp32 values, int32 indices
  g16_bf16_i16    bf16 values, int16 indices
  bf16_i32        bf16 values, int32 indices
  i16_arith       int16 iota, add, mod and compare, then an fp32 add

each through ``ops/kernels/gather16.py`` (``row_gather``, ``int16_arith``)
and printed as the JAX probe prints it: ``<name> OK   checksum=<sum>``, or
``FAIL`` with the error. ``main(device="cpu")`` runs the plain versions; the
default is the card. The JAX probe's interpret switch has no counterpart.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.cds_mvsnet import resolve_device
from ..ops.kernels import int16_arith, row_gather

R, L = 64, 128  # rows x lanes
FORMS = {
    "ctrl_fp32_i32": (torch.float32, torch.int32),
    "g16_bf16_i16": (torch.bfloat16, torch.int16),
    "bf16_i32": (torch.bfloat16, torch.int32),
}


def inputs() -> tuple[np.ndarray, np.ndarray]:
    """The probe's ``src (R, L)`` fp32 and ``idx (R, L)`` int32."""
    rng = np.random.default_rng(0)
    src = rng.standard_normal((R, L)).astype(np.float32)
    idx = rng.integers(0, L, (R, L)).astype(np.int32)
    return src, idx


def _run(name, fn) -> dict:
    try:
        val = float(fn().cpu().numpy().sum())  # numpy's sum, as the JAX probe's
    except Exception as e:  # noqa: BLE001 - the probe records every failure mode, as the JAX one
        head = (str(e).strip().splitlines() or [type(e).__name__])[0][:160]
        print(f"{name:16s} FAIL {type(e).__name__}: {head}")
        return {"ok": False, "error": head}
    print(f"{name:16s} OK   checksum={val:.3f}")
    return {"ok": True, "checksum": val}


def main(argv=None, device="cuda") -> dict:
    """Run the four probes; returns ``{name: {"ok", "checksum" or "error"}}``."""
    argparse.ArgumentParser(description="P2: row gather with 16-bit types, int16 arithmetic").parse_args(argv)
    dev = resolve_device(device)
    src_np, idx_np = inputs()
    src = torch.as_tensor(src_np, device=dev)
    idx = torch.as_tensor(idx_np, device=dev)
    print(f"device={dev.type}")
    results = {name: _run(name, lambda v=v, i=i: row_gather(src, idx, v, i)) for name, (v, i) in FORMS.items()}
    results["i16_arith"] = _run("i16_arith", lambda: int16_arith(src))
    return results


if __name__ == "__main__":
    main()
