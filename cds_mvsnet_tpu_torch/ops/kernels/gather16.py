"""P2: the row gather with 16-bit value and index types,
``row_gather(src, idx, value_dtype, index_dtype)``, and the int16
arithmetic probe ``int16_arith(src)``.

Replace the JAX package's Mosaic probes ``tools/probe_gather16.py``:
``_gather_kernel`` (``pallas_call`` :81, built for (fp32, int32), (bf16,
int16) and (bf16, int32)) and ``_i16_arith_kernel`` (``pallas_call`` :93).
Kernel source: ``csrc/gather16.cu``.

``row_gather``: ``out[r, l] = f32(V(src)[r, j])`` with ``j = I(idx[r, l])``,
where ``V`` is the value type (fp32 or bf16, rounded to nearest even) and
``I`` the index type (int32, or int16, which wraps as an ``astype`` does);
as ``jnp.take_along_axis`` gathers, a negative ``j`` counts from the row's
end and a ``j`` outside ``[-L, L)`` gives NaN. ``int16_arith``: ``src +
((int16(l) + 3) % 7 == 2)`` over the lane index ``l``, the int16 sums
wrapping and ``%`` floored, as ``jnp``'s. Both are exact: a gather, a
widening of bf16 and an add of 0 or 1 round nothing beyond the one
rounding of ``src`` to ``V``, so the card matches the plain versions bit for
bit.

Bound on the H100: a launch. The probe's (64, 128) arrays are 32 KB each;
the bytes take about 30 ns at 3.35 TB/s. Design: ``row_gather`` runs one
block per row, stages the row converted to ``V`` in shared memory (the
counterpart of the TPU's lane crossbar, which gathers within one vreg row),
then each thread gathers outputs of that row; the types are template
parameters (source, value, index). ``int16_arith`` runs one thread per
element with the index arithmetic in ``short``. The row must fit in 48 KB
of shared memory: ``L ≤ 12288`` in fp32, ``24576`` in bf16.
"""

from __future__ import annotations

import torch

from . import _build
from ._launch import I, L, P, entry, on_card, ptr, require, stream

__all__ = ["row_gather", "row_gather_plain", "int16_arith", "int16_arith_plain"]

VALUE_DTYPES = (torch.float32, torch.bfloat16)
INDEX_DTYPES = (torch.int32, torch.int16)
ROW_BYTES = 48 * 1024


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor, value_dtype=torch.float32,
                     index_dtype=torch.int32) -> torch.Tensor:
    """Plain version: ``torch.gather`` on ``src`` cast to the value type, at
    ``idx`` cast to the index type, with the fill and wrap of the kernel."""
    n = src.shape[1]
    values = src.to(value_dtype)
    j = idx.to(index_dtype).long()
    j = torch.where(j < 0, j + n, j)
    inside = (j >= 0) & (j < n)
    got = torch.gather(values, 1, j.clamp(0, n - 1)).float()
    return torch.where(inside, got, torch.full_like(got, float("nan")))


def row_gather(src: torch.Tensor, idx: torch.Tensor, value_dtype=torch.float32,
               index_dtype=torch.int32) -> torch.Tensor:
    """``src (R, L)`` fp32 or bf16, ``idx (R, L)`` int32 -> ``(R, L)`` fp32,
    gathered along each row in ``value_dtype`` at indices in
    ``index_dtype``."""
    require(src.ndim == 2 and idx.shape == src.shape, f"row_gather: src {tuple(src.shape)}, idx {tuple(idx.shape)}")
    require(src.dtype in VALUE_DTYPES and idx.dtype == torch.int32,
            f"row_gather: src {src.dtype} must be fp32 or bf16, idx {idx.dtype} int32")
    require(value_dtype in VALUE_DTYPES and index_dtype in INDEX_DTYPES,
            f"row_gather: value type {value_dtype} (fp32, bf16), index type {index_dtype} (int32, int16)")
    R, n = src.shape
    require(R * n > 0, "row_gather: empty input")
    row_bytes = n * (2 if value_dtype == torch.bfloat16 else 4)
    require(row_bytes <= ROW_BYTES, f"row_gather: a row of {row_bytes} bytes exceeds {ROW_BYTES} of shared memory")
    require(src.is_contiguous() and idx.is_contiguous(), "row_gather: inputs must be contiguous")
    if not on_card("row_gather", src, idx):
        return row_gather_plain(src, idx, value_dtype, index_dtype)
    out = torch.empty((R, n), dtype=torch.float32, device=src.device)
    lib, fn = entry("gather16", "row_gather_launch", [P, P, P, I, I, I, I, I, P])
    err = fn(ptr(src), ptr(idx), ptr(out), int(src.dtype == torch.bfloat16), int(value_dtype == torch.bfloat16),
             int(index_dtype == torch.int16), R, n, stream(src.device))
    _build.check(lib, err, "row_gather")
    row_gather.launches += 1
    return out


def int16_arith_plain(src: torch.Tensor) -> torch.Tensor:
    """Plain version: the lane index in int16, ``torch.remainder`` (floored)."""
    lane = torch.arange(src.shape[1], dtype=torch.int32, device=src.device).to(torch.int16)
    j = torch.remainder(lane + 3, 7)
    return src + torch.where(j == 2, 1.0, 0.0)


def int16_arith(src: torch.Tensor) -> torch.Tensor:
    """``src (R, L)`` fp32 -> ``src + ((int16(l) + 3) % 7 == 2)``, fp32."""
    require(src.ndim == 2 and src.dtype == torch.float32, f"int16_arith: src {tuple(src.shape)} {src.dtype}")
    require(src.numel() > 0 and src.is_contiguous(), "int16_arith: src must be non-empty and contiguous")
    if not on_card("int16_arith", src):
        return int16_arith_plain(src)
    out = torch.empty_like(src)
    lib, fn = entry("gather16", "int16_arith_launch", [P, P, I, L, P])
    err = fn(ptr(src), ptr(out), src.shape[1], src.numel(), stream(src.device))
    _build.check(lib, err, "int16_arith")
    int16_arith.launches += 1
    return out


row_gather.launches = 0
int16_arith.launches = 0
