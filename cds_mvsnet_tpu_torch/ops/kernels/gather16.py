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

Bound on the H100: bytes (source, indices and output once each: 96 KB at
the probe's (64, 128), 29 ns at 3.35 TB/s), so at the probe's size the
launch and the wrapper's host path set the time. The wrappers take the light
launch path of ``_launch.py`` (``csrc/launch.cpp`` allocates and
launches). Design: ``row_gather`` stages a row that fits in one block's
shared memory (227 KB: ``L ≤ 58112`` in fp32 values, ``116224`` in bf16):
the row, converted to ``V``, goes to shared memory (the counterpart of the
TPU's lane crossbar, which gathers within one vreg row), then the block's
threads gather outputs of that row from it. A row is split over as many
blocks as give the card about 264 (two an SM), each block gathering at
least 4096 of its outputs and staging the whole row; blocks have 128 to
1024 threads and each thread keeps 4 loads in flight. A row over 48 KB opts
the kernel in to more shared memory once per process and card, not per
launch. A longer row is gathered straight from device memory, 4 outputs a
thread, through the read-only cache, converted to ``V`` at the load. The
types are template parameters (source, value, index). ``int16_arith`` runs
one thread per element with the index arithmetic in ``short``.
"""

from __future__ import annotations

import torch

from ._launch import binding, card_index, current_stream

__all__ = ["row_gather", "row_gather_plain", "int16_arith", "int16_arith_plain"]

VALUE_DTYPES = (torch.float32, torch.bfloat16)
INDEX_DTYPES = (torch.int32, torch.int16)
# (source, value, index type) -> the C entry point's form: bit 0 a bf16
# source, bit 1 bf16 values, bit 2 int16 indices
_FORMS = {(s, v, i): (s == torch.bfloat16) | (v == torch.bfloat16) << 1 | (i == torch.int16) << 2
         for s in VALUE_DTYPES for v in VALUE_DTYPES for i in INDEX_DTYPES}


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
    if not (src.ndim == 2 and idx.shape == src.shape):
        raise ValueError(f"row_gather: src {tuple(src.shape)}, idx {tuple(idx.shape)}")
    form = _FORMS.get((src.dtype, value_dtype, index_dtype))
    if form is None or idx.dtype != torch.int32:
        if not (src.dtype in VALUE_DTYPES and idx.dtype == torch.int32):
            raise ValueError(f"row_gather: src {src.dtype} must be fp32 or bf16, idx {idx.dtype} int32")
        raise ValueError(f"row_gather: value type {value_dtype} (fp32, bf16), index type {index_dtype} (int32, int16)")
    R, n = src.shape
    if not R * n > 0:
        raise ValueError("row_gather: empty input")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather: inputs must be contiguous")
    dev = card_index("row_gather", src, idx)
    if dev < 0:
        return row_gather_plain(src, idx, value_dtype, index_dtype)
    out = binding().row_gather(src, idx, form, current_stream(dev))
    row_gather.launches += 1
    return out


def int16_arith_plain(src: torch.Tensor) -> torch.Tensor:
    """Plain version: the lane index in int16, ``torch.remainder`` (floored)."""
    lane = torch.arange(src.shape[1], dtype=torch.int32, device=src.device).to(torch.int16)
    j = torch.remainder(lane + 3, 7)
    return src + torch.where(j == 2, 1.0, 0.0)


def int16_arith(src: torch.Tensor) -> torch.Tensor:
    """``src (R, L)`` fp32 -> ``src + ((int16(l) + 3) % 7 == 2)``, fp32."""
    if not (src.ndim == 2 and src.dtype == torch.float32):
        raise ValueError(f"int16_arith: src {tuple(src.shape)} {src.dtype}")
    if not (src.numel() > 0 and src.is_contiguous()):
        raise ValueError("int16_arith: src must be non-empty and contiguous")
    dev = card_index("int16_arith", src)
    if dev < 0:
        return int16_arith_plain(src)
    out = binding().int16_arith(src, current_stream(dev))
    int16_arith.launches += 1
    return out


row_gather.launches = 0
int16_arith.launches = 0
