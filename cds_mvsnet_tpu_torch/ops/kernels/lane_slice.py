"""P1: the sum of dynamic 128-aligned lane slices of one band,
``lane_slice_sum(x, offs)``.

Replaces the JAX package's Mosaic probe ``tools/probe_lane_slice.py::_kernel``
(``pallas_call`` :44): one asynchronous copy of the whole band into on-chip
memory (``pltpu.make_async_copy(...).start()/.wait()`` on a DMA semaphore,
:25-27), then the sum of ``nseg`` 128-wide column slices at offsets read
from the data (SMEM there), each floored to a multiple of 128. Kernel
source: ``csrc/lane_slice.cu``.

``out[r, l] = Σ_i x[r, s_i + l]`` with ``s_i = clamp(128·⌊offs_i/128⌋, 0,
128·(nseg−1))``, summed in slice order in fp32. The JAX kernel leaves
offsets outside ``[0, 128·nseg)`` undefined (its interpret run gives neither
the clamped sum nor zero); the port clamps, in the kernel and in the plain
version alike. The offsets stay on the device: the wrapper never reads them.

Bound on the H100: a launch. At the probe's (8, 512) the band is 16 KB, and
even the largest band one block holds (8 rows, nseg = 56, 224 KB) moves in
under 0.1 µs at 3.35 TB/s, so the launch and one block's latency set the
time. Design, the TPU kernel's own: one block of ``R·128`` threads; one
thread starts a single bulk copy (``cp.async.bulk``, TMA's 1-D form) of the
contiguous band into dynamic shared memory, completing on an ``mbarrier``
with ``expect_tx``, the counterpart of the DMA and its semaphore; the block
clamps the starts while the copy is in flight, waits on the barrier, and
each thread sums its lane. The band must fit in one block's shared memory:
``R·128·nseg·4`` bytes plus the starts within 227 KB, so ``nseg ≤ 56`` at
``R = 8``; the wrapper raises beyond that.
"""

from __future__ import annotations

import torch

from . import _build
from ._launch import I, P, entry, on_card, ptr, require, stream

__all__ = ["lane_slice_sum", "lane_slice_sum_plain"]

LANES = 128
MAX_ROWS = 1024 // LANES  # one block of R·128 threads
MAX_SMEM_BYTES = 232448  # what one block may opt in to on the H100


def lane_slice_sum_plain(x: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Plain version: the clamped slices gathered on ``x``'s device, summed
    one after another in fp32."""
    nseg = offs.shape[0]
    starts = (torch.div(offs.long(), LANES, rounding_mode="floor") * LANES).clamp(0, LANES * (nseg - 1))
    cols = starts[:, None] + torch.arange(LANES, device=x.device)  # (nseg, 128)
    segs = x[:, cols]  # (R, nseg, 128)
    acc = torch.zeros((x.shape[0], LANES), dtype=torch.float32, device=x.device)
    for i in range(nseg):
        acc = acc + segs[:, i]
    return acc


def lane_slice_sum(x: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``x (R, 128·nseg)`` fp32, ``offs (nseg,)`` int32 -> ``(R, 128)`` fp32,
    ``R ≤ 8``."""
    require(offs.ndim == 1 and offs.dtype == torch.int32, f"lane_slice_sum: offs {tuple(offs.shape)} {offs.dtype}")
    nseg = offs.shape[0]
    require(x.ndim == 2 and x.dtype == torch.float32, f"lane_slice_sum: x {tuple(x.shape)} {x.dtype}")
    require(nseg >= 1 and x.shape[1] == LANES * nseg, f"lane_slice_sum: x {tuple(x.shape)} for {nseg} offsets")
    require(1 <= x.shape[0] <= MAX_ROWS, f"lane_slice_sum: {x.shape[0]} rows, one block holds 1 to {MAX_ROWS}")
    band = x.numel() * 4 + nseg * 4
    require(band + 16 <= MAX_SMEM_BYTES,
            f"lane_slice_sum: a band of {band} bytes does not fit in one block's shared memory")
    require(x.is_contiguous() and offs.is_contiguous(), "lane_slice_sum: inputs must be contiguous")
    if not on_card("lane_slice_sum", x, offs):
        return lane_slice_sum_plain(x, offs)
    require(x.data_ptr() % 16 == 0, "lane_slice_sum: x must be 16-byte aligned for the bulk copy")
    out = torch.empty((x.shape[0], LANES), dtype=torch.float32, device=x.device)
    lib, fn = entry("lane_slice", "lane_slice_launch", [P, P, P, I, I, P])
    err = fn(ptr(x), ptr(offs), ptr(out), x.shape[0], nseg, stream(x.device))
    _build.check(lib, err, "lane_slice_sum")
    lane_slice_sum.launches += 1
    return out


lane_slice_sum.launches = 0
