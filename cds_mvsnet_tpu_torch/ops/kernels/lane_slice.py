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
offsets outside ``[0, 128·nseg)`` undefined (its interpret run clamps those
past the band, as the port does, and gives for some below 0 neither the
clamped sum nor zero); the port clamps, in the kernel and in the plain
version alike. The offsets stay on the device: the wrapper never reads them.
The wrapper takes the light launch path of ``_launch.py`` (``csrc/launch.cpp``
allocates and launches).

Bound on the H100: the bytes of the slices the starts name (each a
512-byte row segment per row; the band when the starts cover it), and the
fp32 adds of each output lane, which must run in slice order: ``nseg``
dependent adds. At the probe's (8, 512) the band is 16 KB and the launch sets
the time; a 2 MB band (8 x 128·512) moves in 0.6 µs at 3.35 TB/s. Design:
the TPU kernel's single DMA into VMEM, carried over as one block's bulk copy,
ran at one SM's copy rate and capped the band at one block's shared memory.
Here the grid splits the outputs by (lane group of 8, row): 16·R blocks
(128 at 8 rows). In a block, four loader warps bring its 8 lanes of the
named slices (one 32-byte sector a slice), 128 slices a stage, into a ring
of 8 stages of shared memory (32 KB) with ``cp.async``, 7 stages ahead (896
slices: a 2 MB band's share is in flight at once): two 16-byte copies a
slice where the band is 16-byte aligned, else eight 4-byte ones; each
loader reads its slices' starts before it copies. 8 lanes of a fifth warp
sum their lane stage by stage in slice order, 16 reads ahead of their adds,
so each output is the plain version's fp32 sum bit for bit. The slices a
block reads do not depend on the band's width, so the band has no cap, and
no alignment beyond fp32's is needed.
"""

from __future__ import annotations

import torch

from ._launch import binding, card_index, current_stream

__all__ = ["lane_slice_sum", "lane_slice_sum_plain"]

LANES = 128
MAX_ROWS = 8  # the JAX kernel's (8, 128) accumulator


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
    if not (offs.ndim == 1 and offs.dtype == torch.int32):
        raise ValueError(f"lane_slice_sum: offs {tuple(offs.shape)} {offs.dtype}")
    nseg = offs.shape[0]
    if not (x.ndim == 2 and x.dtype == torch.float32):
        raise ValueError(f"lane_slice_sum: x {tuple(x.shape)} {x.dtype}")
    R, width = x.shape
    if not (nseg >= 1 and width == LANES * nseg):
        raise ValueError(f"lane_slice_sum: x {tuple(x.shape)} for {nseg} offsets")
    if not 1 <= R <= MAX_ROWS:
        raise ValueError(f"lane_slice_sum: {R} rows, the kernel takes 1 to {MAX_ROWS}")
    if not (x.is_contiguous() and offs.is_contiguous()):
        raise ValueError("lane_slice_sum: inputs must be contiguous")
    dev = card_index("lane_slice_sum", x, offs)
    if dev < 0:
        return lane_slice_sum_plain(x, offs)
    out = binding().lane_slice_sum(x, offs, current_stream(dev))
    lane_slice_sum.launches += 1
    return out


lane_slice_sum.launches = 0
