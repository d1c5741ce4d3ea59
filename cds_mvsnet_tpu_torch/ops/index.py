"""``torch.index_select`` with a backward that repeats.

On the card autograd differentiates an index select with ``index_add_`` (and
a gather with ``scatter_add_``), which adds with atomics: two runs of a
train step then differ in the last bits of the gradients. PyTorch lists both
among the operations that are nondeterministic unless
``torch.use_deterministic_algorithms(True)``, a global switch that also
refuses the operations that have no deterministic form. The JAX package
differentiates its gathers on XLA, which repeats from run to run.

:func:`index_select` runs the same copy forward (the same bits). Its
backward on the card is ``index_put_(..., accumulate=True)``, which PyTorch
computes by sorting the indices and summing each index's values in their
order, with or without the switch (``tests/test_torch_cuda.py`` checks that
it repeats). On the CPU the backward is autograd's own (``index_add_``),
which adds in order there. The port's differentiable gathers go through it:
the plain sampler's corner rows (``ops/grid_sample.py``) and the linear
resizes (``ops/resize.py``).
"""

from __future__ import annotations

import torch

__all__ = ["index_select"]


class _IndexSelect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, dim, index):
        ctx.save_for_backward(index)
        ctx.dim, ctx.shape = dim, src.shape
        return torch.index_select(src, dim, index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        if grad.is_cuda:
            moved = grad.movedim(ctx.dim, 0)
            out = moved.new_zeros((ctx.shape[ctx.dim], *moved.shape[1:])).index_put_((index,), moved, accumulate=True)
            return out.movedim(0, ctx.dim), None, None
        return grad.new_zeros(ctx.shape).index_add_(ctx.dim, index, grad), None, None


def index_select(src: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """``torch.index_select(src, dim, index)``; its gradient in ``src``
    repeats on the card."""
    if not src.requires_grad:
        return torch.index_select(src, dim, index)
    return _IndexSelect.apply(src, dim % src.ndim, index)
