"""Profiling and tracing helpers.

Counterpart of ``cds_mvsnet_tpu/utils/profiling.py``: a device trace with
one context manager (``torch.profiler`` in place of ``jax.profiler``), and a
section timer whose sections end in a barrier of the device. CUDA launches
return before the card finishes, so a section that produced device tensors
waits for them (``torch.cuda.synchronize``) before it reads the clock; on
the CPU the barrier is a no-op.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

__all__ = ["device_trace", "SectionTimer", "sync"]


def _first_cuda_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree if tree.is_cuda else None
    leaves = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (list, tuple)) else ()
    for leaf in leaves:
        found = _first_cuda_tensor(leaf)
        if found is not None:
            return found
    return None


def sync(tree) -> None:
    """Device barrier: ``torch.cuda.synchronize()`` on the device of the
    first CUDA tensor in ``tree`` (a tensor, or dicts, lists and tuples of
    them); nothing where it holds none."""
    t = _first_cuda_tensor(tree)
    if t is not None:
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the host and, where a card is
    present, of CUDA activity into ``logdir`` (a ``*.pt.trace.json`` that
    TensorBoard's profiler plugin and Perfetto read); yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))) as prof:
        yield prof


class SectionTimer:
    """Accumulating wall-clock timer for named pipeline sections."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            sync(result)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": v, "mean_s": v / max(self.counts[k], 1), "n": self.counts[k]}
            for k, v in self.totals.items()
        }
