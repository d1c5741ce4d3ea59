"""Tracing: the port's spans and a trace of a run.

:func:`span` names a stretch of host work (``cds.forward``, ``cds.stage2``,
``cds.step.backward``, ...). While a ``torch.profiler`` session records, it
is a ``record_function`` range in the profiler's own trace, on the clock of
the card's CUPTI events, so a kernel launched inside it can be given to it;
otherwise it is one shared null context, which costs a flag read and no
launch, copy or synchronisation. :func:`device_trace` records such a session
around a run and writes it for TensorBoard or Perfetto.

Counterpart of ``cds_mvsnet_tpu/utils/profiling.py``'s ``device_trace``
(``torch.profiler`` in place of ``jax.profiler``).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["device_trace", "span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while the profiler records on this
    thread (autograd's threads inherit the session), else the shared null
    context. Every name the port gives starts with ``cds.``."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the host and, where a card is
    present, of CUDA activity into ``logdir`` (a ``*.pt.trace.json`` that
    TensorBoard's profiler plugin and Perfetto read), the port's ``cds.*``
    spans on the same timeline as the card's kernels; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))) as prof:
        yield prof
