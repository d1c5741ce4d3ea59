"""The ranks of data-parallel training and what they share.

Counterparts of ``cds_mvsnet_tpu/parallel/mesh.py``. JAX runs one process
over a mesh of devices; here each rank is a process with one device, so the
mesh is the process group: ``data_mesh`` is this rank's device,
``batch_sharding`` is ``process_local_batch_slice``, ``replicate`` broadcasts
the weights and statistics from rank 0, and ``shard_batch`` cuts a rank's
slice of every array of a batch along axis 0. Under JAX the batch
statistics of a sharded jit are global; here ``models/layers.py`` and
``training/loss.py`` make them so.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .distributed import process_local_batch_slice

__all__ = ["batch_sharding", "data_mesh", "replicate", "shard_batch"]

batch_sharding = process_local_batch_slice


def data_mesh(group=None, device_type: str = "cuda") -> torch.device:
    """This rank's device: card ``rank`` of ``group`` on the cards (one
    process a card), the CPU otherwise."""
    return torch.device("cuda", dist.get_rank(group)) if device_type == "cuda" else torch.device("cpu")


@torch.no_grad()
def replicate(module: torch.nn.Module, group) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from global rank 0,
    in place."""
    for t in (*module.parameters(), *module.buffers()):
        dist.broadcast(t, src=0, group=group)
    return module


def shard_batch(batch, group=None):
    """This rank's slice along axis 0 of every array or tensor of a nested
    dict (lists too)."""
    start, size = process_local_batch_slice(_leading(batch), group)

    def cut(v):
        if isinstance(v, dict):
            return {k: cut(x) for k, x in v.items()}
        return v[start : start + size]

    return cut(batch)


def _leading(batch) -> int:
    for v in batch.values():
        return _leading(v) if isinstance(v, dict) else len(v)
    raise ValueError("an empty batch")
