"""Joining the process group, and a process's slice of a global batch.

Counterpart of ``cds_mvsnet_tpu/parallel/distributed.py``. Nothing tells a
program of a cluster here: the caller gives the backend (``nccl`` on the
cards, ``gloo`` on the CPU), the rendezvous (``tcp://localhost:<port>`` or
``file://<path>``), the world size and its rank.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "process_local_batch_slice", "spawn"]

JOIN_POLL_S = 30.0  # how often the parent looks at its ranks


def initialize_distributed(backend: str, init_method: str, world_size: int, rank: int):
    """Join the group and return it; None, and no group, at world size 1."""
    if world_size <= 1:
        return None
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return dist.group.WORLD


def process_local_batch_slice(global_batch: int, group=None) -> tuple[int, int]:
    """``(start, size)`` of this process's slice of a global batch: ``size =
    global_batch // world``, rank r from ``r · size``. The whole batch
    without a group."""
    if group is None and not dist.is_initialized():
        return 0, global_batch
    n, i = dist.get_world_size(group), dist.get_rank(group)
    per = global_batch // n
    return i * per, per


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn, world: int, args: tuple, device: str, timeout: float | None = None) -> None:
    """``fn(rank, world, *args, device, init_method)`` in ``world`` fresh
    processes, one a device, meeting at ``tcp://127.0.0.1:<a free port>``.
    Raises when fewer cards than ranks are visible (``device`` on the
    cards), when a rank fails (the others are then stopped; a rank stuck in
    a collective fails at the process group's timeout), and after
    ``timeout`` seconds (the ranks are then stopped)."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} CUDA devices; {torch.cuda.device_count()} are visible")
    ctx = torch.multiprocessing.start_processes(fn, args=(world, *args, device, f"tcp://127.0.0.1:{free_port()}"),
                                                nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=JOIN_POLL_S if deadline is None else max(0.0, min(JOIN_POLL_S,
                                                                                deadline - time.monotonic()))):
        if deadline is not None and time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks still running after {timeout} s")
