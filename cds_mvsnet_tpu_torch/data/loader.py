"""Batching data loader with host worker threads and device prefetch.

Counterpart of ``cds_mvsnet_tpu/data/loader.py::DataLoader``: the same
batches in the same order (with ``shuffle``, an epoch's order is the next
``shuffle`` of one ``np.random.default_rng(seed)``), the same ragged final
batch or none with ``drop_last``, and a worker's exception raised in the
consumer. ``shard=(start, size)`` yields only those samples of every batch
(a rank's slice of the global batch, ``parallel.process_local_batch_slice``),
so that ranks with the same seed together cover the one-process batches.

A dataset with ``draw(idx)`` and ``load(idx, drawn)`` (the training
readers: ``drawn`` is the sample's source-view permutation) has every
sample of an epoch drawn on the iterating thread, in the order of the
epoch's batches and for the other ranks' samples too, before any decode:
the draws do not depend on the number of workers or on which runs first,
and equal those of the JAX loader at one worker. A thread pool decodes the
samples, submitted in order and ahead of the batch
that needs them (across batch boundaries, so that at batch size 1 the
workers decode the next samples in parallel, where the JAX loader maps the
pool over one batch at a time), and the batch is collated as numpy. On the card a
prefetch thread copies each array into pinned host memory and from there to
the device with ``non_blocking=True`` on a side CUDA stream, and records an
event after the copies; the consumer's stream waits on that event before it
reads the batch, and each device tensor is marked as used by the consumer's
stream (``record_stream``), so the caching allocator does not hand its
memory out again while the consumer's work is still queued. On the CPU the
arrays become tensors that share their memory.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

__all__ = ["DataLoader"]

PREFETCH = 2  # batches decoded and placed ahead of the consumer


def _collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts: arrays along a new axis 0, nested dicts
    key by key, anything else into a list."""

    def stack(vals):
        if isinstance(vals[0], dict):
            return {k: stack([v[k] for v in vals]) for k in vals[0]}
        if isinstance(vals[0], np.ndarray):
            return np.stack(vals)
        return list(vals)

    return stack(samples)


def _map_arrays(fn, batch: dict) -> dict:
    return {k: _map_arrays(fn, v) if isinstance(v, dict) else fn(v) for k, v in batch.items()}


def _leaves(batch: dict) -> list:
    out = []
    for v in batch.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


class DataLoader:
    """Iterates dict batches of tensors on ``device``; lists (the file names)
    pass through, and ``batch["host"]`` holds the collated numpy arrays, for
    a consumer that writes them out without a device-to-host copy."""

    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 4, *, device, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 123, shard: tuple[int, int] | None = None):
        if shard is not None and not drop_last:
            raise ValueError("a sharded loader drops the ragged last batch: pass drop_last=True")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.shard = shard

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _plan(self) -> list[list[tuple]]:
        """One epoch's batches, each a list of ``(index, drawn)`` (``drawn``
        None for a dataset without ``draw``), cut to ``shard``."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        draw = getattr(self.dataset, "draw", None)
        plan = []
        for i in range(0, len(idx), self.batch_size):
            b = [int(j) for j in idx[i : i + self.batch_size]]
            if len(b) < self.batch_size and self.drop_last:
                continue
            items = [(j, draw(j) if draw else None) for j in b]
            if self.shard is not None:
                start, size = self.shard
                items = items[start : start + size]
            plan.append(items)
        return plan

    def _sample(self, item: tuple) -> dict:
        j, drawn = item
        return self.dataset[j] if drawn is None else self.dataset.load(j, drawn)

    def _place(self, arrays: dict, side):
        """The arrays on the device, and the event after their copies (None
        on the CPU)."""
        if self.device.type != "cuda":
            return _map_arrays(lambda a: torch.from_numpy(np.ascontiguousarray(a)), arrays), None
        with torch.cuda.stream(side):
            placed = _map_arrays(
                lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(self.device, non_blocking=True),
                arrays,
            )
            ready = torch.cuda.Event()
            ready.record(side)
        return placed, ready

    def __iter__(self) -> Iterator[dict]:
        plan = self._plan()
        items = [item for batch in plan for item in batch]
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    # samples are submitted in order, ahead of the batch that
                    # needs them and across batch boundaries, so every worker
                    # decodes even at batch size 1
                    ahead = max(self.num_workers, PREFETCH * self.batch_size)
                    pending: deque = deque()
                    nxt = stop_at = 0
                    for size in map(len, plan):
                        if stop.is_set():
                            return
                        stop_at += size
                        while nxt < len(items) and (nxt < stop_at or len(pending) < ahead):
                            pending.append(pool.submit(self._sample, items[nxt]))
                            nxt += 1
                        batch = _collate([pending.popleft().result() for _ in range(size)])
                        arrays = {k: v for k, v in batch.items() if not isinstance(v, list)}
                        placed, ready = self._place(arrays, side)
                        placed.update({k: v for k, v in batch.items() if isinstance(v, list)})
                        placed["host"] = arrays
                        q.put((placed, ready))
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                placed, ready = item
                if ready is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(ready)
                    for leaf in _leaves(placed):
                        if isinstance(leaf, torch.Tensor):
                            leaf.record_stream(consumer)
                yield placed
        finally:
            stop.set()
