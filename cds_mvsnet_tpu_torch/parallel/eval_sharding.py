"""Eval sharded over the reference views of a batch.

Counterpart of ``cds_mvsnet_tpu/parallel/eval_sharding.py``. Depth
inference is independent per reference view, so each rank runs the eval
forward on its slice of the view batch (padded to a multiple of the world
size by repeating the last view), with the weights every rank holds; the
forward itself runs no collective. The ranks' depth and confidence maps are
assembled with one ``all_gather``, as JAX assembles its global array, and
the padding is cut off: every rank returns every view's maps.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["make_sharded_eval", "pad_to_multiple"]


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _leaves(tree) -> list:
    return [x for v in tree.values() for x in _leaves(v)] if isinstance(tree, dict) else [tree]


def pad_to_multiple(batch: dict, mult: int) -> tuple[dict, int]:
    """Every leaf of a nested dict of tensors padded along axis 0 to a
    multiple of ``mult`` by repeating its last element: ``(padded, the
    original size)``."""
    sizes = {leaf.shape[0] for leaf in _leaves(batch)}
    assert len(sizes) == 1, f"inconsistent leading dims: {sizes}"
    n = sizes.pop()
    pad = (-n) % mult
    if pad == 0:
        return batch, n
    return _map(lambda t: torch.cat([t, t[-1:].expand(pad, *t.shape[1:])]), batch), n


def make_sharded_eval(model, group=None, temperature: float = 0.01, compute_dtype=torch.float32):
    """``run(imgs, proj_matrices, depth_values) -> (depth, confidence)``:
    ``model``'s eval forward of a batch of B reference views (``imgs
    (B, V, H, W, 3)``, ``proj_matrices[stage] (B, V, 2, 4, 4)``,
    ``depth_values (B, D)`` on this rank's device) sharded over the ranks of
    ``group``; ``depth`` is the refined (or stage-3) depth ``(B, h, w)``,
    ``confidence`` stage 3's photometric confidence, both fp32."""

    def forward(imgs, proj, dv):
        out = model(imgs, proj, dv, temperature=temperature, compute_dtype=compute_dtype)
        return out["refined_depth"].float(), out["stage3"]["photometric_confidence"].float()

    def run(imgs, proj_matrices, depth_values):
        if group is None:
            return forward(imgs, proj_matrices, depth_values)
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        batch, n = pad_to_multiple({"imgs": imgs, "proj": proj_matrices, "dv": depth_values}, world)
        per = batch["imgs"].shape[0] // world
        local = _map(lambda t: t[rank * per : (rank + 1) * per].contiguous(), batch)
        depth, conf = forward(local["imgs"], local["proj"], local["dv"])
        flat = torch.cat([depth.reshape(per, -1), conf.reshape(per, -1)], 1)
        parts = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(parts, flat, group=group)
        full = torch.cat(parts)[:n]
        split = depth[0].numel()
        return full[:, :split].reshape(n, *depth.shape[1:]), full[:, split:].reshape(n, *conf.shape[1:])

    return run
