"""The reference's training step on a batch held in blocks, one a device:
for a global batch whose step does not fit one card (the fp32 reference
took 23.5 GB at a batch of 8 of the DTU training configuration and 47.0 GB
at 16 on an 80 GB H100; 32 ran out of memory).

It runs ``model.train_cascade`` and ``train.final_loss`` as they are, and
departs from ``train.train_step`` only in where the work lies:

- the batch is cut into equal blocks along axis 0, block k on
  ``devices[k]``, and each block's forward runs in a thread of its own on
  copies of the parameters on its device; the copies are differentiable,
  so the gradient reaches the one set of leaves, on ``devices[0]``;
- every train-mode BatchNorm normalises with the statistics of the whole
  batch, as one call on the whole batch does: the blocks meet at each BN
  call, add their sums on each device in block order (the mean first, then
  the biased variance from the summed squared deviations about it), and
  the gradient flows through the sums. The running-statistics records are
  block 0's, one a BN call, as for the whole batch. (``model._bn`` is
  swapped for this while the blocks run, and put back.)
- the loss is ``train.final_loss`` on the blocks' outputs concatenated on
  ``devices[0]``: the same masked means over the whole batch.

The SGD step and the EMA of the running statistics are ``train.train_step``'s.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from . import model
from .model import EPS_BN, Rounding, train_cascade
from .train import BN_MOMENTUM, final_loss, trainable_keys

__all__ = ["train_step_blocks"]

MEET_TIMEOUT_S = 600.0


class _Meeting:
    """Where the blocks' threads add their sums, in block order."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=MEET_TIMEOUT_S)
        self.slots: list = [None] * n
        self.local = threading.local()

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the blocks of each one's ``t``, on this block's device."""
        self.slots[self.local.block] = t
        self.barrier.wait()
        out = self.slots[0].to(t.device)
        for s in self.slots[1:]:
            out = out + s.to(t.device)
        self.barrier.wait()  # every block has read the slots before they are written again
        return out


def _global_bn(meet: _Meeting, plain):
    def bn(c, x, prefix, groups: int = 1):
        if not c.train:
            return plain(c, x, prefix, groups)
        if groups != 1:
            raise NotImplementedError("train_step_blocks: a BN with statistics per group")
        P = c.P
        shape = (1, -1) + (1,) * (x.ndim - 2)
        dims = (0, *range(2, x.ndim))
        n = x.numel() // x.shape[1] * meet.n
        mean = meet.total(x.sum(dims)) / n
        dev = x - mean.reshape(shape)
        var = meet.total(dev.square().sum(dims)) / n
        if meet.local.block == 0:
            c.bn_calls.append((prefix, mean.detach(), var.detach() * n / max(n - 1, 1)))
        weight, bias = P[prefix + ".weight"].reshape(shape), P[prefix + ".bias"].reshape(shape)
        return c.q(dev / torch.sqrt(var.reshape(shape) + EPS_BN) * weight + bias)

    return bn


def _cut(batch, k: int, n: int, device):
    if isinstance(batch, dict):
        return {key: _cut(v, k, n, device) for key, v in batch.items()}
    per = batch.shape[0] // n
    return batch[k * per : (k + 1) * per].to(device)


def _cat(outs: list, device):
    if isinstance(outs[0], dict):
        return {key: _cat([o[key] for o in outs], device) for key in outs[0]}
    return torch.cat([o.to(device) for o in outs])


def train_step_blocks(P: dict, batch: dict, cfg: dict, q: Rounding, devices: list) -> tuple[dict, float, dict]:
    """``train.train_step`` on ``batch`` (on ``devices[0]``, as ``P``) cut
    into ``len(devices)`` blocks (module note): ``(new P, loss,
    gradients)``."""
    n = len(devices)
    if batch["imgs"].shape[0] % n:
        raise ValueError(f"train_step_blocks: a batch of {batch['imgs'].shape[0]} in {n} blocks")
    keys = trainable_keys(P)
    leaves = {k: P[k].detach().clone().requires_grad_(True) for k in keys}
    params = {**P, **leaves}
    meet = _Meeting(n)
    outs, calls, errors = [None] * n, [None] * n, []

    def block(k):
        meet.local.block = k
        try:
            dev = torch.device(devices[k])
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                Pk = {key: v.to(dev) for key, v in params.items()}
                outs[k], calls[k] = train_cascade(Pk, _cut(batch, k, n, dev), cfg["temperature"], cfg, q)
        except BaseException as e:  # the others would wait at the barrier for ever
            errors.append(e)
            meet.barrier.abort()

    plain = model._bn
    model._bn = _global_bn(meet, plain)
    try:
        threads = [threading.Thread(target=block, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        model._bn = plain
    if errors:
        raise errors[0]
    dev0 = torch.device(devices[0])
    out = _cat(outs, dev0)
    dv = batch["depth_values"].float()
    loss = final_loss(out, batch["depth"], batch["mask"], cfg["dlossw"], dv[:, 1] - dv[:, 0])
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)
    new, gdict = dict(P), {}
    with torch.no_grad():
        for k, g in zip(keys, grads):
            g = torch.zeros_like(P[k]) if g is None else g
            gdict[k] = g
            new[k] = P[k] - cfg["lr"] * (g + cfg["weight_decay"] * P[k])
        for prefix, mean, var in calls[0]:
            rm, rv = prefix + ".running_mean", prefix + ".running_var"
            new[rm] = (1 - BN_MOMENTUM) * new[rm] + BN_MOMENTUM * mean.to(dev0)
            new[rv] = (1 - BN_MOMENTUM) * new[rv] + BN_MOMENTUM * var.to(dev0)
    return new, float(loss.detach()), gdict
