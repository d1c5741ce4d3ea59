"""The port's loader with the train options against the JAX package's
loader: the batches of two shuffled epochs from one seed, ``len`` and the
ragged last batch with and without ``drop_last``, and the ranks' slices of
every global batch."""

from __future__ import annotations

import numpy as np
import pytest

from cds_mvsnet_tpu.data.loader import DataLoader as JaxLoader
from cds_mvsnet_tpu_torch.data.loader import DataLoader


class Indices:
    """Sample i is ``{"i": [i]}``."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array([i])}


def epochs(loader, n=2, host=True):
    return [[(b["host"] if host else b)["i"].ravel().tolist() for b in loader] for _ in range(n)]


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("n,bs", [(11, 3), (12, 4), (5, 1)])
def test_shuffled_epochs_equal_jax(n, bs, drop_last):
    kw = dict(batch_size=bs, shuffle=True, drop_last=drop_last, seed=7)
    want_loader = JaxLoader(Indices(n), num_workers=2, device_put_fn=lambda b: b, **kw)
    got_loader = DataLoader(Indices(n), num_workers=3, device="cpu", **kw)
    want = epochs(want_loader, host=False)
    got = epochs(got_loader)
    assert got == want
    assert got[0] != got[1]  # the second epoch is the generator's next shuffle
    if not drop_last:
        assert sorted(sum(got[0], [])) == sorted(sum(got[1], [])) == list(range(n))
    assert len(got_loader) == len(want_loader) == len(got[0])
    assert len(got[0]) == (n // bs if drop_last else -(-n // bs))


def test_unshuffled_is_the_eval_order():
    assert epochs(DataLoader(Indices(7), batch_size=3, device="cpu"), 1) == [[[0, 1, 2], [3, 4, 5], [6]]]


@pytest.mark.parametrize("world", [2, 4])
def test_rank_slices_cover_the_global_batches(world):
    """Ranks with the same seed, each its slice of every batch of 8
    (``process_local_batch_slice``'s arithmetic), cover the one-process
    epochs in order."""
    whole = epochs(DataLoader(Indices(21), batch_size=8, device="cpu", shuffle=True, drop_last=True, seed=3))
    per = 8 // world
    ranks = [epochs(DataLoader(Indices(21), batch_size=8, device="cpu", shuffle=True, drop_last=True, seed=3,
                               shard=(r * per, per))) for r in range(world)]
    for e in range(2):
        assert [sum((ranks[r][e][b] for r in range(world)), []) for b in range(2)] == whole[e]


def test_a_sharded_loader_needs_drop_last():
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(Indices(4), batch_size=2, device="cpu", shard=(0, 1))
