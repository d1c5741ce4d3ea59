"""The port's DTU and BlendedMVS readers against the JAX package's, array
for array, on a tiny layout of each written to disk (one scan, 3 views; the
DTU layout's pair file lists 2 ref views, 7 lights each): every sample in
``mode="val"``; in ``mode="train"`` every sample in index order, and every
batch of a shuffled epoch through the port's loader at 1 and 4 workers
against the JAX loader at one worker (whose draws then follow the batch
order, as the port's do at any number of workers)."""

from __future__ import annotations

import numpy as np
import pytest

from cds_mvsnet_tpu.data.blended import BlendedMVSDataset as JaxBlended
from cds_mvsnet_tpu.data.dtu import DTUDataset as JaxDTU
from cds_mvsnet_tpu.data.loader import DataLoader as JaxLoader
from cds_mvsnet_tpu_torch.data.blended import BlendedMVSDataset
from cds_mvsnet_tpu_torch.data.dtu import DTUDataset
from cds_mvsnet_tpu_torch.data.loader import DataLoader
from cds_mvsnet_tpu_torch.utils.synthetic import write_blended_scan, write_dtu_train_scan

READERS = {"dtu": (JaxDTU, DTUDataset), "blended": (JaxBlended, BlendedMVSDataset)}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    write_dtu_train_scan(root / "dtu", views=3, refs=(0, 1))
    write_blended_scan(root / "blended", views=3)
    for name in READERS:
        (root / name / "list.txt").write_text("scan1\n")
    return root


def readers(root, name: str, mode: str):
    jax_cls, port_cls = READERS[name]
    args = (str(root / name), str(root / name / "list.txt"))
    return jax_cls(*args, mode=mode, nviews=3), port_cls(*args, mode=mode, nviews=3)


def assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert np.array_equal(got, want), where
    else:
        assert got == want, where


@pytest.mark.parametrize("name", sorted(READERS))
def test_layout_shapes(layouts, name):
    want = {"dtu": (14, (3, 512, 640, 3)), "blended": (3, (3, 576, 768, 3))}[name]
    _, ds = readers(layouts, name, "val")
    sample = ds[0]
    assert (len(ds), sample["imgs"].shape) == want
    assert sample["depth"]["stage4"].shape == sample["imgs"].shape[1:3]
    assert sample["depth_values"].shape == (192,)
    # the masks are not all ones: the GT is invalid in a band at the left
    assert 0.5 < sample["mask"]["stage4"].mean() < 1.0


@pytest.mark.parametrize("mode", ["val", "train"])
@pytest.mark.parametrize("name", sorted(READERS))
def test_samples_equal_jax(layouts, name, mode):
    """Every sample, in index order; in train mode both readers' generators
    start from the same seed and draw in that order."""
    jax_ds, ds = readers(layouts, name, mode)
    assert len(ds) == len(jax_ds)
    for i in range(len(ds)):
        assert_same(ds[i], jax_ds[i], f"{name}[{i}]")


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("name", sorted(READERS))
def test_train_loader_draws_in_batch_order(layouts, name, workers):
    """A shuffled epoch of batches of 2 (ragged last batch dropped): the
    port's loader at 1 and 4 workers gives the JAX loader's batches at one
    worker, draws included."""
    jax_ds, ds = readers(layouts, name, "train")
    want = list(JaxLoader(jax_ds, batch_size=2, shuffle=True, drop_last=True, num_workers=1, seed=5,
                          device_put_fn=lambda b: b))
    got = list(DataLoader(ds, batch_size=2, num_workers=workers, device="cpu", shuffle=True, drop_last=True,
                          seed=5))
    assert len(got) == len(want) == len(ds) // 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same({k: v for k, v in g.items() if isinstance(v, list)}, {k: v for k, v in w.items()
                                                                         if isinstance(v, list)}, f"{i}")
        assert_same(g["host"], {k: v for k, v in w.items() if not isinstance(v, list)}, f"batch {i}")
