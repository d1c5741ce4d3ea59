"""The port's eval data path against the JAX package's: image decode and
resize, ``EvalDataset`` samples (equal exactly) and the loader's batches."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from cds_mvsnet_tpu.data import image as jimage
from cds_mvsnet_tpu.data.eval_set import EvalDataset as JaxEvalDataset
from cds_mvsnet_tpu.data.loader import DataLoader as JaxDataLoader
from cds_mvsnet_tpu_torch.data import image as timage
from cds_mvsnet_tpu_torch.data.eval_set import EvalDataset
from cds_mvsnet_tpu_torch.data.loader import DataLoader

CAM = ("extrinsic\n{c} 0 {s} {tx} \n0 1 0 0 \n{ms} 0 {c} {tz} \n0 0 0 1 \n"
       "\nintrinsic\n300.0 0 160 \n0 300.0 120 \n0 0 1 \n\n{depth}\n")


def write_scan(root, name, n, depth_line, pairs, post=(), size=(60, 80), seed=0):
    rng = np.random.default_rng(seed)
    scan = root / name
    for sub in ("images", "images_post", "cams"):
        (scan / sub).mkdir(parents=True, exist_ok=True)
    for v in range(n):
        img = rng.uniform(0, 255, (*size, 3)).astype(np.uint8)
        Image.fromarray(img).save(scan / "images" / f"{v:0>8}.jpg")
        if v in post:  # images_post/ comes before images/
            Image.fromarray(255 - img).save(scan / "images_post" / f"{v:0>8}.jpg")
        a = 0.05 * (v - 1.5)
        (scan / "cams" / f"{v:0>8}_cam.txt").write_text(CAM.format(
            c=np.cos(a), s=np.sin(a), ms=-np.sin(a), tx=0.1 * v, tz=0.02 * v, depth=depth_line))
    lines = [str(len(pairs))]
    for ref, srcs in pairs:
        lines += [str(ref), f"{len(srcs)} " + " ".join(f"{s} 1.0" for s in srcs)]
    (scan / "pair.txt").write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    root = tmp_path_factory.mktemp("scans")
    full = [(v, [u for u in range(4) if u != v]) for v in range(4)]
    write_scan(root, "scan1", 4, "10.0 0.1", full, post=(2,))
    # a 3-token depth line re-derives the interval; view 2 has no source
    # (skipped) and view 3 one (padded with it)
    write_scan(root, "scan2", 4, "10.0 0.1 64", [(0, [1, 2, 3]), (1, [0, 2]), (2, []), (3, [1])], seed=1)
    write_scan(root, "scan3", 3, "10.0 0.1 64 16.4", [(v, [u for u in range(3) if u != v]) for v in range(3)],
               size=(54, 96), seed=2)
    return root


def test_image_helpers_match(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    timage.save_image(tmp_path / "t.jpg", img)
    jimage.save_image(tmp_path / "j.jpg", img)
    assert (tmp_path / "t.jpg").read_bytes() == (tmp_path / "j.jpg").read_bytes()
    Image.fromarray((img[..., 0] * 255).astype(np.uint8)).save(tmp_path / "gray.png")  # converted to RGB
    for name in ("t.jpg", "gray.png"):
        np.testing.assert_array_equal(timage.load_image(tmp_path / name), jimage.load_image(tmp_path / name))
    for out_hw in ((20, 30), (64, 100), (37, 53)):
        np.testing.assert_array_equal(timage.resize_nearest_np(img, out_hw), jimage.resize_nearest_np(img, out_hw))
        np.testing.assert_array_equal(timage.resize_bilinear_np(img, out_hw), jimage.resize_bilinear_np(img, out_hw))
        np.testing.assert_array_equal(timage.resize_bilinear_np(img[..., 0], out_hw),
                                      jimage.resize_bilinear_np(img[..., 0], out_hw))


def assert_samples_equal(got, want):
    assert got.keys() == want.keys()
    assert got["filename"] == want["filename"]
    for key in ("imgs", "depth_values"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert got["proj_matrices"].keys() == want["proj_matrices"].keys()
    for stage in want["proj_matrices"]:
        np.testing.assert_array_equal(got["proj_matrices"][stage], want["proj_matrices"][stage])


@pytest.mark.parametrize("dataset", ["dtu", "tt", "general"])
@pytest.mark.parametrize("refine", [True, False])
def test_eval_samples_are_equal(scans, dataset, refine):
    kw = dict(nviews=3, ndepths=32, interval_scale={"scan1": 1.06, "scan2": 1.0, "scan3": 0.8}, max_h=48,
              max_w=64, dataset=dataset, refine=refine)
    names = ["scan1", "scan2", "scan3"]
    got, want = EvalDataset(str(scans), names, **kw), JaxEvalDataset(str(scans), names, **kw)
    assert got.metas == want.metas and len(got) == 10
    for i in range(len(want)):
        assert_samples_equal(got[i], want[i])


def test_eval_samples_fix_res(scans):
    kw = dict(nviews=4, ndepths=16, interval_scale=1.06, max_h=40, max_w=56, dataset="general", fix_res=True)
    got, want = EvalDataset(str(scans), ["scan3", "scan1"], **kw), JaxEvalDataset(str(scans), ["scan3", "scan1"], **kw)
    for i in range(len(want)):
        assert_samples_equal(got[i], want[i])


def loader_dataset(scans):
    return dict(datapath=str(scans), scans=["scan1", "scan2", "scan3"], nviews=3, ndepths=16, max_h=32, max_w=48,
                dataset="general")


@pytest.mark.parametrize("batch_size,num_workers", [(1, 4), (3, 2), (4, 1)])
def test_loader_batches_match(scans, batch_size, num_workers):
    kw = dict(batch_size=batch_size, num_workers=num_workers)
    ds = EvalDataset(**loader_dataset(scans))
    got = list(DataLoader(ds, device="cpu", **kw))
    want = list(JaxDataLoader(JaxEvalDataset(**loader_dataset(scans)), **kw))
    assert len(got) == len(want) == len(DataLoader(ds, device="cpu", **kw))
    sizes = [len(b["filename"]) for b in got]
    assert sizes == {1: [1] * 10, 3: [3, 3, 3, 1], 4: [4, 4, 2]}[batch_size]
    for g, w in zip(got, want):
        assert g["filename"] == w["filename"]
        assert isinstance(g["imgs"], torch.Tensor) and g["imgs"].device.type == "cpu"
        np.testing.assert_array_equal(g["imgs"].numpy(), np.asarray(w["imgs"]))
        np.testing.assert_array_equal(g["depth_values"].numpy(), np.asarray(w["depth_values"]))
        for stage in w["proj_matrices"]:
            np.testing.assert_array_equal(g["proj_matrices"][stage].numpy(), np.asarray(w["proj_matrices"][stage]))


def test_loader_keeps_host_arrays_and_surfaces_errors(scans):
    ds = EvalDataset(**loader_dataset(scans))
    (batch, *_) = list(DataLoader(ds, batch_size=2, device="cpu"))
    np.testing.assert_array_equal(batch["host"]["imgs"], batch["imgs"].numpy())
    np.testing.assert_array_equal(batch["host"]["proj_matrices"]["stage4"], batch["proj_matrices"]["stage4"].numpy())

    class Broken(EvalDataset):
        def __getitem__(self, idx):
            if idx == 4:
                raise OSError("unreadable view")
            return super().__getitem__(idx)

    seen = []
    with pytest.raises(OSError, match="unreadable"):
        for b in DataLoader(Broken(**loader_dataset(scans)), batch_size=2, device="cpu"):
            seen.append(b["filename"])
    assert len(seen) == 2


def test_loader_decodes_ahead_across_batches(scans):
    """At batch size 1 the workers decode the next samples in parallel: the
    first two samples each wait for the other, which only works if both are
    decoding at once."""
    import threading

    both = threading.Barrier(2, timeout=10)

    class Paired(EvalDataset):
        def __getitem__(self, idx):
            if idx < 2:
                both.wait()
            return super().__getitem__(idx)

    got = [b["filename"] for b in DataLoader(Paired(**loader_dataset(scans)), batch_size=1, num_workers=2,
                                             device="cpu")]
    assert len(got) == 10 and not both.broken
