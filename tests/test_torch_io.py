"""The port's file formats against the JAX package's: PFM maps, cam and pair
files and PLY clouds written by both are byte-equal and read back equal."""

from __future__ import annotations

import numpy as np
import pytest

from cds_mvsnet_tpu.io import cams as jcams
from cds_mvsnet_tpu.io import pfm as jpfm
from cds_mvsnet_tpu.io import ply as jply
from cds_mvsnet_tpu_torch.io import cams as tcams
from cds_mvsnet_tpu_torch.io import pfm as tpfm
from cds_mvsnet_tpu_torch.io import ply as tply


@pytest.mark.parametrize("shape", [(7, 5), (6, 9, 3), (4, 3, 1)])
@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_pfm_bytes_and_read_back(tmp_path, shape, scale):
    rng = np.random.default_rng(0)
    img = rng.standard_normal(shape).astype(np.float32)
    jpfm.write_pfm(tmp_path / "j.pfm", img, scale)
    tpfm.write_pfm(tmp_path / "t.pfm", img, scale)
    assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    got, s_got = tpfm.read_pfm(tmp_path / "j.pfm")
    want, s_want = jpfm.read_pfm(tmp_path / "t.pfm")
    assert s_got == s_want == scale
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img.reshape(got.shape))  # the row flip undone


def test_pfm_big_endian_and_bad_header(tmp_path):
    """A positive scale marks big-endian data; both readers flip it alike."""
    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    with open(tmp_path / "be.pfm", "wb") as f:
        f.write(b"Pf\n4 3\n1.0\n")
        np.flipud(img).astype(">f").tofile(f)
    np.testing.assert_array_equal(tpfm.read_pfm(tmp_path / "be.pfm")[0], jpfm.read_pfm(tmp_path / "be.pfm")[0])
    (tmp_path / "bad.pfm").write_bytes(b"P6\n1 1\n1.0\n")
    with pytest.raises(ValueError, match="not a PFM"):
        tpfm.read_pfm(tmp_path / "bad.pfm")


def test_cam_file_bytes_and_read_back(tmp_path):
    rng = np.random.default_rng(1)
    cam = rng.standard_normal((2, 4, 4)).astype(np.float32)
    cam[1, 3] = [425.0, 2.65, 192.0, 933.8]
    jcams.write_cam_file(tmp_path / "j_cam.txt", cam)
    tcams.write_cam_file(tmp_path / "t_cam.txt", cam)
    assert (tmp_path / "t_cam.txt").read_bytes() == (tmp_path / "j_cam.txt").read_bytes()
    got, want = tcams.read_cam_file(tmp_path / "j_cam.txt"), jcams.read_cam_file(tmp_path / "j_cam.txt")
    np.testing.assert_array_equal(got.extrinsic, want.extrinsic)
    np.testing.assert_array_equal(got.intrinsic, want.intrinsic)
    assert (got.depth_min, got.depth_interval, got.num_depth, got.depth_max) == (
        want.depth_min, want.depth_interval, want.num_depth, want.depth_max)
    np.testing.assert_array_equal(tcams.pack_cam(got.extrinsic, got.intrinsic),
                                  jcams.pack_cam(want.extrinsic, want.intrinsic))


@pytest.mark.parametrize("depth_line", ["425.0", "425.0 2.5", "425.0 2.5 192", "425.0 2.5 192 905.0"])
def test_cam_depth_lines(tmp_path, depth_line):
    (tmp_path / "c.txt").write_text("extrinsic\n" + "1 0 0 0\n0 1 0 0\n0 0 1 0\n0 0 0 1\n"
                                    + "\nintrinsic\n1 0 2\n0 1 3\n0 0 1\n\n" + depth_line + "\n")
    got, want = tcams.read_cam_file(tmp_path / "c.txt"), jcams.read_cam_file(tmp_path / "c.txt")
    assert (got.depth_min, got.depth_interval, got.num_depth, got.depth_max) == (
        want.depth_min, want.depth_interval, want.num_depth, want.depth_max)


def test_pair_file(tmp_path):
    """Views with no sources are dropped by both readers."""
    (tmp_path / "pair.txt").write_text("3\n0\n2 1 10.5 2 3.0\n1\n0\n2\n1 0 7.0\n")
    assert tcams.read_pair_file(tmp_path / "pair.txt") == jcams.read_pair_file(tmp_path / "pair.txt") == [
        (0, [1, 2]), (2, [0])]


@pytest.mark.parametrize("n", [0, 1, 257])
@pytest.mark.parametrize("with_colors", [False, True])
def test_ply_bytes_and_read_back(tmp_path, n, with_colors):
    rng = np.random.default_rng(n)
    pts = rng.standard_normal((n, 3)) * 100
    cols = rng.integers(0, 256, (n, 3)).astype(np.uint8) if with_colors else None
    jply.write_ply(tmp_path / "j.ply", pts, cols)
    tply.write_ply(tmp_path / "t.ply", pts, cols)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    (gp, gc), (wp, wc) = tply.read_ply(tmp_path / "j.ply"), jply.read_ply(tmp_path / "t.ply")
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gc, wc)


def test_ply_reads_ascii(tmp_path):
    (tmp_path / "a.ply").write_text("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
                                    "property float y\nproperty float z\nend_header\n1 2 3\n4 5 6\n")
    (gp, gc), (wp, wc) = tply.read_ply(tmp_path / "a.ply"), jply.read_ply(tmp_path / "a.ply")
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gc, wc)
