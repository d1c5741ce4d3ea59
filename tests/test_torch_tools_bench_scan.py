"""``cds_mvsnet_tpu_torch/tools/bench_scan.py`` on the CPU at a 3-view scan
of 64x128: the JAX tool's keys, the written maps and clouds, and the
report's checks."""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import pytest
import torch

from cds_mvsnet_tpu_torch.io.ply import read_ply
from cds_mvsnet_tpu_torch.tools import bench_scan
from test_torch_tools_source import jax_scan_keys

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)


def test_tool_on_a_tiny_scan(tmp_path, capsys):
    """``--views 3 --h 64 --w 128`` with ``--out``: the line holds exactly
    the JAX tool's keys, its rates are finite and positive, the shares in
    [0, 1), every view's depth map is written, each ``.ply`` holds the
    line's points; no launch on the CPU."""
    report = bench_scan.main(["--views", "3", "--h", "64", "--w", "128", "--out", str(tmp_path)], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == report["line"]
    assert list(line) == jax_scan_keys()
    assert line["backend"] == "cpu"
    assert line["metric"] == "scan e2e (depth+filter+fusion+ply), 3 views at 128x64, 5-view inference, 192 depths"
    for key in ("scans_per_sec_jit_fusion", "scans_per_sec_native_fusion", "depth_maps_per_sec",
                "depth_maps_per_sec_checksum"):
        assert math.isfinite(line[key]) and line[key] > 0, key
    assert 0 <= line["fusion_share_jit"] < 1 and 0 <= line["fusion_share_native"] < 1
    assert line["points_jit"] > 0 and line["points_native"] > 0
    assert len(list((tmp_path / "out" / "scan1" / "depth_est").glob("*.pfm"))) == 3
    assert len(read_ply(tmp_path / "fused_jit.ply")[0]) == line["points_jit"]
    assert len(read_ply(tmp_path / "fused_native.ply")[0]) == line["points_native"]
    assert report["ply_vertices"] == {"points_jit": line["points_jit"], "points_native": line["points_native"]}
    assert report["launches"] == {"depth": {}, "checksum": {}}
    assert chip_smoke.tool_problems("bench_scan", [], report) == []


def test_problems_reports_what_the_card_must_show():
    """The smoke's gate: on the card each leg's launches are ``views`` maps'
    of the product's bf16 counts at 5-view inference, and a ``.ply`` must
    hold the line's points; a rate that is not finite is reported."""
    line = {"points_jit": 10, "points_native": 7, "depth_s_per_scan": 1.5, "fusion_share_jit": 0.25}
    per_map = {"warp_entropy": 12, "conv3d_bn_relu": 3, "exit_softargmin": 3, "dynconv_branches": 1}
    ok = {"line": line, "device": "cuda", "views": 2, "nviews": 5,
          "launches": {leg: {k: 2 * n for k, n in per_map.items()} for leg in ("depth", "checksum")},
          "ply_vertices": {"points_jit": 10, "points_native": 7}}
    assert chip_smoke.tool_problems("bench_scan", [], ok) == []
    bad = {**ok, "line": {**line, "fusion_share_jit": math.nan}, "ply_vertices": {"points_jit": 10, "points_native": 6},
           "launches": {"depth": ok["launches"]["depth"], "checksum": {"warp_entropy": 24}}}
    found = chip_smoke.tool_problems("bench_scan", [], bad)
    assert len(found) == 3
    assert chip_smoke.tool_problems("bench_scan", [], {**bad, "device": "cpu"}) == found[:2]
    assert chip_smoke.tool_problems("bench_scan", [], {**ok, "nviews": 3}) == [
        "launches are gated at 5-view inference, not 3"]


def test_ply_vertices_reads_the_header(tmp_path):
    import numpy as np

    from cds_mvsnet_tpu_torch.io.ply import write_ply

    write_ply(tmp_path / "a.ply", np.zeros((17, 3), np.float32))
    assert bench_scan.ply_vertices(str(tmp_path / "a.ply")) == 17
    (tmp_path / "b.ply").write_bytes(b"ply\nformat binary_little_endian 1.0\nend_header\n")
    with pytest.raises(ValueError, match="no vertex element"):
        bench_scan.ply_vertices(str(tmp_path / "b.ply"))
