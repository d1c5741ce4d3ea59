"""Configurations, traffic, limits and metrics are found by file name, and
BENCHMARK.json agrees with the files."""

import importlib.util
import json

import pytest

from mvsbench.harness import BENCH_DIR, load_cell

ROOT = BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _metric(name):
    spec = importlib.util.spec_from_file_location(name, BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = load_cell(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert (BENCH_DIR / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert c.limits.get("limits"), f"mvsbench/limits/{cell}.json holds no limits"
    assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
    assert c.per_layer


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_entry_has_a_reader(entry):
    """Each per-layer entry finds ``metrics/<name>.py``, whose ``read`` is all
    the file holds of it (the entry holds its layer, unit and cells), and
    lists cells that report the end-to-end metric it moves."""
    assert callable(_metric(entry["name"]).read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(entry["workloads"]) <= cells
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert all(w in e2e[entry["moves"]].get("workloads", [w]) for w in entry["workloads"])


def test_every_config_file_is_used_and_whole():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_a_new_metric_is_a_new_file(tmp_path, monkeypatch):
    """A reader dropped into metrics/ is found by the name an entry gives."""
    from mvsbench import run

    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "probe_ms.offline.py").write_text("def read(t, cfg):\n    return 1.5\n")
    monkeypatch.setattr(run, "BENCH_DIR", tmp_path)
    assert run.load_metric("probe_ms.offline").read(None, None) == 1.5
