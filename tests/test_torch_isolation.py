"""The port stands alone: neither ``cds_mvsnet_tpu_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and the smoke run prints no
result where it cannot drive the card."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "cds_mvsnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "cds_mvsnet_tpu")


def port_sources() -> list[Path]:
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_sources_import_neither_jax_nor_the_jax_package():
    sources = port_sources()
    assert len(sources) > 20
    bad = {
        str(p.relative_to(REPO)): sorted(m for m in imported_modules(p) if m.split(".")[0] in FORBIDDEN)
        for p in sources
    }
    assert {k: v for k, v in bad.items() if v} == {}


def test_every_module_imports_with_jax_blocked():
    """Import every module of the port and ``chip_smoke`` in a fresh
    interpreter where importing JAX or the JAX package fails."""
    code = f"""
import importlib, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
import cds_mvsnet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for new in ("tools.tt_feasibility", "tools.same_steps", "tools.nondeterministic_ops", "ops.index",
            "tools.time_launch_path", "tools.profile_stages", "tools.bench_scan", "tools.bench_train",
            "tools.train_convergence", "tools.convert_checkpoint", "utils.profiling", "utils.logging"):
    assert "cds_mvsnet_tpu_torch." + new in names, new
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in {FORBIDDEN!r}]
assert not loaded, loaded
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_prints_no_result_without_the_card_or_the_port(where, tmp_path):
    """Run here, without a card, and from a directory that holds only the
    script: a non-zero exit and no result line."""
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {**os.environ, "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert ("not importable" if where == "alone" else "no CUDA device") in out.stderr
