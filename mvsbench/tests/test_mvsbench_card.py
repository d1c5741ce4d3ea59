"""On the card: each cell runs once, short, through the command the
driver runs, and its last line holds a correct result. Skips without a
card (decided in the fixture)."""

import json
import subprocess
import sys

import pytest

from mvsbench.harness import BENCH_DIR

BENCH = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "mvsbench.run", "--workload", cell, "--seed", str(2**31 + 99),
                          "--seconds", "3", "--trace", "0"], cwd=BENCH_DIR.parent, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
