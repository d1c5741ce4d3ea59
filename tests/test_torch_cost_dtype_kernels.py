"""``cost_dtype`` against the JAX package: a bf16 cascade with fp32 cost
under the cuDNN front (``s2d``) and the three-kernel front (``pallas3``:
conv0, conv1 and conv2 on kernels). The comparison and its tolerance are
``test_torch_cost_dtype.py``'s; each case spends most of its time tracing
the JAX package's interpreted kernels, so the cases sit in three files that
run side by side.
"""

from __future__ import annotations

import pytest
import torch

from test_torch_cost_dtype import compare_with_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("front", ["s2d", "pallas3"])
def test_stage_with_fp32_cost_matches_jax(monkeypatch, front):
    compare_with_jax(monkeypatch, torch.bfloat16, torch.float32, front)
