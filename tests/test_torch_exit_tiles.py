"""K3's plane limit against the depth counts of the port's entry points, on
the CPU: the kernel keeps every logit of its tile in shared memory, so the
wrapper takes D up to ``MAX_D`` (the card tests run the kernel at every
tile, ``MAX_D`` included) and refuses D past it, on any device, without
falling back to the plain version."""

from __future__ import annotations

import pytest
import torch

from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.eval.streaming import StreamingConfig, StreamingReconstructor
from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.ops.kernels.regress import MAX_D

torch.set_num_threads(2)


def entry_point_planes() -> set[int]:
    """Every per-stage D the entry points make: the CLI's and the model's
    default (48, 32, 8) and the stream's split of its 512 planes."""
    rec = StreamingReconstructor(None, StreamingConfig(height=32, width=64), device="cpu")
    return {*ModelConfig().ndepths, *rec.model_cfg.ndepths}


def exit_inputs(D: int):
    g = torch.Generator().manual_seed(D)
    y = (torch.rand(8, D, 2, 3, generator=g) * 4 - 2).to(torch.bfloat16)
    wp = torch.rand(1, 8, 3, 3, 3, generator=g) * 0.6 - 0.3
    return y, wp, torch.linspace(400.0, 900.0, D)


def test_entry_point_planes_fit():
    planes = entry_point_planes()
    assert planes == {8, 32, 48, 128}
    assert all(1 <= D <= MAX_D for D in planes)


@pytest.mark.parametrize("D", [MAX_D + 8, 2048])
def test_wrapper_refuses_past_max_d(D):
    y = torch.zeros(8, D, 2, 3, dtype=torch.bfloat16)
    wp = torch.zeros(1, 8, 3, 3, 3)
    with pytest.raises(ValueError, match=f"MAX_D={MAX_D}"):
        K.exit_softargmin(y, wp, torch.linspace(1.0, 2.0, D))


@pytest.mark.parametrize("D", [1, 8, 9, 32, 48, 128, 200, 512, 1000, MAX_D])
def test_cpu_takes_the_plain_version_up_to_max_d(D):
    y, wp, hyp = exit_inputs(D)
    before = K.exit_softargmin.launches
    for got, want in zip(K.exit_softargmin(y, wp, hyp), K.exit_softargmin_plain(y, wp, hyp)):
        assert torch.equal(got, want)
    assert K.exit_softargmin.launches == before
