"""The port's ``StreamingReconstructor`` against the JAX package's: the same
pushes assemble the same forward inputs, and each map the port returns is
``CDSMVSNet.forward`` on that window.

The JAX reconstructor's jitted cascade never runs: its ``_forward`` is
replaced on the instance by a recorder, so nothing of the JAX cascade is
compiled (the JAX package's own streaming test compiles it and takes
minutes on the CPU).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.config import ModelConfig as JaxModelConfig
from cds_mvsnet_tpu.eval.streaming import StreamingConfig as JaxStreamingConfig
from cds_mvsnet_tpu.eval.streaming import StreamingReconstructor as JaxStreamingReconstructor
from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.eval.streaming import StreamingConfig, StreamingReconstructor

torch.set_num_threads(2)

H, W, WINDOW, PUSHES = 64, 128, 3, 5
NDEPTHS = (16, 8, 8)  # each stays divisible through the cost UNet's three stride-2 levels
STREAM = dict(window=WINDOW, ndepths_full=32, height=H, width=W, depth_min=1.0, depth_max=4.0)


def frames_and_cams(n: int = PUSHES):
    rng = np.random.default_rng(0)
    f = 4 * 128.0
    out = []
    for i in range(n):
        frame = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0] = np.eye(4)
        cam[0, 0, 3] = 0.05 * i
        cam[0, 1, 3] = 0.02 * (i % 2)
        cam[1, :3, :3] = [[f, 0, 64], [0, f, 32], [0, 0, 1]]
        cam[1, 3, 3] = 1
        out.append((frame, cam))
    return out


def recorded_pushes(rec, recorder_args):
    """Push every frame with ``rec._forward`` replaced by a recorder of its
    inputs as numpy; returns (push results, recorded inputs)."""
    seen = []

    def record(*args):
        imgs, proj, dv = args[-3:]
        seen.append((np.asarray(imgs), {k: np.asarray(v) for k, v in proj.items()}, np.asarray(dv)))
        return recorder_args

    rec._forward = record
    return [rec.push(frame, cam) for frame, cam in frames_and_cams()], seen


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_push_assembles_the_jax_inputs(refine, dtype):
    jax_rec = JaxStreamingReconstructor(
        {}, JaxStreamingConfig(**STREAM, compute_dtype=dtype), model_cfg=JaxModelConfig(refine=refine, ndepths=NDEPTHS))
    zeros = np.zeros((1, H, W), np.float32)
    jax_out, want = recorded_pushes(jax_rec, (zeros, zeros))
    rec = StreamingReconstructor(None, StreamingConfig(**STREAM, compute_dtype=dtype),
                                 model_cfg=ModelConfig(refine=refine, ndepths=NDEPTHS), device="cpu")
    zt = torch.zeros((H, W))
    out, got = recorded_pushes(rec, (zt, zt))
    assert [o is None for o in out] == [o is None for o in jax_out] == [True] * (WINDOW - 1) + [False] * 3
    assert len(got) == len(want) == PUSHES - WINDOW + 1
    for (gi, gp, gd), (wi, wp, wd) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert sorted(gp) == sorted(wp) == [f"stage{i + 1}" for i in range(4 if refine else 3)]
        for k in wp:
            np.testing.assert_array_equal(gp[k], wp[k])
        np.testing.assert_array_equal(gd, wd)
        assert gd.dtype == np.float32 and gd.shape == (1, 32)
    assert rec.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_push_is_the_forward_on_its_window(dtype):
    """Each returned (depth, confidence) is ``forward``'s refined depth and
    stage-3 confidence on the window's inputs at the configured temperature
    and dtype; None until the window fills, and again after reset."""
    cfg = ModelConfig(refine=False, ndepths=NDEPTHS)
    rec = StreamingReconstructor(None, StreamingConfig(**STREAM, compute_dtype=dtype), model_cfg=cfg,
                                 device="cpu")
    pushes = frames_and_cams()
    results, windows = [], []
    for frame, cam in pushes:
        results.append(rec.push(frame, cam))
        windows.append(rec.inputs() if rec.ready else None)
    assert results[:WINDOW - 1] == [None] * (WINDOW - 1)
    for res, inputs in zip(results[WINDOW - 1:], windows[WINDOW - 1:]):
        out = rec.model(*inputs, temperature=0.01, compute_dtype=getattr(torch, dtype))
        depth, conf = res
        assert depth.shape == conf.shape == (H, W) and np.isfinite(depth).all()
        np.testing.assert_array_equal(depth, out["refined_depth"][0].numpy())
        np.testing.assert_array_equal(conf, out["stage3"]["photometric_confidence"][0].numpy())
        assert (depth >= 1.0 - 1e-3).all() and (depth <= 4.0 + 1e-3).all()
    # the newest frame is the reference, then the others by recency
    imgs = windows[-1][0][0].numpy()
    for k in range(WINDOW):
        np.testing.assert_array_equal(imgs[k], pushes[-1 - k][0])
    rec.reset()
    assert not rec.ready
    assert [rec.push(*pushes[i]) is None for i in range(WINDOW - 1)] == [True] * (WINDOW - 1)
    assert rec.push(*pushes[WINDOW - 1]) is not None
    with pytest.raises(ValueError, match="frame"):
        rec.push(np.zeros((H, W + 1, 3), np.float32), pushes[0][1])


def test_default_config_is_the_long_range_split():
    jax_cfg = JaxStreamingConfig()
    assert StreamingConfig().__dict__ == jax_cfg.__dict__
    rec = StreamingReconstructor(None, StreamingConfig(window=2, height=32, width=32), device="cpu")
    assert rec.model_cfg == ModelConfig(refine=False, ndepths=(128, 32, 8), depth_intervals_ratio=(4.0, 2.0, 1.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamingReconstructor(None, StreamingConfig(window=2, height=32, width=32))
