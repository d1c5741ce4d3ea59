"""Real-time streaming reconstruction: depth from a posed video stream.

Own counterpart of ``cds_mvsnet_tpu/eval/streaming.py``, the upstream
smartphone-video and SLAM demo with its long-range split of 512 depth
planes into 128/32/8. Frames are pushed newest first: each pushed frame is
the reference view against the previous ``window − 1`` frames, in recency
order, and each push once the window is full runs one cascade forward.

The window stays on the device as a ring of frames, so a push copies only
the new frame and the small camera pyramid to the card; the JAX module
uploads the whole stacked window on every push. The inputs of a forward are
the same either way (``inputs``). ``compute_dtype="bfloat16"`` runs the
cascade's ``KERNEL_OPS`` (per push K1 12 times, K2 and K3 3 times, K4 once),
``"float32"`` its ``FP32_OPS`` (K9 12 times, K2 3 times). The JAX module's
FeatureNet layout switch has no counterpart: the port has one layout.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..config import ModelConfig
from ..models.cds_mvsnet import build_model

__all__ = ["StreamingConfig", "StreamingReconstructor"]


@dataclass(frozen=True)
class StreamingConfig:
    window: int = 5  # frames per inference (1 ref + window-1 sources)
    ndepths_full: int = 512  # hypotheses across the full range
    height: int = 480
    width: int = 640
    depth_min: float = 0.3
    depth_max: float = 10.0
    temperature: float = 0.01
    compute_dtype: str = "bfloat16"


class StreamingReconstructor:
    """Push posed frames; get a depth map per push once the window fills.

    Frames: ``(H, W, 3)`` float32 in [0, 1]; cams: packed ``(2, 4, 4)``
    (extrinsic world->cam, intrinsic at full frame resolution). ``params``
    is a JAX parameter tree or an ``.npz`` (``models.build_model``); ``None``
    takes the seeded init of ``build_model``. The model runs on ``device``,
    the card unless ``device="cpu"`` is passed.
    """

    def __init__(self, params, stream_cfg: StreamingConfig = StreamingConfig(),
                 model_cfg: ModelConfig | None = None, device="cuda"):
        self.cfg = stream_cfg
        # long-range cascade split (reference README.md:87): 512 -> 128/32/8
        self.model_cfg = model_cfg or ModelConfig(
            refine=False, ndepths=(128, 32, 8), depth_intervals_ratio=(4.0, 2.0, 1.0)
        )
        self.model = build_model(self.model_cfg, params, device=device)
        self.device = next(self.model.parameters()).device
        self.dtype = torch.bfloat16 if stream_cfg.compute_dtype == "bfloat16" else torch.float32
        self.cams: deque = deque(maxlen=stream_cfg.window)
        self._ring = torch.zeros((stream_cfg.window, stream_cfg.height, stream_cfg.width, 3), device=self.device)
        self._pushed = 0  # frames pushed since the last reset; frame k sits in slot k % window
        dv = np.linspace(stream_cfg.depth_min, stream_cfg.depth_max, stream_cfg.ndepths_full, dtype=np.float32)
        self._depth_values = torch.as_tensor(dv[None], device=self.device)

    def reset(self):
        self.cams.clear()
        self._pushed = 0

    @property
    def ready(self) -> bool:
        return len(self.cams) == self.cfg.window

    def push(self, frame: np.ndarray, cam: np.ndarray):
        """Add a posed frame; returns (depth, confidence) for THIS frame as
        the reference view against the previous window-1 frames, or None
        while the window is filling."""
        frame = np.asarray(frame, np.float32)
        if frame.shape != (self.cfg.height, self.cfg.width, 3):
            raise ValueError(f"frame {frame.shape}, expected {(self.cfg.height, self.cfg.width, 3)}")
        self._ring[self._pushed % self.cfg.window].copy_(torch.from_numpy(frame))
        self._pushed += 1
        self.cams.appendleft(np.asarray(cam, np.float32))
        if not self.ready:
            return None
        depth, conf = self._forward(*self.inputs())
        return depth.cpu().numpy(), conf.cpu().numpy()

    def inputs(self):
        """The forward's ``(imgs (1, V, H, W, 3), proj_matrices,
        depth_values (1, ndepths_full))`` for the window as it stands,
        newest frame first; per-stage intrinsics scaled from full
        resolution."""
        window = len(self.cams)
        slots = [(self._pushed - 1 - k) % self.cfg.window for k in range(window)]
        imgs = torch.stack([self._ring[s] for s in slots])[None]
        cams = np.stack(self.cams)  # (V, 2, 4, 4)
        scales = [1.0, 2.0, 4.0] if not self.model_cfg.refine else [0.5, 1.0, 2.0, 4.0]
        proj = {}
        for i, s in enumerate(scales):
            m = cams.copy()
            m[:, 1, :2, :] *= s / 4.0  # streamed intrinsics are full-res
            proj[f"stage{i + 1}"] = torch.as_tensor(m[None], device=self.device)
        return imgs, proj, self._depth_values

    def _forward(self, imgs, proj, depth_values):
        out = self.model(imgs, proj, depth_values, temperature=self.cfg.temperature, compute_dtype=self.dtype)
        return out["refined_depth"][0], out[f"stage{self.model_cfg.num_stages}"]["photometric_confidence"][0]
