"""Step 1 of evaluation: run the cascade over a scan list and write each
view's depth, stacked confidence, camera and image files.

Counterpart of ``cds_mvsnet_tpu/eval/depth_inference.py``, with the same
output layout: ``{out}/{scan}/depth_est/xxxxxxxx.pfm``, ``confidence/*.pfm``
(the stage confidences nearest-resized to the final resolution, stacked
HxWx3), ``cams/*_cam.txt`` and ``images/*.jpg``. File IO runs on a writer
thread. On the card each view's outputs are copied to the host on a side
stream, after the next view's forward has been queued, so the card computes
the next map while this one crosses to the host and is written.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import ModelConfig
from ..data.eval_set import EvalDataset
from ..data.image import resize_nearest_np, save_image
from ..data.loader import DataLoader
from ..io.cams import write_cam_file
from ..io.pfm import write_pfm
from ..models.cds_mvsnet import build_model, resolve_device

__all__ = ["save_depths", "make_eval_forward", "resolve_fast_path"]


def resolve_fast_path(
    compute_dtype: str = "auto",
    feature_impl: str = "auto",
    precision: str = "auto",
    max_h: int | None = None,
    max_w: int | None = None,
    device="cuda",
):
    """``(torch dtype, feature_impl, precision)`` of the eval knobs.

    ``auto`` means bf16 on the card and fp32 on the CPU. ``feature_impl``
    and ``precision`` resolve as in the JAX package (``s2d``/``default`` on
    the accelerator, ``plain``/``highest`` on the CPU, ``s2d`` falls back to
    ``plain`` where the resolution is no multiple of 8) and are reported, but
    they select TPU layouts and XLA precision: the port has one layout and
    keeps fp32 products in fp32, so they do not change its result.
    """
    on_card = torch.device(device).type == "cuda"
    if compute_dtype == "auto":
        compute_dtype = "bf16" if on_card else "fp32"
    if feature_impl == "auto":
        feature_impl = "s2d" if on_card else "plain"
    if precision == "auto":
        precision = "default" if on_card else "highest"
    if feature_impl == "s2d" and max_h is not None and max_w is not None:
        if max_h % 8 != 0 or max_w % 8 != 0:
            feature_impl = "plain"
    dtype = torch.bfloat16 if compute_dtype == "bf16" else torch.float32
    return dtype, feature_impl, precision


def make_eval_forward(model, temperature: float = 0.01, compute_dtype=torch.float32):
    """``forward(imgs, proj_matrices, depth_values)`` -> ``{"refined_depth",
    "conf": {stage: photometric confidence}}``, device tensors."""

    def forward(imgs, proj_matrices, depth_values):
        outputs = model(imgs, proj_matrices, depth_values, temperature=temperature, compute_dtype=compute_dtype)
        return {
            "refined_depth": outputs["refined_depth"],
            "conf": {f"stage{i + 1}": outputs[f"stage{i + 1}"]["photometric_confidence"]
                     for i in range(model.cfg.num_stages)},
        }

    return forward


def _to_host(out: dict, ready, side):
    """Copy a forward's outputs to the host: on the card on ``side`` after
    the event ``ready``, into pinned memory; returns ``(host tensors, done
    event)`` (None on the CPU)."""
    if side is None:
        return {"refined_depth": out["refined_depth"], "conf": dict(out["conf"])}, None
    side.wait_event(ready)
    with torch.cuda.stream(side):
        host = {}
        for key, t in [("refined_depth", out["refined_depth"]), *out["conf"].items()]:
            t.record_stream(side)
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host[key] = h
        done = torch.cuda.Event()
        done.record(side)
    return {"refined_depth": host.pop("refined_depth"), "conf": host}, done


def save_depths(
    params,
    model_cfg: ModelConfig,
    datapath: str,
    scans: list[str],
    outdir: str,
    nviews: int = 5,
    ndepths: int = 192,
    interval_scale: float | dict = 1.06,
    max_h: int = 864,
    max_w: int = 1152,
    fix_res: bool = False,
    dataset: str = "dtu",
    temperature: float = 0.01,
    batch_size: int = 1,
    num_workers: int = 4,
    verbose: bool = True,
    compute_dtype: str = "auto",
    feature_impl: str = "auto",
    precision: str = "auto",
    device="cuda",
) -> dict:
    """Run the cascade with the weights ``params`` (a JAX param tree or an
    ``.npz``, as ``build_model`` takes) over the scans on ``device``; returns
    timing stats ``{mean_s, p50_s, maps_per_sec, n, compute_dtype,
    feature_impl}`` (the first view's time is dropped, as the JAX package
    drops its compile)."""
    dev = resolve_device(device)
    dtype, impl, _ = resolve_fast_path(compute_dtype, feature_impl, precision, max_h=max_h, max_w=max_w,
                                       device=dev)
    ds = EvalDataset(
        datapath, scans, nviews=nviews, ndepths=ndepths, interval_scale=interval_scale,
        max_h=max_h, max_w=max_w, fix_res=fix_res, dataset=dataset, refine=model_cfg.refine,
    )
    loader = DataLoader(ds, batch_size=batch_size, num_workers=num_workers, device=dev)
    model = build_model(model_cfg, params=params, device=dev)
    forward = make_eval_forward(model, temperature, compute_dtype=dtype)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def write_outputs(out, cams, imgs, filenames):
        # on the writer thread: all file IO off the inference path
        for b, filename in enumerate(filenames):
            depth = out["refined_depth"][b]
            h, w = depth.shape
            conf = np.stack([resize_nearest_np(out["conf"][f"stage{s + 1}"][b], (h, w))
                             for s in range(model_cfg.num_stages)], axis=-1)
            write_pfm(os.path.join(outdir, filename.format("depth_est", ".pfm")), depth)
            write_pfm(os.path.join(outdir, filename.format("confidence", ".pfm")), conf)
            cam = cams[b, 0].copy()
            cam[1, 3] = [0, 0, 0, 1]
            cam_path = os.path.join(outdir, filename.format("cams", "_cam.txt"))
            os.makedirs(os.path.dirname(cam_path), exist_ok=True)
            write_cam_file(cam_path, cam)
            img_path = os.path.join(outdir, filename.format("images", ".jpg"))
            os.makedirs(os.path.dirname(img_path), exist_ok=True)
            save_image(img_path, resize_nearest_np(imgs[b, 0], (h, w)))
        return depth.shape

    times = []
    pending = []
    stage_final = f"stage{model_cfg.num_stages + (1 if model_cfg.refine else 0)}"
    writer = ThreadPoolExecutor(max_workers=2, thread_name_prefix="depth-writer")

    def drain(item, idx, t0):
        # view idx's outputs cross to the host after view idx+1's forward
        # has been queued
        out_dev, ready, cams, imgs, filenames = item
        host, done = _to_host(out_dev, ready, side)
        if done is not None:
            done.synchronize()
        out = {"refined_depth": host["refined_depth"].float().numpy(),
               "conf": {k: v.float().numpy() for k, v in host["conf"].items()}}
        times.append(time.perf_counter() - t0)
        pending.append(writer.submit(write_outputs, out, cams, imgs, filenames))
        if verbose:
            print(f"view {idx + 1}: {times[-1]:.3f}s")

    def pad_ragged(batch):
        # a ragged final batch is padded with its last sample to batch_size,
        # as the JAX package pads it to keep one compiled shape; the padded
        # outputs are not written (write_outputs walks the file names)
        n = len(batch["filename"])
        if n == batch_size:
            return batch

        def pad(x):
            if isinstance(x, dict):
                return {k: pad(v) for k, v in x.items()}
            return torch.cat([x, x[-1:].expand(batch_size - n, *x.shape[1:])])

        return {k: v if k in ("filename", "host") else pad(v) for k, v in batch.items()}

    try:
        prev = None
        prev_t0 = None
        for i, batch in enumerate(loader):
            t0 = time.perf_counter()
            batch = pad_ragged(batch)
            out_dev = forward(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
            ready = None
            if side is not None:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(dev))
            if prev is not None:
                drain(prev, i - 1, prev_t0)
            host = batch["host"]
            prev = (out_dev, ready, host["proj_matrices"][stage_final], host["imgs"], batch["filename"])
            prev_t0 = t0
        if prev is not None:
            drain(prev, len(times), prev_t0)
        shapes = [f.result() for f in pending]  # surface writer errors
        if verbose and shapes:
            print(f"output res {shapes[-1]}")
    finally:
        writer.shutdown(wait=True)

    times_arr = np.asarray(times[1:] if len(times) > 1 else times)  # drop the first view
    return {
        "mean_s": float(times_arr.mean()),
        "p50_s": float(np.median(times_arr)),
        "maps_per_sec": float(batch_size / np.median(times_arr)),
        "n": len(times),
        "compute_dtype": "bf16" if dtype == torch.bfloat16 else "fp32",
        "feature_impl": impl,
    }
