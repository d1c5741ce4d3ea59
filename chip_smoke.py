#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, one JSON line each:

1. device: the card (nvidia-smi name and power limit), torch/CUDA/nvcc
   versions, and the build of every ``cds_mvsnet_tpu_torch/csrc/*.cu`` with
   nvcc for sm_90a (timed);
2. kernels: each hand-written kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it (1152x864, V=5, D=192,
   ndepths 48/32/8), with the tolerance stated beside each comparison and the
   kernel's, the plain version's and, where one PyTorch call computes the
   same function, that call's time;
3. serve: the eval cascade with seeded random weights answers 3 requests at
   1152x864; every kernel's launch count must show that the path ran it; its
   stage-3 depth and confidence are compared with the port's plain path on
   the card in bf16 (the gate) and in fp32 (reported);
   one more request runs under ``torch.profiler`` and the device time is
   summed by kernel name;
4. summary: one ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line. Nothing falls back: no GPU
means exit code 2 before any work.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

H, W, V, D_FULL = 864, 1152, 5, 192
NDEPTHS = (48, 32, 8)
REQUESTS = 3
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
SEED = 0

KERNEL_INFO = {
    "warp_entropy": ("cds_mvsnet_tpu_torch/csrc/warp.cu", "cds_mvsnet_tpu/ops/pallas/warp.py:1342"),
    "conv3d_bn_relu": ("cds_mvsnet_tpu_torch/csrc/conv3d.cu", "cds_mvsnet_tpu/ops/pallas/conv3d.py:159"),
    "exit_softargmin": ("cds_mvsnet_tpu_torch/csrc/regress.cu", "cds_mvsnet_tpu/ops/pallas/regress.py:224"),
    "dynconv_branches": ("cds_mvsnet_tpu_torch/csrc/dynconv.cu", "cds_mvsnet_tpu/ops/pallas/s2d_sparse.py:239"),
}
# the kernels' symbols as the profiler names them (csrc/*.cu)
KERNEL_SYMBOLS = ("void warp_entropy_kernel", "conv3d_bn_relu_kernel", "exit_softargmin_kernel",
                  "void dynconv_kernel")
# launches of one request at B=1: K1 once per source view and stage, K2/K3
# once per stage, K4 once (conv01 over the whole 2(V-1)-image stack)
PER_REQUEST = {"warp_entropy": 3 * (V - 1), "conv3d_bn_relu": 3, "exit_softargmin": 3, "dynconv_branches": 1}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed(torch, fn, reps: int) -> float:
    """Mean ms of ``fn()`` on the current stream, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_mem = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def phase_device(torch, kbuild):
    nvcc = subprocess.run([kbuild._nvcc(), "--version"], capture_output=True, text=True, check=True)
    t0 = time.perf_counter()
    info = kbuild.build_all()
    wall = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    emit({
        "phase": "device",
        "card": card_line(),
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc.stdout.strip().splitlines()[-1],
        "build_s": wall,
        "ptxas": ptxas,
    })


def stage_shapes():
    """(C, D, h, w) of each stage on the main path."""
    return [(32, NDEPTHS[0], H // 4, W // 4), (16, NDEPTHS[1], H // 2, W // 2), (8, NDEPTHS[2], H, W)]


def phase_kernels(torch, batch, dev):
    """Each kernel against its plain version at the main-path shapes, in
    bf16 as the main path runs them."""
    import torch.nn.functional as F

    from cds_mvsnet_tpu_torch.ops import kernels as K
    from cds_mvsnet_tpu_torch.ops.geometry import relative_warp_transform

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def uniform(shape, lo=-1.0, hi=1.0, dtype=torch.bfloat16):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo).to(dtype).contiguous()

    results = {name: [] for name in KERNEL_INFO}
    failures = []

    def record(name, stage, err, tol_desc, ok, ms, plain_ms, lib_ms, bytes_moved, flops, peak, extra=None):
        b_ms, b_by = bound(bytes_moved, flops, peak)
        row = {"stage": stage, "max_abs_err": err, "tolerance": tol_desc, "ok": ok, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": bytes_moved, "flops": flops}
        row.update(extra or {})
        results[name].append(row)
        emit({"phase": "kernels", "kernel": name, **row})
        if not ok:
            failures.append(f"{name}@stage{stage}")

    dvals = torch.linspace(425.0, 905.0, D_FULL, device=dev)
    interval = float(dvals[1] - dvals[0])
    for s, (C, D, h, w) in enumerate(stage_shapes(), start=1):
        cams = batch["proj_matrices"][f"stage{s}"]
        rot, trans = relative_warp_transform(cams[:, 0], cams[:, 1])
        rt = torch.cat([rot.reshape(9), trans.reshape(3)]).float().contiguous()
        if s == 1:
            hyp = torch.linspace(425.0, 905.0, D, device=dev).contiguous()
        else:  # per-pixel windows around a smooth depth map, as refined stages
            ratio = (2.0, 1.0)[s - 2]
            centre = uniform((h, w), 560.0, 640.0, torch.float32)
            steps = torch.arange(D, device=dev, dtype=torch.float32) - (D - 1) // 2
            hyp = (centre[None] + steps[:, None, None] * ratio * interval).contiguous()

        # K1: tanh-range features; channels-last source
        src = uniform((h, w, C))
        ref = uniform((C, h, w))
        ip_k, ent_k = K.warp_entropy(src, ref, hyp, rt)
        torch.cuda.synchronize()
        ip_p, ent_p = K.warp_entropy_plain(src, ref, hyp, rt)
        # both sum the same four fp32 corner terms (in another order) and
        # round the warped value to bf16: one bf16 ulp of the warped value,
        # times |ref| <= 1, plus the product's own rounding
        d_ip = (ip_k.float() - ip_p.float()).abs()
        tol_ip = 2 ** -7 * ip_p.float().abs() + 2 ** -8
        d_ent = (ent_k - ent_p).abs()
        ok = bool((d_ip <= tol_ip).all()) and float(d_ent.max()) <= 1e-2
        bytes_k1 = src.numel() * 2 + ref.numel() * 2 + hyp.numel() * 4 + 48 + ip_k.numel() * 2 + ent_k.numel() * 4
        flops_k1 = D * h * w * (11 * C + 20)
        record("warp_entropy", s, float(d_ip.max()),
               "in_prod |d| <= 2^-7|plain| + 2^-8 (one bf16 ulp of warped); entropy |d| <= 1e-2", ok,
               timed(torch, lambda: K.warp_entropy(src, ref, hyp, rt), 10),
               timed(torch, lambda: K.warp_entropy_plain(src, ref, hyp, rt), 2),
               None, bytes_k1, flops_k1, PEAK_FP32_FLOPS,
               {"entropy_max_abs_err": float(d_ent.max()), "in_prod_exact_frac": float((d_ip == 0).float().mean())})
        del ip_k, ip_p, d_ip, tol_ip

        # K2: mean volume in, folded conv0 weights
        vol = uniform((C, D, h, w))
        bound_w = (27 * C) ** -0.5
        wk = uniform((8, C, 3, 3, 3), -bound_w, bound_w, torch.float32)
        bk = uniform((8,), -0.1, 0.1, torch.float32)
        y_k = K.conv3d_bn_relu(vol, wk, bk)
        torch.cuda.synchronize()
        y_p = K.conv3d_bn_relu_plain(vol, wk, bk)
        # fp32 sums in another order, then one rounding to bf16
        d = (y_k.float() - y_p.float()).abs()
        ok = bool((d <= 2 ** -7 * y_p.float().abs() + 1e-3).all())
        wb, bb = wk.to(torch.bfloat16), bk.to(torch.bfloat16)
        record("conv3d_bn_relu", s, float(d.max()), "|d| <= 2^-7|plain| + 1e-3 (one bf16 ulp)", ok,
               timed(torch, lambda: K.conv3d_bn_relu(vol, wk, bk), 5),
               timed(torch, lambda: K.conv3d_bn_relu_plain(vol, wk, bk), 3),
               timed(torch, lambda: F.conv3d(vol[None], wb, bb, padding=1).relu_(), 5),
               vol.numel() * 2 + wk.numel() * 4 + 32 + y_k.numel() * 2,
               2 * 27 * C * 8 * D * h * w, PEAK_BF16_FLOPS)
        del vol, y_k, y_p, d

        # K3: UNet exit in, true hypotheses
        yx = uniform((8, D, h, w), -2.0, 2.0)
        wp = uniform((1, 8, 3, 3, 3), -0.3, 0.3, torch.float32)
        dk, ck = K.exit_softargmin(yx, wp, hyp)
        torch.cuda.synchronize()
        dp, cp = K.exit_softargmin_plain(yx, wp, hyp)
        # fp32 logits summed in another order: depth agrees to fp32
        # rounding of a ~600 mm expectation; confidence is compared where the
        # truncated plane index agrees (a flip moves the window)
        d_dep = (dk - dp).abs()
        same = torch.isclose(dk, dp, rtol=0, atol=1e-2)
        logits = F.conv3d(yx.float()[None], wp, padding=1)[0, 0]
        idx_p = (torch.softmax(logits, 0) * torch.arange(D, device=dev, dtype=torch.float32)[:, None, None]).sum(0)
        frac = idx_p - idx_p.floor()
        safe = (frac > 1e-3) & (frac < 1 - 1e-3)  # no truncation flip possible
        d_conf = (ck - cp).abs()
        ok = bool(same.all()) and float(d_conf[safe].max()) <= 1e-4
        record("exit_softargmin", s, float(d_dep.max()), "depth |d| <= 1e-2 mm; conf |d| <= 1e-4 off truncation boundaries", ok,
               timed(torch, lambda: K.exit_softargmin(yx, wp, hyp), 5),
               timed(torch, lambda: K.exit_softargmin_plain(yx, wp, hyp), 3),
               None, yx.numel() * 2 + wp.numel() * 4 + hyp.numel() * 4 + 2 * h * w * 4,
               2 * 216 * D * h * w, PEAK_BF16_FLOPS,
               {"conf_max_abs_err_safe": float(d_conf[safe].max()),
                "conf_diff_frac": float((d_conf > 1e-4).float().mean()),
                "near_boundary_frac": float((~safe).float().mean())})
        del yx, dk, dp, ck, cp, logits

    # K4: conv01 over the stack of 2(V-1) images, branches k = 3, 5, 7
    N = 2 * (V - 1)
    x = uniform((N, 8, H, W))
    ws = [uniform((11, 8, k, k), -(8 * k * k) ** -0.5, (8 * k * k) ** -0.5, torch.float32) for k in (3, 5, 7)]
    o_k = K.dynconv_branches(x, ws)
    torch.cuda.synchronize()
    o_p = K.dynconv_branches_plain(x, ws)
    d = (o_k.float() - o_p.float()).abs()
    ok = bool((d <= 2 ** -7 * o_p.float().abs() + 1e-3).all())
    wsb = [w_.to(torch.bfloat16) for w_ in ws]
    record("dynconv_branches", 3, float(d.max()), "|d| <= 2^-7|plain| + 1e-3 (one bf16 ulp)", ok,
           timed(torch, lambda: K.dynconv_branches(x, ws), 5),
           timed(torch, lambda: K.dynconv_branches_plain(x, ws), 3),
           timed(torch, lambda: [F.conv2d(x, w_, padding=w_.shape[-1] // 2) for w_ in wsb], 5),
           x.numel() * 2 + sum(w_.numel() * 4 for w_ in ws) + o_k.numel() * 2,
           2 * N * H * W * 11 * 8 * (9 + 25 + 49), PEAK_BF16_FLOPS)
    del x, o_k, o_p, d
    torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return results


def quantiles(torch, diff):
    q = torch.quantile(diff.flatten()[:: max(1, diff.numel() // 1_000_000)].float(),
                       torch.tensor([0.5, 0.99], device=diff.device))
    return float(q[0]), float(q[1])


def phase_serve(torch, batch, dev):
    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.models import build_model
    from cds_mvsnet_tpu_torch.ops import kernels as K

    cfg = ModelConfig(refine=False, ndepths=NDEPTHS)
    model = build_model(cfg, seed=SEED, device=dev)
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])

    def request(**kw):
        out = model(*args, **kw)
        torch.cuda.synchronize()
        return out

    request(compute_dtype=torch.bfloat16)  # warm-up: cuDNN plans, allocator
    for k in K.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        out = request(compute_dtype=torch.bfloat16)
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = {k.__name__: k.launches for k in K.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    want = {name: n * REQUESTS for name, n in PER_REQUEST.items()}
    if launches != want:
        raise RuntimeError(f"launch counts {launches} != expected {want}")

    s3 = out["stage3"]
    for key in ("depth", "photometric_confidence"):
        t = s3[key]
        if tuple(t.shape) != (1, H, W) or not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"stage3 {key}: shape {tuple(t.shape)} or non-finite values")

    plain16 = request(compute_dtype=torch.bfloat16, kernels=False)["stage3"]
    plain32 = request(compute_dtype=torch.float32)["stage3"]
    interval = float(batch["depth_values"][0, 1] - batch["depth_values"][0, 0])  # stage-3 ratio 1
    cmp = {}
    for tag, ref in (("bf16", plain16), ("fp32", plain32)):
        for key in ("depth", "photometric_confidence"):
            med, p99 = quantiles(torch, (s3[key] - ref[key]).abs())
            cmp[f"{tag}_{key}_median"] = med
            cmp[f"{tag}_{key}_p99"] = p99
    # Gate on the same-dtype comparison: the kernel path and the plain path
    # compute the same function in bf16 and differ only where a kernel's fp32
    # sums, taken in another order, round to a neighbouring bf16 value; such
    # flips are rare and the soft-argmin is smooth, so depth stays within a
    # small fraction of the stage-3 plane interval. The fp32 path differs by
    # bf16 quantisation of every feature and volume, which is reported only.
    gate = {
        "depth_median_max": 0.01 * interval,
        "depth_p99_max": 0.25 * interval,
        "conf_median_max": 1e-3,
        "conf_p99_max": 0.05,
    }
    ok = (cmp["bf16_depth_median"] <= gate["depth_median_max"]
          and cmp["bf16_depth_p99"] <= gate["depth_p99_max"]
          and cmp["bf16_photometric_confidence_median"] <= gate["conf_median_max"]
          and cmp["bf16_photometric_confidence_p99"] <= gate["conf_p99_max"])
    emit({
        "phase": "serve", "requests": REQUESTS, "shape": [1, V, H, W, 3], "ndepths": list(NDEPTHS),
        "latency_ms_per_map": lat, "peak_mem_bytes": peak, "launches": launches,
        "depth_interval_mm": interval, "compare": cmp, "gate": gate, "ok": ok,
        "depth_mean_mm": float(s3["depth"].mean()),
    })
    if not ok:
        raise RuntimeError("kernel path disagrees with the plain bf16 path")
    phase_profile(torch, model, lambda: request(compute_dtype=torch.bfloat16))
    return launches


def layer_times(torch, model, request) -> dict:
    """Device ms of each layer over one request, between CUDA events that
    forward hooks record: the FeatureNet's blocks, and per stage the vis head
    (all views) and the cost-reg UNet. The rest of a request is the
    epipoles, hypotheses, K1 and K3."""
    spans, handles = {}, []

    def hooks(name):
        def pre(mod, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans.setdefault(name, []).append([ev])

        def post(mod, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[name][-1].append(ev)

        return pre, post

    named = [(f"feature.{n}", m) for n, m in model.feature.named_children()]
    named += [(f"vis.stage{int(s) + 1}", m) for s, m in model.stage_net.vis.items()]
    named += [(f"cost_reg.stage{int(s) + 1}", m) for s, m in model.cost_regularization.items()]
    for name, mod in named:
        pre, post = hooks(name)
        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    try:
        request()
    finally:
        for h in handles:
            h.remove()
    return {name: sum(a.elapsed_time(b) for a, b in evs) for name, evs in spans.items()}


def phase_profile(torch, model, request, top: int = 15):
    """Where one request's device time goes: ``torch.profiler`` over one
    more bf16 request (after the launch counts were read), device kernel
    time summed by name and by group (the hand-written kernels, cuDNN
    convolutions, PyTorch elementwise and reduction kernels, the rest), and
    the device's busy share of the profiled request's wall time; then the
    device time of each layer over one more request (:func:`layer_times`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((evt.self_device_time_total / 1e3, evt.count, evt.key) for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0), reverse=True)
    device_ms = sum(r[0] for r in rows)
    groups = {"hand_written": 0.0, "convolution": 0.0, "elementwise": 0.0, "other": 0.0}
    for ms, _, key in rows:
        if key.startswith(KERNEL_SYMBOLS):
            groups["hand_written"] += ms
        elif any(tag in key for tag in ("cudnn", "xmma", "cutlass", "convolve", "gemm")):
            groups["convolution"] += ms
        elif "elementwise" in key or "reduce_kernel" in key:
            groups["elementwise"] += ms
        else:
            groups["other"] += ms
    emit({
        "phase": "profile", "wall_ms": wall_ms,
        "device_ms": device_ms if rows else "not measured",
        "busy_share": device_ms / wall_ms if rows else "not measured",
        "groups_ms": groups if rows else "not measured",
        "top": [{"name": k[:100], "ms": ms, "calls": n, "share": ms / device_ms} for ms, n, k in rows[:top]],
        "layers_ms": layer_times(torch, model, request),
    })


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    try:
        from cds_mvsnet_tpu_torch.models import strict_fp32, to_tensors
        from cds_mvsnet_tpu_torch.ops.kernels import _build as kbuild
        from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card", file=sys.stderr)
        return 2

    strict_fp32()
    phase_device(torch, kbuild)
    batch = to_tensors(textured_plane_batch(V=V, H=H, W=W, D=D_FULL, seed=SEED), "cuda")
    dev = torch.device("cuda")
    results = phase_kernels(torch, batch, dev)
    launches = phase_serve(torch, batch, dev)

    kernels = []
    for name, rows in results.items():
        source, replaces = KERNEL_INFO[name]
        # per-request totals at the main-path shapes: K1 runs V-1 times per stage
        mult = (V - 1) if name == "warp_entropy" else 1
        lib = [r["library_ms"] for r in rows]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows) * mult,
            "plain_ms": sum(r["plain_ms"] for r in rows) * mult,
            "bound_ms": sum(r["bound_ms"] for r in rows) * mult,
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
            "library_ms": None if None in lib else sum(lib) * mult,
            "per_stage": [{k: r[k] for k in ("stage", "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
                          for r in rows],
        })
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
