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
   same function, that call's time; K3 and K4, which run on the CUDA
   cores, add a ``bound_halves`` line each with the bytes bound and the
   fp32 FMA floor apart;
   K9 (fp32 and bf16, bit for bit) and K2 in fp32 at the three stage shapes
   of the DTU protocol point (the cascade at 576x768 under refinement), and
   K4 on that point's conv01 input; K4 at each of the FeatureNet's 13
   convs as the feature route (R5) runs them at the serve point (rows
   tagged ``"point": "feature"`` with the layer, beside the layer's cuDNN
   bf16 calls); K9 and K2 in fp32 again at the stage
   shapes of the train CLI's validation batches (the 512x640 DTU train crop
   at 256x320 under refinement; rows tagged ``"point": "train_val"``);
   K5's forward and backward are checked the same way at the three stage
   shapes of the train point (per batch element) and at its ground-truth
   warps (D = 1), each row with the profiler's device time of a call, and
   K5's launch plan at those shapes and route R3's goes on a ``k5_plan``
   line; K6 (timed beside cuDNN's
   two calls and beside K2 then K7 apart), K7, K2 at 16 output
   channels and K8 (per view and over the 4 source views in one launch),
   which only the explicit routes run, at the serve shapes, K7's and K8's
   rows with the profiler's device time of a launch and their launch plans
   on a ``route_plan`` line per stage; K6 and K7 in fp32 (3xTF32 on the
   tensor cores) at the serve stage shapes as the mixed path runs them (rows
   ``"point": "mixed"``) and at the DTU protocol's (``"point": "protocol"``),
   each with its device time, its bound beside one conv's fp32 FMA floor,
   cuDNN's fp32 calls with TF32 off and, for K6, K2 then K7 apart, K6's out0
   and out1 held bit for bit to K2 and K7 in fp32; K1-K4 again at
   the stream point's shapes (C/D/h x w = 32/128/120x160, 16/32/240x320,
   8/8/480x640, K4 on 8 frames at 480x640); K1-K3 at the Tanks and Temples
   stage shapes of scripts/tt_eval.sh's buckets (Family's 32/48/272x480,
   16/32/544x960, 8/8/1088x1920, and stage 1 of the 896x1600 and 544x960
   buckets, 224x400 and 136x240) and K4 on conv01 over 18 images of each
   bucket (rows tagged ``"point": "tt"`` with their bucket); P1 and P2, the probes' kernels,
   at their probes' inputs, P1 on a 192 KB and a 2 MB band, P2 on rows past
   48 KB, bit for bit, each call's ms split into host and device time, P2's
   beside ``torch.gather``'s;
   probes: the probes' entry points (``cds_mvsnet_tpu_torch.tools.
   probe_lane_slice`` and ``probe_gather16``), the path of P1 and P2, with
   their launches;
3. serve: the eval cascade with seeded random weights answers 3 requests at
   1152x864; every kernel's launch count must show that the path ran it; its
   stage-3 depth and confidence are compared with the port's plain path on
   the card in bf16 (the gate) and in fp32 (reported); one fp32 request on
   the fp32 route (K9 and K2 in fp32, launches checked) is held against the
   plain fp32 path (the gate);
   one more request runs under ``torch.profiler`` and the device time is
   summed by kernel name;
   routes: five bf16 requests under the JAX package's warp routes,
   cost-reg fronts and feature route (``models/warp_routes.py``: R1-R5 of
   ``ROUTED``; R5 runs all 13 FeatureNet convs on K4), each with its launch
   counts checked exactly, its stage-3 depth and confidence held to the
   serve gate against the default route on the same weights and batch, and
   its latency beside the default's; R5 also bit for bit against its plain
   twin and, where the serve gate misses, by the JAX route's FeatureNet
   criterion, with each FeatureNet block's device time beside the default
   route's; one R1 and one R5 request run under ``torch.profiler``;
   mixed: the serve point in bf16 with ``cost_dtype=torch.float32`` under
   the fronts ``pallas``, ``pallasf``, ``pallasf3``, ``pallas2`` and
   ``pallas3`` (MIXED), 2 timed requests each with exact launch counts (K1
   12, K4 1, K3 0, K2/K6/K7 in fp32 by front), stage 3 held to the serve
   gate against its plain twin, and reported beside the default request:
   latency per map, depth and confidence against the plain fp32 cascade;
   one request profiled; fp32_routed: one fp32 request under ``v6`` warps
   and the ``pallasf3`` front at the DTU protocol point (K9 12, K6 3 and K2
   3 at O=16, in fp32) held to the serve gate against the fp32 default
   request;
4. train: the train step at the JAX package's train bench point (512x640
   DTU crops, B=2, V=5, D=192, ndepths 48/32/8, refinement, bf16, FeatureNet
   recomputed in the backward, SGD lr 0.01 and weight decay 0.01,
   temperature 0.01) takes 1 warm-up and 3 timed steps on one seeded
   ``synthetic_batch``; the losses must be finite and each K5 kernel must
   launch B·3·(V−1)·2 = 48 times per step; one step's loss and gradients on
   the kernel path are held against the plain bf16 path from the same
   weights (the gate) and the plain fp32 path (reported), and each of that
   step's K5 calls, forward and backward, against the plain versions on its
   own inputs (the gate); a second kernel-path step from the same weights
   must equal the first bit for bit (the gate); one more step runs under
   ``torch.profiler``;
   train_cli: the train CLI (``cds_mvsnet_tpu_torch.cli.train_cli.main``,
   in this process) for one epoch on a synthetic DTU training scan in Yao
   Yao's layout written to disk (5 views of a textured plane, 3 ref views x
   7 lights: 10 steps of 2), with ``configs/config_dtu.json``'s model,
   nviews 4 and SGD settings in bf16 (``--bs 2 --n_devices 1``), then its
   validation (10 fp32 batches of 2); every loss and validation metric
   finite, K5's launches exactly 36 a step and K9's and K2's 18 and 6 a
   validation batch, the parameters on the card, a checkpoint and its
   sidecar written, and ``--resume`` from it restoring the weights without
   training; its s/step, loader-wait share and peak memory beside the train
   phase's s/step; then ``tools/dryrun_multichip.py`` with one ``nccl`` rank
   on the card (a train step and sharded eval through the process group);
5. product: the eval product (``cds_mvsnet_tpu_torch.cli.test_cli.main``)
   on a synthetic DTU-layout scan written to disk (6 views of a textured
   plane at 1600x1200, 5 sources each) at the protocol of
   ``scripts/dtu_eval.sh`` (1152x1536, V=5, D=192, interval scale 1.06,
   ndepths 48/32/8, refinement, gipuma fusion with disparity 0.1 and 2
   consistent views), once with ``--compute_dtype auto`` (bf16 on the card:
   K1-K4) and once with ``fp32`` (K9 and K2 in fp32); each run's launch
   counts per view, its files, each written depth against an in-process
   forward on the same batch, the host synchronisations it makes, then the
   ``normal`` fusion with loose thresholds, ``fuse_view`` on the card
   against the CPU, and one profiled bf16 run for the device's busy share;
   tt: the Family row of ``scripts/tt_eval.sh`` (TT_FLAGS: 10 views, 256
   depths, no refinement, 1088x1920, normal fusion with confidence 0.1, 4
   views, 1 px) through ``test_cli.main`` in bf16 on a synthetic scene in
   the tt layout (11 views of a sphere_scene at 1920x1080, T&T's
   four-number depth line, 10 sources a view), on the seeded weights fitted
   TT_FIT_STEPS bf16 steps on a small sphere scene: launches per map exactly K1
   27, K2 3, K3 3, K4 1, every other kernel 0, each written depth against an
   in-process forward (the product's gate), fused points > 0, view 0's
   ``fuse_view`` on the card against the CPU; maps/s, the fusion's wall
   time and the peak device memory;
6. stream: ``eval/streaming.py`` at its defaults (480x640, window 5, 512
   planes split 128/32/8, temperature 0.01, seeded random weights) on a
   12-view ``sphere_scene`` pushed in order, depth range 425-937 from the
   scene, bf16 (K1-K4) and fp32 (K9, K2): 4 pushes return None and 8 return
   maps, each push's launches exactly PER_PUSH, each map held to the serve
   gate against the plain path of its dtype on the same window; then the
   latency of each push, frames/s, peak memory, depth error against the
   scene's exact depth (reported) and one profiled push, started on an idle
   card, with the hand-written launches the profile saw beside one push's;
7. custom: the custom-scene path (COLMAP workspace -> ``data/colmap.py`` ->
   ``test_cli --dataset general`` at 864x1152 in bf16 -> normal fusion ->
   ``score_points`` and ``eval_depth_map`` against the scene's geometry);
8. tools: the port's ``profile_stages`` (and ``--marginals``),
   ``bench_scan``, ``bench_train`` and ``train_convergence`` through their
   ``main`` at the JAX tools' points, each tool's JSON line on a line of its
   own: exact launches of the prefix requests, the scan's maps and the bf16
   train step, prefix stages bit for bit, ``.ply`` vertex counts equal to
   the line's points, a decreasing loss (``phase_tools``);
9. summary: one ``{"kernels": [...]}`` line (K1-K9, K6 and K7 in fp32 with
   the mixed path's launches, P1 and P2; rows of other points under
   ``<point>_per_stage``, the T&T rows as ``tt_per_stage``), the card line, and last
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
PEAK_TF32_FLOPS = 495e12  # dense TF32 tensor-core rate
SEED = 0
# the train point (tools/bench_train.py of the JAX package)
TRAIN_B, TRAIN_H, TRAIN_W = 2, 512, 640
TRAIN_STEPS = 3
TRAIN_TEMPERATURE = 0.01

# the train CLI's point: configs/config_dtu.json (nviews 4, SGD) in bf16 at
# a batch of 2 on a DTU training scan of 5 views, 3 of them ref views
TRAIN_CLI_BS, TRAIN_CLI_VIEWS, TRAIN_CLI_REFS, TRAIN_CLI_NVIEWS, DTU_LIGHTS, DTU_VAL_BS = 2, 5, (0, 1, 2), 4, 7, 2

# the DTU protocol point of scripts/dtu_eval.sh
DTU_H, DTU_W, DTU_VIEWS, DTU_SRC_H, DTU_SRC_W = 1152, 1536, 6, 1200, 1600
DTU_INFER_FLAGS = ["--dataset", "dtu", "--interval_scale", "1.06", "--num_view", str(V), "--numdepth", str(D_FULL),
                   "--max_h", str(DTU_H), "--max_w", str(DTU_W)]
DTU_FLAGS = [*DTU_INFER_FLAGS, "--filter_method", "gipuma", "--prob_threshold", "0.0,0.0,0.0",
             "--disp_threshold", "0.1", "--num_consistent", "2"]
# loose thresholds of the normal filter, so that points exist to compare
NORMAL_FLAGS = ["--skip_inference", "--filter_method", "normal", "--thres_view", "2", "--thres_disp", "50.0"]

# the stream point: eval/streaming.py's StreamingConfig defaults (480x640,
# window 5, 512 planes split 128/32/8, bf16, temperature 0.01) apart from the
# depth range, which is the 12-view sphere_scene's (425-937)
STREAM_H, STREAM_W, STREAM_WINDOW, STREAM_VIEWS, STREAM_PLANES = 480, 640, 5, 12, 512
STREAM_NDEPTHS = (128, 32, 8)
# the custom-scene point: a sphere_scene written as a COLMAP workspace,
# converted, then test_cli --dataset general at 864x1152 without refinement
# (stage 1 at 108x144 would not halve three times at half resolution)
CUSTOM_VIEWS, CUSTOM_H, CUSTOM_W = 5, 864, 1152
# points of each cloud that score_points sees (every k-th point): with the
# random weights' maps far from the surface, its nearest-neighbour search
# over the full clouds (5M points each) takes minutes
SCORE_POINTS = 100_000
CUSTOM_FLAGS = ["--dataset", "general", "--numdepth", str(D_FULL), "--max_h", str(CUSTOM_H), "--max_w", str(CUSTOM_W),
                "--num_view", str(V), "--no_refinement", "--filter_method", "normal", "--thres_view", "2",
                "--thres_disp", "50.0"]

# the Tanks and Temples point: scripts/tt_eval.sh's Family row (10 views,
# 256 depths, no refinement, 1088x1920, normal fusion with confidence 0.1, 4
# consistent views, 1 px) through test_cli on a synthetic scene in the tt
# layout: 11 views of a sphere_scene at 1920x1080 (the reader pads 4 edge
# rows above and below to 1088), each with 10 sources
TT_H, TT_W, TT_SRC_H, TT_VIEWS, TT_SOURCES, TT_D = 1088, 1920, 1080, 11, 9, 256
TT_FLAGS = ["--dataset", "tt", "--no_refinement", "--interval_scale", "1.0", "--num_view", "10", "--numdepth", "256",
            "--max_h", "1088", "--max_w", "1920", "--filter_method", "normal", "--conf", "0.1,0.1,0.1",
            "--thres_view", "4", "--thres_disp", "1.0"]
# the buckets of tt_eval.sh's table whose stages the kernels phase checks:
# Family's three, and stage 1 of the two others (widths 400 and 240 against
# 32-wide tiles); K4 on conv01 over 2(V-1) images at each bucket
TT_BUCKETS = {"1088x1920": (1, 2, 3), "896x1600": (1,), "544x960": (1,)}
# the T&T phase's weights: the seeded init trained TT_FIT_STEPS bf16 steps
# on a 5-view sphere_scene at TT_FIT_H x TT_FIT_W with the scene's 256
# planes. Random weights give a near-uniform probability over a stage's
# planes (stage 1: 4/48 = 0.083 in the confidence window), all under the
# Family row's threshold of 0.1, so its fusion would keep no point
TT_FIT_STEPS, TT_FIT_H, TT_FIT_W = 60, 256, 320
# the tools ported from the JAX package's tools/, each at that tool's own
# point (its module constants and flag defaults), in the order they run
TOOLS = (("profile_stages", ["--reps", "3"]), ("profile_stages", ["--marginals"]), ("bench_scan", []),
         ("bench_train", ["--bs", str(TRAIN_B)]), ("train_convergence", []))

KERNEL_INFO = {
    "warp_entropy": ("cds_mvsnet_tpu_torch/csrc/warp.cu", "cds_mvsnet_tpu/ops/pallas/warp.py:1342"),
    "conv3d_bn_relu": ("cds_mvsnet_tpu_torch/csrc/conv3d_mma.cuh", "cds_mvsnet_tpu/ops/pallas/conv3d.py:159"),
    "exit_softargmin": ("cds_mvsnet_tpu_torch/csrc/regress.cu", "cds_mvsnet_tpu/ops/pallas/regress.py:224"),
    "dynconv_branches": ("cds_mvsnet_tpu_torch/csrc/dynconv.cu", "cds_mvsnet_tpu/ops/pallas/s2d_sparse.py:239"),
    "warp_sim": ("cds_mvsnet_tpu_torch/csrc/warp.cu", "cds_mvsnet_tpu/ops/pallas/warp_vjp.py:75"),
    "warp_sim_backward": ("cds_mvsnet_tpu_torch/csrc/warp_vjp.cu", "cds_mvsnet_tpu/ops/pallas/warp_vjp.py:92"),
    "warp_gather": ("cds_mvsnet_tpu_torch/csrc/gather.cu", "cds_mvsnet_tpu/ops/pallas/warp.py:1608"),
    "conv3d_bn_relu_fp32": ("cds_mvsnet_tpu_torch/csrc/conv3d.cu", "cds_mvsnet_tpu/ops/pallas/conv3d.py:159"),
    "conv3d_front_fused": ("cds_mvsnet_tpu_torch/csrc/conv3d_fused.cu", "cds_mvsnet_tpu/ops/pallas/conv3d.py:392"),
    "conv3d_down": ("cds_mvsnet_tpu_torch/csrc/conv3d.cu", "cds_mvsnet_tpu/ops/pallas/conv3d.py:490"),
    "conv3d_front_fused_fp32": ("cds_mvsnet_tpu_torch/csrc/conv3d_fused.cu", "cds_mvsnet_tpu/ops/pallas/conv3d.py:392"),
    "conv3d_down_fp32": ("cds_mvsnet_tpu_torch/csrc/conv3d.cu", "cds_mvsnet_tpu/ops/pallas/conv3d.py:490"),
    "conv3d_bn_relu_o16": ("cds_mvsnet_tpu_torch/csrc/conv3d_mma.cuh", "cds_mvsnet_tpu/ops/pallas/conv3d.py:159"),
    "warp_sim_coords": ("cds_mvsnet_tpu_torch/csrc/warp_coords.cu", "cds_mvsnet_tpu/ops/pallas/warp.py:1451"),
    "warp_sim_coords_batched": ("cds_mvsnet_tpu_torch/csrc/warp_coords.cu", "cds_mvsnet_tpu/ops/pallas/warp.py:431"),
    "lane_slice_sum": ("cds_mvsnet_tpu_torch/csrc/lane_slice.cu", "tools/probe_lane_slice.py:44"),
    "row_gather": ("cds_mvsnet_tpu_torch/csrc/gather16.cu", "tools/probe_gather16.py:81"),
    "int16_arith": ("cds_mvsnet_tpu_torch/csrc/gather16.cu", "tools/probe_gather16.py:93"),
}
# the probes' kernels, which only their entry points run
# (cds_mvsnet_tpu_torch/tools/probe_*.py), and their launches in one run of
# each entry point's main
PER_PROBE_RUN = {"lane_slice_sum": 1, "row_gather": 3, "int16_arith": 1}
PROBE_NAMES = tuple(PER_PROBE_RUN)
# kernels whose launches the fp32 product run counts (K2's wrapper serves both routes)
FP32_KERNEL_NAMES = ("warp_gather", "conv3d_bn_relu_fp32")
TRAIN_KERNEL_NAMES = ("warp_sim", "warp_sim_backward")
# the fp32 forms of K6 and K7, which the mixed path (cost_dtype=float32)
# runs: their rows at the mixed serve point are the main ones
MIXED_KERNEL_NAMES = ("conv3d_front_fused_fp32", "conv3d_down_fp32")
# the kernels' symbols as the profiler names them (csrc/*.cu): K1
# warp_entropy_kernel (warp_kernel<C, false> in earlier commits), K5's forward
# warp_kernel, its backward warp_sim_backward_max_kernel (with the
# fixed-point d_src), warp_sim_backward_kernel and warp_sim_backward_finish_kernel
# (to_bf16_kernel in earlier commits); K2 in
# bf16 conv3d_mma_kernel, in fp32 conv3d_tf32_kernel
# (conv3d_bn_relu_kernel in earlier commits), K7 in bf16 conv3d_down_mma_kernel
# (conv3d_bn_relu_kernel in earlier commits, as K7 in fp32 then); K6 in bf16
# conv3d_fused_mma_kernel, in fp32 conv3d_fused_tf32_kernel (conv3d_fused_kernel
# in earlier commits), K7 in fp32 conv3d_down_tf32_kernel; K3
# exit_softargmin_kernel<cols, rows, planes> (a plain function, named
# without "void", in earlier commits, whose csrc this script also reads), K4
# dynconv_kernel<OA>, K9 gather_kernel<T, C> (the lane-group gather)
KERNEL_SYMBOLS = ("void warp_kernel", "void warp_entropy_kernel", "void conv3d_bn_relu_kernel",
                  "void conv3d_mma_kernel", "void conv3d_tf32_kernel",
                  "void exit_softargmin_kernel", "exit_softargmin_kernel",
                  "void dynconv_kernel", "void warp_sim_backward_kernel", "warp_sim_backward_finish_kernel",
                  "warp_sim_backward_max_kernel",
                  "to_bf16_kernel", "void gather_kernel",
                  "void conv3d_fused_kernel", "conv3d_fused_mma_kernel", "void warp_coords_kernel",
                  "void conv3d_down_mma_kernel", "conv3d_fused_tf32_kernel", "void conv3d_down_tf32_kernel",
                  "lane_slice_kernel", "void row_gather_kernel", "void row_gather_direct_kernel",
                  "int16_arith_kernel")
# launches of one request at B=1: K1 once per source view and stage, K2/K3
# once per stage (PER_STAGE), K4 once (conv01 over the whole 2(V-1)-image
# stack)
PER_STAGE = {"warp_entropy": V - 1, "conv3d_bn_relu": 1, "exit_softargmin": 1}
PER_REQUEST = {**{name: 3 * n for name, n in PER_STAGE.items()}, "dynconv_branches": 1}
# launches of one train step: each K5 kernel once per batch element, source
# view and stage for the sweep, and as often for the GT-depth warp
PER_STEP = {name: TRAIN_B * 3 * (V - 1) * 2 for name in TRAIN_KERNEL_NAMES}
# launches of one train CLI step (K5, nviews 4) and of one of its fp32
# validation batches (K9 per batch element, source view and stage; K2 per
# batch element and stage); every other kernel: 0
PER_CLI_STEP = {name: TRAIN_CLI_BS * 3 * (TRAIN_CLI_NVIEWS - 1) * 2 for name in TRAIN_KERNEL_NAMES}
PER_VAL_BATCH = {"warp_gather": DTU_VAL_BS * 3 * (TRAIN_CLI_NVIEWS - 1), "conv3d_bn_relu": DTU_VAL_BS * 3}
# launches per view of the product: bf16 runs K1-K4, fp32 runs K9 and K2
# (and the T&T phase's map, bf16 over 9 source views)
OFF_PATH = {"conv3d_front_fused": 0, "conv3d_down": 0, "warp_sim_coords": 0, "warp_sim_coords_batched": 0,
            **{name: 0 for name in PROBE_NAMES}}
PER_VIEW = {
    "bf16": {"warp_entropy": 3 * (V - 1), "conv3d_bn_relu": 3, "exit_softargmin": 3, "dynconv_branches": 1,
             "warp_gather": 0, "warp_sim": 0, "warp_sim_backward": 0, **OFF_PATH},
    "fp32": {"warp_entropy": 0, "conv3d_bn_relu": 3, "exit_softargmin": 0, "dynconv_branches": 0,
             "warp_gather": 3 * (V - 1), "warp_sim": 0, "warp_sim_backward": 0, **OFF_PATH},
}
PER_TT_VIEW = {**PER_VIEW["bf16"], "warp_entropy": 3 * TT_SOURCES}
# launches per push of the stream once its window is full (every kernel not
# named: 0): bf16 runs K1-K4, fp32 K9 and K2
PER_PUSH = {
    "bf16": {"warp_entropy": 3 * (STREAM_WINDOW - 1), "conv3d_bn_relu": 3, "exit_softargmin": 3,
             "dynconv_branches": 1},
    "fp32": {"warp_gather": 3 * (STREAM_WINDOW - 1), "conv3d_bn_relu": 3},
}
# the routed requests of the routes phase: (warp route per stage, front) and
# the launches of one request at B=1 (every kernel not named: 0). K6, K7 and
# K2's O=16 conv2 run once per stage; K8 once per source view and stage, or
# once per stage over all V-1 views (v6sb)
ROUTED = {
    "R1": ({1: "v6s", 2: "v6sd", 3: "v6sc"}, "pallasf3",
           {"conv3d_front_fused": 3, "conv3d_bn_relu": 3, "warp_sim_coords": 3 * (V - 1), "exit_softargmin": 3,
            "dynconv_branches": 1}),
    "R2": ({1: "v6sb", 2: "v6sb", 3: "v6sb"}, "pallas3",
           {"conv3d_bn_relu": 6, "conv3d_down": 3, "warp_sim_coords_batched": 3, "exit_softargmin": 3,
            "dynconv_branches": 1}),
    "R3": ({1: "v7m", 2: "v7m", 3: "v7m"}, "pallas2",
           {"conv3d_bn_relu": 3, "conv3d_down": 3, "warp_sim": 3 * (V - 1), "exit_softargmin": 3,
            "dynconv_branches": 1}),
    "R4": ({1: "v6", 2: "v6", 3: "v6"}, "pallasf",
           {"conv3d_front_fused": 3, "warp_gather": 3 * (V - 1), "exit_softargmin": 3, "dynconv_branches": 1}),
    # the default warp routes and front with every FeatureNet conv on K4
    # (ROUTE_FEATURE): K4 once a conv, every other count the default's
    "R5": ({}, "pallas", {**PER_REQUEST, "dynconv_branches": 13}),
}
# the feature route of each routed request (the others: the default conv01)
ROUTE_FEATURE = {"R5": "all"}
# the mixed path: the serve point in bf16 with cost_dtype=float32 (the cost
# regularisation in fp32) under each front, the default warp (v8) and
# feature route (conv01); the launches of one request beside K1's 12 and
# K4's 1 (K3 0: an fp32 volume takes the plain tail). K2 in fp32 runs conv0
# (pallas, pallas2, pallas3) and conv2 at O=16 (pallas3, pallasf3), K6 in
# fp32 conv0 and conv1 (pallasf, pallasf3), K7 in fp32 conv1 (pallas2,
# pallas3)
MIXED_REQUESTS = 2
MIXED_BASE = {"warp_entropy": 3 * (V - 1), "dynconv_branches": 1}
MIXED = {
    "pallas": {"conv3d_bn_relu": 3},
    "pallasf": {"conv3d_front_fused": 3},
    "pallasf3": {"conv3d_front_fused": 3, "conv3d_bn_relu": 3},
    "pallas2": {"conv3d_bn_relu": 3, "conv3d_down": 3},
    "pallas3": {"conv3d_bn_relu": 6, "conv3d_down": 3},
}
# the front whose launches of K6 and K7 in fp32 the kernels line reports
MIXED_LAUNCHES = {"conv3d_front_fused_fp32": ("pallasf", "conv3d_front_fused"),
                  "conv3d_down_fp32": ("pallas2", "conv3d_down")}
# one fp32 request under routes at the DTU protocol point: K9 warps every
# stage (v6), K6 in fp32 conv0 and conv1, K2 in fp32 conv2 at O=16
FP32_ROUTED = ({1: "v6", 2: "v6", 3: "v6"}, "pallasf3",
               {"warp_gather": 3 * (V - 1), "conv3d_front_fused": 3, "conv3d_bn_relu": 3})
# which routed request's counts each route-only kernel reports in the
# kernels line (conv3d_bn_relu_o16: R1, whose K2 launches are all conv2's)
ROUTE_LAUNCHES = {"conv3d_front_fused": ("R1", "conv3d_front_fused"), "conv3d_bn_relu_o16": ("R1", "conv3d_bn_relu"),
                  "warp_sim_coords": ("R1", "warp_sim_coords"), "conv3d_down": ("R2", "conv3d_down"),
                  "warp_sim_coords_batched": ("R2", "warp_sim_coords_batched")}


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


def emit_bound_halves(row: dict, name: str) -> None:
    """The two halves of a CUDA-core kernel's bound on a line of their own:
    the bytes over the memory rate and the fp32 FMA floor (operations over
    the fp32 rate); the row's ``bound_ms`` is the larger."""
    emit({"phase": "bound_halves", "kernel": name, "stage": row["stage"], "point": row.get("point", "serve"),
          **({"layer": row["layer"]} if "layer" in row else {}),
          "bytes_bound_ms": row["bytes"] / PEAK_BYTES_PER_S * 1e3, "fma_floor_ms": row["flops"] / PEAK_FP32_FLOPS * 1e3})


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


def phase_kernels(torch, batch, train_batch, stream_scene, dev):
    """Each kernel against its plain version at the main-path shapes, in
    bf16 as the main path runs them: K1-K4 at the serve point's and the
    stream point's (rows tagged ``"point": "stream"``), K5 at the train
    point's; P1 and P2 at their probes'."""
    import torch.nn.functional as F

    from cds_mvsnet_tpu_torch.ops import kernels as K
    from cds_mvsnet_tpu_torch.ops.geometry import relative_warp_transform

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def uniform(shape, lo=-1.0, hi=1.0, dtype=torch.bfloat16):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo).to(dtype).contiguous()

    results = {name: [] for name in (*KERNEL_INFO, "warp_gather_bf16")}
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
            failures.append(f"{name}@{row.get('point', 'main')}:stage{stage}")
        return row

    # P1 and P2 first: their host times before any profiler session
    probe_kernels(torch, dev, record)
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
        route_kernels(torch, batch, uniform, record, s, (C, D, h, w), hyp)

        cascade_kernels(torch, dev, uniform, record, s, (C, D, h, w), hyp, rt)

    # K6 and K7 in fp32 as the mixed path (cost_dtype=float32) runs them
    fp32_front_kernels(torch, uniform, tagged(record, "mixed"), stage_shapes())
    # K4: conv01 over the stack of 2(V-1) images, branches k = 3, 5, 7
    dynconv_kernel(torch, uniform, record, 2 * (V - 1), H, W)
    feature_kernels(torch, uniform, tagged(record, "feature"))
    stream_kernels(torch, dev, uniform, tagged(record, "stream"), stream_scene)
    tt_kernels(torch, dev, uniform, record)

    train_kernels(torch, dev, uniform, record, train_batch)
    protocol_kernels(torch, dev, uniform, record)
    train_val_kernels(torch, dev, uniform, record)
    torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return results


def train_kernels(torch, dev, uniform, record, train_batch):
    """K5, forward and backward, per batch element at the train point's stage
    shapes: source and reference share the stage resolution; stage 1 sweeps
    planes, stages 2 and 3 per-pixel windows (ratios 2 and 1); then the
    ground-truth warps at D = 1 (rows tagged ``"point": "gt"``). Each row
    also carries the profiler's device ms of one call (``device_ms``: the
    backward's memset, kernel and finishing kernel) and of the main kernel
    (``main_device_ms``). Emits K5's launch plan at these shapes and at
    route R3's (``k5_plan``)."""
    from cds_mvsnet_tpu_torch.ops import kernels as K
    from cds_mvsnet_tpu_torch.ops.geometry import relative_warp_transform
    from cds_mvsnet_tpu_torch.ops.kernels import warp_vjp

    interval = 480.0 / (D_FULL - 1)
    th, tw = TRAIN_H // 2, TRAIN_W // 2  # refinement: the cascade runs at half resolution
    plans = []
    card_plan = getattr(warp_vjp, "card_plan", None)  # absent in earlier commits' packages
    for point in ("sweep", "gt"):
        for s, (C, D) in enumerate(zip((32, 16, 8), NDEPTHS), start=1):
            scale = 2 ** (3 - s)
            h, w = th // scale, tw // scale
            cams = train_batch["proj_matrices"][f"stage{s}"]
            rot, trans = relative_warp_transform(cams[:1, 0], cams[:1, 1])
            rt = torch.cat([rot.reshape(9), trans.reshape(3)]).float().contiguous()
            if point == "gt":
                D, hyp = 1, uniform((1, h, w), 560.0, 640.0, torch.float32)
            elif s == 1:
                hyp = torch.linspace(425.0, 905.0, D, device=dev).contiguous()
            else:
                centre = uniform((h, w), 560.0, 640.0, torch.float32)
                steps = torch.arange(D, device=dev, dtype=torch.float32) - (D - 1) // 2
                hyp = (centre[None] + steps[:, None, None] * (4.0 / scale) * interval).contiguous()
            tag = {} if point == "sweep" else {"point": "gt"}
            src, ref = uniform((h, w, C)), uniform((C, h, w))
            ip_k, sim_k = K.warp_sim(src, ref, hyp, rt)
            torch.cuda.synchronize()
            ip_p, sim_p = K.warp_sim_plain(src, ref, hyp, rt)
            # K1's tolerance for in_prod; sim sums C products of the same bf16
            # values, a warped value may sit one bf16 ulp away
            d_ip = (ip_k.float() - ip_p.float()).abs()
            d_sim = (sim_k - sim_p).abs()
            ok = (bool((d_ip <= 2 ** -7 * ip_p.float().abs() + 2 ** -8).all())
                  and bool((d_sim <= 2 ** -7 * ip_p.float().abs().sum(0) + 1e-5).all()))
            io_bytes = (src.numel() * 2 + ref.numel() * 2 + hyp.numel() * 4 + 48 + ip_k.numel() * 2
                        + sim_k.numel() * 4)
            fwd = lambda: K.warp_sim(src, ref, hyp, rt)
            record("warp_sim", s, max(float(d_ip.max()), float(d_sim.max())),
                   "in_prod |d| <= 2^-7|plain| + 2^-8; sim |d| <= 2^-7 sum_C|in_prod| + 1e-5", ok,
                   timed(torch, fwd, 10), timed(torch, lambda: K.warp_sim_plain(src, ref, hyp, rt), 3),
                   None, io_bytes, D * h * w * (11 * C + 12), PEAK_FP32_FLOPS,
                   {"shape": [C, D, h, w], "in_prod_max_abs_err": float(d_ip.max()),
                    "sim_max_abs_err": float(d_sim.max()), "in_prod_mismatches": int((d_ip != 0).sum()),
                    "device_ms": call_device_ms(torch, fwd),
                    "main_device_ms": kernel_device_ms(torch, fwd, "void warp_kernel"), **tag})
            del ip_k, ip_p, d_ip

            # the backward against autograd of the plain forward (the gate, with
            # the bf16 roundings autograd adds inside its partial sums) and
            # against the explicit plain backward (fp32 sums, one rounding)
            g_ip = uniform((C, D, h, w))
            g_sim = uniform((D, h, w), dtype=torch.float32)
            ds_k, dr_k = K.warp_sim_backward(src, ref, hyp, rt, g_ip, g_sim)
            torch.cuda.synchronize()
            src_g, ref_g = src.clone().requires_grad_(), ref.clone().requires_grad_()
            outs = K.warp_sim_plain(src_g, ref_g, hyp, rt)
            plain_bwd = lambda: torch.autograd.grad(outs, (src_g, ref_g), (g_ip, g_sim), retain_graph=True)
            ds_p, dr_p = plain_bwd()
            ds_e, dr_e = K.warp_sim_backward_plain(src, ref, hyp, rt, g_ip, g_sim)
            # the plain backward on |inputs| sums |terms| behind each element
            abs_terms = K.warp_sim_backward_plain(src.abs(), ref.abs(), hyp, rt, g_ip.abs(), g_sim.abs())
            errs, rels, ok = [], [], True
            for got, want, explicit, s_abs in zip((ds_k, dr_k), (ds_p, dr_p), (ds_e, dr_e), abs_terms):
                d = (got.float() - want.float()).abs()
                errs.append(float(d.max()))
                rels.append(float((got.float() - want.float()).norm() / want.float().norm()))
                ok &= bool((d <= 2 ** -6 * (want.float().abs() + s_abs.float()) + 1e-6).all()) and rels[-1] <= 1e-2
                d_e = (got.float() - explicit.float()).abs()
                ok &= bool((d_e <= 2 ** -7 * (explicit.float().abs() + s_abs.float()) + 1e-6).all())
            bwd_bytes = (src.numel() * 2 + ref.numel() * 2 + hyp.numel() * 4 + 48 + g_ip.numel() * 2
                         + g_sim.numel() * 4 + ds_k.numel() * 2 + dr_k.numel() * 2)
            bwd = lambda: K.warp_sim_backward(src, ref, hyp, rt, g_ip, g_sim)
            record("warp_sim_backward", s, max(errs),
                   "vs autograd of the plain forward: |d| <= 2^-6(|plain| + sum|terms|) and rel L2 <= 1e-2; "
                   "vs the explicit plain backward: |d| <= 2^-7(|plain| + sum|terms|)", ok,
                   timed(torch, bwd, 10), timed(torch, plain_bwd, 3),
                   None, bwd_bytes, D * h * w * (20 * C + 12), PEAK_FP32_FLOPS,
                   {"shape": [C, D, h, w], "d_src_max_abs_err": errs[0], "d_ref_max_abs_err": errs[1],
                    "d_src_rel_l2": rels[0], "d_ref_rel_l2": rels[1],
                    "explicit_plain_ms": timed(torch, lambda: K.warp_sim_backward_plain(src, ref, hyp, rt, g_ip,
                                                                                        g_sim), 3),
                    "device_ms": call_device_ms(torch, bwd),
                    "main_device_ms": kernel_device_ms(torch, bwd, "void warp_sim_backward_kernel"), **tag})
            del outs, ds_p, dr_p, g_ip
            if card_plan is not None:
                for kernel in ("forward", "backward"):
                    plans.append({"point": point, "stage": s, "kernel": kernel, "shape": [C, D, h, w],
                                  **card_plan(kernel, C, D, h, w)})
    if card_plan is not None:
        for s, (C, D, h, w) in enumerate(stage_shapes(), start=1):  # route R3 (v7m) runs the forward
            plans.append({"point": "r3", "stage": s, "kernel": "forward", "shape": [C, D, h, w],
                          **card_plan("forward", C, D, h, w)})
        emit({"phase": "k5_plan", "plans": plans})


def cascade_kernels(torch, dev, uniform, record, s, shape, hyp, rt):
    """K1, K2 and K3 against their plain versions at one stage shape of the
    eval cascade, bf16 as the main path runs them: ``hyp`` the stage's
    hypotheses, ``rt`` the 12-scalar warp of one (ref, src) pair."""
    import torch.nn.functional as F

    from cds_mvsnet_tpu_torch.ops import kernels as K
    from cds_mvsnet_tpu_torch.ops.kernels import warp as k1_module

    card_plan = getattr(k1_module, "warp_entropy_card_plan", None)  # absent in earlier commits' packages
    C, D, h, w = shape
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
           {"entropy_max_abs_err": float(d_ent.max()), "in_prod_exact_frac": float((d_ip == 0).float().mean()),
            "device_ms": kernel_device_ms(torch, lambda: K.warp_entropy(src, ref, hyp, rt), "warp_entropy_kernel"),
            "plan": card_plan(C, h, w) if card_plan else None})
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
    # one output channel: the CUDA cores' fp32 rate, not the tensor cores'
    k3_bytes = yx.numel() * 2 + wp.numel() * 4 + hyp.numel() * 4 + 2 * h * w * 4
    k3_flops = 2 * 216 * D * h * w
    row = record("exit_softargmin", s, float(d_dep.max()), "depth |d| <= 1e-2 mm; conf |d| <= 1e-4 off truncation boundaries", ok,
           timed(torch, lambda: K.exit_softargmin(yx, wp, hyp), 5),
           timed(torch, lambda: K.exit_softargmin_plain(yx, wp, hyp), 3),
           None, k3_bytes, k3_flops, PEAK_FP32_FLOPS,
           {"conf_max_abs_err_safe": float(d_conf[safe].max()),
            "conf_diff_frac": float((d_conf > 1e-4).float().mean()),
            "near_boundary_frac": float((~safe).float().mean()),
            "device_ms": kernel_device_ms(torch, lambda: K.exit_softargmin(yx, wp, hyp), "exit_softargmin_kernel",
                                          reps=5)})
    emit_bound_halves(row, "exit_softargmin")
    del yx, dk, dp, ck, cp, logits


def dynconv_kernel(torch, uniform, record, N, H, W):
    """K4 against its plain version on conv01's stack of ``N`` images at
    ``H x W``: the branches k = 3, 5, 7."""
    import torch.nn.functional as F

    from cds_mvsnet_tpu_torch.ops import kernels as K

    x = uniform((N, 8, H, W))
    ws = [uniform((11, 8, k, k), -(8 * k * k) ** -0.5, (8 * k * k) ** -0.5, torch.float32) for k in (3, 5, 7)]
    o_k = K.dynconv_branches(x, ws)
    torch.cuda.synchronize()
    o_p = K.dynconv_branches_plain(x, ws)
    d = (o_k.float() - o_p.float()).abs()
    # the plain version's (c, ky, kx) fp32 chain, which the bf16 cascade's
    # near-argmax branch mixture needs (PERF.md §6): bit for bit
    ok = torch.equal(o_k, o_p)
    wsb = [w_.to(torch.bfloat16) for w_ in ws]
    # the contract keeps K4 on the CUDA cores: its floor is the fp32 FMA rate
    k4_bytes = x.numel() * 2 + sum(w_.numel() * 4 for w_ in ws) + o_k.numel() * 2
    k4_flops = 2 * N * H * W * 11 * 8 * (9 + 25 + 49)
    row = record("dynconv_branches", 3, float(d.max()), "bit for bit (torch.equal)", ok,
           timed(torch, lambda: K.dynconv_branches(x, ws), 5),
           timed(torch, lambda: K.dynconv_branches_plain(x, ws), 3),
           timed(torch, lambda: [F.conv2d(x, w_, padding=w_.shape[-1] // 2) for w_ in wsb], 5),
           k4_bytes, k4_flops, PEAK_FP32_FLOPS,
           {"exact_frac": float((d == 0).float().mean()),
            "device_ms": kernel_device_ms(torch, lambda: K.dynconv_branches(x, ws), "dynconv_kernel", reps=5)})
    emit_bound_halves(row, "dynconv_branches")
    del x, o_k, o_p, d


def feature_kernels(torch, uniform, record):
    """K4 at each of the FeatureNet's 13 convs as the feature route runs
    them over the stack of 2(V-1) images at the serve point
    (``feature_net.k4_forms``), against its plain version bit for bit,
    beside the same layer's cuDNN bf16 ``F.conv2d`` calls (one a branch, the
    library column), each also by device time; stage 3, 2, 1 = output at
    1/1, 1/2, 1/4 of 864x1152."""
    import torch.nn.functional as F

    from cds_mvsnet_tpu_torch.models.feature_net import k4_forms
    from cds_mvsnet_tpu_torch.ops import kernels as K

    N = 2 * (V - 1)
    for layer, I_, OA, ks, stride, h, w in k4_forms(H, W):
        x = uniform((N, I_, h, w))
        ws = [uniform((OA, I_, k, k), -(I_ * k * k) ** -0.5, (I_ * k * k) ** -0.5, torch.float32) for k in ks]
        o_k = K.dynconv_branches(x, ws, stride=stride)
        torch.cuda.synchronize()
        o_p = K.dynconv_branches_plain(x, ws, stride)
        d = (o_k.float() - o_p.float()).abs()
        wsb = [w_.to(torch.bfloat16) for w_ in ws]

        def library():
            return [F.conv2d(x, w_, stride=stride, padding=w_.shape[-1] // 2) for w_ in wsb]

        Ho, Wo = o_k.shape[-2:]
        row = record("dynconv_branches", {H: 3, H // 2: 2, H // 4: 1}[h // stride], float(d.max()),
                     "bit for bit (torch.equal)", torch.equal(o_k, o_p),
                     timed(torch, lambda: K.dynconv_branches(x, ws, stride=stride), 5),
                     timed(torch, lambda: K.dynconv_branches_plain(x, ws, stride), 3),
                     timed(torch, library, 5),
                     x.numel() * 2 + sum(w_.numel() * 4 for w_ in ws) + o_k.numel() * 2,
                     2 * N * Ho * Wo * OA * I_ * sum(k * k for k in ks), PEAK_FP32_FLOPS,
                     {"layer": layer, "form": {"I": I_, "OA": OA, "k": list(ks), "stride": stride, "in": [N, h, w]},
                      "exact_frac": float((d == 0).float().mean()),
                      "device_ms": call_device_ms(torch, lambda: K.dynconv_branches(x, ws, stride=stride), reps=5),
                      "library_device_ms": call_device_ms(torch, library, reps=5)})
        emit_bound_halves(row, "dynconv_branches")
        del x, ws, wsb, o_k, o_p, d


def tagged(record, point: str, **more):
    """``record`` with ``"point": point`` (and ``more``) added to each row's
    extras."""
    def rec(*args):
        extra = dict(args[11]) if len(args) > 11 else {}
        return record(*args[:11], {**extra, "point": point, **more})

    return rec


def stream_cams(cams):
    """Per-stage packed cameras ``(1, V, 2, 4, 4)`` of a window of
    full-resolution cameras ``(V, 2, 4, 4)``, scaled as
    ``eval/streaming.py`` scales them."""
    out = {}
    for i, scale in enumerate((1.0, 2.0, 4.0)):
        m = cams.copy()
        m[:, 1, :2, :] *= scale / 4.0
        out[f"stage{i + 1}"] = m[None]
    return out


def stream_stage_shapes():
    """(C, D, h, w) of each stage at the stream point."""
    return [(32, STREAM_NDEPTHS[0], STREAM_H // 4, STREAM_W // 4),
            (16, STREAM_NDEPTHS[1], STREAM_H // 2, STREAM_W // 2), (8, STREAM_NDEPTHS[2], STREAM_H, STREAM_W)]


def stream_kernels(torch, dev, uniform, record, scene):
    """K1-K3 at the stream point's stage shapes, on the warp between the
    first window's reference and its first source view, and K4 on its stack
    of 2(window-1) frames at 480x640."""
    from cds_mvsnet_tpu_torch.ops.geometry import relative_warp_transform

    cams = stream_cams(scene["cams"][STREAM_WINDOW - 1::-1])  # the first full window, newest first
    interval = (scene["depth_max"] - scene["depth_min"]) / (STREAM_PLANES - 1)
    for s, (C, D, h, w) in enumerate(stream_stage_shapes(), start=1):
        m = torch.as_tensor(cams[f"stage{s}"], device=dev)
        rot, trans = relative_warp_transform(m[:, 0], m[:, 1])
        rt = torch.cat([rot.reshape(9), trans.reshape(3)]).float().contiguous()
        if s == 1:
            hyp = torch.linspace(scene["depth_min"], scene["depth_max"], D, device=dev).contiguous()
        else:  # per-pixel windows around a smooth depth map, ratios 2 and 1
            centre = uniform((h, w), 560.0, 640.0, torch.float32)
            steps = torch.arange(D, device=dev, dtype=torch.float32) - (D - 1) // 2
            hyp = (centre[None] + steps[:, None, None] * (2.0, 1.0)[s - 2] * interval).contiguous()
        cascade_kernels(torch, dev, uniform, record, s, (C, D, h, w), hyp, rt)
    dynconv_kernel(torch, uniform, record, 2 * (STREAM_WINDOW - 1), STREAM_H, STREAM_W)


def tt_stage_shapes(bh: int, bw: int):
    """(C, D, h, w) of each stage at a T&T bucket of ``bh x bw``."""
    return [(32, NDEPTHS[0], bh // 4, bw // 4), (16, NDEPTHS[1], bh // 2, bw // 2), (8, NDEPTHS[2], bh, bw)]


def tt_kernels(torch, dev, uniform, record):
    """K1-K3 at the T&T buckets' stage shapes (TT_BUCKETS: Family's three
    stages at 272x480, 544x960 and 1088x1920, and stage 1 of the 896x1600
    and 544x960 buckets, 224x400 and 136x240, whose widths are no multiple
    of 32), on the warp between the first two views of a textured plane at
    the bucket, and K4 on conv01 over 2(V-1) = 18 images of each bucket;
    rows tagged ``"point": "tt"`` with their bucket."""
    from cds_mvsnet_tpu_torch.ops.geometry import relative_warp_transform
    from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

    interval = (937.0 - 425.0) / TT_D  # the T&T scene's depth line
    for bucket, stages in TT_BUCKETS.items():
        bh, bw = (int(x) for x in bucket.split("x"))
        rec = tagged(record, "tt", bucket=bucket)
        cams = textured_plane_batch(V=2, H=bh, W=bw, D=TT_D, seed=SEED)["proj_matrices"]
        for s in stages:
            C, D, h, w = tt_stage_shapes(bh, bw)[s - 1]
            m = torch.as_tensor(cams[f"stage{s}"], device=dev)
            rot, trans = relative_warp_transform(m[:, 0], m[:, 1])
            rt = torch.cat([rot.reshape(9), trans.reshape(3)]).float().contiguous()
            if s == 1:
                hyp = torch.linspace(425.0, 937.0, D, device=dev).contiguous()
            else:  # per-pixel windows around a smooth depth map, ratios 2 and 1
                centre = uniform((h, w), 560.0, 640.0, torch.float32)
                steps = torch.arange(D, device=dev, dtype=torch.float32) - (D - 1) // 2
                hyp = (centre[None] + steps[:, None, None] * (2.0, 1.0)[s - 2] * interval).contiguous()
            cascade_kernels(torch, dev, uniform, rec, s, (C, D, h, w), hyp, rt)
            torch.cuda.empty_cache()
        dynconv_kernel(torch, uniform, rec, 2 * TT_SOURCES, bh, bw)
        torch.cuda.empty_cache()


def host_ms(torch, fn, reps: int) -> float:
    """Host ms of one call of ``fn``: the host clock around the enqueue of
    ``reps`` back-to-back calls (no sync inside), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / reps


def probe_kernels(torch, dev, record):
    """P1 at the probe's input (8 rows, nseg 4, ``x = arange``, offsets
    ``128·i``), on a 192 KB band (nseg 48) and on a 2 MB band (nseg 512),
    both with seeded values at unaligned offsets (rows tagged ``"point":
    "wide"``); P2's three gather forms and the int16 arithmetic at the
    probe's (64, 128) seeded inputs, and the three forms on rows past 48 KB,
    (64, 16384) fp32 and (8, 65536) bf16 sources (``"wide"``). Each must
    equal its plain version bit for bit. Each row holds the call's ``ms``
    (CUDA events around back-to-back calls), ``host_ms`` (the host clock
    around their enqueue) and ``device_ms`` (the kernel under the profiler);
    P2's rows hold ``torch.gather``'s three beside them. Every time is taken
    before the first device time: a ``torch.profiler`` session leaves each
    later launch of the process slower on the host (PERF.md). The bound
    counts the bytes the call needs: for P1 the slices its starts name, each
    once."""
    import numpy as np

    from cds_mvsnet_tpu_torch.ops import kernels as K
    from cds_mvsnet_tpu_torch.tools.probe_gather16 import FORMS, inputs

    cases = []  # [name, stage, kernel call, plain call, library call or None, bytes, flops, extra]

    def check(name, stage, call, plain, library, bytes_moved, flops, extra):
        got = call()
        torch.cuda.synchronize()
        want = plain()
        extra.update(max_abs_err=float((got - want).nan_to_num().abs().max()),
                     ok=torch.equal(got.view(torch.int32), want.view(torch.int32)))
        cases.append([name, stage, call, plain, library, bytes_moved(got), flops, extra])

    rng = np.random.default_rng(SEED)
    for nseg in (4, 48, 512):
        if nseg == 4:
            x = torch.arange(8 * 128 * nseg, dtype=torch.float32, device=dev).reshape(8, -1)
            offs = torch.arange(nseg, dtype=torch.int32, device=dev) * 128
        else:
            x = torch.as_tensor(rng.standard_normal((8, 128 * nseg)).astype(np.float32), device=dev)
            offs = torch.as_tensor(rng.integers(0, 128 * nseg, nseg).astype(np.int32), device=dev)
        starts = (torch.div(offs.long(), 128, rounding_mode="floor") * 128).clamp(0, 128 * (nseg - 1))
        slices = int(torch.unique(starts).numel())
        check("lane_slice_sum", f"nseg{nseg}", lambda x=x, offs=offs: K.lane_slice_sum(x, offs),
              lambda x=x, offs=offs: K.lane_slice_sum_plain(x, offs), None,
              lambda got, x=x, nseg=nseg, slices=slices: (x.shape[0] * 128 * slices + nseg + got.numel()) * 4,
              x.numel(), {"shape": list(x.shape), "offsets": offs.tolist()[:8], "slices_read": slices,
                          **({"point": "wide"} if nseg > 4 else {})})
    src_np, idx_np = inputs()
    shapes = [(torch.as_tensor(src_np, device=dev), torch.as_tensor(idx_np, device=dev), None)]
    for (R, n), sdt in (((64, 16384), torch.float32), ((8, 65536), torch.bfloat16)):
        g = np.random.default_rng(SEED)
        src = torch.as_tensor(g.standard_normal((R, n)).astype(np.float32), device=dev).to(sdt)
        idx = torch.as_tensor(g.integers(-n - 64, n + 64, (R, n)).astype(np.int32), device=dev)
        shapes.append((src, idx, "wide"))
    for src, idx, point in shapes:
        idx64 = idx.long().remainder(src.shape[1])  # torch.gather takes no index outside [0, L)
        for form, (vdt, idt) in FORMS.items():
            values = src.to(vdt)
            check("row_gather", form if point is None else f"{form}@{src.shape[0]}x{src.shape[1]}",
                  lambda src=src, idx=idx, vdt=vdt, idt=idt: K.row_gather(src, idx, vdt, idt),
                  lambda src=src, idx=idx, vdt=vdt, idt=idt: K.row_gather_plain(src, idx, vdt, idt),
                  lambda values=values, idx64=idx64: torch.gather(values, 1, idx64),
                  lambda got, src=src, idx=idx: src.numel() * src.element_size() + idx.numel() * 4 + got.numel() * 4,
                  0, {"shape": list(src.shape), "source": str(src.dtype).replace("torch.", ""),
                      "library": "torch.gather on the values in their type, int64 indices in [0, L)",
                      **({"point": point} if point else {})})
    src = shapes[0][0]
    check("int16_arith", "i16_arith", lambda: K.int16_arith(src), lambda: K.int16_arith_plain(src), None,
          lambda got: 2 * src.numel() * 4, src.numel(), {"shape": list(src.shape)})
    for case in cases:  # times first
        name, _, call, plain, library, _, _, extra = case
        extra.update(ms=timed(torch, call, 100), host_ms=host_ms(torch, call, 100), plain_ms=timed(torch, plain, 10))
        if library is not None:
            extra.update(library_ms=timed(torch, library, 100), library_host_ms=host_ms(torch, library, 100))
    symbols = {"lane_slice_sum": "lane_slice_kernel", "row_gather": "row_gather", "int16_arith": "int16_arith"}
    for name, stage, call, plain, library, bytes_moved, flops, extra in cases:  # then device times
        extra["device_ms"] = kernel_device_ms(torch, call, symbols[name])
        if library is not None:
            extra["library_device_ms"] = kernel_device_ms(torch, library, "gather")
        record(name, stage, extra.pop("max_abs_err"), "bit for bit", extra.pop("ok"), extra.pop("ms"),
               extra.pop("plain_ms"), extra.pop("library_ms", None), bytes_moved, flops, PEAK_FP32_FLOPS, extra)


def route_kernels(torch, batch, uniform, record, s, shape, hyp):
    """The kernels only the explicit routes run, at stage ``s``'s serve
    shape: K8 per view and over the V-1 source views in one launch (the
    plane sweep of ``hyp`` to each source view of the serve batch), then K6
    on the mean volume's shape, K7 on conv0's and K2 at O=16 on conv2's."""
    import torch.nn.functional as F

    from cds_mvsnet_tpu_torch.ops import kernels as K
    from cds_mvsnet_tpu_torch.ops.geometry import relative_warp_transform, sweep_coords

    C, D, h, w = shape
    cams = batch["proj_matrices"][f"stage{s}"]
    views = []
    for v in range(1, V):
        rot, trans = relative_warp_transform(cams[:, 0], cams[:, v])
        px, py = sweep_coords(rot, trans, hyp[None], h, w)
        views.append((uniform((h, w, C)), uniform((C, h, w)), px.reshape(D, h, w).contiguous(),
                      py.reshape(D, h, w).contiguous()))
    one = views[0]
    ip_k, sim_k = K.warp_sim_coords(*one)
    torch.cuda.synchronize()
    ip_p, sim_p = K.warp_sim_coords_plain(*one)
    # the same corners, weights, op-by-op sums and product as the plain
    # version: in_prod bit for bit; sim sums C fp32 products in another order
    d_sim = (sim_k - sim_p).abs()
    ok = torch.equal(ip_k, ip_p) and bool((d_sim <= 1e-5 * ip_p.float().abs().sum(0) + 1e-30).all())
    view_bytes = (one[0].numel() + one[1].numel()) * 2 + 2 * one[2].numel() * 4 + ip_k.numel() * 2 + sim_k.numel() * 4
    view_flops = D * h * w * (11 * C + 20)
    record("warp_sim_coords", s, float((ip_k.float() - ip_p.float()).abs().max()),
           "in_prod bit for bit; sim |d| <= 1e-5 sum_C|in_prod|", ok,
           timed(torch, lambda: K.warp_sim_coords(*one), 10), timed(torch, lambda: K.warp_sim_coords_plain(*one), 2),
           None, view_bytes, view_flops, PEAK_FP32_FLOPS,
           {"shape": [C, D, h, w], "sim_max_abs_err": float(d_sim.max()),
            "sim_max_rel_err": float((d_sim / (ip_p.float().abs().sum(0) + 1e-30)).max()),
            "device_ms": kernel_device_ms(torch, lambda: K.warp_sim_coords(*one), "warp_coords_kernel", reps=10)})
    del ip_k, ip_p, sim_k, sim_p, d_sim
    stacked = [torch.stack(t).contiguous() for t in zip(*views)]
    ip_b, sim_b = K.warp_sim_coords_batched(*stacked)
    torch.cuda.synchronize()
    err = 0.0
    for i in range(V - 1):  # the same body as the per-view launch: bit for bit
        ip_v, sim_v = K.warp_sim_coords(*views[i])
        err = max(err, float((ip_b[i].float() - ip_v.float()).abs().max()), float((sim_b[i] - sim_v).abs().max()))
    del ip_b, sim_b, ip_v, sim_v
    record("warp_sim_coords_batched", s, err, f"bit for bit against {V - 1} per-view launches", err == 0.0,
           timed(torch, lambda: K.warp_sim_coords_batched(*stacked), 5),
           timed(torch, lambda: K.warp_sim_coords_batched_plain(*stacked), 1),
           None, (V - 1) * view_bytes, (V - 1) * view_flops, PEAK_FP32_FLOPS,
           {"shape": [V - 1, C, D, h, w], "device_ms": kernel_device_ms(
               torch, lambda: K.warp_sim_coords_batched(*stacked), "warp_coords_kernel", reps=5)})
    del views, stacked, one

    def weights(o, c):
        bound_w = (27 * c) ** -0.5
        return uniform((o, c, 3, 3, 3), -bound_w, bound_w, torch.float32), uniform((o,), -0.1, 0.1, torch.float32)

    def one_ulp(got, want):
        d = (got.float() - want.float()).abs()
        return float(d.max()), bool((d <= 2 ** -7 * want.float().abs() + 1e-3).all())

    def bf(wb):
        return [t.to(torch.bfloat16) for t in wb]

    # K6: out0 against K2's plain version, out1 against K7's plain version
    # on the kernel's own out0 (a flipped ulp of out0 does not propagate);
    # timed beside cuDNN's two calls and beside K2 then K7 apart
    vol = uniform((C, D, h, w))
    wb0, wb1 = weights(8, C), weights(16, 8)
    o0, o1 = K.conv3d_front_fused(vol, *wb0, *wb1)
    torch.cuda.synchronize()
    e0, ok0 = one_ulp(o0, K.conv3d_bn_relu_plain(vol, *wb0))
    e1, ok1 = one_ulp(o1, K.conv3d_down_plain(o0, *wb1))
    # K6's conv1 runs K7-fp32's step (csrc/conv3d_tf32.cuh) on out0:
    # K7 in fp32 on out0's values, rounded to bf16, bit for bit
    same_as_k2_k7 = torch.equal(o0, K.conv3d_bn_relu(vol, *wb0)) and torch.equal(
        o1, K.conv3d_down(o0.float(), *wb1).to(torch.bfloat16))
    lw0, lw1 = bf(wb0), bf(wb1)
    Do, ho, wo = D // 2, h // 2, w // 2
    record("conv3d_front_fused", s, max(e0, e1), "out0 vs K2's plain, out1 vs K7's plain on out0: "
           "|d| <= 2^-7|plain| + 1e-3 (one bf16 ulp)", ok0 and ok1,
           timed(torch, lambda: K.conv3d_front_fused(vol, *wb0, *wb1), 5),
           timed(torch, lambda: K.conv3d_front_fused_plain(vol, *wb0, *wb1), 2),
           timed(torch, lambda: F.conv3d(F.conv3d(vol[None], *lw0, padding=1).relu_(), *lw1, stride=2,
                                         padding=1).relu_(), 5),
           (vol.numel() + o0.numel() + o1.numel()) * 2 + sum(t.numel() * 4 for t in (*wb0, *wb1)),
           2 * 27 * C * 8 * D * h * w + 2 * 27 * 8 * 16 * Do * ho * wo, PEAK_BF16_FLOPS,
           {"shape": [C, D, h, w], "out0_max_abs_err": e0, "out1_max_abs_err": e1,
            "equal_to_k2_then_k7": same_as_k2_k7,
            "k2_plus_k7_ms": timed(torch, lambda: K.conv3d_down(K.conv3d_bn_relu(vol, *wb0), *wb1), 5),
            "library": "two calls: F.conv3d+ReLU (conv0), then F.conv3d stride 2+ReLU (conv1)"})
    del vol, o0, o1

    # K7 on conv0's shape, K2 at O=16 on conv2's
    for name, x, wb, stride in (("conv3d_down", uniform((8, D, h, w)), weights(16, 8), 2),
                                ("conv3d_bn_relu_o16", uniform((16, Do, ho, wo)), weights(16, 16), 1)):
        fn = K.conv3d_down if stride == 2 else K.conv3d_bn_relu
        plain = K.conv3d_down_plain if stride == 2 else K.conv3d_bn_relu_plain
        y = fn(x, *wb)
        torch.cuda.synchronize()
        err, ok = one_ulp(y, plain(x, *wb))
        lw = bf(wb)
        extra = {"shape": list(x.shape)}
        if stride == 2:
            extra["device_ms"] = kernel_device_ms(torch, lambda: fn(x, *wb), "conv3d_down_mma_kernel", reps=10)
        record(name, s, err, "|d| <= 2^-7|plain| + 1e-3 (one bf16 ulp)", ok,
               timed(torch, lambda: fn(x, *wb), 5), timed(torch, lambda: plain(x, *wb), 3),
               timed(torch, lambda: F.conv3d(x[None], *lw, stride=stride, padding=1).relu_(), 5),
               (x.numel() + y.numel()) * 2 + sum(t.numel() * 4 for t in wb),
               2 * 27 * x.shape[0] * 16 * y[0].numel(), PEAK_BF16_FLOPS, extra)
        del x, y
    route_plans(s, (C, D, h, w))


def route_plans(s, shape) -> None:
    """K7's and K8's launch plans at stage ``s``'s serve shape, as their
    launchers make them on the card (``route_plan`` line): K7 on conv0's
    output (its tile, tiles, blocks, registers, blocks an SM, shared bytes),
    K8 per view and over the V-1 source views (lanes a pixel, pixels a
    block, chunk, chunks, blocks, registers, blocks an SM, shared bytes)."""
    import ctypes

    from cds_mvsnet_tpu_torch.ops.kernels import _build
    from cds_mvsnet_tpu_torch.ops.kernels import conv3d as k7_module
    from cds_mvsnet_tpu_torch.ops.kernels import warp_coords as k8_module
    from cds_mvsnet_tpu_torch.ops.kernels._launch import I, P, entry

    C, D, h, w = shape
    keys = ("tile_z", "tile_y", "tile_x", "tiles", "blocks", "registers", "blocks_per_sm", "shared_bytes")
    out = (ctypes.c_int * len(keys))()
    lib, fn = entry("conv3d", "conv3d_down_plan", [I] * 5 + [P])
    _build.check(lib, fn(16, 8, D, h, w, ctypes.cast(out, P)), "conv3d_down_plan")
    emit({"phase": "route_plan", "stage": s,
          "conv3d_down": {"shape": [8, D, h, w], **dict(zip(keys, out)),
                          "box_bytes": k7_module.launch_plan(8, D, h, w)["box_bytes"]},
          "warp_sim_coords": {"shape": [C, D, h, w], **k8_module.card_plan(1, C, D, h, w)},
          "warp_sim_coords_batched": {"shape": [V - 1, C, D, h, w], **k8_module.card_plan(V - 1, C, D, h, w)}})


def fp32_front_kernels(torch, uniform, record, shapes) -> None:
    """K6 and K7 in fp32 (3xTF32 on the tensor cores) at the stage ``shapes``
    of a point: K6 on the volume mean's shape, K7 on conv0's output. Gates:
    each output within 1e-5 of the sum of |terms| + 1e-7 of its plain
    version (K6's out1 on its own out0), and bit for bit K6's out0 with K2 in
    fp32 and its out1 with K7 in fp32 on out0 (the shared bodies of
    csrc/conv3d_tf32.cuh). Each row has the profiler's device ms, the bound
    of the three TF32 products beside one conv's fp32 FMA floor, cuDNN's
    fp32 calls (TF32 off) and, for K6, K2 then K7 apart."""
    import torch.nn.functional as F

    from cds_mvsnet_tpu_torch.ops import kernels as K

    def weights(o, c):
        bound_w = (27 * c) ** -0.5
        return uniform((o, c, 3, 3, 3), -bound_w, bound_w, torch.float32), uniform((o,), -0.1, 0.1, torch.float32)

    def within(got, want, x, w, b, stride):
        terms = F.conv3d(x.abs()[None], w.abs(), stride=stride, padding=1)[0] + b.abs()[:, None, None, None]
        d = (got - want).abs()
        return float(d.max()), bool((d <= 1e-5 * terms + 1e-7).all())

    for s, (C, D, h, w) in enumerate(shapes, start=1):
        vol = uniform((C, D, h, w), dtype=torch.float32)
        wb0, wb1 = weights(8, C), weights(16, 8)
        o0, o1 = K.conv3d_front_fused(vol, *wb0, *wb1)
        torch.cuda.synchronize()
        e0, ok0 = within(o0, K.conv3d_bn_relu_plain(vol, *wb0), vol, *wb0, 1)
        e1, ok1 = within(o1, K.conv3d_down_plain(o0, *wb1), o0, *wb1, 2)
        same = {"out0_equals_k2_fp32": torch.equal(o0, K.conv3d_bn_relu(vol, *wb0)),
                "out1_equals_k7_fp32": torch.equal(o1, K.conv3d_down(o0, *wb1))}
        Do, ho, wo = D // 2, h // 2, w // 2
        flops = 2 * 27 * C * 8 * D * h * w + 2 * 27 * 8 * 16 * Do * ho * wo
        record("conv3d_front_fused_fp32", s, max(e0, e1),
               "out0 vs K2's plain, out1 vs K7's plain on out0: |d| <= 1e-5 sum|terms| + 1e-7; out0 == K2-fp32, "
               "out1 == K7-fp32 on out0", ok0 and ok1 and all(same.values()),
               timed(torch, lambda: K.conv3d_front_fused(vol, *wb0, *wb1), 5),
               timed(torch, lambda: K.conv3d_front_fused_plain(vol, *wb0, *wb1), 2),
               timed(torch, lambda: F.conv3d(F.conv3d(vol[None], *wb0, padding=1).relu_(), *wb1, stride=2,
                                             padding=1).relu_(), 5),
               (vol.numel() + o0.numel() + o1.numel()) * 4 + sum(t.numel() * 4 for t in (*wb0, *wb1)),
               3 * flops, PEAK_TF32_FLOPS,
               {"shape": [C, D, h, w], "out0_max_abs_err": e0, "out1_max_abs_err": e1, **same,
                "fma_floor_ms": flops / PEAK_FP32_FLOPS * 1e3,
                "k2_plus_k7_ms": timed(torch, lambda: K.conv3d_down(K.conv3d_bn_relu(vol, *wb0), *wb1), 5),
                "device_ms": kernel_device_ms(torch, lambda: K.conv3d_front_fused(vol, *wb0, *wb1),
                                              "conv3d_fused_tf32_kernel", reps=10),
                "library": "two fp32 calls, TF32 off: F.conv3d+ReLU (conv0), then F.conv3d stride 2+ReLU (conv1)"})
        del vol, o0, o1
        x = uniform((8, D, h, w), dtype=torch.float32)
        y = K.conv3d_down(x, *wb1)
        torch.cuda.synchronize()
        err, ok = within(y, K.conv3d_down_plain(x, *wb1), x, *wb1, 2)
        flops = 2 * 27 * 8 * 16 * y[0].numel()
        record("conv3d_down_fp32", s, err, "|d| <= 1e-5 sum|terms| + 1e-7", ok,
               timed(torch, lambda: K.conv3d_down(x, *wb1), 5), timed(torch, lambda: K.conv3d_down_plain(x, *wb1), 3),
               timed(torch, lambda: F.conv3d(x[None], *wb1, stride=2, padding=1).relu_(), 5),
               (x.numel() + y.numel()) * 4 + sum(t.numel() * 4 for t in wb1), 3 * flops, PEAK_TF32_FLOPS,
               {"shape": [8, D, h, w], "fma_floor_ms": flops / PEAK_FP32_FLOPS * 1e3,
                "device_ms": kernel_device_ms(torch, lambda: K.conv3d_down(x, *wb1), "conv3d_down_tf32_kernel",
                                              reps=10),
                "library": "F.conv3d stride 2+ReLU in fp32, TF32 off"})
        del x, y
    torch.cuda.empty_cache()


def protocol_stage_shapes():
    """(C, D, h, w) of each stage at the DTU protocol point: the cascade runs
    at half the 1152x1536 input under refinement."""
    h, w = DTU_H // 2, DTU_W // 2
    return [(32, NDEPTHS[0], h // 4, w // 4), (16, NDEPTHS[1], h // 2, w // 2), (8, NDEPTHS[2], h, w)]


def protocol_kernels(torch, dev, uniform, record):
    """K9 in fp32 (the fp32 route) and bf16 (its TPU twin ``warp_pallas_v6``),
    and K2 in fp32, against their plain versions at the protocol point's
    stage shapes, and K6 and K7 in fp32 there (rows tagged ``"point":
    "protocol"``). Then K4 (the bf16 route's conv01) at the protocol point's
    input, rows tagged ``"point": "protocol"``."""
    from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

    rig = textured_plane_batch(V=2, H=DTU_H, W=DTU_W, D=D_FULL, refine=True, tz_step=4.0, seed=SEED)
    fp32_kernels(torch, dev, uniform, record, rig, protocol_stage_shapes(), (torch.float32, torch.bfloat16))
    fp32_front_kernels(torch, uniform, tagged(record, "protocol"), protocol_stage_shapes())
    # K4 on conv01's stack of 2(V-1) images at the cascade's input (576x768)
    dynconv_kernel(torch, uniform, tagged(record, "protocol"), 2 * (V - 1), DTU_H // 2, DTU_W // 2)


def train_val_stage_shapes():
    """(C, D, h, w) of each stage of the train CLI's validation batches: the
    DTU train crop (512x640) at half resolution under refinement."""
    h, w = TRAIN_H // 2, TRAIN_W // 2
    return [(32, NDEPTHS[0], h // 4, w // 4), (16, NDEPTHS[1], h // 2, w // 2), (8, NDEPTHS[2], h, w)]


def train_val_kernels(torch, dev, uniform, record):
    """K9 and K2 in fp32, as the train CLI's validation batches run them,
    against their plain versions at those batches' stage shapes, rows tagged
    ``"point": "train_val"``."""
    from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

    rig = textured_plane_batch(V=2, H=TRAIN_H, W=TRAIN_W, D=D_FULL, refine=True, tz_step=4.0, seed=SEED)
    fp32_kernels(torch, dev, uniform, tagged(record, "train_val"), rig, train_val_stage_shapes(), (torch.float32,))


def grid_sample_bf16_ms(torch, src, px, py):
    """``F.grid_sample`` on K9's bf16 source at its shape, the grid in bf16
    too (the call takes one dtype, so the coordinates are rounded: not K9's
    function, hence no ``library_ms``): its ms, or what it raised."""
    import torch.nn.functional as F

    D, h, w = px.shape
    src_nchw = src.permute(2, 0, 1)[None].contiguous()
    grid = torch.stack([px * (2 / (w - 1)) - 1, py * (2 / (h - 1)) - 1], -1).reshape(1, D * h, w, 2).to(src.dtype)
    try:
        return timed(torch, lambda: F.grid_sample(src_nchw, grid, mode="bilinear", padding_mode="zeros",
                                                  align_corners=True), 10)
    except RuntimeError as e:
        return f"raises: {str(e).splitlines()[0][:160]}"


def fp32_kernels(torch, dev, uniform, record, rig, shapes, gather_dtypes):
    """K9 (in each of ``gather_dtypes``) and K2 in fp32 against their plain
    versions at the stage ``shapes`` of ``rig`` (two views with finite
    epipoles, cams under refinement); the coordinates are a plane sweep
    from 425 mm at a DTU cam file's interval, then per-pixel windows."""
    import torch.nn.functional as F

    from cds_mvsnet_tpu_torch.ops import kernels as K
    from cds_mvsnet_tpu_torch.ops.geometry import relative_warp_transform, sweep_coords

    interval = 2.5 * 1.06  # a DTU cam file's interval at --interval_scale 1.06
    for s, (C, D, h, w) in enumerate(shapes, start=1):
        cams = torch.as_tensor(rig["proj_matrices"][f"stage{s}"], device=dev)
        rot, trans = relative_warp_transform(cams[:, 0], cams[:, 1])
        if s == 1:
            hyp = torch.linspace(425.0, 425.0 + interval * (D_FULL - 1), D, device=dev)
        else:  # per-pixel windows around a smooth depth map, as refined stages
            centre = uniform((h, w), 560.0, 640.0, torch.float32)
            steps = torch.arange(D, device=dev, dtype=torch.float32) - (D - 1) // 2
            hyp = centre[None] + steps[:, None, None] * (4.0 / 2 ** (s - 1)) * interval
        px, py = sweep_coords(rot, trans, hyp[None], h, w)
        px, py = px.reshape(D, h, w).contiguous(), py.reshape(D, h, w).contiguous()

        # K9: same corners, fp32 weights and op-by-op sums as the plain
        # version, one rounding at the store: bit for bit
        for dtype in gather_dtypes:
            name = "warp_gather" if dtype == torch.float32 else "warp_gather_bf16"
            src = uniform((h, w, C), dtype=dtype)
            out = K.warp_gather(src, px, py)
            torch.cuda.synchronize()
            want = K.warp_gather_plain(src, px, py)
            d = (out.float() - want.float()).abs()
            tol, ok = "bit for bit (torch.equal)", torch.equal(out, want)
            if dtype == torch.float32:
                # the library call: NCHW source, grid normalised for align_corners=True
                src_nchw = src.permute(2, 0, 1)[None].contiguous()
                grid = torch.stack([px * (2 / (w - 1)) - 1, py * (2 / (h - 1)) - 1], -1).reshape(1, D * h, w, 2)
                lib_ms = timed(torch, lambda: F.grid_sample(src_nchw, grid, mode="bilinear", padding_mode="zeros",
                                                            align_corners=True), 10)
                del src_nchw, grid
                extra = {}
            else:  # no PyTorch call samples a bf16 source with fp32 coordinates
                lib_ms = None
                extra = {"grid_sample_bf16_ms": grid_sample_bf16_ms(torch, src, px, py)}
            es = src.element_size()
            record(name, s, float(d.max()), tol, ok,
                   timed(torch, lambda: K.warp_gather(src, px, py), 10),
                   timed(torch, lambda: K.warp_gather_plain(src, px, py), 2),
                   lib_ms, src.numel() * es + 2 * px.numel() * 4 + out.numel() * es, D * h * w * (8 * C + 20),
                   PEAK_FP32_FLOPS, {"shape": [C, D, h, w], "exact_frac": float((d == 0).float().mean()),
                                     "device_ms": kernel_device_ms(torch, lambda: K.warp_gather(src, px, py),
                                                                  "gather_kernel"), **extra})
            del src, out, want, d

        # K2 in fp32: 3xTF32 products of each term, 27·C terms summed in
        # another order (TF32 off in the plain version and cuDNN); its bound
        # counts the three TF32 MMAs, the fp32 FMA floor of one conv beside it
        vol = uniform((C, D, h, w), dtype=torch.float32)
        bound_w = (27 * C) ** -0.5
        wk = uniform((8, C, 3, 3, 3), -bound_w, bound_w, torch.float32)
        bk = uniform((8,), -0.1, 0.1, torch.float32)
        vol16 = vol.to(torch.bfloat16)  # the bf16 instantiation at the same shape, timed beside it
        y_k = K.conv3d_bn_relu(vol, wk, bk)
        torch.cuda.synchronize()
        y_p = K.conv3d_bn_relu_plain(vol, wk, bk)
        terms = F.conv3d(vol.abs()[None], wk.abs(), padding=1)[0] + bk.abs()[:, None, None, None]
        d = (y_k - y_p).abs()
        record("conv3d_bn_relu_fp32", s, float(d.max()), "|d| <= 1e-5 sum|terms| + 1e-7",
               y_k.dtype == torch.float32 and bool((d <= 1e-5 * terms + 1e-7).all()),
               timed(torch, lambda: K.conv3d_bn_relu(vol, wk, bk), 5),
               timed(torch, lambda: K.conv3d_bn_relu_plain(vol, wk, bk), 3),
               timed(torch, lambda: F.conv3d(vol[None], wk, bk, padding=1).relu_(), 5),
               vol.numel() * 4 + wk.numel() * 4 + 32 + y_k.numel() * 4, 3 * 2 * 27 * C * 8 * D * h * w, PEAK_TF32_FLOPS,
               {"shape": [C, D, h, w], "bf16_ms": timed(torch, lambda: K.conv3d_bn_relu(vol16, wk, bk), 5),
                "fma_floor_ms": 2 * 27 * C * 8 * D * h * w / PEAK_FP32_FLOPS * 1e3,
                "device_ms": kernel_device_ms(torch, lambda: K.conv3d_bn_relu(vol, wk, bk), "conv3d_tf32_kernel")})
        del vol, vol16, y_k, y_p, terms, d, px, py, hyp


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
    plain32 = request(compute_dtype=torch.float32, kernels=False)["stage3"]
    k0 = {name: k.launches for name, k in all_kernels().items()}
    route32 = request(compute_dtype=torch.float32)["stage3"]  # FP32_OPS: K9 and K2 in fp32
    fp32_launches = {name: k.launches - k0[name] for name, k in all_kernels().items() if k.launches != k0[name]}
    if fp32_launches != {"warp_gather": 3 * (V - 1), "conv3d_bn_relu": 3}:
        raise RuntimeError(f"the fp32 route launched {fp32_launches}, not K9 12 and K2 3 times")
    interval = float(batch["depth_values"][0, 1] - batch["depth_values"][0, 0])  # stage-3 ratio 1
    cmp = {}
    for tag, got, ref in (("bf16", s3, plain16), ("fp32_route", route32, plain32), ("fp32", s3, plain32)):
        for key in ("depth", "photometric_confidence"):
            med, p99 = quantiles(torch, (got[key] - ref[key]).abs())
            cmp[f"{tag}_{key}_median"] = med
            cmp[f"{tag}_{key}_p99"] = p99
    # Gate on the same-dtype comparisons: the bf16 kernel path against the
    # plain bf16 path, and the fp32 route (K9, K2 in fp32) against the plain
    # fp32 path. Each pair computes the same function and differs only where
    # a kernel's fp32 sums, taken in another order, round differently (to a
    # neighbouring bf16 value in bf16); such flips are rare and the
    # soft-argmin is smooth, so depth stays within a small fraction of the
    # stage-3 plane interval. The bf16 kernel path against the plain fp32
    # path ("fp32") differs by bf16 quantisation of every feature and volume,
    # which is reported only.
    gate = {
        "depth_median_max": 0.01 * interval,
        "depth_p99_max": 0.25 * interval,
        "conf_median_max": 1e-3,
        "conf_p99_max": 0.05,
    }
    ok = all(cmp[f"{tag}_depth_median"] <= gate["depth_median_max"]
             and cmp[f"{tag}_depth_p99"] <= gate["depth_p99_max"]
             and cmp[f"{tag}_photometric_confidence_median"] <= gate["conf_median_max"]
             and cmp[f"{tag}_photometric_confidence_p99"] <= gate["conf_p99_max"]
             for tag in ("bf16", "fp32_route"))
    emit({
        "phase": "serve", "requests": REQUESTS, "shape": [1, V, H, W, 3], "ndepths": list(NDEPTHS),
        "latency_ms_per_map": lat, "peak_mem_bytes": peak, "launches": launches,
        "depth_interval_mm": interval, "compare": cmp, "gate": gate, "ok": ok,
        "depth_mean_mm": float(s3["depth"].mean()), "fp32_route_launches": fp32_launches,
    })
    if not ok:
        raise RuntimeError("a kernel route disagrees with the plain path of its dtype")
    phase_profile(torch, model, lambda: request(compute_dtype=torch.bfloat16))
    return launches


def hooked_layers(model):
    """``(name, module)`` of the FeatureNet's blocks and, per stage, the vis
    head and the cost-reg UNet."""
    named = [(f"feature.{n}", m) for n, m in model.feature.named_children()]
    named += [(f"vis.stage{int(s) + 1}", m) for s, m in model.stage_net.vis.items()]
    return named + [(f"cost_reg.stage{int(s) + 1}", m) for s, m in model.cost_regularization.items()]


def kernel_by_layer(torch, model, request, pattern: str) -> dict:
    """Device ms and calls of the kernels whose name holds ``pattern``, by
    layer of :func:`hooked_layers`: one request per layer, with
    ``torch.profiler`` running only inside that layer's forward calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    found = {}
    for name, mod in hooked_layers(model):
        profs = []

        def pre(m, args):
            torch.cuda.synchronize()
            profs.append(profile(activities=[ProfilerActivity.CUDA]))
            profs[-1].start()

        def post(m, args, out):
            torch.cuda.synchronize()
            profs[-1].stop()

        handles = [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
        try:
            request()
        finally:
            for h in handles:
                h.remove()
        hits = [(evt.self_device_time_total / 1e3, evt.count) for p in profs for evt in p.key_averages()
                if evt.device_type == DeviceType.CUDA and pattern in evt.key]
        if hits:
            found[name] = {"ms": sum(h[0] for h in hits), "calls": sum(h[1] for h in hits)}
    return found


def layer_times(torch, model, request) -> dict:
    """Device ms of each layer of :func:`hooked_layers` over one request,
    between CUDA events that forward hooks record. The rest of a request is
    the epipoles, hypotheses, K1 and K3."""
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

    for name, mod in hooked_layers(model):
        pre, post = hooks(name)
        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    try:
        request()
    finally:
        for h in handles:
            h.remove()
    return {name: sum(a.elapsed_time(b) for a, b in evs) for name, evs in spans.items()}


def device_profile(torch, run, top: int = 15) -> dict:
    """``torch.profiler`` over one call of ``run``: device kernel time
    summed by name and by group (the hand-written kernels, cuDNN
    convolutions, PyTorch elementwise and reduction kernels, the rest), the
    device's busy share of the call's wall time, and the host operators
    with the most self CPU time (under the profiler, which adds to each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((evt.self_device_time_total / 1e3, evt.count, evt.key) for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0), reverse=True)
    device_ms = sum(r[0] for r in rows)
    groups = {"hand_written": 0.0, "convolution": 0.0, "elementwise": 0.0, "other": 0.0}
    hand_written_calls = 0
    for ms, n, key in rows:
        if key.startswith(KERNEL_SYMBOLS):
            groups["hand_written"] += ms
            hand_written_calls += n
        elif any(tag in key for tag in ("cudnn", "xmma", "cutlass", "convolve", "gemm")):
            groups["convolution"] += ms
        elif "elementwise" in key or "reduce_kernel" in key:
            groups["elementwise"] += ms
        else:
            groups["other"] += ms
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms if rows else "not measured",
        "busy_share": device_ms / wall_ms if rows else "not measured",
        "groups_ms": groups if rows else "not measured",
        "hand_written_calls": hand_written_calls,
        "top": [{"name": k[:100], "ms": ms, "calls": n, "share": ms / device_ms} for ms, n, k in rows[:top]],
        "host_top": [{"name": evt.key[:60], "self_cpu_ms": evt.self_cpu_time_total / 1e3, "calls": evt.count}
                     for evt in sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                                       key=lambda e: -e.self_cpu_time_total)[:10]],
    }


def kernel_device_ms(torch, fn, symbol: str, reps: int = 20) -> float:
    """Device ms of one launch of the kernel named ``symbol`` under
    ``torch.profiler``, over ``reps`` calls of ``fn``: for a kernel whose
    wrapper's host path takes longer than the kernel itself; None where no
    such kernel ran."""
    prof = device_profile(torch, lambda: [fn() for _ in range(reps)], top=5)
    return next((t["ms"] / t["calls"] for t in prof["top"] if symbol in t["name"]), None)


def call_device_ms(torch, fn, reps: int = 20, profiles: int = 3) -> float:
    """Device ms of one call of ``fn`` under ``torch.profiler``: every kernel
    and memset it runs, over ``reps`` calls; the median of ``profiles``
    profiles (one of them once missed most of a call's kernels)."""
    totals = [device_profile(torch, lambda: [fn() for _ in range(reps)], top=1)["device_ms"]
              for _ in range(profiles)]
    totals = sorted(t for t in totals if isinstance(t, float))  # "not measured" where no device time showed
    return totals[len(totals) // 2] / reps if totals else None


SGEMM = "precomputed_convolve_sgemm"  # the largest cuDNN kernel of a request (PERF.md)


def phase_profile(torch, model, request):
    """Where one request's device time goes: :func:`device_profile` over one
    more bf16 request (after the launch counts were read), the device time
    of each layer over one more request (:func:`layer_times`), and the
    layers that run cuDNN's ``SGEMM`` kernel (:func:`kernel_by_layer`)."""
    emit({"phase": "profile", **device_profile(torch, request), "layers_ms": layer_times(torch, model, request),
          "sgemm_by_layer": kernel_by_layer(torch, model, request, SGEMM)})


def phase_routes(torch, batch, dev):
    """R1-R5 of ``ROUTED`` at the serve point: each after a warm-up with
    every launch count set to 0, REQUESTS timed requests whose launches must
    be exactly the route's; stage 3 held to the serve gate against the
    default route's request (same weights, batch and dtype), R5 also to its
    plain twin (:func:`feature_route_checks`); one R1 and one R5 request
    profiled.
    Returns the route-only kernels' launches (``ROUTE_LAUNCHES``) and R5's
    K4 launches a request."""
    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.models import Routes, build_model

    model = build_model(ModelConfig(refine=False, ndepths=NDEPTHS), seed=SEED, device=dev)
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    kernels = all_kernels()

    def request(routes):
        out = model(*args, compute_dtype=torch.bfloat16, routes=routes)
        torch.cuda.synchronize()
        return out

    def timed_requests(routes):
        request(routes)  # warm-up: cuDNN plans, the allocator
        for k in kernels.values():
            k.launches = 0
        lat = []
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            out = request(routes)
            lat.append((time.perf_counter() - t0) * 1e3)
        return out["stage3"], lat, {name: k.launches for name, k in kernels.items()}

    ref, ref_lat, _ = timed_requests(None)
    interval = float(batch["depth_values"][0, 1] - batch["depth_values"][0, 0])
    gate = {"depth_median_max": 0.01 * interval, "depth_p99_max": 0.25 * interval, "conf_median_max": 1e-3,
            "conf_p99_max": 0.05}
    rows, counts, problems = {}, {}, []
    for tag, (warp, front, per_request) in ROUTED.items():
        routes = Routes(warp, front, feature=ROUTE_FEATURE.get(tag, "conv01"))
        s3, lat, launches = timed_requests(routes)
        want = {name: per_request.get(name, 0) * REQUESTS for name in kernels}
        cmp = {}
        for key in ("depth", "photometric_confidence"):
            cmp[f"{key}_median"], cmp[f"{key}_p99"] = quantiles(torch, (s3[key] - ref[key]).abs())
        finite = all(tuple(s3[k].shape) == (1, H, W) and bool(torch.isfinite(s3[k]).all())
                     for k in ("depth", "photometric_confidence"))
        in_gate = (cmp["depth_median"] <= gate["depth_median_max"] and cmp["depth_p99"] <= gate["depth_p99_max"]
                   and cmp["photometric_confidence_median"] <= gate["conf_median_max"]
                   and cmp["photometric_confidence_p99"] <= gate["conf_p99_max"])
        rows[tag] = {"warp": warp, "front": front, "feature": sorted(routes.feature), "latency_ms_per_map": lat,
                     "launches": launches, "launches_expected": want, "compare_to_default": cmp,
                     "serve_gate": in_gate, "ok": launches == want and finite and in_gate}
        if tag in ROUTE_FEATURE:
            extra = feature_route_checks(torch, model, args, routes, in_gate)
            rows[tag].update(extra, ok=launches == want and finite and extra["feature_ok"])
        counts[tag] = launches
        if not rows[tag]["ok"]:
            problems.append(f"{tag}: launches {launches == want}, finite {finite}, gate {in_gate}")
    emit({"phase": "routes", "requests": REQUESTS, "depth_interval_mm": interval,
          "default_latency_ms_per_map": ref_lat, "routed": rows, "gate": gate, "ok": not problems})
    for tag in ("R1", "R5"):
        r = Routes(*ROUTED[tag][:2], feature=ROUTE_FEATURE.get(tag, "conv01"))
        emit({"phase": "routes_profile", "route": tag, **device_profile(torch, lambda: request(r))})
    if problems:
        raise RuntimeError(f"routes phase failed: {problems}")
    return ({name: counts[tag][kname] for name, (tag, kname) in ROUTE_LAUNCHES.items()},
            counts["R5"]["dynconv_branches"] // REQUESTS)


def meets_serve_gate(cmp: dict, gate: dict) -> bool:
    return (cmp["depth_median"] <= gate["depth_median_max"] and cmp["depth_p99"] <= gate["depth_p99_max"]
            and cmp["photometric_confidence_median"] <= gate["conf_median_max"]
            and cmp["photometric_confidence_p99"] <= gate["conf_p99_max"])


def compare(torch, got, want) -> dict:
    """Median and p99 of |got - want| of stage 3's depth and confidence."""
    cmp = {}
    for key in ("depth", "photometric_confidence"):
        cmp[f"{key}_median"], cmp[f"{key}_p99"] = quantiles(torch, (got[key] - want[key]).abs())
    return cmp


def phase_mixed(torch, batch, dev):
    """The mixed path at the serve point (MIXED): bf16 with
    ``cost_dtype=torch.float32`` under each front, MIXED_REQUESTS timed
    requests after a warm-up with every launch count set to 0, launches
    exactly the front's; stage 3 held to the serve gate against its plain
    twin (``kernels=False``, the same cost dtype); reported without a gate:
    depth and confidence against the plain fp32 cascade beside the default
    bf16 request's (what ``cost_dtype`` buys), latency per map beside the
    default request's; one request profiled. Returns K6's and K7's fp32
    launches (MIXED_LAUNCHES)."""
    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.models import Routes, build_model

    model = build_model(ModelConfig(refine=False, ndepths=NDEPTHS), seed=SEED, device=dev)
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    kernels = all_kernels()

    def request(compute_dtype=torch.bfloat16, **kw):
        out = model(*args, compute_dtype=compute_dtype, **kw)
        torch.cuda.synchronize()
        return out["stage3"]

    def timed_requests(**kw):
        request(**kw)  # warm-up: cuDNN plans, the allocator
        for k in kernels.values():
            k.launches = 0
        lat = []
        for _ in range(MIXED_REQUESTS):
            t0 = time.perf_counter()
            out = request(**kw)
            lat.append((time.perf_counter() - t0) * 1e3)
        return out, lat, {name: k.launches for name, k in kernels.items()}

    ref, ref_lat, _ = timed_requests()
    twin = request(cost_dtype=torch.float32, kernels=False)
    plain32 = request(torch.float32, kernels=False)
    interval = float(batch["depth_values"][0, 1] - batch["depth_values"][0, 0])
    gate = {"depth_median_max": 0.01 * interval, "depth_p99_max": 0.25 * interval, "conf_median_max": 1e-3,
            "conf_p99_max": 0.05}
    rows, problems = {}, []
    for front, per in MIXED.items():
        s3, lat, launches = timed_requests(routes=Routes({}, front), cost_dtype=torch.float32)
        want = {name: {**MIXED_BASE, **per}.get(name, 0) * MIXED_REQUESTS for name in kernels}
        cmp = compare(torch, s3, twin)
        finite = all(tuple(s3[k].shape) == (1, H, W) and bool(torch.isfinite(s3[k]).all())
                     for k in ("depth", "photometric_confidence"))
        ok = launches == want and finite and meets_serve_gate(cmp, gate)
        rows[front] = {"latency_ms_per_map": lat, "launches": launches, "launches_expected": want,
                       "compare_to_plain_twin": cmp, "serve_gate": meets_serve_gate(cmp, gate),
                       "accuracy_vs_plain_fp32": compare(torch, s3, plain32), "ok": ok}
        if not ok:
            problems.append(f"{front}: launches {launches == want}, finite {finite}, gate {meets_serve_gate(cmp, gate)}")
    emit({"phase": "mixed", "requests": MIXED_REQUESTS, "depth_interval_mm": interval, "gate": gate,
          "default_latency_ms_per_map": ref_lat, "default_accuracy_vs_plain_fp32": compare(torch, ref, plain32),
          "mixed_plain_twin_vs_plain_fp32": compare(torch, twin, plain32), "fronts": rows, "ok": not problems})
    emit({"phase": "mixed_profile", "front": "pallasf",
          **device_profile(torch, lambda: request(routes=Routes({}, "pallasf"), cost_dtype=torch.float32))})
    if problems:
        raise RuntimeError(f"mixed phase failed: {problems}")
    return {name: rows[front]["launches"][kname] for name, (front, kname) in MIXED_LAUNCHES.items()}


def phase_fp32_routed(torch, dev) -> None:
    """One fp32 request under routes at the DTU protocol point (1152x1536,
    refinement: the cascade at 576x768; FP32_ROUTED: K9 at every stage, K6
    and K2 at O=16 in fp32), MIXED_REQUESTS timed after a warm-up with every
    launch count set to 0, launches exactly FP32_ROUTED's; stage 3 held to
    the serve gate against the fp32 default request on the same weights and
    batch, latency per map beside the default's."""
    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.models import Routes, build_model, to_tensors
    from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

    model = build_model(ModelConfig(refine=True, ndepths=NDEPTHS), seed=SEED, device=dev)
    b = to_tensors(textured_plane_batch(V=V, H=DTU_H, W=DTU_W, D=D_FULL, refine=True, seed=SEED), dev)
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    kernels = all_kernels()
    warp, front, per = FP32_ROUTED
    routes = Routes(warp, front)

    def timed_requests(routes):
        model(*args, compute_dtype=torch.float32, routes=routes)  # warm-up
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        lat = []
        for _ in range(MIXED_REQUESTS):
            t0 = time.perf_counter()
            out = model(*args, compute_dtype=torch.float32, routes=routes)["stage3"]
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        return out, lat, {name: k.launches for name, k in kernels.items()}

    ref, ref_lat, _ = timed_requests(None)
    s3, lat, launches = timed_requests(routes)
    want = {name: per.get(name, 0) * MIXED_REQUESTS for name in kernels}
    interval = float(b["depth_values"][0, 1] - b["depth_values"][0, 0])
    gate = {"depth_median_max": 0.01 * interval, "depth_p99_max": 0.25 * interval, "conf_median_max": 1e-3,
            "conf_p99_max": 0.05}
    cmp = compare(torch, s3, ref)
    finite = all(bool(torch.isfinite(s3[k]).all()) for k in ("depth", "photometric_confidence"))
    ok = launches == want and finite and meets_serve_gate(cmp, gate)
    emit({"phase": "fp32_routed", "warp": warp, "front": front, "shape": [1, V, DTU_H, DTU_W, 3],
          "requests": MIXED_REQUESTS, "latency_ms_per_map": lat, "default_latency_ms_per_map": ref_lat,
          "launches": launches, "launches_expected": want, "depth_interval_mm": interval,
          "compare_to_default": cmp, "gate": gate, "ok": ok})
    del model, b, args
    torch.cuda.empty_cache()
    if not ok:
        raise RuntimeError(f"fp32 routed request: launches {launches == want}, finite {finite}, gate {cmp}")


def feature_route_checks(torch, model, args, routes, in_serve_gate: bool) -> dict:
    """R5's own gate. Its request bit for bit against the same request with
    the routed convs on K4's plain version (a forward pre-hook on the
    FeatureNet swaps the functions), FeatureNet outputs and stage 3 alike.
    Then the serve gate against the default route; where the branch
    softmax at temperature 0.001 makes it miss, the JAX package's criterion
    for this route (``tests/test_feature_net_s2d.py:42-57``, temperature
    0.5) on the request's FeatureNet input: against the fp32 FeatureNet,
    p99.5 and max error at most twice the default bf16 route's (floors 2e-2
    and 5e-2).
    Also each FeatureNet block's device time in one request of this route
    and of the default route (:func:`layer_times`)."""
    from cds_mvsnet_tpu_torch.ops import kernels as K

    def request(r):
        model(*args, compute_dtype=torch.bfloat16, routes=r)
        torch.cuda.synchronize()

    def feature_layers_ms(r):
        return {k: v for k, v in layer_times(torch, model, lambda: request(r)).items() if k.startswith("feature.")}

    seen = {}

    def keep(mod, a, kw, out):
        seen["in"], seen["out"] = (a, kw), out

    def to_plain(mod, a, kw):
        return a, {**kw, "branches": dict.fromkeys(kw["branches"], K.dynconv_branches_plain)}

    def run(*hooks):
        handles = [model.feature.register_forward_pre_hook(h, with_kwargs=True) for h in hooks[:-1]]
        handles.append(model.feature.register_forward_hook(hooks[-1], with_kwargs=True))
        try:
            out = model(*args, compute_dtype=torch.bfloat16, routes=routes)["stage3"]
        finally:
            for h in handles:
                h.remove()
        torch.cuda.synchronize()
        return out, seen.pop("out"), seen.pop("in")

    s3, feats, (f_args, f_kw) = run(keep)
    s3_p, feats_p, _ = run(to_plain, keep)
    feats_equal = all(torch.equal(a, b) for st in feats for a, b in zip(feats[st], feats_p[st]))
    request_equal = all(torch.equal(s3[k], s3_p[k]) for k in ("depth", "photometric_confidence"))
    x, epi = f_args[:2]
    del feats, feats_p
    with torch.no_grad():  # at the JAX test's temperature: at 0.001 both bf16 routes flip branches wholesale
        truth = model.feature(x.float(), epi, 0.5, branches={})
        default = model.feature(x, epi, 0.5, branches={"conv01": K.dynconv_branches})
        routed = model.feature(x, epi, 0.5, branches=f_kw["branches"])
    criterion, crit_ok = {}, True
    for st in truth:
        for i, name in enumerate(("feat", "nc_sum", "nc_abs")):
            e = [(t.float() - truth[st][i]).abs() for t in (default[st][i], routed[st][i])]
            q = [float(torch.quantile(t.flatten()[:: max(1, t.numel() // 4_000_000)], 0.995)) for t in e]
            m = [float(t.max()) for t in e]
            ok = q[1] <= max(2 * q[0], 2e-2) and m[1] <= max(2 * m[0], 5e-2)
            crit_ok &= ok
            criterion[f"{st}/{name}"] = {"p995_default": q[0], "p995_routed": q[1], "max_default": m[0],
                                         "max_routed": m[1], "ok": ok}
    del truth, default, routed
    feature_ok = feats_equal and request_equal and (in_serve_gate or crit_ok)
    return {"plain_twin": {"featurenet_bit_for_bit": feats_equal, "request_bit_for_bit": request_equal},
            "featurenet_criterion": criterion, "featurenet_criterion_ok": crit_ok,
            "gate_used": "serve gate" if in_serve_gate else "JAX route criterion on the FeatureNet",
            "layers_ms": feature_layers_ms(routes), "default_layers_ms": feature_layers_ms(None),
            "feature_ok": feature_ok}


def rel_l2(torch, got, want) -> float:
    num = sum(float((g.float() - w.float()).square().sum()) for g, w in zip(got, want))
    den = sum(float(w.float().square().sum()) for w in want)
    return (num / max(den, 1e-30)) ** 0.5


def check_k5_calls(torch, calls) -> dict:
    """K5 on the train step's own data: each recorded backward call
    ``(src, ref, depth, rt, g_in_prod, g_sim, d_src, d_ref)`` against the
    explicit plain backward, and its forward (launched again on the same
    inputs) against the plain forward, with the kernels phase's elementwise
    tolerances."""
    from cds_mvsnet_tpu_torch.ops import kernels as K

    worst = {"fwd_in_prod": 0.0, "fwd_sim": 0.0, "bwd_d_src": 0.0, "bwd_d_ref": 0.0}
    ok = True
    for call in calls:
        src, ref, depth, rt, g_ip, g_sim, d_src, d_ref = (t.detach() for t in call)
        ip_k, sim_k = K.warp_sim(src, ref, depth, rt)
        ip_p, sim_p = K.warp_sim_plain(src, ref, depth, rt)
        d_ip = (ip_k.float() - ip_p.float()).abs()
        scale = ip_p.float().abs()
        ok &= bool((d_ip <= 2 ** -7 * scale + 2 ** -8 * ref.float().abs().max()).all())
        ok &= bool(((sim_k - sim_p).abs() <= 2 ** -7 * scale.sum(0) + 1e-30).all())
        worst["fwd_in_prod"] = max(worst["fwd_in_prod"], float((d_ip / (scale + 1e-30)).max()))
        worst["fwd_sim"] = max(worst["fwd_sim"], float(((sim_k - sim_p).abs() / (scale.sum(0) + 1e-30)).max()))
        want = K.warp_sim_backward_plain(src, ref, depth, rt, g_ip, g_sim)
        terms = K.warp_sim_backward_plain(src.abs(), ref.abs(), depth, rt, g_ip.abs(), g_sim.abs())
        for key, got, w, t in zip(("bwd_d_src", "bwd_d_ref"), (d_src, d_ref), want, terms):
            d = (got.float() - w.float()).abs()
            bound_ = w.float().abs() + t.float()
            ok &= bool((d <= 2 ** -7 * bound_ + 1e-30).all())
            worst[key] = max(worst[key], float((d / (bound_ + 1e-30)).max()))
    return {"k5_calls": len(calls), "k5_calls_ok": ok,
            **{f"k5_calls_worst_{k}_rel": v for k, v in worst.items()}}


def phase_train(torch, batch, dev):
    """The train step at the train point: 1 warm-up and TRAIN_STEPS timed
    steps on the kernel path, the K5 launch counts, the kernel path's
    gradients against the plain paths' from the same weights, and one
    profiled step."""
    from cds_mvsnet_tpu_torch.config import ModelConfig, TrainConfig
    from cds_mvsnet_tpu_torch.models import build_model
    from cds_mvsnet_tpu_torch.ops import kernels as K
    from cds_mvsnet_tpu_torch.training import TrainStep

    cfg = TrainConfig(compute_dtype="bf16", remat_features=True)  # SGD lr 0.01, weight decay 0.01
    model = build_model(ModelConfig(refine=True, ndepths=NDEPTHS), seed=SEED, device=dev)
    names = [n for n, p in model.named_parameters() if p.requires_grad]

    # one step's loss and gradients from the same weights on three paths;
    # gradients() leaves the weights as they are. The kernel path runs
    # twice, and the two must agree bit for bit (K5 sums d_src in fixed
    # point, cuDNN runs its deterministic algorithms). The first run records
    # each K5 backward call's inputs and outputs for the check of every call
    # below.
    from cds_mvsnet_tpu_torch.ops.kernels import warp_vjp

    backward, calls = warp_vjp.FusedWarpTrain.backward, []

    def recording(ctx, g_in_prod, g_sim):
        d_src, d_ref, *rest = backward(ctx, g_in_prod, g_sim)
        calls.append((*ctx.saved_tensors, g_in_prod.contiguous(), g_sim.contiguous(), d_src, d_ref))
        return (d_src, d_ref, *rest)

    grads = {}
    for tag, kernels, dtype in (("kernel", True, "bf16"), ("kernel_again", True, "bf16"),
                                ("plain_bf16", False, "bf16"), ("plain_fp32", False, "fp32")):
        step = TrainStep(model, TrainConfig(compute_dtype=dtype, remat_features=True), kernels=kernels)
        warp_vjp.FusedWarpTrain.backward = staticmethod(recording if tag == "kernel" else backward)
        try:
            metrics, _ = step.gradients(batch, TRAIN_TEMPERATURE)
        finally:
            warp_vjp.FusedWarpTrain.backward = staticmethod(backward)
        torch.cuda.synchronize()
        grads[tag] = (float(metrics["loss"]), [p.grad.detach().clone() for p in step.params])
    for p in model.parameters():
        p.grad = None
    repeat = {"loss": grads["kernel"][0] == grads["kernel_again"][0],
              "grads": all(torch.equal(a, b) for a, b in zip(grads["kernel"][1], grads["kernel_again"][1]))}

    def group_of(name):
        return name.split(".")[0] if not name.startswith("stage_net") else "vis"

    cmp = {}
    for tag in ("kernel_again", "plain_bf16", "plain_fp32"):
        loss, g = grads[tag]
        cmp[f"{tag}_loss_rel"] = abs(grads["kernel"][0] - loss) / abs(loss)
        cmp[f"{tag}_grad_rel_l2"] = rel_l2(torch, grads["kernel"][1], g)
        for group in sorted({group_of(n) for n in names}):
            idx = [i for i, n in enumerate(names) if group_of(n) == group]
            cmp[f"{tag}_grad_rel_l2_{group}"] = rel_l2(torch, [grads["kernel"][1][i] for i in idx],
                                                       [g[i] for i in idx])
    del grads
    cmp.update(check_k5_calls(torch, calls))
    del calls
    # The gates. (1) Every K5 call of the kernel path's step, forward and
    # backward, on its own inputs, within the kernels phase's elementwise
    # tolerances (check_k5_calls). (2) The step: the loss to 1e-4 relative,
    # the gradient over all trainable leaves to 5e-2 relative L2. K5 and the
    # plain warp project, weight and gather with the same fp32 roundings, so
    # the two bf16 paths run the same forward; their backwards differ in the
    # order and rounding of d_src's sums (K5 in fixed point, the plain
    # version by fp32 adds) and in autograd's bf16 partial sums of d_ref.
    # Only the FeatureNet's gradient sees that, and it is ill-conditioned in
    # its inputs: in fp32 a 1e-6 relative change of the input images moves
    # some gradients by more than 1e-2 (tests/test_torch_train_step.py); two
    # runs of the kernel path whose d_src differed only in the order of fp32
    # atomics differed by about 1e-2 (PERF.md). A wrong backward moves it by
    # 1 or more: the FeatureNet's gradient reaches the loss only through the
    # warp. (3) The kernel path's two steps bit for bit.
    gate = {"k5_calls": "every call within its elementwise tolerance", "loss_rel_max": 1e-4,
            "grad_rel_l2_max": 5e-2, "kernel_again": "loss and every gradient bit for bit"}
    ok = (cmp["k5_calls_ok"] and cmp["plain_bf16_loss_rel"] <= gate["loss_rel_max"]
          and cmp["plain_bf16_grad_rel_l2"] <= gate["grad_rel_l2_max"] and repeat["loss"] and repeat["grads"])

    losses = []
    step = TrainStep(model, cfg)
    step(batch, TRAIN_TEMPERATURE)  # warm-up: cuDNN plans, the allocator
    torch.cuda.synchronize()
    for k in K.TRAIN_KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = step(batch, TRAIN_TEMPERATURE)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in out.items()})
    launches = {k.__name__: k.launches for k in K.TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    want = {name: n * TRAIN_STEPS for name, n in PER_STEP.items()}
    finite = all(v == v and abs(v) != float("inf") for row in losses for v in row.values())
    emit({
        "phase": "train", "shape": [TRAIN_B, V, TRAIN_H, TRAIN_W, 3], "ndepths": list(NDEPTHS), "D": D_FULL,
        "compute_dtype": "bf16", "remat_features": True, "temperature": TRAIN_TEMPERATURE,
        "s_per_step": secs, "peak_mem_bytes": peak, "losses": losses, "launches": launches,
        "launches_expected": want, "compare": cmp, "kernel_again_bit_for_bit": repeat, "gate": gate,
        "ok": ok and finite and launches == want,
    })
    emit({"phase": "train_profile", **device_profile(torch, lambda: step(batch, TRAIN_TEMPERATURE))})
    if not finite:
        raise RuntimeError(f"non-finite training loss: {losses}")
    if launches != want:
        raise RuntimeError(f"K5 launch counts {launches} != expected {want}")
    if not ok:
        raise RuntimeError(f"the kernel path's step disagrees with the plain bf16 path's or does not repeat "
                           f"({repeat})")
    return launches, secs


def spread(xs) -> dict:
    import statistics

    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs), "n": len(xs)}


def phase_train_cli(torch, train_secs) -> None:
    """The train CLI for one epoch on a synthetic DTU training scan, then
    ``--resume`` from its checkpoint, then the dryrun over one nccl rank
    (see the module note)."""
    import json
    import math
    import os
    import tempfile
    from pathlib import Path

    from cds_mvsnet_tpu_torch.cli.train_cli import main as train_main
    from cds_mvsnet_tpu_torch.utils.synthetic import write_dtu_train_scan

    repo = Path(__file__).resolve().parent
    kernels = all_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_dtu_train_scan(tmp / "dtu", views=TRAIN_CLI_VIEWS, refs=TRAIN_CLI_REFS, seed=SEED)
        for name in ("train.txt", "val.txt"):
            (tmp / "dtu" / name).write_text("scan1\n")
        raw = json.loads((repo / "configs" / "config_dtu.json").read_text())
        raw["data"][0].update(datapath=str(tmp / "dtu"), listfile=str(tmp / "dtu" / "train.txt"))
        raw["save_dir"] = str(tmp / "saved")
        raw["train"]["compute_dtype"] = "bf16"
        (tmp / "config.json").write_text(json.dumps(raw))
        setup_s = time.perf_counter() - t0
        argv = ["-c", str(tmp / "config.json"), "--epochs", "1", "--bs", str(TRAIN_CLI_BS), "--n_devices", "1"]

        for k in kernels.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = train_main(argv, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        steps, val_batches = len(trainer.timings), sum(len(dl) for dl in trainer.val_loaders)
        want = {name: 0 for name in kernels}
        want.update({name: n * steps for name, n in PER_CLI_STEP.items()})
        want.update({name: n * val_batches for name, n in PER_VAL_BATCH.items()})
        first_step, later = trainer.timings[0], trainer.timings[1:]
        wait, busy = sum(t["wait_s"] for t in later), sum(t["step_s"] for t in later)
        history = trainer.history
        finite = bool(history) and all(math.isfinite(v) for log in history for v in log.values())
        on_card = all(p.device.type == "cuda" for p in trainer.model.parameters())
        ckpt = Path(raw["save_dir"]) / "checkpoint-epoch1.npz"
        written = ckpt.exists() and ckpt.with_suffix(".json").exists()

        for k in kernels.values():
            k.launches = 0
        resumed = train_main([*argv, "--resume", str(ckpt), "--save_dir", str(tmp / "resumed")], device="cuda")
        restored = all(torch.equal(v, resumed.model.state_dict()[k]) for k, v in trainer.model.state_dict().items())
        resume = {"start_epoch": resumed.start_epoch, "steps": len(resumed.timings), "weights_equal": restored,
                  "train_launches": sum(kernels[n].launches for n in TRAIN_KERNEL_NAMES)}
        resume_ok = resume == {"start_epoch": 2, "steps": 0, "weights_equal": True, "train_launches": 0}
        steps_expected = len(TRAIN_CLI_REFS) * DTU_LIGHTS // TRAIN_CLI_BS
        del trainer, resumed
        torch.cuda.empty_cache()

    dry = subprocess.run([sys.executable, "-m", "cds_mvsnet_tpu_torch.tools.dryrun_multichip", "1", "--device",
                          "cuda"], cwd=repo, capture_output=True, text=True, timeout=600)
    dry_ok = dry.returncode == 0 and dry.stdout.strip().splitlines()[-1:] == ["dryrun_multichip ok"]
    emit({
        "phase": "train_cli", "config": "configs/config_dtu.json", "compute_dtype": "bf16", "bs": TRAIN_CLI_BS,
        "nviews": TRAIN_CLI_NVIEWS, "shape": [TRAIN_CLI_BS, TRAIN_CLI_NVIEWS, 512, 640, 3], "steps": steps,
        "steps_expected": steps_expected, "val_batches": val_batches, "setup_s": setup_s, "wall_s": wall,
        "s_per_step_after_first": spread([t["step_s"] for t in later]),
        "loader_wait_s_after_first": spread([t["wait_s"] for t in later]),
        "loader_wait_share": wait / (wait + busy), "first_step": first_step,
        "train_phase_s_per_step": spread(train_secs), "peak_mem_bytes": peak, "history": history,
        "launches": {k: v for k, v in launches.items() if v or want[k]},
        "launches_expected": {k: v for k, v in want.items() if v}, "checkpoint_written": written, "resume": resume,
        "params_on_card": on_card, "dryrun_multichip": "ok" if dry_ok else dry.stdout[-500:] + dry.stderr[-2000:],
        "ok": finite and launches == want and written and resume_ok and on_card and dry_ok
        and steps == steps_expected,
    })
    if not finite:
        raise RuntimeError(f"train_cli: a non-finite loss or validation metric: {history}")
    if steps != steps_expected or launches != want:
        raise RuntimeError(f"train_cli: {steps} steps, launches {launches} != expected {want}")
    if not (written and resume_ok and on_card):
        raise RuntimeError(f"train_cli: checkpoint {written}, resume {resume}, parameters on the card {on_card}")
    if not dry_ok:
        raise RuntimeError(f"train_cli: dryrun_multichip over one nccl rank failed:\n{dry.stdout[-2000:]}"
                           f"\n{dry.stderr[-4000:]}")


def write_dtu_scan(root, seed: int = SEED):
    """A synthetic scan in the DTU test layout under ``root/scan1``: 6 views
    of a textured plane at 1600x1200 (``images/*.jpg``), their cam files
    with full-resolution intrinsics and a two-token depth line (425 mm,
    2.5 mm), and a pair file that gives each view the other 5 as sources."""
    import os

    import numpy as np

    from cds_mvsnet_tpu_torch.data.image import save_image
    from cds_mvsnet_tpu_torch.utils.synthetic import textured_plane_batch

    scan = os.path.join(root, "scan1")
    for sub in ("images", "cams"):
        os.makedirs(os.path.join(scan, sub), exist_ok=True)
    rig = textured_plane_batch(V=DTU_VIEWS, H=DTU_SRC_H, W=DTU_SRC_W, D=D_FULL, tz_step=4.0, seed=seed)
    cams = rig["proj_matrices"]["stage3"][0]  # full-resolution intrinsics
    for v in range(DTU_VIEWS):
        save_image(os.path.join(scan, "images", f"{v:0>8}.jpg"), rig["imgs"][0, v])
        rows = [" ".join(str(x) for x in row) for row in (*cams[v, 0], *cams[v, 1, :3, :3])]
        with open(os.path.join(scan, "cams", f"{v:0>8}_cam.txt"), "w") as f:
            f.write("extrinsic\n" + "\n".join(rows[:4]) + "\n\nintrinsic\n" + "\n".join(rows[4:])
                    + "\n\n425.0 2.5\n")
    lines = [str(DTU_VIEWS)]
    for v in range(DTU_VIEWS):
        srcs = [u for u in range(DTU_VIEWS) if u != v]
        lines += [str(v), f"{len(srcs)} " + " ".join(f"{u} {100.0 - abs(u - v):.1f}" for u in srcs)]
    with open(os.path.join(scan, "pair.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return ["scan1"]


def all_kernels():
    from cds_mvsnet_tpu_torch.ops import kernels as K

    return {k.__name__: k for k in (*K.KERNELS, *K.TRAIN_KERNELS, *K.FP32_KERNELS, *K.ROUTE_KERNELS, *K.PROBE_KERNELS)}


def product_run(torch, argv):
    """``test_cli.main(argv)`` on the card with every launch count set to 0
    just before it and read just after, and the host synchronisations it
    makes (``torch.cuda.set_sync_debug_mode("warn")``) by call site."""
    import warnings

    from cds_mvsnet_tpu_torch.cli.test_cli import main as cli_main

    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            result = cli_main(argv, device="cuda")
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    syncs = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{w.filename.split('site-packages/')[-1].split('cds_mvsnet_tpu_torch/')[-1]}:{w.lineno}"
            syncs[site] = syncs.get(site, 0) + 1
    return result, launches, syncs, wall


def check_written(np, out_dir, views, dmin, dmax):
    """The files of one inference run: finite depths of the protocol size
    inside the depth range, stacked confidences, cams and images."""
    import os

    from cds_mvsnet_tpu_torch.io.pfm import read_pfm

    scan = os.path.join(out_dir, "scan1")
    problems = []
    for v in range(views):
        depth, _ = read_pfm(os.path.join(scan, "depth_est", f"{v:0>8}.pfm"))
        conf, _ = read_pfm(os.path.join(scan, "confidence", f"{v:0>8}.pfm"))
        if depth.shape != (DTU_H, DTU_W) or not np.isfinite(depth).all():
            problems.append(f"depth {v}: shape {depth.shape} or non-finite")
        elif depth.min() < dmin - 1e-3 or depth.max() > dmax + 1e-3:
            problems.append(f"depth {v}: [{depth.min()}, {depth.max()}] outside [{dmin}, {dmax}]")
        if conf.shape != (DTU_H, DTU_W, 3) or not np.isfinite(conf).all():
            problems.append(f"confidence {v}: shape {conf.shape}")
        for sub, suffix in (("cams", "_cam.txt"), ("images", ".jpg")):
            if not os.path.exists(os.path.join(scan, sub, f"{v:0>8}{suffix}")):
                problems.append(f"{sub} {v} missing")
    return problems


def forward_overlap(torch, model, b, reps: int = 3, dtypes=None) -> dict:
    """Host and device time of one forward, in bf16 and in fp32 (or
    ``dtypes``, tag -> dtype): the host time until ``forward`` returns (what
    the next view waits for before it can be queued) and until the card has
    finished."""
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    out = {}
    for tag, dtype in (dtypes or {"bf16": torch.bfloat16, "fp32": torch.float32}).items():
        model(*args, compute_dtype=dtype)
        torch.cuda.synchronize()
        host, total = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            model(*args, compute_dtype=dtype)
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            total.append((time.perf_counter() - t0) * 1e3)
        out[tag] = {"host_ms": host, "total_ms": total}
    return out


def phase_product(torch, dev):
    """The eval product at the DTU protocol point, bf16 then fp32 (see the
    module note). Returns the fp32 run's launches of K9 and K2."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.data.eval_set import EvalDataset
    from cds_mvsnet_tpu_torch.fusion.pipeline import FusionConfig, _load_view, fuse_view
    from cds_mvsnet_tpu_torch.io.pfm import read_pfm
    from cds_mvsnet_tpu_torch.models import build_model, to_tensors
    from cds_mvsnet_tpu_torch.models.convert import save_model

    def batch_of(sample):
        return to_tensors({k: v[None] if not isinstance(v, dict) else {s: a[None] for s, a in v.items()}
                           for k, v in sample.items() if k != "filename"}, dev)

    work = tempfile.mkdtemp(prefix="cds_smoke_")
    try:
        data = os.path.join(work, "data")
        scans = write_dtu_scan(data)
        ckpt = os.path.join(work, "ckpt.npz")
        cfg = ModelConfig(refine=True, ndepths=NDEPTHS)
        save_model(ckpt, build_model(cfg, seed=SEED, device=dev))
        ds = EvalDataset(data, scans, nviews=V, ndepths=D_FULL, interval_scale=1.06, max_h=DTU_H, max_w=DTU_W,
                         dataset="dtu", refine=True)
        interval = float(ds[0]["depth_values"][1] - ds[0]["depth_values"][0])  # stage-3 ratio 1
        dmin, dmax = float(ds[0]["depth_values"][0]), float(ds[0]["depth_values"][-1])
        runs, ok, problems = {}, True, []
        for tag, dtype_flag in (("bf16", "auto"), ("fp32", "fp32")):
            out_dir = os.path.join(work, f"out_{tag}")
            argv = ["--testpath", data, "--resume", ckpt, "--outdir", out_dir, *DTU_FLAGS,
                    "--compute_dtype", dtype_flag]
            result, launches, syncs, wall = product_run(torch, argv)
            want = {name: n * DTU_VIEWS for name, n in PER_VIEW[tag].items()}
            found = check_written(np, out_dir, DTU_VIEWS, dmin, dmax)
            # each written depth against an in-process forward on the same
            # batch: the serve gate
            model = build_model(cfg, params=ckpt, device=dev)
            dtype = torch.bfloat16 if tag == "bf16" else torch.float32
            med, p99 = [], []
            for i in range(len(ds)):
                b = batch_of(ds[i])
                ref = model(b["imgs"], b["proj_matrices"], b["depth_values"], temperature=0.01,
                            compute_dtype=dtype)["refined_depth"][0]
                got = torch.as_tensor(read_pfm(os.path.join(out_dir, "scan1", "depth_est", f"{i:0>8}.pfm"))[0],
                                      device=dev)
                m, q = quantiles(torch, (got - ref).abs())
                med.append(m)
                p99.append(q)
            del model
            torch.cuda.empty_cache()
            gate = max(med) <= 0.01 * interval and max(p99) <= 0.25 * interval
            ply = os.path.join(out_dir, "scan1.ply")
            run_ok = launches == want and not found and gate and os.path.exists(ply)
            # maps_per_sec is save_depths' batch / median view time; the
            # sustained rate is 1 / mean_s (views 2-6, whose times tile the run)
            runs[tag] = {"maps_per_sec": result["inference"]["maps_per_sec"],
                         "maps_per_sec_sustained": 1.0 / result["inference"]["mean_s"], "stats": result["inference"],
                         "wall_s": wall, "launches": launches, "launches_expected": want,
                         "gipuma_points": result["points"]["scan1"], "host_syncs": syncs,
                         "written_vs_forward_depth_median_mm": med, "written_vs_forward_depth_p99_mm": p99,
                         "files_ok": not found, "ok": run_ok}
            problems += [f"{tag}: {p}" for p in found]
            if launches != want:
                problems.append(f"{tag}: launches {launches} != {want}")
            if not gate:
                problems.append(f"{tag}: written depth vs forward median {max(med)}, p99 {max(p99)} mm")
            ok &= run_ok

        overlap = forward_overlap(torch, build_model(cfg, params=ckpt, device=dev), batch_of(ds[0]))
        torch.cuda.empty_cache()

        # the normal filter with loose thresholds on the bf16 maps, and one
        # view's fuse_view on the card against the CPU
        out_dir = os.path.join(work, "out_bf16")
        normal, _, _, normal_wall = product_run(
            torch, ["--testpath", data, "--resume", ckpt, "--outdir", out_dir, *NORMAL_FLAGS])
        fcfg = FusionConfig(n_src_views=10, vthresh=2.0, img_dist_thresh=50.0, depth_thresh=0.01)
        scan_dir = os.path.join(out_dir, "scan1")
        views = [_load_view(scan_dir, v) for v in range(DTU_VIEWS)]
        fused = {}
        for where in (dev, torch.device("cpu")):
            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a), device=where)

            pts, mask, depth = fuse_view(t(views[0][0]), t(views[0][1]), t(np.stack([v[0] for v in views[1:]])),
                                         t(np.stack([v[1] for v in views[1:]])), t(views[0][2]),
                                         t(np.stack([v[2] for v in views[1:]])), fcfg)
            fused[where.type] = [x.cpu() for x in (pts, mask, depth)]
        (pg, mg, dg), (pc, mc, dc) = fused[dev.type], fused["cpu"]
        # masks come from <, > and >= on fp32 results: a pixel at a threshold
        # may flip, in the final mask or in a view's mask inside the average
        flips = float((mg != mc).float().mean())
        dep_off = float(((dg - dc).abs() > 1e-5 * dc.abs()).float().mean())
        both = mg & mc
        pts_off = float((both & ((pg - pc).abs().amax(-1) > 1e-5 * pc.abs().amax(-1))).float().mean())
        fuse_ok = flips <= 1e-4 and dep_off <= 1e-4 and pts_off <= 1e-4
        ok &= fuse_ok and normal["points"]["scan1"] > 0
        if not fuse_ok:
            problems.append(f"fuse_view card vs CPU: mask flips {flips}, points off {pts_off}, depth off {dep_off}")

        # one more bf16 inference run under the profiler: the device's busy
        # share of the product's wall time, with the set-up in it
        prof_dir = os.path.join(work, "out_profile")
        from cds_mvsnet_tpu_torch.cli.test_cli import main as cli_main

        profiled = {}

        def profiled_run():
            profiled.update(cli_main(["--testpath", data, "--resume", ckpt, "--outdir", prof_dir, *DTU_INFER_FLAGS,
                                      "--filter_method", "none"], device="cuda"))

        profile = device_profile(torch, profiled_run)
        profile["stats"] = profiled["inference"]
        emit({"phase": "product", "scan": [DTU_VIEWS, DTU_SRC_H, DTU_SRC_W], "shape": [DTU_H, DTU_W],
              "flags": DTU_FLAGS, "ndepths": list(NDEPTHS), "depth_interval_mm": interval,
              "depth_range_mm": [dmin, dmax], "runs": runs, "forward_overlap": overlap,
              "normal": {"flags": NORMAL_FLAGS, "points": normal["points"]["scan1"], "wall_s": normal_wall},
              "fuse_view_card_vs_cpu": {"mask_flip_frac": flips, "points_off_frac": pts_off,
                                        "depth_off_frac": dep_off, "kept_frac": float(mc.float().mean())},
              "gate": {"written_vs_forward_depth_median_max_mm": 0.01 * interval,
                       "written_vs_forward_depth_p99_max_mm": 0.25 * interval,
                       "fuse_view": "mask flips, and points or fused depths off by > 1e-5 relative, "
                                    "each on <= 1e-4 of the pixels"},
              "problems": problems, "ok": ok})
        emit({"phase": "product_profile", "compute_dtype": "bf16", "views": DTU_VIEWS, **profile})
        if not ok:
            raise RuntimeError(f"product phase failed: {problems}")
        return {"warp_gather": runs["fp32"]["launches"]["warp_gather"],
                "conv3d_bn_relu_fp32": runs["fp32"]["launches"]["conv3d_bn_relu"]}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def write_tt_scene(root, seed: int = SEED) -> str:
    """A synthetic scene in the Tanks and Temples layout under
    ``root/Family``: TT_VIEWS views of a ``sphere_scene`` at 1920x1080 as
    ``images/*.jpg``, their cam files with full-resolution intrinsics and
    T&T's four-number depth line (``depth_min interval num depth_max``: 425,
    2, 256, 937), and a pair file that gives each view the 10 nearest
    others as sources."""
    import os

    from cds_mvsnet_tpu_torch.data.image import save_image
    from cds_mvsnet_tpu_torch.utils.synthetic import sphere_scene

    scan = os.path.join(root, "Family")
    for sub in ("images", "cams"):
        os.makedirs(os.path.join(scan, sub), exist_ok=True)
    scene = sphere_scene(V=TT_VIEWS, H=TT_SRC_H, W=TT_W)
    dmin, dmax = scene["depth_min"], scene["depth_max"]
    for v in range(TT_VIEWS):
        save_image(os.path.join(scan, "images", f"{v:0>8}.jpg"), scene["imgs"][v])
        cam = scene["cams"][v]
        rows = [" ".join(str(x) for x in row) for row in (*cam[0], *cam[1, :3, :3])]
        with open(os.path.join(scan, "cams", f"{v:0>8}_cam.txt"), "w") as f:
            f.write("extrinsic\n" + "\n".join(rows[:4]) + "\n\nintrinsic\n" + "\n".join(rows[4:])
                    + f"\n\n{dmin} {(dmax - dmin) / TT_D} {TT_D} {dmax}\n")
    lines = [str(TT_VIEWS)]
    for v in range(TT_VIEWS):
        srcs = sorted((u for u in range(TT_VIEWS) if u != v), key=lambda u: (abs(u - v), u))[:TT_SOURCES + 1]
        lines += [str(v), f"{len(srcs)} " + " ".join(f"{u} {100.0 - abs(u - v):.1f}" for u in srcs)]
    with open(os.path.join(scan, "pair.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return "Family"


def fit_tt_weights(torch, model, dev) -> dict:
    """Train ``model`` TT_FIT_STEPS steps in bf16 on the kernel path, SGD at
    lr 0.01, on the five views of a ``sphere_scene`` at TT_FIT_H x TT_FIT_W,
    each the reference of its two neighbours, with the T&T scene's 256
    planes from 425 to 937; the losses and seconds it took."""
    from cds_mvsnet_tpu_torch.config import TrainConfig
    from cds_mvsnet_tpu_torch.models import to_tensors
    from cds_mvsnet_tpu_torch.training import TrainStep
    from cds_mvsnet_tpu_torch.utils.synthetic import sphere_scene, sphere_train_batch

    scene = sphere_scene(V=5, H=TT_FIT_H, W=TT_FIT_W)
    batches = [to_tensors(sphere_train_batch(scene, r, [(r + 1) % 5, (r + 4) % 5], D=TT_D, refine=False), dev)
               for r in range(5)]
    step = TrainStep(model, TrainConfig(compute_dtype="bf16", lr=0.01))
    t0 = time.perf_counter()
    losses = [float(step(batches[i % 5], 0.01)["loss"]) for i in range(TT_FIT_STEPS)]
    return {"steps": TT_FIT_STEPS, "shape": [1, 3, TT_FIT_H, TT_FIT_W, 3], "D": TT_D, "first_losses": losses[:5],
            "last_losses": losses[-5:], "s": time.perf_counter() - t0}


def phase_tt(torch, dev):
    """The Tanks and Temples point through the eval product: the Family row
    of ``scripts/tt_eval.sh`` (TT_FLAGS) by ``test_cli.main`` in this process
    on a synthetic scene in the tt layout (``write_tt_scene``), bf16 on the
    card. Checks each map's launches (K1 27, K2 3, K3 3, K4 1, every other
    kernel 0), the written files, each written depth against an in-process
    forward on the same batch (the product phase's gate), the fused points
    (> 0) and one view's ``fuse_view`` on the card against the CPU with the
    row's thresholds; reports maps/s, the fusion's wall time (a second run
    with ``--skip_inference``) and the peak device memory. The weights are
    the seeded init after ``fit_tt_weights``."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.data.eval_set import EvalDataset
    from cds_mvsnet_tpu_torch.fusion.pipeline import FusionConfig, _load_view, fuse_view
    from cds_mvsnet_tpu_torch.io.cams import read_pair_file
    from cds_mvsnet_tpu_torch.io.pfm import read_pfm
    from cds_mvsnet_tpu_torch.models import build_model, to_tensors
    from cds_mvsnet_tpu_torch.models.convert import save_model

    work = tempfile.mkdtemp(prefix="cds_smoke_tt_")
    try:
        data = os.path.join(work, "data")
        t0 = time.perf_counter()
        scene = write_tt_scene(data)
        scene_s = time.perf_counter() - t0
        scenes = os.path.join(work, "scenes.txt")
        with open(scenes, "w") as f:
            f.write(scene + "\n")
        cfg = ModelConfig(refine=False, ndepths=NDEPTHS)
        ckpt = os.path.join(work, "ckpt.npz")
        model = build_model(cfg, seed=SEED, device=dev)
        fit = fit_tt_weights(torch, model, dev)
        save_model(ckpt, model)
        del model
        out_dir = os.path.join(work, "out")
        argv = ["--testpath", data, "--testlist", scenes, "--resume", ckpt, "--outdir", out_dir, *TT_FLAGS]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        result, launches, syncs, wall = product_run(torch, argv)
        peak = torch.cuda.max_memory_allocated()
        want = {name: n * TT_VIEWS for name, n in PER_TT_VIEW.items()}
        problems = [] if launches == want else [f"launches {launches} != {want}"]

        ds = EvalDataset(data, [scene], nviews=TT_SOURCES + 1, ndepths=TT_D, interval_scale=1.0, max_h=TT_H,
                         max_w=TT_W, dataset="tt", refine=False)
        interval = float(ds[0]["depth_values"][1] - ds[0]["depth_values"][0])  # stage 3 sweeps at ratio 1
        dmin, dmax = float(ds[0]["depth_values"][0]), float(ds[0]["depth_values"][-1])
        model = build_model(cfg, params=ckpt, device=dev)
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[result["inference"]["compute_dtype"]]
        med, p99 = [], []
        scan_dir = os.path.join(out_dir, scene)
        for i in range(len(ds)):
            sample, vid = ds[i], ds.metas[i][1]
            b = to_tensors({k: v[None] if not isinstance(v, dict) else {s: a[None] for s, a in v.items()}
                            for k, v in sample.items() if k != "filename"}, dev)
            ref = model(b["imgs"], b["proj_matrices"], b["depth_values"], temperature=0.01,
                        compute_dtype=dtype)["refined_depth"][0]
            depth = read_pfm(os.path.join(scan_dir, "depth_est", f"{vid:0>8}.pfm"))[0]
            conf = read_pfm(os.path.join(scan_dir, "confidence", f"{vid:0>8}.pfm"))[0]
            if depth.shape != (TT_H, TT_W) or not np.isfinite(depth).all():
                problems.append(f"depth {vid}: shape {depth.shape} or non-finite")
                continue
            if depth.min() < dmin - 1e-3 or depth.max() > dmax + 1e-3:
                problems.append(f"depth {vid}: [{depth.min()}, {depth.max()}] outside [{dmin}, {dmax}]")
            if conf.shape != (TT_H, TT_W, 3) or not np.isfinite(conf).all():
                problems.append(f"confidence {vid}: shape {conf.shape}")
            m, q = quantiles(torch, (torch.as_tensor(depth, device=dev) - ref).abs())
            med.append(m)
            p99.append(q)
        del model
        torch.cuda.empty_cache()
        gate = len(med) == TT_VIEWS and max(med) <= 0.01 * interval and max(p99) <= 0.25 * interval
        if not gate:
            problems.append(f"written depth vs forward: median {med}, p99 {p99} (interval {interval})")
        points = result["points"][scene]
        if points <= 0:
            problems.append("normal fusion kept no point")

        # the fusion alone, as the script's row runs it on the written maps
        fused_again, fusion_launches, _, fusion_wall = product_run(torch, [*argv, "--skip_inference"])
        if fused_again["points"][scene] != points:
            problems.append(f"fusion again: {fused_again['points'][scene]} points, not {points}")

        # view 0's fuse_view on the card against the CPU, with the row's thresholds
        fcfg = FusionConfig(n_src_views=10, conf_thresholds=(0.1, 0.1, 0.1), img_dist_thresh=1.0,
                            depth_thresh=0.01, vthresh=4)
        ref_id, src_ids = read_pair_file(os.path.join(data, scene, "pair.txt"))[0]
        views = [_load_view(scan_dir, v) for v in (ref_id, *src_ids[:10])]
        fused = {}
        for where in (dev, torch.device("cpu")):
            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a), device=where)

            pts, mask, depth = fuse_view(t(views[0][0]), t(views[0][1]), t(np.stack([v[0] for v in views[1:]])),
                                         t(np.stack([v[1] for v in views[1:]])), t(views[0][2]),
                                         t(np.stack([v[2] for v in views[1:]])), fcfg)
            fused[where.type] = [x.cpu() for x in (pts, mask, depth)]
        (pg, mg, dg), (pc, mc, dc) = fused[dev.type], fused["cpu"]
        flips = float((mg != mc).float().mean())
        dep_off = float(((dg - dc).abs() > 1e-5 * dc.abs()).float().mean())
        both = mg & mc
        pts_off = float((both & ((pg - pc).abs().amax(-1) > 1e-5 * pc.abs().amax(-1))).float().mean())
        if not (flips <= 1e-4 and dep_off <= 1e-4 and pts_off <= 1e-4):
            problems.append(f"fuse_view card vs CPU: mask flips {flips}, points off {pts_off}, depth off {dep_off}")
        stats = result["inference"]
        if stats["compute_dtype"] != "bf16":
            problems.append(f"the CLI ran {stats['compute_dtype']}, not bf16")
        emit({"phase": "tt", "scene": [TT_VIEWS, TT_SRC_H, TT_W], "shape": [TT_H, TT_W], "flags": TT_FLAGS,
              "ndepths": list(NDEPTHS), "depth_interval": interval, "depth_range": [dmin, dmax],
              "scene_s": scene_s, "fit": fit, "maps_per_sec": stats["maps_per_sec"],
              "maps_per_sec_sustained": 1.0 / stats["mean_s"], "stats": stats, "wall_s": wall,
              "fusion_wall_s": fusion_wall, "fusion_launches": {k: v for k, v in fusion_launches.items() if v},
              "peak_mem_bytes": peak, "launches": launches, "launches_expected": want, "host_syncs": syncs,
              "fused_points": points, "written_vs_forward_depth_median": med, "written_vs_forward_depth_p99": p99,
              "fuse_view_card_vs_cpu": {"mask_flip_frac": flips, "points_off_frac": pts_off,
                                        "depth_off_frac": dep_off, "kept_frac": float(mc.float().mean())},
              "gate": {"written_vs_forward_depth_median_max": 0.01 * interval,
                       "written_vs_forward_depth_p99_max": 0.25 * interval, "fused_points_min": 1},
              "problems": problems, "ok": not problems})
        if problems:
            raise RuntimeError(f"tt phase failed: {problems}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_probes(torch) -> dict:
    """The probes' own entry points, the path of P1 and P2: each tool's
    ``main`` on the card, every launch count set to 0 just before and read
    just after. Returns the probes' launches."""
    from cds_mvsnet_tpu_torch.tools import probe_gather16, probe_lane_slice

    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    lane = probe_lane_slice.main([], device="cuda")
    gather = probe_gather16.main([], device="cuda")
    launches = {name: k.launches for name, k in kernels.items()}
    want = {name: PER_PROBE_RUN.get(name, 0) for name in kernels}
    ok = lane["ok"] and all(r["ok"] for r in gather.values()) and launches == want
    emit({"phase": "probes", "lane_slice": lane, "gather16": gather,
          "launches": {n: c for n, c in launches.items() if c}, "launches_expected": PER_PROBE_RUN, "ok": ok})
    if not ok:
        raise RuntimeError("a probe failed or launched other kernels than its own")
    return {name: launches[name] for name in PROBE_NAMES}


def phase_stream(torch, scene, dev):
    """The stream point (see the module note), bf16 then fp32. Pass 1 pushes
    the 12 frames in order with every launch count set to 0 before each push
    and read after it (exactly PER_PUSH once the window is full, nothing
    before), and holds each map to the serve gate against the plain path
    (``kernels=False``) of its dtype on the same window. Pass 2, after a
    reset, times each push on the host clock (the numpy return synchronises)
    with the peak memory; the host and total time of a forward on the last
    window; one more push runs under ``torch.profiler`` after a synchronise,
    and its profile counts the hand-written launches it saw
    (``hand_written_calls``) beside one push's (``PER_PUSH``)."""
    import numpy as np

    from cds_mvsnet_tpu_torch.eval.streaming import StreamingConfig, StreamingReconstructor

    kernels = all_kernels()
    interval = (scene["depth_max"] - scene["depth_min"]) / (STREAM_PLANES - 1)  # the stage-3 plane interval
    gate = {"depth_median_max": 0.01 * interval, "depth_p99_max": 0.25 * interval, "conf_median_max": 1e-3,
            "conf_p99_max": 0.05}
    runs, problems = {}, []
    for tag, dtype in (("bf16", "bfloat16"), ("fp32", "float32")):
        cfg = StreamingConfig(depth_min=scene["depth_min"], depth_max=scene["depth_max"], compute_dtype=dtype)
        rec = StreamingReconstructor(None, cfg, device=dev)  # build_model's seeded weights
        want = {name: PER_PUSH[tag].get(name, 0) for name in kernels}
        nones, maps, bad_launches = 0, [], []
        for v in range(STREAM_VIEWS):
            for k in kernels.values():
                k.launches = 0
            out = rec.push(scene["imgs"][v], scene["cams"][v])
            launches = {name: k.launches for name, k in kernels.items()}
            if out is None:
                nones += 1
                if any(launches.values()):
                    bad_launches.append(v)
                continue
            if launches != want:
                bad_launches.append(v)
            imgs, proj, dv = rec.inputs()
            ref = rec.model(imgs, proj, dv, temperature=cfg.temperature, compute_dtype=rec.dtype, kernels=False)
            cmp = {}
            for key, got, plain in (("depth", out[0], ref["refined_depth"][0]),
                                    ("conf", out[1], ref["stage3"]["photometric_confidence"][0])):
                cmp[f"{key}_median"], cmp[f"{key}_p99"] = quantiles(
                    torch, (torch.as_tensor(got, device=dev) - plain).abs())
            err = np.abs(out[0] - scene["gt_depth"][v])
            maps.append({"view": v, "vs_plain": cmp, "finite": bool(np.isfinite(out[0]).all()),
                         "gt_abs_err_mean": float(err.mean()), "gt_abs_err_median": float(np.median(err)),
                         "gt_within_4_frac": float((err < 4 * interval).mean())})
            if not (cmp["depth_median"] <= gate["depth_median_max"] and cmp["depth_p99"] <= gate["depth_p99_max"]
                    and cmp["conf_median"] <= gate["conf_median_max"] and cmp["conf_p99"] <= gate["conf_p99_max"]
                    and maps[-1]["finite"]):
                problems.append(f"{tag} view {v}: {cmp}")
        if nones != STREAM_WINDOW - 1 or len(maps) != STREAM_VIEWS - STREAM_WINDOW + 1 or bad_launches:
            problems.append(f"{tag}: {nones} None, {len(maps)} maps, launches off at pushes {bad_launches}")

        rec.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lat = []
        for v in range(STREAM_VIEWS):
            t0 = time.perf_counter()
            out = rec.push(scene["imgs"][v], scene["cams"][v])
            if out is not None:
                lat.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        imgs, proj, dv = rec.inputs()
        forward = forward_overlap(torch, rec.model, {"imgs": imgs, "proj_matrices": proj, "depth_values": dv},
                                  dtypes={tag: rec.dtype})[tag]
        # nothing of the pushes before may run inside the profiled window
        torch.cuda.synchronize()
        profile = device_profile(torch, lambda: rec.push(scene["imgs"][0], scene["cams"][0]))
        # the hand-written launches the profile saw against one push's: fewer
        # means the window held part of a push
        profile["hand_written_calls_per_push"] = sum(PER_PUSH[tag].values())
        runs[tag] = {"latency_ms_per_push": lat, "frames_per_s": 1e3 * len(lat) / sum(lat),
                     "frames_per_s_median": 1e3 / sorted(lat)[len(lat) // 2], "peak_mem_bytes": peak,
                     "pushes_none": nones, "maps": maps, "launches_per_push": PER_PUSH[tag],
                     "forward_on_window": forward, "profile": profile}
        del rec
        torch.cuda.empty_cache()
    ok = not problems
    emit({"phase": "stream", "shape": [STREAM_WINDOW, STREAM_H, STREAM_W, 3], "views": STREAM_VIEWS,
          "planes": STREAM_PLANES, "ndepths": list(STREAM_NDEPTHS),
          "depth_range": [scene["depth_min"], scene["depth_max"]], "depth_interval": interval, "gate": gate,
          "runs": runs, "problems": problems, "ok": ok})
    if not ok:
        raise RuntimeError(f"stream phase failed: {problems}")


def phase_custom(torch, dev):
    """The custom-scene path: a 5-view sphere_scene at 864x1152 written as a
    COLMAP workspace (binary model), converted by ``data/colmap.py``, then
    ``test_cli.main`` with ``CUSTOM_FLAGS`` (bf16 on the card, normal
    fusion) from a seeded checkpoint; launches per view as the product's
    bf16 run; the fused cloud scored against the scene's surface points
    (``score_points``) and each depth map against its exact depth
    (``eval_depth_map``), reported (random weights: the maps sit far from
    the surface, so the DTU cut at 20 can leave no distance to average).
    Gate: files written, launches, points fused, and finite scores with the
    distances clipped at 60 but not cut (``max_dist=inf``)."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from cds_mvsnet_tpu_torch.config import ModelConfig
    from cds_mvsnet_tpu_torch.data.colmap import convert_scene
    from cds_mvsnet_tpu_torch.eval.depth_metrics import eval_depth_map
    from cds_mvsnet_tpu_torch.eval.dtu_benchmark import score_points
    from cds_mvsnet_tpu_torch.io.pfm import read_pfm
    from cds_mvsnet_tpu_torch.io.ply import read_ply
    from cds_mvsnet_tpu_torch.models import build_model
    from cds_mvsnet_tpu_torch.models.convert import save_model
    from cds_mvsnet_tpu_torch.utils.synthetic import sphere_scene, write_colmap_workspace

    work = tempfile.mkdtemp(prefix="cds_custom_")
    try:
        t0 = time.perf_counter()
        scene = sphere_scene(V=CUSTOM_VIEWS, H=CUSTOM_H, W=CUSTOM_W)
        write_colmap_workspace(os.path.join(work, "colmap"), scene, ext=".bin")
        n = convert_scene(os.path.join(work, "colmap"), os.path.join(work, "data", "scan1"), max_d=D_FULL,
                          model_ext=".bin")
        ckpt = os.path.join(work, "ckpt.npz")
        save_model(ckpt, build_model(ModelConfig(refine=False, ndepths=NDEPTHS), seed=SEED, device=dev))
        setup_s = time.perf_counter() - t0
        out_dir = os.path.join(work, "out")
        argv = ["--testpath", os.path.join(work, "data"), "--resume", ckpt, "--outdir", out_dir, *CUSTOM_FLAGS]
        result, launches, syncs, wall = product_run(torch, argv)
        want = {name: c * CUSTOM_VIEWS for name, c in PER_VIEW["bf16"].items()}
        problems = [] if launches == want else [f"launches {launches} != {want}"]
        depth_scores = []
        for v in range(CUSTOM_VIEWS):
            path = os.path.join(out_dir, "scan1", "depth_est", f"{v:0>8}.pfm")
            if not os.path.exists(path):
                problems.append(f"depth {v} missing")
                continue
            est = read_pfm(path)[0]
            depth_scores.append(eval_depth_map(est, scene["gt_depth"][v]).as_dict())
        points = result["points"]["scan1"]
        t0 = time.perf_counter()
        cloud = read_ply(os.path.join(out_dir, "scan1.ply"))[0] if points else np.zeros((0, 3), np.float32)
        gt = scene["gt_points"]
        cloud, gt = cloud[::max(1, len(cloud) // SCORE_POINTS)], gt[::max(1, len(gt) // SCORE_POINTS)]
        scores = score_points(cloud, gt)
        clipped = score_points(cloud, gt, max_dist=float("inf"))
        score_s = time.perf_counter() - t0
        finite = all(np.isfinite(clipped[k]) for k in ("acc_mean", "comp_mean"))
        if not points or not finite or len(depth_scores) != CUSTOM_VIEWS:
            problems.append(f"{points} points, scores {clipped}")
        emit({"phase": "custom", "views": CUSTOM_VIEWS, "shape": [CUSTOM_H, CUSTOM_W], "flags": CUSTOM_FLAGS,
              "converted": n, "setup_s": setup_s, "inference": result["inference"], "wall_s": wall,
              "launches": launches, "launches_expected": want, "host_syncs": syncs, "points": points,
              "scored_points": [len(cloud), len(gt)], "score_points": scores, "score_points_uncut": clipped,
              "score_s": score_s, "depth_metrics": depth_scores,
              "problems": problems, "ok": not problems})
        if problems:
            raise RuntimeError(f"custom-scene phase failed: {problems}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_tool(name: str, argv: list[str]):
    """``cds_mvsnet_tpu_torch.tools.<name>.main(argv, device="cuda")`` with
    its output captured: its JSON line is printed on a line of its own, its
    progress lines go to stderr; returns ``(report, seconds)``."""
    import contextlib
    import importlib
    import io

    module = importlib.import_module(f"cds_mvsnet_tpu_torch.tools.{name}")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        report = module.main(argv, device="cuda")
    seconds = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    print("\n".join(lines[:-1]), file=sys.stderr, flush=True)
    print(lines[-1], flush=True)
    return report, seconds


def tool_problems(name: str, argv: list[str], report: dict) -> list[str]:
    """What a run of tool ``name`` with ``argv`` must show, from the report
    its ``main`` returns; the tools phase and the card tests hold each run
    to it. ``profile_stages``: the line's keys are the JAX tool's and K1's,
    each prefix's stages equal the full cascade's bit for bit, and a
    prefix-n request launches n stages' PER_STAGE and K4 once;
    ``--marginals``: the four split values. ``bench_scan`` at 5-view
    inference: each leg launches PER_VIEW["bf16"] a view, each ``.ply``
    holds the line's points, every rate is finite. ``bench_train``: finite
    losses, a bf16 step PER_STEP scaled to its batch, an fp32 step no
    kernel. ``train_convergence``: the loss decreases. Launches are held
    only where the report's device is the card (on the CPU the wrappers
    run their plain versions)."""
    import math

    if name == "train_convergence":
        return [] if report["loss_decreased"] else [
            f"loss did not decrease ({report['loss_first_epoch']} -> {report['loss_last_epoch']})"]
    line, out = report["line"], []
    card = report["device"] == "cuda"
    if name == "profile_stages" and "--marginals" in argv:
        split = [k for k in line if k.startswith("stage")]
        return [] if len(split) == 4 else [f"split {split}"]
    if name == "profile_stages":
        from cds_mvsnet_tpu_torch.tools.profile_stages import PREFIXES, line_keys

        if list(line) != line_keys():
            out.append(f"keys {list(line)} != {line_keys()}")
        out += [f"{p}: stages differ from the full cascade's" for p, ok in report["prefix_equal"].items() if not ok]
        for n in PREFIXES if card else ():
            want = {**{k: n * c for k, c in PER_STAGE.items()}, "dynconv_branches": 1}
            if report["launches"].get(f"prefix{n}") != want:
                out.append(f"prefix{n} launches {report['launches'].get(f'prefix{n}')} != {want}")
    elif name == "bench_scan":
        out += [f"{k} = {v}" for k, v in line.items() if isinstance(v, float) and not math.isfinite(v)]
        out += [f"{k}: {line[k]} in the line, {n} in the .ply" for k, n in report["ply_vertices"].items()
                if line[k] != n]
        if card and report["nviews"] != V:
            out.append(f"launches are gated at {V}-view inference, not {report['nviews']}")
        want = {k: n * report["views"] for k, n in PER_VIEW["bf16"].items() if n}
        out += [f"{leg} launches {got} != {want}" for leg, got in report["launches"].items() if card and got != want]
    elif name == "bench_train":
        out += [f"{mode}: loss not finite" for mode, row in line.items() if not row["loss_finite"]]
        for mode, got in report["launches"].items() if card else ():
            want = {k: n * report["bs"] // TRAIN_B for k, n in PER_STEP.items()} if mode == "bf16" else {}
            if got != want:
                out.append(f"{mode} step launches {got} != {want}")
    return out


def phase_tools(torch) -> None:
    """The tools of ``cds_mvsnet_tpu_torch/tools/`` that the JAX package's
    ``tools/`` has (TOOLS), each through its ``main`` on the card at the JAX
    tool's point, each run held to :func:`tool_problems`: ``profile_stages``
    with 3 reps and its ``--marginals``, the default scan of ``bench_scan``,
    ``bench_train`` at B=2 and ``train_convergence`` at its defaults. A
    failure raises."""
    runs, problems = {}, []
    for name, argv in TOOLS:
        report, seconds = run_tool(name, argv)
        key = f"{name} {' '.join(argv)}".strip()
        problems += [f"{key}: {p}" for p in tool_problems(name, argv, report)]
        run = {"seconds": seconds}
        if name == "train_convergence":
            run["loss"] = [report["loss_first_epoch"], report["loss_last_epoch"]]
        elif "--marginals" in argv:
            run["split"] = {k: v for k, v in report["line"].items() if k.startswith("stage")}
        else:
            run["launches"] = report["launches"]
        runs[key] = run
        torch.cuda.empty_cache()
    emit({"phase": "tools", "runs": runs, "seconds": sum(r["seconds"] for r in runs.values()),
          "problems": problems, "ok": not problems})
    if problems:
        raise RuntimeError(f"tools phase failed: {problems}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    try:
        from cds_mvsnet_tpu_torch.models import strict_fp32, to_tensors
        from cds_mvsnet_tpu_torch.ops.kernels import _build as kbuild
        from cds_mvsnet_tpu_torch.utils.synthetic import sphere_scene, synthetic_batch, textured_plane_batch
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
    train_batch = to_tensors(synthetic_batch(B=TRAIN_B, V=V, H=TRAIN_H, W=TRAIN_W, D=D_FULL, refine=True,
                                             with_gt=True, seed=SEED), "cuda")
    stream_scene = sphere_scene(V=STREAM_VIEWS, H=STREAM_H, W=STREAM_W)
    results = phase_kernels(torch, batch, train_batch, stream_scene, dev)
    launches = phase_probes(torch)
    launches.update(phase_serve(torch, batch, dev))
    route_launches, feature_route_launches = phase_routes(torch, batch, dev)
    launches.update(route_launches)
    launches.update(phase_mixed(torch, batch, dev))
    del batch
    torch.cuda.empty_cache()
    phase_fp32_routed(torch, dev)
    torch.cuda.empty_cache()
    train_launches, train_secs = phase_train(torch, train_batch, dev)
    launches.update(train_launches)
    del train_batch
    torch.cuda.empty_cache()
    phase_train_cli(torch, train_secs)
    launches.update(phase_product(torch, dev))
    torch.cuda.empty_cache()
    phase_tt(torch, dev)
    torch.cuda.empty_cache()
    phase_stream(torch, stream_scene, dev)
    del stream_scene
    torch.cuda.empty_cache()
    phase_custom(torch, dev)
    torch.cuda.empty_cache()
    phase_tools(torch)

    kernels = []
    for name, source_replaces in KERNEL_INFO.items():
        source, replaces = source_replaces
        # the main path's shapes; K5's step also runs the GT warps at D=1;
        # K6 and K7 in fp32 run on the mixed path
        points = {None, "gt"} if name in TRAIN_KERNEL_NAMES else {"mixed"} if name in MIXED_KERNEL_NAMES else {None}
        rows = [r for r in results[name] if r.get("point") in points]
        # per-request totals at the serve shapes: K1 runs V-1 times per
        # stage; per-map totals at the protocol point: K9 runs V-1 times per
        # stage; per-step totals at the train shapes: K5 runs B·(V-1) times
        # per stage for the sweep and as often for the GT warp
        mult = {"warp_entropy": V - 1, "warp_gather": V - 1, "warp_sim": TRAIN_B * (V - 1),
                "warp_sim_backward": TRAIN_B * (V - 1), "warp_sim_coords": V - 1}.get(name, 1)
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
            "per": ("step" if name in TRAIN_KERNEL_NAMES else "map" if name in FP32_KERNEL_NAMES
                    else "probe run" if name in PROBE_NAMES else "request"),
            "per_stage": [{k: r[k] for k in ("point", "stage", "ms", "plain_ms", "library_ms", "bound_ms",
                                             "max_abs_err", "k2_plus_k7_ms", "host_ms", "device_ms",
                                             "main_device_ms", "library_host_ms", "library_device_ms",
                                             "fma_floor_ms") if k in r}
                          for r in rows],
        })
        for point in sorted({r.get("point") for r in results[name]} - points):
            kernels[-1][f"{point}_per_stage"] = [
                {k: r[k] for k in ("layer", "bucket", "stage", "ms", "plain_ms", "library_ms", "bound_ms",
                                   "max_abs_err", "host_ms", "device_ms", "library_host_ms", "library_device_ms",
                                   "k2_plus_k7_ms", "fma_floor_ms")
                 if k in r}
                for r in results[name] if r.get("point") == point]
        if name in PROBE_NAMES:  # the probes run only in their tools
            kernels[-1]["launches_per_map"] = 0
        if name == "dynconv_branches":  # every FeatureNet conv on K4 (route R5)
            feat = [r for r in results[name] if r.get("point") == "feature"]
            kernels[-1]["feature_route"] = {
                "launches_per_map": feature_route_launches,
                **{key: None if any(r[key] is None for r in feat) else sum(r[key] for r in feat)
                   for key in ("ms", "device_ms", "library_ms", "library_device_ms", "bound_ms", "plain_ms")}}
        if name == "warp_gather":  # the bf16 instantiation, off the main path
            kernels[-1]["bf16_per_stage"] = [
                {k: r[k] for k in ("stage", "ms", "plain_ms", "bound_ms", "max_abs_err", "device_ms",
                                   "grid_sample_bf16_ms")}
                for r in results["warp_gather_bf16"]]
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
