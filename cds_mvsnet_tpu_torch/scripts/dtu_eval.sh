#!/usr/bin/env bash
# The PyTorch/CUDA port's copy of scripts/dtu_eval.sh (the JAX package's): the same
# run, through cds_mvsnet_tpu_torch.cli.test_cli on the card.
# Canonical DTU evaluation, matching the published protocol
# (reference scripts/dtu_eval.sh:6): interval_scale 1.06, 5 views, 192
# depths, 1152x1536 with refinement, gipuma-style consistency fusion with
# prob_threshold 0,0,0 / disp_threshold 0.1 / num_consistent 2 — served here
# by the native C++ fusion library (fusion/native.py).
set -euo pipefail
TESTPATH=${1:?usage: dtu_eval.sh TESTPATH CKPT [OUTDIR]}
CKPT=${2:?}
OUTDIR=${3:-outputs/dtu}

python -m cds_mvsnet_tpu_torch.cli.test_cli \
  --dataset dtu --testpath "$TESTPATH" --testlist lists/dtu/test.txt \
  --resume "$CKPT" --outdir "$OUTDIR" \
  --interval_scale 1.06 --num_view 5 --numdepth 192 \
  --max_h 1152 --max_w 1536 \
  --filter_method gipuma --prob_threshold 0.0,0.0,0.0 \
  --disp_threshold 0.1 --num_consistent 2
