#!/usr/bin/env bash
# The PyTorch/CUDA port's copy of scripts/tt_eval.sh (the JAX package's): the same
# run, through cds_mvsnet_tpu_torch.cli.test_cli on the card.
# Tanks & Temples intermediate evaluation (reference scripts/tt_eval.sh:
# 10 views, 256 depths, no refinement, per-scene resolution/threshold table).
set -euo pipefail
TESTPATH=${1:?usage: tt_eval.sh TESTPATH CKPT [OUTDIR]}
CKPT=${2:?}
OUTDIR=${3:-outputs/tt}

declare -A RES_H=( [Family]=1088 [Francis]=1088 [Horse]=1088 [Lighthouse]=896 \
                   [M60]=896 [Panther]=896 [Playground]=896 [Train]=544 )
declare -A RES_W=( [Family]=1920 [Francis]=1920 [Horse]=1920 [Lighthouse]=1600 \
                   [M60]=1600 [Panther]=1600 [Playground]=1600 [Train]=960 )
declare -A CONF=( [Family]="0.1,0.1,0.1" [Francis]="0.3,0.3,0.3" [Horse]="0.05,0.05,0.05" \
                  [Lighthouse]="0.3,0.3,0.3" [M60]="0.2,0.2,0.2" [Panther]="0.2,0.2,0.2" \
                  [Playground]="0.3,0.3,0.3" [Train]="0.2,0.2,0.2" )
declare -A VTH=( [Family]=4 [Francis]=5 [Horse]=3 [Lighthouse]=5 [M60]=4 [Panther]=4 \
                 [Playground]=5 [Train]=4 )

for SCENE in Family Francis Horse Lighthouse M60 Panther Playground Train; do
  echo "scene $SCENE"
  mkdir -p "$OUTDIR"
  python -m cds_mvsnet_tpu_torch.cli.test_cli \
    --dataset tt --testpath "$TESTPATH" --testlist <(echo "$SCENE") \
    --resume "$CKPT" --outdir "$OUTDIR" --no_refinement \
    --interval_scale 1.0 --num_view 10 --numdepth 256 \
    --max_h "${RES_H[$SCENE]}" --max_w "${RES_W[$SCENE]}" \
    --filter_method normal --conf "${CONF[$SCENE]}" \
    --thres_view "${VTH[$SCENE]}" --thres_disp 1.0
done
