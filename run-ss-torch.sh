#!/usr/bin/env bash
# Semantic-segmentation stage orchestration on the PyTorch port (the
# counterpart of run-ss.sh, which runs the JAX package).
#
# Usage: ./run-ss-torch.sh <config.conf> [expdir] [pretrained_ckpt]
#
# Creates the experiment directory, snapshots the config + code state, then
# runs on this host's GPU:
#   1. seg training   (mem_tpu_torch.cli.train_seg)  — 160k iters, poly LR,
#      layer-decay 0.65, periodic mIoU eval (the DistEvalHook role)
#   2. seg evaluation (mem_tpu_torch.cli.test_seg)   — per-class mIoU/mDice/
#      mFscore table (+ optional --aug_test TTA from the .conf)
# pruning non-final checkpoints in between. Same flat `key = value` .conf
# surface as run-pipeline-torch.sh; a `device = cpu` key reaches both stages
# as their --device. The backbone checkpoint (a pretraining .pth) comes from
# the conf's `pretrained` key or $3.
set -euo pipefail

CONFIG=${1:?usage: run-ss-torch.sh <config.conf> [expdir] [pretrained_ckpt]}
EXPDIR=${2:-}
PRETRAINED=${3:-}

get_config_value() {  # reference run-ss.sh:10-15 semantics
    # `|| true`: a missing key yields empty, not a set -e abort
    { grep -E "^$1 *=" "$CONFIG" || true; } | tail -1 \
        | sed 's/^[^=]*= *//' | sed 's/ *$//'
}

expweek=$(get_config_value expweek)
expname=$(get_config_value expname)
if [ -z "$EXPDIR" ]; then
    EXPDIR="experiments/${expweek}_${expname}"
fi
mkdir -p "$EXPDIR"/{seg,logs}

cp "$CONFIG" "$EXPDIR/config.conf"
git -C "$(dirname "$0")" rev-parse HEAD > "$EXPDIR/code_version.txt" 2>/dev/null || true
git -C "$(dirname "$0")" diff > "$EXPDIR/code_diff.patch" 2>/dev/null || true

PY=${PYTHON:-python}
LOG="$EXPDIR/logs/log.txt"
echo "== seg pipeline start $(date -Is) config=$CONFIG expdir=$EXPDIR" | tee -a "$LOG"

if [ -z "$PRETRAINED" ]; then
    PRETRAINED=$(get_config_value pretrained)
fi
PRETRAINED_ARGS=()
if [ -n "$PRETRAINED" ]; then
    PRETRAINED_ARGS=(--pretrained "$PRETRAINED")
fi

echo "== stage 1: seg training (pretrained: ${PRETRAINED:-none})" | tee -a "$LOG"
$PY -m mem_tpu_torch.cli.train_seg --config "$CONFIG" \
    "${PRETRAINED_ARGS[@]+"${PRETRAINED_ARGS[@]}"}" \
    --output_dir "$EXPDIR/seg" 2>&1 | tee -a "$LOG"
$PY - "$EXPDIR/seg" <<'PRUNE'
import sys
from mem_tpu_torch.utils.checkpoint import prune_checkpoints
prune_checkpoints(sys.argv[1])
PRUNE

CKPT="$EXPDIR/seg/checkpoint-final.pth"
# evaluate on the val split: the conf's img_dir/ann_dir point at train for
# the training stage, so re-point them explicitly (CLI overrides beat conf)
VAL_IMG=$(get_config_value val_img_dir); VAL_IMG=${VAL_IMG:-imgs/val}
VAL_ANN=$(get_config_value val_ann_dir); VAL_ANN=${VAL_ANN:-anns/val}
echo "== stage 2: seg evaluation ($CKPT)" | tee -a "$LOG"
$PY -m mem_tpu_torch.cli.test_seg --config "$CONFIG" \
    --checkpoint "$CKPT" \
    --img_dir "$VAL_IMG" --ann_dir "$VAL_ANN" 2>&1 | tee -a "$LOG"

echo "== seg pipeline done $(date -Is)" | tee -a "$LOG"
