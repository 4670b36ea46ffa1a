#!/usr/bin/env bash
# Pipeline orchestration on the PyTorch port (the counterpart of
# run-pipeline.sh, which runs the JAX package).
#
# Usage: ./run-pipeline-torch.sh <config.conf> [expdir]
#
# Creates an experiment directory, snapshots the config + code state, then
# runs the three stages sequentially on this host's GPU:
#   1. eventvae tokenizer   (mem_tpu_torch.cli.train_vae)
#   2. MEM pretraining      (mem_tpu_torch.cli.run_mem_pretraining)
#   3. classification FT    (mem_tpu_torch.cli.run_class_finetuning)
# pruning non-final checkpoints between stages. Config keys are the same
# flat `key = value` .conf surface as run-pipeline.sh (configs/*.conf); a
# `device = cpu` key reaches every stage as its --device (each stage reads
# the conf). Stage skipping: vae_skip / pt_skip keys; stage checkpoints
# (.pth files) can be injected via vae_checkpoint / pt_checkpoint.
set -euo pipefail

CONFIG=${1:?usage: run-pipeline-torch.sh <config.conf> [expdir]}
EXPDIR=${2:-}

get_config_value() {  # reference run-pipeline.sh:10-14 semantics
    # `|| true`: a missing key yields empty, not a set -e abort
    { grep -E "^$1 *=" "$CONFIG" || true; } | tail -1 \
        | sed 's/^[^=]*= *//' | sed 's/ *$//'
}

expweek=$(get_config_value expweek)
expname=$(get_config_value expname)
if [ -z "$EXPDIR" ]; then
    EXPDIR="experiments/${expweek}_${expname}"
fi
mkdir -p "$EXPDIR"/{vae,pretrain,finetune,logs}

# snapshot config + code state
cp "$CONFIG" "$EXPDIR/config.conf"
git -C "$(dirname "$0")" rev-parse HEAD > "$EXPDIR/code_version.txt" 2>/dev/null || true
git -C "$(dirname "$0")" diff > "$EXPDIR/code_diff.patch" 2>/dev/null || true

PY=${PYTHON:-python}
LOG="$EXPDIR/logs/log.txt"
echo "== pipeline start $(date -Is) config=$CONFIG expdir=$EXPDIR" | tee -a "$LOG"

vae_skip=$(get_config_value vae_skip); vae_skip=${vae_skip:-0}
pt_skip=$(get_config_value pt_skip); pt_skip=${pt_skip:-0}
vae_ckpt=$(get_config_value vae_checkpoint)
pt_ckpt=$(get_config_value pt_checkpoint)

prune() {  # keep final/best/latest (train-pipeline.sbatch:87-101)
    $PY - "$1" <<'PRUNE'
import sys
from mem_tpu_torch.utils.checkpoint import prune_checkpoints
prune_checkpoints(sys.argv[1])
PRUNE
}

# -- stage 1: VAE -----------------------------------------------------------
if [ "$vae_skip" != "1" ] && [ -z "$vae_ckpt" ]; then
    echo "== stage 1: event VAE" | tee -a "$LOG"
    $PY -m mem_tpu_torch.cli.train_vae --config "$CONFIG" \
        --output_dir "$EXPDIR/vae" 2>&1 | tee -a "$LOG"
    prune "$EXPDIR/vae"
    vae_ckpt="$EXPDIR/vae/checkpoint-final.pth"
fi

# -- stage 2: pretraining ---------------------------------------------------
if [ "$pt_skip" != "1" ] && [ -z "$pt_ckpt" ]; then
    echo "== stage 2: MEM pretraining (vae: $vae_ckpt)" | tee -a "$LOG"
    $PY -m mem_tpu_torch.cli.run_mem_pretraining --config "$CONFIG" \
        --discrete_vae_weight_path "$vae_ckpt" \
        --output_dir "$EXPDIR/pretrain" 2>&1 | tee -a "$LOG"
    prune "$EXPDIR/pretrain"
    pt_ckpt="$EXPDIR/pretrain/checkpoint-final.pth"
fi

# -- stage 3: finetuning ----------------------------------------------------
echo "== stage 3: classification finetuning (pt: $pt_ckpt)" | tee -a "$LOG"
$PY -m mem_tpu_torch.cli.run_class_finetuning --config "$CONFIG" \
    --finetune "$pt_ckpt" \
    --output_dir "$EXPDIR/finetune" 2>&1 | tee -a "$LOG"
prune "$EXPDIR/finetune"

echo "== pipeline done $(date -Is)" | tee -a "$LOG"
