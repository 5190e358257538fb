#!/usr/bin/env bash
# Hyperparameter sweep over learning rates / seeds / hidden dims, PyTorch port.
# Capability parity: scripts/tpu_sweep.sh, the JAX package's counterpart of
# the reference's bash-loop sweep (src/slurm/slurm_loop.sh:13-22). `sweep`
# trains the whole lr x seed grid in one captured step a chunk (the configs
# a loop inside one CUDA graph; train/sweep.py); hidden-dim shapes run
# sequentially around it.
set -euo pipefail

DATASET_HOME="${DATASET_HOME:-../data}"
CHECKPOINT_ROOT="${CHECKPOINT_ROOT:-../sweeps}"

python -m inferbiomechanics_tpu_torch sweep \
  --dataset-home "$DATASET_HOME" \
  --checkpoint-dir "$CHECKPOINT_ROOT" \
  --model-type feedforward \
  --lrs 1e-3 1e-4 1e-5 \
  --seeds 0 1 2 \
  --hidden-dims-grid "512,512" "1024,1024" "256,256,256" \
  --epochs "${EPOCHS:-5}" "$@"
# results: $CHECKPOINT_ROOT/sweep/feedforward/sweep_results.json (ranked,
# with per-config dev curves) + one loadable checkpoint per config
