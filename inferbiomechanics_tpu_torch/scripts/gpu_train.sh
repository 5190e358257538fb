#!/usr/bin/env bash
# Single-node GPU training run of the PyTorch port.
# Capability parity: scripts/tpu_train.sh, the JAX package's counterpart of
# the reference's SLURM wrappers (src/slurm/slurm_example.sh) — resource
# selection + the train command — on a CUDA machine. Run from the repo root
# (or with the repo on PYTHONPATH).
set -euo pipefail

DATASET_HOME="${DATASET_HOME:-../data}"
CHECKPOINT_DIR="${CHECKPOINT_DIR:-../checkpoints}"
MODEL="${MODEL:-feedforward}"

# DOCTOR=1: gate the run on the machine's health (CUDA device, nvcc, the
# kernels' build, a K1 launch, copy and matmul rates; `doctor` exits 1
# when one of them looks degraded)
if [[ "${DOCTOR:-0}" == "1" ]]; then
  python -m inferbiomechanics_tpu_torch doctor || { echo "backend degraded — not launching"; exit 1; }
fi

exec python -m inferbiomechanics_tpu_torch train \
  --dataset-home "$DATASET_HOME" \
  --checkpoint-dir "$CHECKPOINT_DIR" \
  --model-type "$MODEL" \
  --history-len 50 --stride 5 \
  --batch-size "${BATCH_SIZE:-4096}" \
  --epochs "${EPOCHS:-10}" \
  --opt-type "${OPT:-rmsprop}" --learning-rate "${LR:-1e-4}" \
  "$@"
