#!/usr/bin/env bash
# Multi-GPU (and multi-node) data-parallel training of the PyTorch port.
# Capability parity: scripts/tpu_multihost_train.sh, the JAX package's
# counterpart of the reference's torchrun DDP launchers. IB_MULTIHOST=1
# makes `train` join the process group torchrun sets up, one GPU a rank
# (NCCL; parallel/dist.py). One node: run it as it is. Several nodes: run
# this same script on every node with NNODES, NODE_RANK (0 .. NNODES-1),
# MASTER_ADDR (node 0's address) and MASTER_PORT set alike. GPUs a node
# default to the count `nvidia-smi -L` lists (NPROC_PER_NODE overrides it).
set -euo pipefail

export IB_MULTIHOST=1
exec torchrun \
  --nnodes "${NNODES:-1}" \
  --node-rank "${NODE_RANK:-0}" \
  --master-addr "${MASTER_ADDR:-localhost}" \
  --master-port "${MASTER_PORT:-29500}" \
  --nproc-per-node "${NPROC_PER_NODE:-$(nvidia-smi -L | grep -c '^GPU')}" \
  -m inferbiomechanics_tpu_torch train \
  --dataset-home "${DATASET_HOME:-../data}" \
  --checkpoint-dir "${CHECKPOINT_DIR:-../checkpoints}" \
  --model-type "${MODEL:-feedforward}" \
  --batch-size "${BATCH_SIZE:-4096}" \
  "$@"
