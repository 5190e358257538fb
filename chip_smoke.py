#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``inferbiomechanics_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run:
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. build the kernels (``ops/csrc/*.cu``: K1 fused MLP, K2 fused encoder
     layer, K3 its backward, K4 fused GroundLink forward) from this checkout
     with nvcc;
  3. each kernel against its plain PyTorch version on the card: K1 at 17
     cases (atol 1e-2; both of its kernels, either side of the batch where
     the choice turns, odd batches), K2 at ten, each through both of its
     shapes (small: a cluster splits the columns; large: one block a row
     tile), at full width either side of the threshold (rtol = atol = 1e-2),
     K4 at fifteen, each through both of its shapes (small: a cluster splits
     every layer's columns; large: one block a tile of many windows), either
     side of the threshold and in both output formats (2e-2 x max|plain|),
     K3 at ten (dx and each of the 12 gradients within 2e-2 x
     that tensor's max|plain|, and two calls bitwise equal), each in the
     shape its plan picks (small: a cluster splits the columns; large: one
     block a tile), either side of the threshold, and at B = 19 and 64
     through both shapes, with random biases and LayerNorm rows;
  4. the feedforward serving slice through the ``serve`` command's wiring:
     the default model at full width (1770->512->512->30, sigmoid, window
     50 / stride 5, max_batch 4096) with seeded random weights, answering
     /health, /schema, /predict (JSON, b64), /predict_file, concurrent
     clients through the dynamic batcher, /reload and /metrics; every answer
     is held against the plain version on the card, and every device forward
     must have launched K1 once;
  5. the transformer serving slice, the same requests through
     ``serve --model-type transformer --fused-inference`` at full width
     (d_model 256, 4 layers, 8 heads, 4x MLP, T = 10, 177 channels, 7 output
     heads): every head of every answer is held against the plain fused
     forward on the card, /schema says ``fused_inference: true``, and every
     device forward must have launched K2 four times;
  5b. the GroundLink serving slice, the same requests through ``serve
     --model-type groundlink`` at full width (177 -> 128 -> 128 -> 256 -> 256,
     k = 7, T = 10, fc_depth 3): every answer is held against the plain
     version on the card, and every device forward must have launched K4
     once;
  5c. the serving extras, at fewer requests: a 3-member feedforward
     ``--ensemble`` (mean and spread against the plain versions, 3 K1
     launches a forward, /reload refused), ``--tta-mirror`` on GroundLink
     (the symmetrized plain forward, 2 K4 launches a forward) and
     ``--reload-poll-sec`` picking up a checkpoint written while serving;
  6. times at B=1 and B=4096 (K1 also at 64 and 512, with which of its two
     kernels served each; K2 with which of its shapes; K4 also at 8, 64 and
     512 in ``last_frame``, both output formats at 1 and 4096, with the
     shape that served each): each
     kernel, its plain version (the f32 precision reference) and a PyTorch library baseline (K1: a bf16 cuBLAS
     chain; K2: ``nn.TransformerEncoderLayer`` in bf16; K3: autograd through
     that layer, forward and backward; K4: bf16 ``F.pad`` + ``F.conv1d`` +
     ``F.elu`` x4 and ``F.linear`` x3, both output formats), by CUDA events
     and by profiler device time, beside the bound the card allows; the
     device time of K3 by launch (tile kernel, weight gradients, reduce) at
     B = 1, 64 and 4096 with the shape that served each; the
     rate of K3's tile kernel on the tensor cores; registers, stack and
     spills of K1's, K3's and K4's kernels as ptxas reports them; the 4-layer
     encoder stack; /predict p50 of the three services; the weight
     packing of a train step, a whole train step step by step (``pallas`` and
     ``vpu``) and where its time goes, and a ``pallas`` train step at the
     default batch of 64, where K3 runs its small shape (launches by shape
     counted); the ``pallas`` step at B = 4096 and 64 in chunks of 64 (the
     default ``--device-chunk-steps``: graph replays), by the host clock,
     with the device busy time and idle share beside those step by step, and
     the K2 and K3 kernels of a chunk counted in its profiler trace;
  7. training at full width through the ``train`` command's wiring: a
     synthetic train and dev set, ``--model-type transformer --attn-impl
     pallas --batch-size 4096``, 2 epochs in chunks (the default
     ``--device-chunk-steps 64``, clamped to the epoch: each step after the
     first two a replay of the step captured as a CUDA graph); the wrappers
     count the eager steps' launches and the capture's, and the run's
     profiler trace holds K2 4 times a forward (train steps and dev batches)
     and K3 4 x 3 times a train step, replays included; the loss falls; the
     same run step by step (``--device-chunk-steps 1``) ends bitwise where
     the chunked one ends, and so does the chunked run once more after it
     (windows/s of all three, with the capture's seconds); the first step
     built by hand through the kernels has the step-by-step run's first
     logged loss, and its loss and gradients agree with the same step
     through the plain versions on the card; a run
     stopped after epoch 0 and resumed ends with bitwise the parameters of
     the uninterrupted run; ``serve`` answers /predict from the checkpoint as
     the model's own forward does;
  7b. one epoch each of the same transformer with ``--attn-impl vpu`` (plain
     autograd) and of the default feedforward model;
  7c. one epoch of ``--model-type groundlink`` at the JAX defaults
     (``fc_dropout`` 0.2; plain bf16 autograd with dropout in training): the
     loss is finite and the last step's falls below the epoch's mean, K4
     launched once a dev-eval forward, a checkpoint written; windows/s of
     all four;
  7d. the chunked step: the ``pallas`` transformer at the default batch of
     64 over an epoch of two chunks of 64 and a remainder against the same
     epoch step by step, bitwise, with one capture, a replay a step after
     the first two, and the K2 and K3 kernels of the run counted in its
     profiler trace; the same on the host-loader tier (``--device-data off
     --host-chunk-steps 64 --host-upload-dtype bf16`` against step by step
     in float32, bitwise), and that tier at B=4096 in float32 with chunks of
     64 and of 8 against step by step (bitwise, windows/s);
     GroundLink (dropout 0.2) at B=4096 over 2 epochs chunked against step
     by step, and stopped after epoch 0 and resumed against uninterrupted
     (bitwise; else the first tensor that differs and by how much);
  8. ``analyze`` through the command's wiring on the checkpoints of phases 7
     (``pallas`` transformer), 7b (``vpu`` transformer, feedforward) and 7c
     (GroundLink), on a dev split of one synthetic subject (one trial of 600
     frames; the train split empty): each eval forward launched its kernel
     the expected number of times (K1 1, K2 4, K4 1; none for ``vpu``), the
     report agrees with the same evaluation through the plain versions at the
     phase 3 tolerances, CSV rows with ``--eval-chunk-steps 64`` equal those
     with 1 within 1e-5 relative, a 2-member feedforward ``--ensemble`` (2 K1
     launches a forward) and ``--tta-mirror`` on GroundLink (2 K4 launches a
     forward) run once; eval windows/s of each model at B=1 (metrics to the
     host every 64 batches and every batch) and at B=512 (on a dev split of
     its own, 24 full batches, after a warm-up run) beside the card's name
     and power limit;
  9. the diffusion denoiser at full width (d_model 256, 4 layers, 8 heads,
     1000 timesteps, 50 DDIM steps, 30 target channels) with seeded weights,
     an EMA tree that differs, a ``run_config.json`` sidecar (normalized
     target space) and a sidecar-less copy (raw): the chains through K2
     against the same chains through the plain layer at B = 1, 2 and 64 with
     eta 0, eta 1 and guidance 2 (the 50-step chain's eps at each step on the
     plain chain's own x_t within 5e-2 x max|plain|, its answers per head
     printed; a partial chain's (partial_frac 0.3) answers element by
     element within 5e-2 x each head's max; 4 x (50 + 15) K2 launches, the
     50-step chain's also counted by name in a profiler trace at B=1 with
     the device's idle share); ``serve --model-type diffusion
     --fused-inference`` (answers equal to the chain run directly, 200 K2
     launches a device forward, /predict p50 at B=1, windows/s at B=4096,
     ``--diffusion-samples 4`` as one stacked batch, ``--use-ema``,
     ``--diffusion-partial 0.3`` from a feedforward all-frames proposal (its
     t_top 300 and 15 steps, K1 once a forward; the answer element by
     element against the plain chain from the plain proposal), the reload
     poller, /schema, the raw target space); ``analyze --model-type
     diffusion --fused-inference`` at B=1 on a dev split of 149 windows (200
     K2 launches a window, rows equal run to run, eval windows/s; with
     ``--diffusion-partial 0.3`` its rows against the plain chains' within
     5e-2 x each column's max);
  10. diffusion training at full width through the ``train`` command
     (``--model-type diffusion --output-data-format all_frames --ema-decay
     0.999 --cond-dropout 0.1 --fused-inference``): at the default B=64 on
     one subject (148 steps an epoch: two chunks of 64 and a remainder) with
     a dev split of one batch, 2 epochs traced: one capture, a replay a step
     after the first two, no K3, the dev eval's K2 launches (200 a dev batch
     and eval) counted by the wrappers and by name in the trace, the loss
     falls, EMA in the checkpoint; the same run step by step, and stopped
     after epoch 0 and resumed, bitwise (parameters, optimizer state, EMA);
     ``serve --use-ema`` (the answer of the EMA weights' chain) and
     ``analyze --use-ema`` of the trained checkpoint; the trained weights'
     dev chain through K2, each step's eps on the plain chain's own x_t
     within 5e-2 x max|plain|, and a partial chain's answers element by
     element; 2 epochs at B=4096 on phase 7's 40 subjects; the chunked
     step's ms by the host clock, device busy ms and idle share, and a dev
     chain's seconds, at both batches.
 11. the training options beside the JAX defaults through ``train``,
     ``serve`` and ``analyze`` (``phase_regularised``): the feedforward model
     with ``--batchnorm --dropout --dropout-prob 0.1 --augment-mirror
     --augment-noise-std 0.05`` at B=4096 on phase 7's 40 subjects (2
     epochs, one chunk an epoch, K1 in the dev evals) and at B=64 on phase
     7d's subject (also with ``--grad-accum-steps 2``), chunked against step
     by step and resumed against uninterrupted, bitwise with the running
     statistics; its eval through K1 on the folded packing against the plain
     version (``k1_limit``), timed at B=1 and 4096; ``serve`` and ``analyze``
     of its checkpoint, K1 once a forward; a chunk's coins recorded inside
     its replays (all distinct, about half mirrored); the ``pallas``
     transformer augmented, its K2 and K3 kernels in a profiler trace equal
     to the same run's unaugmented; the ``vpu`` transformer with dropout,
     served through K2; the denoiser with ``--augment-mirror`` and EMA,
     chunked against step by step; the chunked step's ms, device busy ms and
     idle share with and without augmentation.
 12. the analytical and physics path (``phase_physics``): two synthetic
     subjects with differently scaled standard skeletons and the coupled
     knee of ``tests/fixtures/knee_golden.osim``; FK, COM acceleration and
     ``inverse_dynamics_from_predictions`` on the card against the same code
     in float64 on the CPU (1e-5 / 1e-4 x max|.|); ``analyze --model-type
     analytical --compute-report`` at B=1 in chunks of 64 and of 1 (one
     CUDA graph a batch shape; rows and report equal), its first 8 batches
     graphed bitwise equal to the eager step and against the float64 CPU
     step, launches a batch eager and replayed and a chunk of 8 batches'
     idle share in a profiler trace, and B=512 on phase 8's 24 batches;
     ``analyze --compute-report`` of phase 8's feedforward and GroundLink
     checkpoints (a K1 / K4 launch a forward, rows unchanged, the report's
     host ms a batch, the report against the float64 CPU report of the same
     outputs);
     ``train --compute-report`` (feedforward, 2 epochs at B=64), whose dev
     ``tau_avg_err`` is the report over the same dev batches.
 13. checkpoints across frameworks (``phase_checkpoints``): JAX-format
     files of every family written by the port's own msgpack writer (seeded
     full-width weights, an rmsprop ``nu`` tree, the denoiser's EMA), served
     by ``serve --checkpoint-file x.ckpt`` (K1 once, K2 4 times a forward or
     a DDIM step, K4 once) and scored by ``analyze --checkpoint-file``,
     bitwise the same weights' ``.torch.pt``; ``train --async-checkpoint``
     against ``train`` (feedforward at B=4096 on phase 7's 40 subjects, 2
     epochs, and the ``pallas`` transformer at B=64; a checkpoint a chunk of
     4): the checkpoints bitwise equal, the snapshot's ms against the
     synchronous write's, the chunked step's ms with and without the flag;
     a SIGTERM to a ``train`` subprocess during an asynchronous (slowed)
     write: exit 0, the newest checkpoint loads; a JAX-format ``pallas``
     payload converted and resumed by ``train``, K2 and K3 counted by name
     in a profiler trace (12 K3 launches a step), bitwise the run resumed
     from the port's ``.torch.pt``; a soup of two trained feedforward
     checkpoints served through K1 (``k1_limit``).
 14. scale-out on one card (``phase_scale_out``): ``train --device-data
     stream`` on phase 7's 40 subjects cut into at least 4 segments (the
     ``pallas`` transformer at B=4096 for an epoch, K2 and K3 counted by name
     in a profiler trace; feedforward for 2 epochs in chunks of 64, of 1 and
     with ``--no-materialize-features``, each epoch's losses and the final
     checkpoints bitwise; windows/s beside the device-resident runs, a
     segment's upload, training and build ms, a streamed epoch's idle
     share; the denoiser with EMA at B=64, 200 K2 launches a dev batch), and
     ``sweep`` (feedforward at B=4096, 3 lrs x 2 seeds, 2 epochs, plain and
     ``--pbt-every 1``; ``pallas`` at B=64, 2 x 2, traced; GroundLink and the
     denoiser at B=64, 2 x 1): config i bitwise a one-config sweep of
     (lr_i, seed_i), the kernels' launches K times a one-config sweep's, a
     sweep stopped by SIGTERM after epoch 0 and rerun bitwise the
     uninterrupted one, a point served through K1; the aggregate windows/s,
     the chunked step's ms against K, the captures' seconds.
 15. data parallelism over processes (``phase_data_parallel``): world 1 on
     NCCL in this process, the ``pallas`` transformer and feedforward at
     B=4096 in chunks of 8 captured steps with the gradient all-reduce inside
     the graph, bitwise the chunks without a process group, K2 / K3 / NCCL
     kernels counted in a profiler trace, a step's ms with and without the
     group and the all-reduce's alone; two ranks sharing the card over gloo
     (NCCL with two GPUs), feedforward and ``pallas`` steps bitwise equal
     across the ranks and within 2e-2 x max of one process at the global
     batch, K1-K4 launched in every rank and held to their plain versions;
     the ``train`` command under ``IB_MULTIHOST=gloo torchrun
     --nproc-per-node 2`` on ``--device-data sharded`` (``--geometry-folder``
     named, ``--no-wandb``): feedforward with
     ``--grad-allreduce-dtype bf16`` (rank 0's checkpoint served through
     K1), the denoiser with EMA (its dev chains through K2). ``--only-phase
     15`` runs the build and this phase alone.
 16. model parallelism and sharded sweeps (``phase_model_parallel``), every
     rank a gloo rank sharing the card. Three commands in one
     ``IB_MULTIHOST=gloo torchrun --nproc-per-node 2`` (``chip_smoke.py
     --rank-jobs``): ``train --model-parallel 2`` (the ``pallas`` transformer
     at full width, B=64; one ``data`` row, step by step with no collective;
     both ranks bitwise one process, 4 K2 and 12 K3 a step in each rank's
     profiler trace; the ``sharding_rules`` shard's bytes against the whole
     state, its gather bitwise), the 1-D ``sweep --device-data sharded``
     (feedforward K=2 at B=512) and ``sweep --shard-configs`` (``pallas`` K=4
     at B=64, 2 epochs, ``--pbt-every 1``: bitwise the one-process sweep, 8
     K2 and 24 K3 a step in each rank's trace, a rank's step ms in chunks of
     captured steps against one process's); then the 2-D (config 2, data 2)
     layout on four ranks (``--nproc-per-node 4``), bitwise the 1-D sweep,
     K1 in its dev evals. ``--only-phase 16`` runs the build and this phase
     alone.
 17. inference and serving extras (``phase_inference``) at full width:
     ``serve --quantize int8`` of a feedforward checkpoint (no K1 launch; its
     answers at B=1 and B=4096 against the same int8 forward on the CPU, a
     few quantisation steps apart at most, and within 5% of the range of
     the f32 plain forward; /predict p50 at B=1, windows/s at B=4096);
     ``analyze --quantize int8`` at B=1 and B=512 beside the unquantized
     command (windows/s, the reports); ``export`` of feedforward, the
     ``pallas`` transformer, GroundLink and the int8 feedforward, each loaded
     back with ``torch.export.load`` and run at B=1 and 4096: K1 once, K2 4
     times, K4 once a call, bitwise the eager eval forward; the export's
     seconds and the artifact's bytes; the diffusion chain exported at
     ``--static-batch 2 --sample-steps 10`` (its seed at call time, bitwise
     the eager chain); one K1 call through the ``ib_torch::fused_mlp``
     operator against the direct call (us each); ``save-prediction-csv``
     through K1 against ``--device cpu``, the ``Predictor``'s windows/s at
     batch 512. ``--only-phase 17`` runs the build and this phase alone.
 18. the viewer commands (``phase_viewer``) at full width on phase 17's
     checkpoints, for feedforward (K1), the ``pallas`` transformer (K2) and
     GroundLink (K4), on subject 0 of phase 4's data with a Geometry folder
     of small meshes: ``visualize-file`` of a 1100-frame trial (1049
     windows: 3 forwards of at most 512, 4 K2 launches each) against the
     same command with ``--device cpu`` (data exactly, FK within 1.5e-4,
     predictions at each kernel's served-answer tolerance, a frame near the
     0.3 rule on its CoPs), the command's seconds and the payload's; 200
     ticks of ``visualize``'s live session (a B=1 forward, the loss
     evaluator and FK a tick; p50 / p99 ms against the 40 ms tick, launches
     a tick), the first five against the CPU session's; ``visualize-file
     --live`` serving a WebSocket client on a loopback port; ``review-file
     --threshold-ratio 1.25`` (both trials) against its rows from the CPU
     Predictor. ``--only-phase 18`` runs the build and this phase alone.
 19. the lifted flags and the small commands (``phase_cli_extras``) at full
     width on the defaults, four train subjects and one dev subject:
     ``pickle-data``, then feedforward ``train --use-pickled`` and ``train``
     from the ``.b3d`` files with the same flags and seed, their checkpoints
     bitwise equal and K1 launched once a dev batch, both runs logged with
     their git hash to the JSONL fallback, wandb hidden (``--geometry-folder``
     named: nothing fetches); ``train --model-type transformer --attn-impl pallas
     --profile`` for one epoch at B=64 beside the same run unprofiled,
     before and after it: checkpoints bitwise equal, the Chrome trace read
     back holding K3 12 x steps and K2 4 x (steps + dev forwards) by the
     names ``ops/tune.py`` uses, its bytes and what ``--profile`` added to
     the epoch and to the command; ``analyze --plot-errors`` for feedforward
     (K1) and GroundLink (K4): the PNGs of both splits, the CSV rows of the
     run without the flag, one launch a batch; ``sanity-check``, each
     printed statistic against float64 on the card. ``--only-phase 19``
     runs the build and this phase alone.
 20. the last four commands (``phase_last_commands``), each in this process
     through ``__main__.main``: ``doctor --json --transfer-mb 256
     --dataset-home`` phase 4's data (healthy; the card's name and power
     limit as ``nvidia-smi`` gives them; K1 once at B=1 and once at B=4096,
     held to ``mlp_reference``, and in a profiler trace of a second run two
     ``fused_mlp_kernel`` launches of two instantiations; pageable and
     pinned GB/s, the build's status, each launch's us); ``make-plots`` over
     phase 4's subjects with every figure group, drawn by
     ``utils/png_plot.py`` (matplotlib hidden where installed): the files
     ``render_plots`` names, PNGs that decode, again from ``--use-cache``;
     ``plot-training`` of phase 19's JSONL run logs (finals equal to each
     key's last value) and ``--compare`` of both; ``convert-b3d`` of 4
     legacy subjects of 2 x 1500 frames, each output byte for byte what
     ``ensure_tpu_format`` writes, then ``--verify`` and ``--infer-schema``
     clean. ``--only-phase 20`` runs the build and this phase alone.
 21. the last options (``phase_options``):
     ``--attn-impl flax`` in the transformer and the denoiser, ``--conv-impl
     banded`` in GroundLink; both flax runs converted to the ``vpu`` tree by
     ``scripts/convert_attn_checkpoint.py`` (``.torch.pt`` and ``.ckpt``,
     there and back bitwise) and served, scored and sampled through K2
     (``phase_converted_flax``). ``--only-phase 21`` runs the build and this
     phase alone.
 22. the quality studies (``phase_quality``; ``inferbiomechanics_tpu_torch/
     scripts/``) on the study split of 5796 train and 2898 dev windows,
     each through its command-line entry in this process: ``parity_rmse
     --model feedforward --epochs 2`` and ``anchor_quality --family
     transformer --attn-impl pallas --epochs 1``. The data's sha256 equals
     ``docs/port_parity/study_data.json``'s; a profiler trace of each run
     holds K1 once a dev batch, K2 4 x (train steps + dev batches) and K3's
     three kernels 4 x train steps, as the wrappers count them; each curve
     is finite and ends with its dev force and COM-acc errors below those
     of its initial weights.
     ``--only-phase 22`` runs the build and this phase alone.

Profiler device times (``ops/tune.py::device_times``) come from traces that
hold every launch of the work (a window opens with 256 launches that are not
counted, and the device idles 50 ms before and after the work): a kernel's
time is its duration summed over the launches traced, divided by that count;
a trace short of ``iters`` x a call's launches fails the run.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or run outside a checkout
of the repo, it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import csv
import dataclasses
import functools
import importlib.util
import io
import json
import logging
import os
import re
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np

REPO = Path(__file__).resolve().parent
# K1. One bf16 ulp below 2.0 is 7.8e-3: a different summation order in f32 can
# flip the final bf16 rounding by one ulp, and the outputs stay below 2.
ATOL = 1e-2
# K2 against its plain version. Both round the same operands to bf16 and sum
# in f32; they differ in the order of the sums and the bf16 roundings that
# flips, on outputs of a few units. The JAX suite allows its TPU kernel
# rtol = atol = 5e-2 for the same comparison.
ENC_TOL = 1e-2
# A served transformer answer against the plain fused forward, per head,
# relative to the head's largest value: the heads round to bf16 (one ulp at
# 2..4 is 1.6e-2), so a layer difference within ENC_TOL can move an answer
# by an ulp or two. The JAX suite holds its fused forward to 3e-2 this way.
HEAD_REL = 3e-2
# K4 against its plain version, relative to the largest output. Both round
# the same operands to bf16 and sum in f32; a different order of the sums
# flips the bf16 rounding of some activations (2^-8 relative), and the six
# layers that follow carry and amplify a flip. The plain version on a CPU with
# every f32 sum perturbed by 1e-6 relative moves its own outputs by 3.4e-3 x
# max|out| at full width, and the kernel was seen up to 3.9e-3 x max|plain|
# from the plain version on the card; a wrong tap, row or bias moves the
# outputs by their own size. The JAX suite allows its fused forward 5e-2 x
# max|ref| in bf16. A served answer is held the same way, against the largest
# value of its whole 30-wide output vector: the four heads are slices of it,
# and an error of this size may fall on the head with the smallest values.
GL_REL = 2e-2
# K3 against its plain version, dx and each of the 12 gradients relative to
# that tensor's largest plain value. Both recompute the forward with the same
# bf16 operands and f32 sums and round the same gradient operands to bf16;
# they sum in another order, which flips bf16 roundings of recomputed
# activations and of gradients that feed later products. The JAX suite allows
# its Pallas backward 5e-2 x max against jax.vjp in bf16
# (tests/test_pallas_encoder.py). The same limit holds a train step's
# gradients through the kernels against the step through the plain versions.
BWD_REL = 2e-2
# the K2 and K3 kernels by name in a profiler trace (the first name that
# matches; the cluster tile kernel is K3's small shape, the other its large)
ENC_KERNELS = ('fused_encoder_kernel', 'encoder_bwd_tile_kernel_cluster',
               'encoder_bwd_tile_kernel', 'encoder_wgrad_kernel', 'encoder_bwd_reduce_kernel')
K3_TILE = {'small': 'encoder_bwd_tile_kernel_cluster', 'large': 'encoder_bwd_tile_kernel'}
FULL_DIMS = [1770, 512, 512, 30]
GL_FULL = dict(t=10, c_in=177, features=(128, 128, 256, 256), taps=7, fc_depth=3, c_out=30)
ENC_FULL = dict(t=10, d=256, heads=8, mlp_ratio=4, layers=4)
# dense peaks of one H100 SXM (NVIDIA's data sheet), for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
K1 = {
    'name': 'fused_mlp_forward (K1)',
    'route': 'cuda',
    'source': 'inferbiomechanics_tpu_torch/ops/csrc/fused_mlp.cu',
    'replaces': 'inferbiomechanics_tpu/ops/pallas_mlp.py:53',
}
K2 = {
    'name': 'fused_encoder_layer (K2)',
    'route': 'cuda',
    'source': 'inferbiomechanics_tpu_torch/ops/csrc/fused_encoder.cu',
    'replaces': 'inferbiomechanics_tpu/ops/pallas_encoder.py:296',
}
K3 = {
    'name': 'fused_encoder_layer_bwd (K3)',
    'route': 'cuda',
    'source': 'inferbiomechanics_tpu_torch/ops/csrc/fused_encoder_bwd.cu',
    'replaces': 'inferbiomechanics_tpu/ops/pallas_encoder.py:520',
}
K4 = {
    'name': 'fused_groundlink_forward (K4)',
    'route': 'cuda',
    'source': 'inferbiomechanics_tpu_torch/ops/csrc/fused_groundlink.cu',
    'replaces': 'inferbiomechanics_tpu/ops/pallas_groundlink.py:149',
}


def k1_limit(max_abs: float) -> float:
    """K1's limit for outputs up to ``max_abs``: ATOL below 2, doubled for
    each octave above, where one bf16 ulp doubles (a batchnorm model's head,
    folded, gives outputs beyond 2)."""
    return ATOL * 2.0 ** max(0, int(np.ceil(np.log2(max_abs / 2)))) if max_abs > 2 else ATOL


def _get(url: str):
    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read())


def _post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body,
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _decode(outputs: dict) -> dict:
    """Response outputs (JSON lists or b64) -> numpy arrays by key."""
    out = {}
    for k, v in outputs.items():
        if isinstance(v, dict):
            v = np.frombuffer(base64.b64decode(v['b64']), '<f4').reshape(v['shape'])
        out[k] = np.asarray(v, np.float32)
    return out


def _agree(outputs: dict, want: dict, what: str, atol: float = 0.0,
           rel: float = 0.0) -> float:
    """Hold a response's outputs to ``want`` head by head, each within
    ``atol + rel * max|want head|``; returns the largest difference."""
    got = _decode(outputs)
    _check(set(got) == set(want), f'{what}: heads {sorted(got)}')
    worst = 0.0
    for k in want:
        _check(got[k].shape == want[k].shape and np.isfinite(got[k]).all(),
               f'{what}: bad output {k} {got[k].shape}')
        err = float(np.abs(got[k] - want[k]).max())
        limit = atol + rel * float(np.abs(want[k]).max())
        _check(err <= limit, f'{what}: head {k} max abs err {err} > {limit}')
        worst = max(worst, err)
    return worst


def _vector_limit(want: dict) -> float:
    """GL_REL x the largest value of a GroundLink answer over all its heads."""
    return GL_REL * max(float(np.abs(v).max()) for v in want.values())


def _random_params(torch, dims, gen):
    k_params = []
    for d0, d1 in zip(dims[:-1], dims[1:]):
        k = d0 ** -0.5
        k_params.append(((torch.rand(d0, d1, generator=gen) * 2 - 1) * k,
                         (torch.rand(d1, generator=gen) * 2 - 1) * k))
    return k_params


def _random_encoder_params(torch, fe, gen, d, mlp_ratio):
    """LeCun-normal kernels with random biases and LayerNorm rows (not the
    zeros and ones of ``init_encoder_params``, or a wrong bias add goes
    unseen)."""
    params = list(fe.init_encoder_params(gen, d, mlp_ratio))
    for i, p in enumerate(params):
        if p.ndim == 1:
            noise = torch.randn(p.shape, generator=gen)
            params[i] = 1.0 + 0.2 * noise if fe.PARAM_NAMES[i].endswith('scale') else 0.3 * noise
    return tuple(params)


def phase_k4_vs_plain(torch, fg, random_params, seed: int):
    """K4's two shapes against the plain version: at full width either side
    of the plan's threshold as the plan picks, and every case through the
    other shape as well (the threshold moved); returns the worst error at
    the full-width cases and the shape that served each case."""
    gen = torch.Generator().manual_seed(seed)
    full, small = GL_FULL['features'], (16, 16, 24, 24)
    edge = fg.SMALL_BATCH_MAX
    cases = [(b, 10, full, 3, fmt) for b in (1, 2, 7, edge, edge + 1, 4099)
             for fmt in ('last_frame', 'all_frames')]
    cases += [(37, 4, small, 3, 'all_frames'),     # the small test shape, padded widths
              (37, 4, small, 3, 'last_frame'),
              (37, 10, full, 1, 'last_frame')]     # the head right after the convs
    worst, served = 0.0, {}
    for b, t, features, fc_depth, fmt in cases:
        packed = fg.pack_groundlink_params(
            random_params(gen, GL_FULL['c_in'], features, fc_depth), 'cuda')
        x = torch.randn(b, t, GL_FULL['c_in'], generator=gen).cuda()
        ref = fg.groundlink_reference(x, packed.params, fmt, fc_depth)
        planned = fg.plan_groundlink(b, t, packed.pwidths, packed.n_conv, fc_depth,
                                     packed.taps, fmt != 'all_frames').shape
        for shape in (planned, 'large' if planned == 'small' else 'small'):
            fg.SMALL_BATCH_MAX = edge if shape == planned else (1 << 30 if shape == 'small' else 0)
            before, shapes_before = fg.launches, dict(fg.shape_launches)
            out = fg.fused_groundlink_forward(x, packed, fmt)
            fg.SMALL_BATCH_MAX = edge
            _check(fg.launches == before + 1 and
                   fg.shape_launches[shape] == shapes_before[shape] + 1,
                   f'launch counters did not rise for the {shape} shape')
            torch.cuda.synchronize()
            _check(out.shape == ref.shape == (b, t if fmt == 'all_frames' else 1, 30)
                   and bool(torch.isfinite(out).all()), f'bad output {tuple(out.shape)}')
            err, scale = float((out - ref).abs().max()), float(ref.abs().max())
            how = 'as planned' if shape == planned else 'threshold moved'
            print(f'[kernel] K4 B={b} T={t} {"->".join(map(str, features))} fc_depth '
                  f'{fc_depth} {fmt} ({shape} shape, {how}): max abs err {err:.3g}, max '
                  f'|ref| {scale:.3g} (limit {GL_REL} x max |ref|)', flush=True)
            _check(err <= GL_REL * scale, f'K4 disagrees with the plain version: {err}')
            if features == full:
                worst = max(worst, err)
            served.setdefault(f'B={b} T={t} fc_depth {fc_depth} {fmt}', []).append(shape)
    return worst, served


def phase_k1_vs_plain(torch, fm, seed: int) -> float:
    gen = torch.Generator().manual_seed(seed)
    # both of K1's kernels, either side of the batch where the choice turns,
    # odd batches (rows the tensor map of x cannot hold) and a ragged last tile
    edge = fm.SMALL_BATCH_MAX
    cases = [(b, FULL_DIMS, 'sigmoid') for b in (1, 2, 37, edge, edge + 1, 4096, 4099)]
    cases += [(b, FULL_DIMS, a) for b in (37, edge + 37)
              for a in ('relu', 'tanh', 'gelu', 'elu')]
    cases += [(37, [1770, 512, 512, 300], 'sigmoid'),      # all_frames head
              (37, [1770, 256, 256, 256, 30], 'sigmoid')]  # another depth
    worst = 0.0
    for b, dims, act in cases:
        packed = fm.pack_mlp_params(_random_params(torch, dims, gen), 'cuda')
        x = torch.randn(b, dims[0], generator=gen).cuda()
        before = fm.launches
        out = fm.fused_mlp_forward(x, packed, act)
        _check(fm.launches == before + 1, 'launch counter did not rise')
        ref = fm.mlp_reference(x, packed.layers, act)
        torch.cuda.synchronize()
        _check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
               f'bad output {tuple(out.shape)} for {dims}')
        err = float((out - ref).abs().max())
        print(f'[kernel] K1 B={b} {"->".join(map(str, dims))} {act} '
              f'({fm.plan_mlp(b, packed.pdims).kernel}-batch kernel): '
              f'max abs err {err:.3g} (atol {ATOL})', flush=True)
        _check(err <= ATOL, f'K1 disagrees with the plain version: {err}')
        worst = max(worst, err)
    return worst


def phase_k2_vs_plain(torch, fe, seed: int):
    """K2's two shapes against the plain version: at full width either side
    of the plan's threshold as the plan picks, and every case through the
    other shape as well (the threshold moved); returns the worst error and
    the shape that served each case."""
    gen = torch.Generator().manual_seed(seed)
    full = (ENC_FULL['t'], ENC_FULL['d'], ENC_FULL['heads'])
    edge = fe.SMALL_BATCH_MAX
    cases = [(b, *full) for b in (1, 2, 5, 37, edge, edge + 1, 4096, 4099)]
    cases += [(37, 4, 128, 4),         # the small test shape
              (37, 10, 384, 8)]        # 48-wide heads, two row tiles a block
    worst, served = 0.0, {}
    for b, t, d, heads in cases:
        packed = fe.pack_encoder_params(
            _random_encoder_params(torch, fe, gen, d, ENC_FULL['mlp_ratio']), 'cuda')
        x = torch.randn(b, t, d, generator=gen).cuda()
        ref = fe.encoder_layer_reference(x, packed.params, heads)
        planned = fe.plan_encoder(b, t, d, packed.mlp_dim, heads).shape
        for shape in (planned, 'large' if planned == 'small' else 'small'):
            if shape == 'small' and fe.small_cluster(d, heads) == 1:
                continue
            fe.SMALL_BATCH_MAX = edge if shape == planned else (1 << 30 if shape == 'small' else 0)
            before, shapes_before = fe.launches, dict(fe.shape_launches)
            out = fe.fused_encoder_layer(x, packed, heads)
            fe.SMALL_BATCH_MAX = edge
            _check(fe.launches == before + 1 and
                   fe.shape_launches[shape] == shapes_before[shape] + 1,
                   f'launch counters did not rise for the {shape} shape')
            torch.cuda.synchronize()
            _check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                   f'bad output {tuple(out.shape)}')
            err = float((out - ref).abs().max())
            excess = float(((out - ref).abs() - ENC_TOL * ref.abs()).max())
            how = 'as planned' if shape == planned else 'threshold moved'
            print(f'[kernel] K2 B={b} T={t} d={d} H={heads} ({shape} shape, {how}): max abs '
                  f'err {err:.3g}, max |ref| {float(ref.abs().max()):.3g} (rtol = atol = '
                  f'{ENC_TOL})', flush=True)
            _check(excess <= ENC_TOL, f'K2 disagrees with the plain version: {err}')
            worst = max(worst, err)
            served.setdefault(f'B={b} T={t} d={d} H={heads}', []).append(shape)
    return worst, served


def phase_k3_vs_plain(torch, fe, seed: int):
    """K3 against the plain version in the shape its plan picks (small: a
    cluster splits the columns; large: one block a tile), at full width on
    either side of the plan's threshold and at other shapes, and through both
    shapes (the threshold moved) at B = 19 and 64. Returns the largest error
    relative to its tensor's max|plain| at the full-width cases, and the shape
    that served each case."""
    gen = torch.Generator().manual_seed(seed)
    full = (ENC_FULL['t'], ENC_FULL['d'], ENC_FULL['heads'])
    edge = fe.BWD_SMALL_BATCH_MAX
    # 19: no multiple of the tile; the threshold and one past it
    cases = [(b, *full) for b in sorted({1, 8, 19, 64, edge, edge + 1, 4096})]
    cases += [(37, 4, ENC_FULL['d'], ENC_FULL['heads']),
              (37, 10, 128, 4),        # three row tiles, 128-column MLP chunks
              (700, 4, 128, 4),        # several tiles a block, several row splits
              (9, 10, 512, 8)]         # one window a tile; no small shape fits
    names = ('x',) + fe.PARAM_NAMES
    worst, served = 0.0, {}
    for b, t, d, heads in cases:
        packed = fe.pack_encoder_params(
            _random_encoder_params(torch, fe, gen, d, ENC_FULL['mlp_ratio']), 'cuda',
            transposes=True)
        x = torch.randn(b, t, d, generator=gen).cuda()
        g = torch.randn(b, t, d, generator=gen).cuda()
        ref_dx, ref_grads = fe.encoder_layer_bwd_reference(x, g, packed.params, heads)
        planned = fe.plan_encoder_bwd(b, t, d, packed.mlp_dim, heads).shape
        shapes = [planned]
        if (b, t, d, heads) in ((19, *full), (64, *full)):
            shapes.append('large' if planned == 'small' else 'small')
        for shape in shapes:
            fe.BWD_SMALL_BATCH_MAX = edge if shape == planned else (
                1 << 30 if shape == 'small' else 0)
            before, shapes_before = fe.bwd_launches, dict(fe.bwd_shape_launches)
            dx, grads = fe.fused_encoder_layer_bwd(x, g, packed, heads)
            _check(fe.bwd_launches == before + fe.BWD_LAUNCHES_PER_LAYER and
                   fe.bwd_shape_launches[shape] == shapes_before[shape] + 1,
                   f'K3 launch counters did not rise for the {shape} shape')
            dx2, grads2 = fe.fused_encoder_layer_bwd(x, g, packed, heads)
            fe.BWD_SMALL_BATCH_MAX = edge
            torch.cuda.synchronize()
            rel, at = 0.0, ''
            for name, got, again, ref in zip(names, (dx, *grads), (dx2, *grads2),
                                             (ref_dx, *ref_grads)):
                _check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                       f'K3 bad output {name} {tuple(got.shape)}')
                _check(bool(torch.equal(got, again)),
                       f'K3 {name}: two calls on the same inputs differ')
                r = float((got - ref).abs().max()) / float(ref.abs().max())
                if r > rel:
                    rel, at = r, name
            how = 'as planned' if shape == planned else 'threshold moved'
            print(f'[kernel] K3 B={b} T={t} d={d} H={heads} ({shape} shape, {how}): worst '
                  f'max abs err / max |plain| {rel:.3g} (at d{at}; limit {BWD_REL}); two '
                  f'calls bitwise equal', flush=True)
            _check(rel <= BWD_REL, f'K3 disagrees with the plain version: {rel} at d{at}')
            if (t, d, heads) == full:
                worst = max(worst, rel)
            served.setdefault(f'B={b} T={t} d={d} H={heads}', []).append(shape)
    return worst, served


def _ptxas_report(log: str, needle: str) -> dict:
    """What ``nvcc -Xptxas -v`` said of the kernels whose (mangled) name
    contains ``needle``: registers, bytes of stack, spill stores and loads."""
    out = {}
    pattern = (r"Function properties for (\S+)\s+(\d+) bytes stack frame, (\d+) bytes spill "
               r"stores, (\d+) bytes spill loads\s+ptxas info\s*: Used (\d+) registers")
    for name, stack, stores, loads, regs in re.findall(pattern, log):
        if needle in name:
            out[name] = dict(registers=int(regs), stack_bytes=int(stack),
                             spill_store_bytes=int(stores), spill_load_bytes=int(loads))
    return out


def _cuda_ms(torch, fn, iters: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _device_us(torch, fn, iters: int = 20):
    """Profiler device time per call (us) of ``fn``'s GPU kernels
    (``ops/tune.py::device_us``: each kernel's durations summed over the
    launches the trace holds, divided by that count, times its launches a
    call); None if the trace holds no device time. A trace of ``iters``
    calls short of ``iters`` x a call's launches fails the run
    (``ShortTraceError``, an AssertionError as ``_check`` raises)."""
    from inferbiomechanics_tpu_torch.ops.tune import device_us
    total = device_us(fn, iters)
    return total if total > 0 else None


def _traced(torch, fn, names=ENC_KERNELS):
    """Run ``fn()`` once under ``torch.profiler`` (``ops/tune.py::
    traced_kernels``: the window opens with launches that are not counted,
    and the device idles TRACE_MARGIN_S before and after the work); return
    its result, the GPU kernels of the work in the trace counted by the
    first of ``names`` their name holds ('other' for the rest), and their
    summed device time in us. Kernels a CUDA graph replays are in the trace
    one by one, so this counts the launches no wrapper saw."""
    from inferbiomechanics_tpu_torch.ops.tune import traced_kernels
    result, kernels = traced_kernels(fn)
    counts, busy = dict.fromkeys((*names, 'other'), 0), 0.0
    for name, us in kernels:
        counts[next((n for n in names if n in name), 'other')] += 1
        busy += us
    return result, counts, busy


def _check_traced(traced, layers: int, steps: int, forwards: int, shape: str, what: str):
    """The trace's K2 and K3 kernels are those of ``steps`` train steps and
    ``forwards`` more forwards of ``layers`` encoder layers, K3's tile kernel
    in ``shape``."""
    tile, other = K3_TILE[shape], K3_TILE['large' if shape == 'small' else 'small']
    want = {'fused_encoder_kernel': layers * (steps + forwards), tile: layers * steps,
            other: 0, 'encoder_wgrad_kernel': layers * steps,
            'encoder_bwd_reduce_kernel': layers * steps}
    _check(all(traced[k] == v for k, v in want.items()),
           f'{what}: traced kernels {traced}, want {want}')


def _device_us_by_name(torch, fn, names, iters: int = 10) -> dict:
    """Profiler device time per call of the GPU kernels whose name contains
    one of ``names``, and of all the others together (as :func:`_device_us`,
    and failing as it does on a trace short of its launches)."""
    from inferbiomechanics_tpu_torch.ops.tune import device_us_by_name
    return device_us_by_name(fn, names, iters)[0]


def _time_three(torch, fns: dict, iters: int = 10):
    """CUDA-event time (ms; plain, library, kernel, kernel, library, plain:
    the better of two medians of ``iters`` calls each) and profiler device
    time (us, ``iters`` traced calls) of the 'kernel', 'plain' and 'library'
    callables."""
    ms = {}
    for name in ('plain', 'library', 'kernel', 'kernel', 'library', 'plain'):
        ms[name] = min(ms.get(name, float('inf')), _cuda_ms(torch, fns[name], iters=iters))
    return ms, {name: _device_us(torch, f, iters) for name, f in fns.items()}


def _bf16_chain(torch, x, layers, act):
    """K1's speed baseline, not the precision reference: the layer chain as
    bf16 cuBLAS GEMMs (f32 accumulate, bf16 out, bias added in bf16)."""
    h = x.to(torch.bfloat16)
    for i, (W, b) in enumerate(layers):
        h = torch.addmm(b, h, W)
        if i < len(layers) - 1:
            h = act(h)
    return h.float()


def _bound(mm_flops: float, f32_flops: float, n_bytes: float):
    """(ms, 'bytes' or 'operations'): the least time the card could take."""
    t_ops = mm_flops / PEAK_BF16_FLOPS + f32_flops / PEAK_F32_FLOPS
    t_bytes = n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, 'operations' if t_ops >= t_bytes else 'bytes'


def k1_bound(batch: int, dims):
    """x read once (f32), the bf16 weights and f32 biases read once, the
    output written once (f32); 2 operations per multiply-add."""
    pairs = sum(d0 * d1 for d0, d1 in zip(dims[:-1], dims[1:]))
    n_bytes = batch * dims[0] * 4 + pairs * 2 + sum(dims[1:]) * 4 + batch * dims[-1] * 4
    return _bound(2.0 * batch * pairs, 0.0, n_bytes)


def k2_bound(batch: int, t: int, d: int, m: int):
    """x read and the output written once (f32), the bf16 weights and f32
    rows read once; the four products on the tensor cores (bf16), scores and
    value mix in f32 (2 T T d multiply-adds a window)."""
    pairs = 3 * d * d + d * d + 2 * d * m
    n_bytes = 2 * batch * t * d * 4 + pairs * 2 + (9 * d + m) * 4
    return _bound(2.0 * batch * t * pairs, 2.0 * 2 * batch * t * t * d, n_bytes)


def k4_bound(batch: int, fmt: str, t: int, c_in: int, features, taps: int,
             fc_depth: int, c_out: int):
    """x read once (f32), the bf16 weights and f32 biases read once, the
    output written once (f32); 2 operations per multiply-add, at true widths:
    the convs on the frames the output needs and the FC head on every frame
    (``all_frames``) or on the last. ``all_frames`` needs every frame of every
    conv; ``last_frame`` only the last ``min(T, 1 + (n - 1 - l) (k // 2))``
    frames of conv l of n (10, 7, 4 and 1 at T = 10, k = 7), since the head
    reads frame T-1 alone (fused_groundlink.layer_frames): 32.34 us at B=4096
    on the served model, where counting every frame gives 80.78 us."""
    widths = [c_in, *features]
    n = len(features)
    keep = [t if fmt == 'all_frames' else min(t, 1 + (n - 1 - l) * (taps // 2))
            for l in range(n)]
    conv_w = taps * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    conv = taps * sum(k * a * b for k, a, b in zip(keep, widths[:-1], widths[1:]))
    c = widths[-1]
    head = (fc_depth - 1) * c * c + c * c_out
    frames = t if fmt == 'all_frames' else 1
    n_bytes = (batch * t * c_in * 4 + (conv_w + head) * 2
               + (sum(features) + (fc_depth - 1) * c) * 4 + batch * frames * c_out * 4)
    return _bound(2.0 * batch * (conv + frames * head), 0.0, n_bytes)


def k3_bound(batch: int, t: int, d: int, m: int):
    """x and g read and dx written once (f32), the bf16 weights and f32 rows
    read once (the transposes are the same matrices), the f32 gradients
    written once. On the tensor cores: the recompute without its last product
    (Wqkv, Wproj, W1) and the eight gradient products (each weight once
    against its transpose and once as A^T G); in f32: scores and value mix
    forward (2 T T d multiply-adds a window) and dp, dv, dk, dq backward
    (4 T T d)."""
    pairs = 3 * d * d + d * d + 2 * d * m
    n_bytes = 3 * batch * t * d * 4 + pairs * 2 + (9 * d + m) * 4 + (pairs + 9 * d + m) * 4
    mm = 2.0 * batch * t * ((pairs - d * m) + 2 * pairs)
    return _bound(mm, 2.0 * 6 * batch * t * t * d, n_bytes)


def _host_p50_ms(fn, iters: int) -> float:
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _serve(port, argv):
    """One server from ``serve`` arguments, running; returns (service,
    server, url)."""
    svc, server = port.start(port.build_parser().parse_args(argv))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return svc, server, f'http://127.0.0.1:{server.server_address[1]}'


def _stop(svc, server):
    server.shutdown()
    server.server_close()
    svc.close()


def _b64_body(x: np.ndarray, **more) -> bytes:
    x = np.ascontiguousarray(x, '<f4')
    return json.dumps({'inputs_b64': base64.b64encode(x.tobytes()).decode(),
                       'shape': list(x.shape), 'encoding': 'b64', **more}).encode()


def phase_service(port, tag, cfg, flags, data, ckpt_root, ds, new_weights, agree,
                  counter, per_forward, seed):
    """Serve ``cfg``'s model through the ``serve`` command's wiring
    (``port``: its ``build_parser``, ``start`` and ``WindowDataset``; one
    server with ``--warmup``, one with the dynamic batcher), send the
    requests, hold every answer to its plain version (``agree``) and the kernel's launch
    count (``counter.launches``, set to 0 just before, read just after)
    against the device forwards. Returns the launches and the /predict p50
    at B=1 and B=4096."""
    servers = []
    try:
        serve_args = ['serve', '--dataset-home', str(data), '--checkpoint-dir',
                      str(ckpt_root), '--port', '0', '--device', 'cuda', *flags]
        counter.launches = 0     # counts from here on are this path's
        servers.append(_serve(port, serve_args + ['--warmup']))
        servers.append(_serve(port, serve_args + ['--batch-wait-ms', '5']))
        url, url_b = servers[0][2], servers[1][2]

        h = _get(url + '/health')
        _check(h['status'] == 'ok' and h['model'] == cfg.model_type
               and h['epoch'] == 1, f'/health {h}')
        s = _get(url + '/schema')
        _check((s['num_model_frames'], s['num_input_channels'], s['max_batch'],
                s['window_size'], s['stride'], s['output_data_format'],
                s['fused_inference'])
               == (10, 177, 4096, 50, 5, 'last_frame', bool(cfg.fused_inference))
               and s['device'].startswith('cuda'), f'/schema {s}')
        errs = {}
        for b in (1, 37):
            x = ds.gather(np.arange(b)).inputs
            r = _post(url + '/predict', json.dumps({'inputs': x.tolist()}).encode())
            errs[f'json B={b}'] = agree(r['outputs'], x, f'/predict json B={b}')
        x4096 = ds.gather(np.arange(4096)).inputs
        body4096 = _b64_body(x4096)
        r = _post(url + '/predict', body4096)
        errs['b64 B=4096'] = agree(r['outputs'], x4096, '/predict b64 B=4096')
        subject = str(data / 'subject_0.b3d')
        r = _post(url + '/predict_file', json.dumps({'file': subject, 'trial': 1}).encode())
        fds = port.WindowDataset(subject, window_size=cfg.window_size, stride=cfg.stride,
                            skip_loading_skeletons=True)
        xf = fds.gather(np.nonzero(fds.win_trial == 1)[0]).inputs
        _check(len(r['window_starts']) == len(xf), '/predict_file window count')
        errs[f'predict_file {len(xf)} windows'] = agree(r['outputs'], xf, '/predict_file')

        # 8 concurrent clients through the dynamic batcher
        rng = np.random.default_rng(seed)
        jobs = [[(int(rng.integers(0, len(ds) - 64)), int(rng.integers(1, 65)))
                 for _ in range(6)] for _ in range(8)]
        failures, worst = [], [0.0]

        def client(reqs):
            try:
                for start_i, b in reqs:
                    x = ds.gather(np.arange(start_i, start_i + b)).inputs
                    r = _post(url_b + '/predict', json.dumps({'inputs': x.tolist()}).encode())
                    worst[0] = max(worst[0], agree(r['outputs'], x, 'batched /predict'))
            except Exception as e:   # reported below; the run fails
                failures.append(repr(e))

        threads = [threading.Thread(target=client, args=(j,)) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        _check(not failures and not any(t.is_alive() for t in threads),
               f'concurrent clients: {failures}')
        errs['8 concurrent clients'] = worst[0]
        coalesced = _get(url_b + '/schema')['dynamic_batching']['forwards']

        # /reload onto a newer checkpoint
        new_weights(seed + 1, 2)
        r = _post(url + '/reload', b'{}')
        _check(r['reloaded'] and r['epoch'] == 2, f'/reload {r}')
        x = ds.gather(np.arange(37)).inputs
        r = _post(url + '/predict', json.dumps({'inputs': x.tolist()}).encode())
        errs['after /reload B=37'] = agree(r['outputs'], x, '/predict after /reload')

        m, m_b = _get(url + '/metrics'), _get(url_b + '/metrics')
        launches = counter.launches
        forwards = m['device_forwards'] + m_b['device_forwards']
        for what, e in errs.items():
            print(f'[{tag}] {what}: max abs err vs plain {e:.3g}', flush=True)
        print(f'[{tag}] 48 concurrent requests in {coalesced} device forwards; '
              f'metrics {m} / {m_b}', flush=True)
        _check(m['errors'] == 0 and m_b['errors'] == 0, 'errors in /metrics')
        _check(m_b['requests'] == 48, f'batched requests {m_b["requests"]}')
        _check(launches == per_forward * forwards > 0,
               f'{launches} kernel launches for {forwards} device forwards')
        print(f'[{tag}] kernel launches {launches} == {per_forward} x device '
              f'forwards {forwards}', flush=True)

        x1 = json.dumps({'inputs': ds.gather(np.arange(1)).inputs.tolist()}).encode()
        p50_b1 = _host_p50_ms(lambda: _post(url + '/predict', x1), 20)
        p50_b4096 = _host_p50_ms(lambda: _post(url + '/predict', body4096), 10)
        print(f'[{tag}] /predict B=1 json p50 {p50_b1:.2f} ms (20 requests); '
              f'B=4096 b64 p50 {p50_b4096:.1f} ms (10 requests) = '
              f'{4096 / p50_b4096 * 1e3:.0f} windows/s', flush=True)
        return launches, (p50_b1, p50_b4096)
    finally:
        for svc, server, _ in servers:
            _stop(svc, server)


def phase_ensemble(port, data, dirs, ds, plain_members, counter):
    """A 3-member feedforward ``--ensemble``: mean and spread against the
    plain versions, one kernel launch a member and device forward, /reload
    refused. Returns the launches."""
    argv = ['serve', '--dataset-home', str(data), '--checkpoint-dir',
            str(Path(dirs[0]).parent), '--port', '0', '--device', 'cuda',
            '--ensemble', *dirs]
    counter.launches = 0
    svc, server, url = _serve(port, argv)
    try:
        h, s = _get(url + '/health'), _get(url + '/schema')
        _check(h['ensemble_size'] == len(dirs) and s['ensemble']['size'] == len(dirs)
               and [m['path'] for m in s['ensemble']['members']] == list(dirs),
               f'/health {h} /schema ensemble {s["ensemble"]}')
        for b in (37, 4096):
            x = ds.gather(np.arange(b)).inputs
            r = _post(url + '/predict', _b64_body(x, spread=True))
            outs = plain_members(x)           # one output dict a member
            mean = {k: np.mean([o[k] for o in outs], axis=0) for k in outs[0]}
            std = {k: np.std([o[k] for o in outs], axis=0) for k in outs[0]}
            e_mean = _agree(r['outputs'], mean, f'ensemble mean B={b}', atol=ATOL)
            e_std = _agree(r['spread'], std, f'ensemble spread B={b}', atol=ATOL)
            _check(max(float(v.max()) for v in std.values()) > ATOL,
                   'the members do not differ')
            print(f'[extras] ensemble of {len(dirs)} B={b}: mean max abs err vs plain '
                  f'{e_mean:.3g}, spread {e_std:.3g} (atol {ATOL})', flush=True)
        try:
            _post(url + '/reload', b'{}')
            refused = False
        except urllib.error.HTTPError as e:
            refused = e.code == 400
        _check(refused, '/reload of an ensemble was not refused')
        m = _get(url + '/metrics')
        launches = counter.launches
        _check(m['errors'] == 1, f'errors {m["errors"]} (the refused /reload alone)')
        _check(launches == len(dirs) * m['device_forwards'] > 0,
               f'{launches} kernel launches for {m["device_forwards"]} device forwards')
        print(f'[extras] ensemble: kernel launches {launches} == {len(dirs)} x device '
              f'forwards {m["device_forwards"]}; /reload refused', flush=True)
        return launches
    finally:
        _stop(svc, server)


def phase_tta_and_poller(port, data, ckpt_root, ds, symmetrized, new_weights, counter,
                         seed):
    """``--tta-mirror`` on GroundLink with ``--reload-poll-sec``: every
    answer is the symmetrized plain forward, two kernel launches a device
    forward, and a checkpoint written while serving is picked up. Returns the
    launches."""
    argv = ['serve', '--dataset-home', str(data), '--checkpoint-dir', str(ckpt_root),
            '--port', '0', '--device', 'cuda', '--model-type', 'groundlink',
            '--tta-mirror', '--reload-poll-sec', '0.2']
    counter.launches = 0
    svc, server, url = _serve(port, argv)
    try:
        for b in (1, 37, 4096):
            x = ds.gather(np.arange(b)).inputs
            r = _post(url + '/predict', _b64_body(x))
            want = symmetrized(x)
            err = _agree(r['outputs'], want, f'tta-mirror B={b}', atol=_vector_limit(want))
            print(f'[extras] groundlink --tta-mirror B={b}: max abs err vs the '
                  f'symmetrized plain forward {err:.3g}', flush=True)
        epoch = _get(url + '/health')['epoch']
        new_weights(seed + 7, epoch + 1)       # lands while the server polls
        deadline = time.time() + 60
        while time.time() < deadline and _get(url + '/health')['epoch'] != epoch + 1:
            time.sleep(0.1)
        _check(_get(url + '/health')['epoch'] == epoch + 1,
               'the poller did not pick up the new checkpoint')
        x = ds.gather(np.arange(37)).inputs
        r = _post(url + '/predict', _b64_body(x))
        want = symmetrized(x)
        err = _agree(r['outputs'], want, 'tta-mirror after the poller reload',
                     atol=_vector_limit(want))
        m = _get(url + '/metrics')
        launches = counter.launches
        _check(m['errors'] == 0, 'errors in /metrics')
        _check(launches == 2 * m['device_forwards'] > 0,
               f'{launches} kernel launches for {m["device_forwards"]} device forwards')
        print(f'[extras] poller picked up epoch {epoch + 1} (max abs err after it '
              f'{err:.3g}); kernel launches {launches} == 2 x device forwards '
              f'{m["device_forwards"]}', flush=True)
        return launches
    finally:
        _stop(svc, server)


class _LossLog(logging.Handler):
    """Collects the train loop's logged steps as (epoch, batch, loss), and
    the seconds of each capture of a train step."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.steps, self.captures = [], []

    def emit(self, record):
        if str(record.msg).startswith(('epoch %d batch %d loss', 'epoch %d batch %d eps-mse')):
            self.steps.append(tuple(record.args))
        elif str(record.msg).startswith('train step captured'):
            self.captures.append(record.args[0])


@contextlib.contextmanager
def _plain_encoder_layers(fe):
    """Route ``FusedEncoderLayerFn`` through the plain versions (forward
    ``encoder_layer_reference``, backward ``encoder_layer_bwd_reference``) on
    any device, to hold a step through the kernels against."""
    kernel_fwd, kernel_bwd = fe.fused_encoder_layer, fe.fused_encoder_layer_bwd
    fe.fused_encoder_layer = lambda x, packed, heads: fe.encoder_layer_reference(
        x, packed.params, heads)
    fe.fused_encoder_layer_bwd = lambda x, g, packed, heads: fe.encoder_layer_bwd_reference(
        x, g, packed.params, heads)
    try:
        yield
    finally:
        fe.fused_encoder_layer, fe.fused_encoder_layer_bwd = kernel_fwd, kernel_bwd


def _first_step(torch, port, model, data, idx, lc):
    """Loss and gradients (by parameter name) of one train step's forward and
    backward on ``model``; no update."""
    model.train()
    model.zero_grad(set_to_none=True)
    inputs, labels = data.gather(idx)
    loss, _ = port.loss_and_metrics(model(inputs), port.unpack(labels, data.lab_offsets), lc)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}


def _compare_final(torch, a, b, epoch, limit=0.0):
    """The final checkpoints (``epoch_{epoch}_batch_0``) of two runs:
    parameters, optimizer state, EMA (when they keep one) and step, bitwise;
    else the first tensor that differs, in parameter order, and its largest
    difference. Fails when a difference exceeds ``limit`` x that tensor's
    largest value (0: any)."""
    want, got = (torch.load(str(d / f'epoch_{epoch}_batch_0.torch.pt'), map_location='cpu',
                            weights_only=True) for d in (a, b))
    _check(want['step'] == got['step'], f'{a} / {b}: steps {want["step"]} / {got["step"]}')
    _check(('ema_params' in want) == ('ema_params' in got), f'{a} / {b}: EMA in one only')
    pairs, got_of = [], {}
    for side, out in ((want, pairs), (got, None)):
        named = list(side['model_state_dict'].items())
        named += [(f'ema {k}', v) for k, v in side.get('ema_params', {}).items()]
        for i, st in side['optimizer_state_dict']['state'].items():
            named += [(f'optimizer state {i}/{k}', v) for k, v in st.items()]
        if out is None:
            got_of.update(named)
        else:
            out.extend(named)
    differing = [(k, float((v.float() - got_of[k].float()).abs().max()),
                  float(v.float().abs().max())) for k, v in pairs
                 if not torch.equal(v, got_of[k])]
    if not differing:
        return dict(bitwise=True, tensors=len(pairs),
                    verdict=f'bitwise equal ({len(pairs)} tensors, step {want["step"]})')
    name, err, scale = differing[0]
    worst = max(e / max(m, 1e-30) for _, e, m in differing)
    _check(worst <= limit, f'{a} / {b}: {len(differing)} of {len(pairs)} tensors differ, '
                           f'first {name} by {err:.3g} (max {scale:.3g})')
    return dict(bitwise=False, tensors=len(pairs), differing=len(differing), first=name,
                first_max_abs=err, worst_rel=worst,
                verdict=f'NOT bitwise: {len(differing)} of {len(pairs)} tensors differ, '
                        f'first {name} by {err:.3g} (max |value| {scale:.3g}), worst '
                        f'{worst:.3g} relative')


def phase_training(torch, port, fe, fg, step_mod, root, seed, card, device='cuda',
                   batch=4096, subjects=40, trial_length=2100, size_flags=()):
    """Train the transformer with ``--attn-impl pallas`` through the
    ``train`` command's wiring (``port``: the command's parser and runner and
    the modules a step is made of) and check launch counts (the wrappers'
    counters, and the K2 and K3 kernels in a profiler trace of the run,
    graph replays included), the loss, the first step against the plain
    versions, an exact resume and the served checkpoint. ``size_flags``
    narrows the model for a rehearsal; the run on the card passes none (full
    width). Returns the numbers for the report."""
    data = root / 'train_data'
    for split, n, first in (('train', subjects, 100), ('dev', 1, 200)):
        (data / split).mkdir(parents=True)
        for i in range(n):
            port.write_synthetic_subject(str(data / split / f'subject_{i}.b3d'),
                                         num_trials=2, trial_length=trial_length,
                                         seed=seed + first + i)
    pallas = ['--model-type', 'transformer', '--attn-impl', 'pallas', *size_flags]

    def argv(ckpt, flags, epochs):
        return ['train', '--dataset-home', str(data), '--checkpoint-dir', str(ckpt),
                '--batch-size', str(batch), '--epochs', str(epochs), '--device', device,
                '--seed', str(seed), *flags]

    def run(ckpt, flags, epochs):
        return port.run_training(port.parser().parse_args(argv(ckpt, flags, epochs)))

    loop_log = logging.getLogger('inferbiomechanics_tpu_torch.train.loop')
    loop_log.setLevel(logging.INFO)
    handler = _LossLog()
    loop_log.addHandler(handler)
    step_log = logging.getLogger('inferbiomechanics_tpu_torch.train.step')
    step_log.addHandler(handler)
    try:
        # the main path: 2 epochs, counts set to 0 just before, read just
        # after; the run traced by the profiler
        fe.launches = fe.bwd_launches = 0
        fe.bwd_shape_launches.update(small=0, large=0)
        captures = step_mod.captures
        result, traced, _ = _traced(torch, lambda: run(root / 'ckpt_a', pallas, 2))
        k2_launches, k3_launches = fe.launches, fe.bwd_launches
        k3_shapes = dict(fe.bwd_shape_launches)
        captures = step_mod.captures - captures
        steps, capture_s = list(handler.steps), list(handler.captures)
    finally:
        loop_log.removeHandler(handler)
    args = port.parser().parse_args(argv(root / 'ckpt_a', pallas, 2))
    cfg = port.config_from_args(args)
    layers = cfg.num_layers
    train_ds, dev_ds = (port.WindowDataset(
        str(data / split), window_size=cfg.window_size, stride=cfg.stride,
        output_data_format=cfg.output_data_format, skip_loading_skeletons=True)
        for split in ('train', 'dev'))
    train_steps = result.windows_seen // batch
    dev_batches = 2 * (len(dev_ds) // batch)
    _check(result.epochs_run == 2 and train_steps == 2 * (len(train_ds) // batch)
           and train_steps >= 16 and dev_batches >= 2,
           f'{result.epochs_run} epochs, {train_steps} train steps, {dev_batches} dev batches')
    # the wrappers count each eager step and the capture (which records the
    # launches into the graph); the trace holds every launch that ran
    called = (step_mod.GraphedStep.WARMUP_STEPS + 1) * captures
    _check(captures == 1 and k2_launches == layers * (called + dev_batches)
           and k3_launches == layers * fe.BWD_LAUNCHES_PER_LAYER * called,
           f'wrappers: {captures} captures, K2 {k2_launches} and K3 {k3_launches} launches '
           f'for {dev_batches} dev batches of {layers} layers')
    k3_shape = fe.plan_encoder_bwd(batch, cfg.window_size // cfg.stride, cfg.d_model,
                                   cfg.d_model * ENC_FULL['mlp_ratio'], cfg.num_heads).shape
    _check(k3_shapes[k3_shape] == layers * called and sum(k3_shapes.values()) ==
           layers * called, f'K3 by shape: {k3_shapes}, the plan picks {k3_shape}')
    _check_traced(traced, layers, train_steps, dev_batches, k3_shape, 'main path')
    k2_traced = traced['fused_encoder_kernel']
    k3_traced = sum(traced[k] for k in ENC_KERNELS[1:])
    print(f'[train] pallas transformer, B={batch}: {train_steps} train steps and '
          f'{dev_batches} dev batches in 2 epochs, {captures} capture; wrappers: K2 '
          f'{k2_launches} == {layers} x ({called} + {dev_batches}), K3 {k3_launches} == '
          f'{layers} x {fe.BWD_LAUNCHES_PER_LAYER} x {called} (eager steps and the capture); '
          f'in the profiler trace of the run: K2 {k2_traced} == {layers} x ({train_steps} + '
          f'{dev_batches}), K3 {k3_traced} == {layers} x {fe.BWD_LAUNCHES_PER_LAYER} x '
          f'{train_steps} ({k3_shape} shape); {result.windows_per_sec:.0f} windows/s under '
          f'the profiler', flush=True)
    first, last = steps[0][2], steps[-1][2]
    _check(len(steps) >= 2 and np.isfinite([s[2] for s in steps]).all() and last < first,
           f'logged losses {steps}')
    print(f'[train] loss of the logged steps {[round(s[2], 4) for s in steps]} (once a '
          f'chunk, at its last batch): falls', flush=True)
    dev_loss = result.final_dev_metrics['loss']
    _check(np.isfinite(dev_loss), f'dev loss {dev_loss}')

    # the same run dispatched step by step: bitwise the chunked one, and its
    # first logged loss is the first step's
    loop_log.addHandler(handler)
    handler.steps.clear()
    handler.captures.clear()
    try:
        per_step = run(root / 'ckpt_s', [*pallas, '--device-chunk-steps', '1'], 2)
        first = handler.steps[0][2]
        # chunked once more, not traced, now that the process has trained at
        # this size
        again = run(root / 'ckpt_c', pallas, 2)
        again_capture_s = list(handler.captures)
    finally:
        loop_log.removeHandler(handler)
        step_log.removeHandler(handler)
    _check(per_step.windows_seen == result.windows_seen, 'per-step run: windows')
    chunked_vs_step = _compare_final(torch, root / 'ckpt_a' / 'transformer',
                                     root / 'ckpt_s' / 'transformer', 1)
    chunked_again = _compare_final(torch, root / 'ckpt_a' / 'transformer',
                                   root / 'ckpt_c' / 'transformer', 1)
    print(f'[chunk] pallas B={batch}, 2 epochs of {train_steps // 2} steps (one chunk each) '
          f'against the same run step by step ({card}): {chunked_vs_step["verdict"]}; '
          f'chunked again: {chunked_again["verdict"]}; windows/s chunked '
          f'{result.windows_per_sec:.0f} (the process\'s first training, traced; capture '
          f'{", ".join(f"{t:.3f}" for t in capture_s)} s), step by step '
          f'{per_step.windows_per_sec:.0f}, chunked again {again.windows_per_sec:.0f} (capture '
          f'{", ".join(f"{t:.3f}" for t in again_capture_s)} s)', flush=True)

    # the first step, through the kernels and through the plain versions
    lc = port.loss_config_from(cfg)
    model = port.build_model_for_dataset(
        cfg, train_ds, generator=torch.Generator().manual_seed(cfg.seed), device=device)
    ddata = port.DeviceResidentData(train_ds, device)
    perm = np.random.default_rng((cfg.seed, 0)).permutation(len(train_ds))
    idx = torch.from_numpy(perm[:batch]).to(device)
    loss_k, grads_k = _first_step(torch, port, model, ddata, idx, lc)
    with _plain_encoder_layers(fe):
        loss_p, grads_p = _first_step(torch, port, model, ddata, idx, lc)
    _check(abs(loss_k - first) <= 1e-5 * abs(first),
           f'first step loss {loss_k} != the run\'s first logged loss {first}')
    _check(abs(loss_k - loss_p) <= BWD_REL * abs(loss_p),
           f'first step loss {loss_k} through the kernels, {loss_p} through the plain versions')
    _check(set(grads_k) == set(grads_p) and any(n.startswith('enc0_') for n in grads_k),
           'gradients missing')
    worst, at = 0.0, ''
    for n, gp in grads_p.items():
        scale = float(gp.abs().max())
        err = float((grads_k[n] - gp).abs().max())
        _check(err <= BWD_REL * scale, f'first step: gradient of {n} off by {err} '
                                       f'(max |plain| {scale})')
        if scale > 0 and err / scale > worst:
            worst, at = err / scale, n
    print(f'[train] first step: loss {loss_k:.6g} through K2/K3, {loss_p:.6g} through the '
          f'plain versions; worst gradient error / max |plain| {worst:.3g} (at {at}; '
          f'limit {BWD_REL}) over {len(grads_p)} parameters', flush=True)
    del model, ddata, grads_k, grads_p

    # stopped after epoch 0 and resumed == uninterrupted, bitwise
    run(root / 'ckpt_b', pallas, 1)
    resumed = run(root / 'ckpt_b', pallas, 2)
    _check(resumed.epochs_run == 1, f'the resumed run ran {resumed.epochs_run} epochs')
    final = [torch.load(str(root / c / 'transformer' / 'epoch_1_batch_0.torch.pt'),
                        map_location='cpu', weights_only=True) for c in ('ckpt_a', 'ckpt_b')]
    for k, v in final[0]['model_state_dict'].items():
        _check(bool(torch.equal(v, final[1]['model_state_dict'][k])),
               f'resume: parameter {k} differs from the uninterrupted run')
    for i, st in final[0]['optimizer_state_dict']['state'].items():
        for k, v in st.items():
            _check(bool(torch.equal(v, final[1]['optimizer_state_dict']['state'][i][k])),
                   f'resume: optimizer state {i}/{k} differs')
    _check(final[0]['step'] == final[1]['step'] == train_steps, 'resume: step count')
    print(f'[train] stopped after epoch 0 and resumed: {len(final[0]["model_state_dict"])} '
          f'parameters and the optimizer state bitwise equal to the uninterrupted run',
          flush=True)

    # the port's serve answers from the checkpoint the trainer wrote
    served = port.build_model_for_dataset(cfg, dev_ds, device=device)
    port.load_latest_checkpoint(served, str(root / 'ckpt_a' / 'transformer'))
    served.eval()
    xs = {b: dev_ds.gather(np.arange(b)).inputs for b in (1, 37, batch)}
    with torch.no_grad():
        want = {b: {k: v.cpu().numpy() for k, v in
                    served(torch.from_numpy(x).to(device)).items()} for b, x in xs.items()}
    fe.launches = 0
    svc, server, url = _serve(port, [
        'serve', '--dataset-home', str(data), '--checkpoint-dir', str(root / 'ckpt_a'),
        '--port', '0', '--device', device, '--max-batch', str(batch), *pallas])
    try:
        h = _get(url + '/health')
        _check(h['status'] == 'ok' and h['model'] == 'transformer' and h['epoch'] == 1,
               f'/health {h}')
        errs = [_agree(_post(url + '/predict', _b64_body(x))['outputs'], want[b],
                       f'served pallas checkpoint B={b}', rel=HEAD_REL)
                for b, x in xs.items()]
        m = _get(url + '/metrics')
        _check(m['errors'] == 0 and fe.launches == layers * m['device_forwards'] > 0,
               f'{fe.launches} K2 launches for {m["device_forwards"]} device forwards: {m}')
        print(f'[train] serve answers /predict from the trained checkpoint (epoch 1): max '
              f'abs err vs the model\'s own forward {max(errs):.3g}; K2 launches '
              f'{fe.launches} == {layers} x device forwards {m["device_forwards"]}',
              flush=True)
    finally:
        _stop(svc, server)

    # 7b. the comparison runs, one epoch each
    vpu = run(root / 'ckpt_vpu', ['--model-type', 'transformer', '--attn-impl', 'vpu',
                                  *size_flags], 1)
    ff = run(root / 'ckpt_ff', ['--model-type', 'feedforward'], 1)
    _check(vpu.epochs_run == ff.epochs_run == 1
           and np.isfinite(vpu.final_train_metrics['loss'])
           and np.isfinite(ff.final_train_metrics['loss']), 'comparison runs')
    # 7c. GroundLink at the JAX defaults (fc_dropout 0.2): plain bf16 autograd
    # with dropout in training, K4 in the dev eval
    loop_log.addHandler(handler)
    handler.steps.clear()
    try:
        fg.launches = 0
        gl = run(root / 'ckpt_gl', ['--model-type', 'groundlink'], 1)
        k4_train_launches, gl_steps = fg.launches, list(handler.steps)
    finally:
        loop_log.removeHandler(handler)
    # the one chunk of the epoch logs the loss of its last step
    gl_last, gl_mean = gl_steps[-1][2], gl.final_train_metrics['loss']
    _check(gl.epochs_run == 1 and np.isfinite([gl_last, gl_mean]).all()
           and np.isfinite(gl.final_dev_metrics['loss']) and gl_last < gl_mean,
           f'GroundLink: last step loss {gl_last}, epoch mean {gl_mean}, '
           f'dev {gl.final_dev_metrics}')
    _check(k4_train_launches == len(dev_ds) // batch,
           f'GroundLink training: {k4_train_launches} K4 launches for '
           f'{len(dev_ds) // batch} dev batches')
    _check((root / 'ckpt_gl' / 'groundlink' / 'epoch_0_batch_0.torch.pt').exists(),
           'GroundLink checkpoint')
    print(f'[train] groundlink, fc_dropout 0.2, B={batch}: last step loss {gl_last:.4f} '
          f'below the epoch mean {gl_mean:.4f} (falls); K4 launches {k4_train_launches} == dev '
          f'batches {len(dev_ds) // batch}; checkpoint written', flush=True)
    wps = {'transformer pallas (K2 + K3)': result.windows_per_sec,
           'transformer vpu (plain autograd)': vpu.windows_per_sec,
           'feedforward (plain autograd)': ff.windows_per_sec,
           'groundlink (plain bf16 autograd, dropout)': gl.windows_per_sec}
    print(f'[train] windows/s at B={batch}: '
          + ', '.join(f'{k} {v:.0f}' for k, v in wps.items()), flush=True)
    return dict(k2_launches=k2_launches, k3_launches=k3_launches,
                k3_shape_launches=k3_shapes, k2_traced=k2_traced, k3_traced=k3_traced,
                traced=traced, captures=captures, capture_s=capture_s,
                capture_s_again=again_capture_s, train_steps=train_steps,
                dev_batches=dev_batches, windows_per_sec=wps, first_loss=first,
                last_loss=last, first_step_grad_rel=worst,
                chunked_vs_step=chunked_vs_step,
                windows_per_sec_step_by_step=per_step.windows_per_sec,
                windows_per_sec_chunked_again=again.windows_per_sec,
                groundlink=dict(k4_launches=k4_train_launches, last_loss=gl_last,
                                epoch_mean_loss=gl_mean))


def phase_chunked(torch, port, fe, step_mod, root, seed, card, device='cuda', batch=64,
                  trial_length=4800, gl_batch=4096, size_flags=()):
    """The chunked step through the ``train`` command (7d): the ``pallas``
    transformer at ``batch`` (the default 64: K3's small shape) over an
    epoch of two full chunks of 64 and a remainder, against the same run
    step by step, with the K2 and K3 kernels of the run counted in a
    profiler trace; the host-loader tier at ``batch`` and at ``gl_batch``;
    GroundLink (dropout 0.2) at ``gl_batch`` over 2 epochs, chunked
    against step by step, and chunked resumed after epoch 0 (phase 7c's
    run, copied) against uninterrupted. Returns the numbers for the report."""
    data = root / 'chunk_data'
    (data / 'train').mkdir(parents=True)
    port.write_synthetic_subject(str(data / 'train' / 'subject_0.b3d'), num_trials=2,
                                 trial_length=trial_length, seed=seed + 300)
    pallas = ['--model-type', 'transformer', '--attn-impl', 'pallas', *size_flags]

    def run(home, ckpt, flags, epochs, b):
        return port.run_training(port.parser().parse_args([
            'train', '--dataset-home', str(home), '--checkpoint-dir', str(ckpt),
            '--batch-size', str(b), '--epochs', str(epochs), '--device', device,
            '--seed', str(seed), *flags]))

    # pallas at the default batch: counts set to 0 just before, read just
    # after; the run traced by the profiler
    fe.launches = fe.bwd_launches = 0
    fe.bwd_shape_launches.update(small=0, large=0)
    replays, captures = step_mod.replays, step_mod.captures
    chunked, traced, _ = _traced(torch, lambda: run(data, root / 'ckpt_64c', pallas, 1, batch))
    k2, k3, k3_shapes = fe.launches, fe.bwd_launches, dict(fe.bwd_shape_launches)
    replays, captures = step_mod.replays - replays, step_mod.captures - captures
    cfg = port.config_from_args(port.parser().parse_args(['train', *pallas]))
    layers, steps = cfg.num_layers, chunked.windows_seen // batch
    chunk = min(cfg.device_chunk_steps, steps)
    warmup = step_mod.GraphedStep.WARMUP_STEPS
    _check(chunked.epochs_run == 1 and steps > 2 * chunk and steps % chunk,
           f'{steps} steps: not two chunks of {chunk} and a remainder')
    _check(captures == 1 and replays == steps - warmup,
           f'{captures} captures, {replays} replays for {steps} steps')
    # the wrappers saw the eager steps and the capture; the trace every launch
    _check(k2 == layers * (warmup + 1) and k3 == layers * fe.BWD_LAUNCHES_PER_LAYER * (warmup + 1),
           f'wrappers: K2 {k2}, K3 {k3} launches for {warmup} eager steps and a capture')
    k3_shape = fe.plan_encoder_bwd(batch, cfg.window_size // cfg.stride, cfg.d_model,
                                   cfg.d_model * ENC_FULL['mlp_ratio'], cfg.num_heads).shape
    _check(k3_shapes[k3_shape] == layers * (warmup + 1), f'K3 by shape {k3_shapes}')
    _check_traced(traced, layers, steps, 0, k3_shape, f'pallas B={batch} chunked')
    k2_traced = traced['fused_encoder_kernel']
    k3_traced = sum(traced[k] for k in ENC_KERNELS[1:])
    step_by_step = run(data, root / 'ckpt_64s', [*pallas, '--device-chunk-steps', '1'], 1,
                       batch)
    pallas_b64 = _compare_final(torch, root / 'ckpt_64c' / 'transformer',
                                root / 'ckpt_64s' / 'transformer', 0)
    print(f'[chunk] pallas B={batch}, {steps} steps in chunks of {chunk} (the last '
          f'{steps % chunk}) against step by step ({card}): {pallas_b64["verdict"]}; '
          f'{captures} capture, {replays} replays after {warmup} eager steps; wrappers: K2 '
          f'{k2}, K3 {k3}; in the profiler trace of the run: K2 {k2_traced} == {layers} x '
          f'{steps} steps, K3 {k3_traced} == {layers} x {fe.BWD_LAUNCHES_PER_LAYER} x {steps} '
          f'({k3_shape} shape); windows/s chunked {chunked.windows_per_sec:.0f} (traced), '
          f'step by step {step_by_step.windows_per_sec:.0f}', flush=True)

    # the host-loader tier: chunks of 64 uploaded in one copy with the inputs
    # rounded to bf16 on the host, against step by step in float32 (the
    # model rounds its inputs to bf16 itself)
    host = ['--device-data', 'off']
    host_c = run(data, root / 'ckpt_64hc', [*pallas, *host, '--host-chunk-steps', str(chunk),
                                            '--host-upload-dtype', 'bf16'], 1, batch)
    host_s = run(data, root / 'ckpt_64hs', [*pallas, *host], 1, batch)
    _check(host_c.windows_seen == host_s.windows_seen == steps * batch, 'host tier runs')
    host_b64 = _compare_final(torch, root / 'ckpt_64hc' / 'transformer',
                              root / 'ckpt_64hs' / 'transformer', 0)
    print(f'[chunk] pallas B={batch}, host-loader tier, --host-chunk-steps {chunk} '
          f'--host-upload-dtype bf16 against step by step in float32 ({card}): '
          f'{host_b64["verdict"]}; windows/s chunked {host_c.windows_per_sec:.0f}, step by '
          f'step {host_s.windows_per_sec:.0f}', flush=True)

    # the host-loader tier at gl_batch, in float32: one epoch step by step,
    # in chunks of 64 (clamped to the epoch) and of 8
    home = root / 'train_data'
    host_big = {k: run(home, root / f'ckpt_hb{k}', [*pallas, *host, '--host-chunk-steps', str(k)],
                       1, gl_batch) for k in (1, 64, 8)}
    _check(len({r.windows_seen for r in host_big.values()}) == 1, 'host tier runs at B=4096')
    host_big_cmp = {k: _compare_final(torch, root / 'ckpt_hb1' / 'transformer',
                                      root / f'ckpt_hb{k}' / 'transformer', 0) for k in (64, 8)}
    host_big_steps = host_big[1].windows_seen // gl_batch
    print(f'[chunk] pallas B={gl_batch}, host-loader tier in float32, {host_big_steps} steps '
          f'({card}): --host-chunk-steps 64 (one chunk of {min(64, host_big_steps)}) '
          f'{host_big_cmp[64]["verdict"]}, --host-chunk-steps 8 {host_big_cmp[8]["verdict"]} '
          f'against step by step; windows/s step by step {host_big[1].windows_per_sec:.0f}, '
          f'chunks of 64 {host_big[64].windows_per_sec:.0f}, chunks of 8 '
          f'{host_big[8].windows_per_sec:.0f}', flush=True)

    # GroundLink: chunked, step by step, and resumed after epoch 0
    gl = ['--model-type', 'groundlink']
    gl_a = run(home, root / 'ckpt_gl_a', gl, 2, gl_batch)
    gl_s = run(home, root / 'ckpt_gl_s', [*gl, '--device-chunk-steps', '1'], 2, gl_batch)
    shutil.copytree(root / 'ckpt_gl', root / 'ckpt_gl_b')
    gl_b = run(home, root / 'ckpt_gl_b', gl, 2, gl_batch)
    _check(gl_b.epochs_run == 1 and gl_a.windows_seen == gl_s.windows_seen
           == 2 * gl_b.windows_seen, 'GroundLink runs')
    gl_step = _compare_final(torch, root / 'ckpt_gl_a' / 'groundlink',
                             root / 'ckpt_gl_s' / 'groundlink', 1)
    gl_resume = _compare_final(torch, root / 'ckpt_gl_a' / 'groundlink',
                               root / 'ckpt_gl_b' / 'groundlink', 1)
    gl_steps = gl_a.windows_seen // gl_batch
    print(f'[chunk] groundlink B={gl_batch}, 2 epochs of {gl_steps // 2} steps, chunked against '
          f'step by step ({card}): {gl_step["verdict"]}', flush=True)
    print(f'[chunk] groundlink B={gl_batch}, chunked, stopped after epoch 0 and resumed '
          f'against uninterrupted ({card}): {gl_resume["verdict"]}; windows/s chunked '
          f'{gl_a.windows_per_sec:.0f}, step by step {gl_s.windows_per_sec:.0f}', flush=True)
    return dict(pallas_b64=dict(steps=steps, chunk=chunk, captures=captures, replays=replays,
                                k2_launches=k2, k3_launches=k3, k3_shape_launches=k3_shapes,
                                k2_traced=k2_traced, k3_traced=k3_traced, traced=traced,
                                vs_step_by_step=pallas_b64,
                                windows_per_sec=chunked.windows_per_sec,
                                windows_per_sec_step_by_step=step_by_step.windows_per_sec),
                pallas_b64_host_tier=dict(vs_step_by_step=host_b64,
                                          windows_per_sec=host_c.windows_per_sec,
                                          windows_per_sec_step_by_step=host_s.windows_per_sec),
                pallas_host_tier_big=dict(
                    batch=gl_batch, steps=host_big_steps,
                    vs_step_by_step={k: v['verdict'] for k, v in host_big_cmp.items()},
                    windows_per_sec={k: v.windows_per_sec for k, v in host_big.items()}),
                groundlink=dict(steps=gl_steps, vs_step_by_step=gl_step, resume=gl_resume,
                                windows_per_sec=gl_a.windows_per_sec,
                                windows_per_sec_step_by_step=gl_s.windows_per_sec))


@contextlib.contextmanager
def _plain_forwards(fm, fe, fg):
    """Route the models' eval forwards through the plain versions of K1, K2
    and K4 on any device, to hold an evaluation through the kernels
    against."""
    from inferbiomechanics_tpu_torch.models import feedforward, groundlink
    saved = (feedforward.fused_mlp_forward, fe.fused_encoder_layer,
             groundlink.fused_groundlink_forward)
    feedforward.fused_mlp_forward = lambda x, packed, act: fm.mlp_reference(
        x, packed.layers, act)
    fe.fused_encoder_layer = lambda x, packed, heads: fe.encoder_layer_reference(
        x, packed.params, heads)
    groundlink.fused_groundlink_forward = lambda x, packed, fmt: fg.groundlink_reference(
        x, packed.params, fmt, packed.fc_depth)
    try:
        yield
    finally:
        (feedforward.fused_mlp_forward, fe.fused_encoder_layer,
         groundlink.fused_groundlink_forward) = saved


def phase_analyze(torch, port, fm, fe, fg, root, seed, card, member, frames=600,
                  wide_batches=24, device='cuda'):
    """``analyze`` through the command's wiring on the checkpoints phase 7
    wrote (transformer ``pallas``, ``vpu``, feedforward, GroundLink), on a dev
    split of one synthetic subject (one trial; the train split is empty):
    every eval forward launches its kernel the expected number of times, the
    report agrees with the same evaluation through the plain versions at the
    kernels' phase 3 tolerances, CSV rows with ``--eval-chunk-steps`` 64 equal
    those with 1 within 1e-5 relative, a 2-member feedforward ``--ensemble``
    (``member``: another checkpoint dir) and ``--tta-mirror`` on GroundLink
    each run once; windows/s of each model at B=1 (``--eval-chunk-steps`` 64
    and 1) and at B=512, the latter on a dev split of its own of
    ``wide_batches`` full batches (four trials), after a warm-up run at
    B=512 on the first split. ``device`` 'cpu' rehearses the phase."""

    def split(name, trials, length, subject_seed):
        """A dev split of one synthetic subject and an empty train split;
        returns its directory and its window count."""
        home = root / name
        (home / 'train').mkdir(parents=True)
        (home / 'dev').mkdir()
        port.write_synthetic_subject(str(home / 'dev' / 'subject.b3d'), num_trials=trials,
                                     trial_length=length, seed=subject_seed)
        return home, len(port.WindowDataset(str(home / 'dev'), window_size=50, stride=5,
                                            skip_loading_skeletons=True))

    data, windows = split('analyze_data', 1, frames, seed + 300)
    # a trial of L frames holds L - 51 windows at window 50 / stride 5
    wide_data, wide_windows = split('analyze_wide', 4, wide_batches * 512 // 4 + 51,
                                    seed + 301)
    _check(wide_windows == wide_batches * 512,
           f'wide split: {wide_windows} windows, expected {wide_batches} x 512')
    # name -> checkpoint root, flags, the kernel's module, its launches a
    # forward, the report's tolerance against the plain versions
    models = {
        'transformer pallas (K2)': ('ckpt_a', ['--model-type', 'transformer',
                                               '--attn-impl', 'pallas'], fe, 4, HEAD_REL),
        'transformer vpu (plain)': ('ckpt_vpu', ['--model-type', 'transformer'], None, 0, None),
        'feedforward (K1)': ('ckpt_ff', [], fm, 1, ATOL),
        'groundlink (K4)': ('ckpt_gl', ['--model-type', 'groundlink'], fg, 1, GL_REL),
    }
    kernel_modules = (fm, fe, fg)

    def run(ckpt, flags, extra=(), home=data, expect=windows):
        """One ``analyze`` on the split under ``home`` (``expect`` windows);
        returns its dev result, its dev rows and the kernels' launches
        (counts set to 0 just before, read just after)."""
        args = port.parser().parse_args([
            'analyze', '--dataset-home', str(home), '--checkpoint-dir', str(root / ckpt),
            '--no-wandb', '--device', device, *flags, *extra])
        csv_path = root / ckpt / args.model_type / 'dev_analysis.csv'
        if csv_path.exists():
            csv_path.unlink()
        for m in kernel_modules:
            m.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = port.analyze(args)
        launches = [m.launches for m in kernel_modules]
        _check('train: no windows, skipping' in out.getvalue() and set(result) == {'dev'},
               f'analyze {flags} {extra}: splits {set(result)}')
        dev = result['dev']
        _check(dev['windows'] == expect and np.isfinite(list(dev['summary'].values())).all(),
               f'analyze {flags} {extra}: {dev}')
        with open(csv_path) as f:
            rows = list(csv.reader(f))
        _check(len(rows) == expect, f'{len(rows)} CSV rows for {expect} windows')
        return dev, rows, launches

    rates, report = {}, {}
    for name, (ckpt, flags, module, per_forward, tol) in models.items():
        chunked, rows64, launches = run(ckpt, flags)
        want = [per_forward * windows if m is module else 0 for m in kernel_modules]
        _check(launches == want, f'analyze {name}: K1/K2/K4 launches {launches}, '
                                 f'expected {want} for {windows} forwards at B=1')
        per_batch, rows1, _ = run(ckpt, flags, ['--eval-chunk-steps', '1'])
        _check([r[:2] for r in rows1] == [r[:2] for r in rows64], f'{name}: row order')
        a, b = (np.asarray([r[2:] for r in rows], float) for rows in (rows64, rows1))
        chunk_err = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())
        _check(chunk_err <= 1e-5, f'{name}: chunked rows off per-batch rows by {chunk_err}')
        # B=512: a warm-up on this split (a full batch and a short one), then
        # the timed run on the wide split
        for home, expect in ((data, windows), (wide_data, wide_windows)):
            wide, _, wide_launches = run(ckpt, flags, ['--batch-size', '512'], home, expect)
            forwards = -(-expect // 512)
            _check(wide_launches == [per_forward * forwards if m is module else 0
                                     for m in kernel_modules],
                   f'analyze {name} B=512: launches {wide_launches} for {forwards} forwards')
        entry = dict(launches_b1=launches, windows_per_sec_b1=windows / chunked['seconds'],
                     windows_per_sec_b1_per_batch=windows / per_batch['seconds'],
                     windows_per_sec_b512=wide_windows / wide['seconds'],
                     b512_seconds=wide['seconds'], chunked_vs_per_batch_rel=chunk_err)
        if module is not None:
            with _plain_forwards(fm, fe, fg):
                plain, _, plain_launches = run(ckpt, flags)
            _check(plain_launches == [0, 0, 0], f'{name}: plain run launched {plain_launches}')
            worst = max(abs(chunked['summary'][k] - v) / max(abs(v), 1e-30)
                        for k, v in plain['summary'].items())
            _check(worst <= tol, f'analyze {name}: report off the plain versions by {worst} '
                                 f'relative (limit {tol}): {chunked["summary"]} against '
                                 f'{plain["summary"]}')
            entry['report_rel_vs_plain'] = worst
        report[name] = entry
        rates[name] = (entry['windows_per_sec_b1'], entry['windows_per_sec_b1_per_batch'],
                       entry['windows_per_sec_b512'])
        print(f'[analyze] {name}: {windows} windows at B=1 in {chunked["seconds"]} s '
              f'(--eval-chunk-steps 64), {per_batch["seconds"]} s (1); {wide_windows} '
              f'windows at B=512 in {wide["seconds"]} s; launches K1/K2/K4 {launches}; '
              f'chunked (64) rows vs per-batch rows {chunk_err:.3g} relative; report vs the '
              f'plain versions {entry.get("report_rel_vs_plain", "n/a (no kernel)")}',
              flush=True)

    ens, _, ens_launches = run('ckpt_ff', ['--ensemble', str(root / 'ckpt_ff' / 'feedforward'),
                                           str(member)])
    _check(ens_launches == [2 * windows, 0, 0],
           f'--ensemble of 2: launches {ens_launches} for {windows} forwards')
    tta, _, tta_launches = run('ckpt_gl', ['--model-type', 'groundlink', '--tta-mirror'])
    _check(tta_launches == [0, 0, 2 * windows],
           f'--tta-mirror: launches {tta_launches} for {windows} forwards')
    report['extras'] = dict(ensemble_launches=ens_launches, tta_launches=tta_launches,
                            ensemble_loss=ens['summary']['loss'], tta_loss=tta['summary']['loss'])
    print(f'[analyze] --ensemble of 2 feedforward: K1 launches {ens_launches[0]} == 2 x '
          f'{windows}; --tta-mirror GroundLink: K4 launches {tta_launches[2]} == 2 x '
          f'{windows}', flush=True)
    print(f'[analyze] eval windows/s ({card}): '
          + '; '.join(f'{k} {v[0]} at B=1 (chunks of 64), {v[1]} at B=1 (chunks of 1), '
                      f'{v[2]} at B=512 ({wide_windows} windows)' for k, v in rates.items()),
          flush=True)
    return report


# 9. the diffusion denoiser: sampling, serve and analyze through K2, held to
# the plain layer within DIFF_REL x max|plain|, the JAX suite's limit for its
# fused forward against model.apply. A chain from the top of the schedule is
# held step by step (each step's eps through K2 on the plain chain's own x_t),
# not by its answers: at its first step x0 = 8 sign(x_t - eps), so where x_t
# and eps nearly tie a rounding difference flips an element's sign (a correct
# chain was seen with 64% of a head's elements within the limit on the card).
# Its share within the limit is printed. A partial chain (partial_frac 0.3:
# from t = 300, 15 steps) is well conditioned: its answers, a served
# partial request's and the rows of a partial analyze are held element by
# element.
DIFF_REL = 5e-2


def _heads_vs(got: dict, want: dict, rel: float = DIFF_REL):
    """Per head: the max abs error, that error over max|want|, and the share
    of elements within ``rel`` x max|want| (numpy or torch on either side)."""
    out = {}
    for k, w in want.items():
        w = np.asarray(w.cpu() if hasattr(w, 'cpu') else w, np.float32)
        g = np.asarray(got[k].cpu() if hasattr(got[k], 'cpu') else got[k], np.float32)
        _check(g.shape == w.shape and np.isfinite(g).all(), f'head {k}: {g.shape} {w.shape}')
        err, top = np.abs(g - w), float(np.abs(w).max())
        out[k.replace('groundContact', '').replace('InRootFrame', '')] = (
            float(err.max()), float(err.max()) / top, float((err <= rel * top).mean()))
    return out


def phase_diffusion(torch, port, fe, fm, fg, diffusion, root, seed, card, data, ds,
                    device='cuda', steps=50, big=4096, frames=200):
    """The diffusion slice at full width (d_model 256, 4 layers, 8 heads, 1000
    timesteps, T = 10 x 177 channels, 30 target channels) with seeded weights
    and an EMA tree that differs: the sampler through K2 against the plain
    chain (each step's eps on the plain chain's own x_t; a partial chain's
    answers); ``serve --model-type diffusion --fused-inference`` (answers,
    launches, p50 at B=1, windows/s at B=4096, --diffusion-samples 4,
    --use-ema, --diffusion-partial 0.3 with a feedforward proposal against
    the plain chain, the reload poller, /schema, a checkpoint in the raw
    target space); ``analyze --model-type diffusion --fused-inference``
    (rows run to run, eval windows/s at B=1, a partial run's rows against
    the plain chains', on a dev split of one trial of ``frames`` frames). ``device`` 'cpu' rehearses the phase (no launch counts there;
    ``steps`` and ``big`` shrink the chains and the large request)."""
    on_card = device == 'cuda'
    ckpt_root, raw_root = root / 'diffusion_ckpts', root / 'diffusion_raw'
    cfg = port.config_from_args(port.parser().parse_args(
        ['train', '--model-type', 'diffusion', '--output-data-format', 'all_frames',
         '--fused-inference']))
    _check((cfg.d_model, cfg.num_layers, cfg.num_heads, cfg.diffusion_timesteps)
           == (ENC_FULL['d'], ENC_FULL['layers'], ENC_FULL['heads'], 1000),
           'diffusion defaults moved')
    layers = ENC_FULL['layers']

    def denoiser(s: int):
        """Seeded weights on the card, and an EMA tree that differs."""
        model = port.build_model_for_dataset(
            cfg, ds, generator=torch.Generator().manual_seed(s), device=device).eval()
        gen = torch.Generator().manual_seed(s + 1)
        ema = {k: v * (1 + 0.05 * torch.randn(v.shape, generator=gen).to(device))
               for k, v in model.state_dict().items()}
        return model, ema

    def write(model, ema, epoch, where=ckpt_root, sidecar=True):
        port.save_checkpoint(str(where / 'diffusion'), model, epoch, 0, ema_params=ema)
        if sidecar:
            port.save_run_config(str(where / 'diffusion'), cfg)

    model, ema = denoiser(seed + 40)
    write(model, ema, 1)
    write(model, ema, 1, raw_root, sidecar=False)
    ema_model, _ = denoiser(seed + 40)
    ema_model.load_state_dict(ema)
    _check(diffusion.checkpoint_target_space(str(ckpt_root / 'diffusion')) == 'normalized'
           and diffusion.checkpoint_target_space(str(raw_root / 'diffusion')) == 'raw',
           'target spaces of the two copies')

    def chain(net, x, init=None, **kw):
        """The chain through K2 on the card from a generator seeded 0, as a
        request runs it."""
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
        sampler = diffusion.make_sampler(net, num_steps=steps, fused_inference=True, **kw)
        return sampler(net, x, torch.Generator(device=device).manual_seed(0), init=init)

    def held(heads: dict) -> bool:
        """Every element of every head within DIFF_REL x its head's max."""
        return all(share == 1.0 for _, _, share in heads.values())

    part = diffusion.make_sampler(model, num_steps=steps, partial_frac=0.3)
    n_part = len(part.timesteps)
    # 9a. the chains through K2 against the plain chains
    chains = {}
    for b in (1, 2, 64):
        x = torch.from_numpy(ds.gather(np.arange(b)).inputs).to(device)
        init = torch.randn(b, 10, 30, generator=torch.Generator().manual_seed(seed + b)).to(device)
        for name, kw in (('eta 0', {}), ('eta 1', {'eta': 1.0}),
                         ('guidance 2', {'guidance_scale': 2.0})):
            fused = diffusion.make_sampler(model, num_steps=steps, fused_inference=True, **kw)
            fused_part = diffusion.make_sampler(model, num_steps=steps, fused_inference=True,
                                                partial_frac=0.3, **kw)
            fe.launches = 0
            got = fused(model, x, torch.Generator(device=device).manual_seed(0))
            got_part = fused_part(model, x, torch.Generator(device=device).manual_seed(0),
                                  init=init)
            launches = fe.launches
            trace = []
            with _plain_forwards(fm, fe, fg):
                want = fused(model, x, torch.Generator(device=device).manual_seed(0),
                             trace=trace)
                want_part = fused_part(model, x, torch.Generator(device=device).manual_seed(0),
                                       init=init)
            cfg2 = 'guidance_scale' in kw
            rows = torch.cat([x, torch.zeros_like(x)]) if cfg2 else x
            worst = 0.0
            with torch.no_grad():
                for t, xt in trace:
                    xb = torch.cat([xt, xt]) if cfg2 else xt
                    tb = torch.full((xb.shape[0],), t, device=device)
                    a = diffusion.fused_denoiser_eps(model, xb, tb, rows)
                    r = diffusion.fused_denoiser_eps(model, xb, tb, rows, use_kernel=False)
                    worst = max(worst, float((a - r).abs().max() / r.abs().max()))
            heads, heads_part = _heads_vs(got, want), _heads_vs(got_part, want_part)
            chains[f'B={b} {name}'] = dict(launches=launches, step_eps_rel=worst, heads=heads,
                                           partial_heads=heads_part)
            _check(not on_card or launches == layers * (steps + n_part),
                   f'chain B={b} {name}: {launches} K2 launches')
            _check(worst <= DIFF_REL, f'chain B={b} {name}: a step\'s eps through K2 off the '
                                      f'plain layer by {worst} x max (limit {DIFF_REL})')
            _check(held(heads_part), f'partial chain B={b} {name}: answers {heads_part}')
            print(f'[diffusion] chain B={b} {name}: {launches} K2 launches ({steps} + {n_part} '
                  f'steps); each step\'s eps through K2 vs the plain layer on the plain chain\'s '
                  f'x_t: max {worst:.3g} x max|plain| (limit {DIFF_REL}); the partial chain\'s '
                  f'answers vs the plain one, per head (max abs err, over max|plain|, share '
                  f'within {DIFF_REL} x max, held at 1.0): {heads_part}; the whole chain\'s, not held: {heads}',
                  flush=True)
    x1 = torch.from_numpy(ds.gather(np.arange(1)).inputs).to(device)
    one = diffusion.make_sampler(model, num_steps=steps, fused_inference=True)
    traced, busy, chain_ms = None, None, None
    if on_card:
        _, traced, busy = _traced(torch, lambda: one(model, x1, torch.Generator(
            device=device).manual_seed(0)))
        _check(traced['fused_encoder_kernel'] == layers * steps,
               f'chain B=1 traced {traced}, want {layers * steps} K2')
        chain_ms = _host_p50_ms(lambda: (one(model, x1, torch.Generator(
            device=device).manual_seed(0)), torch.cuda.synchronize()), 10)
        print(f'[diffusion] chain B=1, {steps} steps: profiler trace {traced} (K2 {layers} '
              f'x {steps}); device busy {busy:.1f} us of a host-clock p50 of {chain_ms:.2f} '
              f'ms (10 chains): idle share {1 - busy / 1e3 / chain_ms:.3f} ({card})',
              flush=True)

    # 9b. serve
    base = ['serve', '--dataset-home', str(data), '--checkpoint-dir', str(ckpt_root),
            '--port', '0', '--device', device, '--model-type', 'diffusion',
            '--output-data-format', 'all_frames', '--fused-inference',
            '--sample-steps', str(steps)]
    served, p50 = {}, {}

    def off_the_chain(r, want, what):
        """A served answer against the chain run directly on the card."""
        got = _decode(r['outputs'])
        err = max(float(np.abs(got[k] - want[k].cpu().numpy()).max()) for k in want)
        _check(err <= 1e-5 * max(float(v.abs().max()) for v in want.values()),
               f'{what}: off the direct chain by {err}')
        return err

    fe.launches = 0
    svc, server, url = _serve(port, base + ['--reload-poll-sec', '0.2'])
    try:
        s = _get(url + '/schema')
        _check((s['model_type'], s['diffusion_sample_steps'], s['diffusion_samples'],
                s['use_ema'], s['fused_inference'], s['output_data_format'])
               == ('diffusion', steps, 1, False, True, 'all_frames'), f'/schema {s}')
        xs = {b: ds.gather(np.arange(b)).inputs for b in (1, 37, big)}
        results = {b: _post(url + '/predict', _b64_body(xs[b])) for b in (1, 37, big)}
        body1 = json.dumps({'inputs': xs[1].tolist()}).encode()
        p50['1'] = _host_p50_ms(lambda: _post(url + '/predict', body1), 20)
        body_big = _b64_body(xs[big])
        p50[str(big)] = _host_p50_ms(lambda: _post(url + '/predict', body_big), 3)
        forwards = _get(url + '/metrics')['device_forwards']
        launches = fe.launches
        _check(not on_card or launches == layers * steps * forwards > 0,
               f'serve: {launches} K2 launches for {forwards} device forwards')
        served['launches'] = dict(k2=launches, forwards=forwards)
        for b, r in results.items():
            served[f'B={b} vs the direct chain'] = off_the_chain(
                r, chain(model, xs[b]), f'/predict B={b}')
        # the poller swaps to a newer checkpoint
        new_model, new_ema = denoiser(seed + 41)
        write(new_model, new_ema, 2)
        deadline = time.time() + 60
        while time.time() < deadline and _get(url + '/health')['epoch'] != 2:
            time.sleep(0.1)
        _check(_get(url + '/health')['epoch'] == 2, 'reload poller: epoch 2 not picked up')
        served['after the poller'] = off_the_chain(
            _post(url + '/predict', _b64_body(xs[37])), chain(new_model, xs[37]),
            'after the poller')
    finally:
        _stop(svc, server)
    write(model, ema, 3)      # the first weights again, newest, for what follows
    print(f'[diffusion] serve: /predict B=1 JSON p50 {p50["1"]:.2f} ms (20 requests); '
          f'B={big} b64 p50 {p50[str(big)]:.1f} ms (3 requests) = '
          f'{big / p50[str(big)] * 1e3:.1f} windows/s; K2 launches {launches} == {layers} x '
          f'{steps} x {forwards} device forwards; answers == the direct chain {served} '
          f'({card})', flush=True)

    extras = {}
    x2 = ds.gather(np.arange(2)).inputs
    # --diffusion-samples 4: four chains stacked, one K2 launch a layer and step
    fe.launches = 0
    svc, server, url = _serve(port, base + ['--diffusion-samples', '4'])
    try:
        r = _post(url + '/predict', _b64_body(x2, spread=True))
        forwards = _get(url + '/metrics')['device_forwards']
        launches = fe.launches
    finally:
        _stop(svc, server)
    _check(not on_card or launches == layers * steps * forwards == layers * steps,
           f'--diffusion-samples 4: {launches} K2 launches for {forwards} forwards')
    stacked = chain(model, np.concatenate([x2] * 4))
    mean, spread = diffusion.stacked_samples(stacked, 4)
    got_m, got_s = _decode(r['outputs']), _decode(r['spread'])
    err = max(max(float(np.abs(got_m[k] - mean[k].cpu().numpy()).max()),
                  float(np.abs(got_s[k] - spread[k].cpu().numpy()).max())) for k in mean)
    _check(err <= 1e-5 * max(float(v.abs().max()) for v in mean.values()),
           f'--diffusion-samples 4: off the stacked chains by {err}')
    _check(all(float(v.min()) >= 0 and float(v.max()) > 0 for v in spread.values()),
           'spread of 4 chains')
    extras['samples 4'] = dict(k2=launches, err=err)
    # --use-ema
    fe.launches = 0
    svc, server, url = _serve(port, base + ['--use-ema'])
    try:
        _check(_get(url + '/schema')['use_ema'] is True, '--use-ema /schema')
        r = _post(url + '/predict', _b64_body(x2))
        launches = fe.launches
    finally:
        _stop(svc, server)
    err = off_the_chain(r, chain(ema_model, x2), '--use-ema')
    _check(not on_card or launches == layers * steps,
           f'--use-ema: {launches} K2 launches for one forward')
    with _plain_forwards(fm, fe, fg):
        plain_ema = chain(ema_model, x2)
    # printed, not held: a chain from the top of the schedule (see DIFF_REL)
    extras['use_ema'] = dict(k2=launches, err=err,
                             vs_plain_chain=_heads_vs(chain(ema_model, x2), plain_ema))
    # --diffusion-partial 0.3 from a feedforward all-frames proposal
    pcfg = port.config_from_args(port.parser().parse_args(
        ['train', '--output-data-format', 'all_frames']))
    proposal = port.build_model_for_dataset(pcfg, ds, generator=torch.Generator().manual_seed(
        seed + 42), device=device).eval()
    port.save_checkpoint(str(root / 'proposal'), proposal, 0, 0)
    # t_top and the step count as the JAX sampler computes them
    t_top = max(1, int(round(0.3 * 999)))
    _check(int(part.timesteps[0]) == t_top == 300
           and n_part == max(1, min(int(round(steps * 0.3)), t_top + 1))
           == (15 if steps == 50 else n_part), f'partial 0.3: steps {part.timesteps}')
    fe.launches = fm.launches = 0
    svc, server, url = _serve(port, base + ['--diffusion-partial', '0.3', '--init-checkpoint',
                                            str(root / 'proposal')])
    try:
        r = _post(url + '/predict', _b64_body(x2))
        forwards = _get(url + '/metrics')['device_forwards']
        launches, k1 = fe.launches, fm.launches
    finally:
        _stop(svc, server)
    _check(not on_card or launches == layers * n_part * forwards and k1 == forwards == 1,
           f'--diffusion-partial: K2 {launches}, K1 {k1} for {forwards} forwards')
    xt2 = torch.from_numpy(x2).to(device)
    with torch.no_grad():
        init = diffusion.diffusion_targets_from_outputs(proposal(xt2))
        err = off_the_chain(r, chain(model, x2, partial_frac=0.3, init=init),
                            '--diffusion-partial')
        # the served answer against the plain chain from the plain proposal
        with _plain_forwards(fm, fe, fg):
            plain = chain(model, x2, partial_frac=0.3,
                          init=diffusion.diffusion_targets_from_outputs(proposal(xt2)))
    heads = _heads_vs(_decode(r['outputs']), plain)
    _check(held(heads), f'--diffusion-partial vs the plain chain: {heads}')
    extras['partial 0.3'] = dict(t_top=t_top, steps=n_part, k2=launches, k1=k1, err=err,
                                 vs_plain_chain=heads)
    # the raw target space: the sidecar-less copy
    svc, server, url = _serve(port, ['serve', '--dataset-home', str(data), '--checkpoint-dir',
                                     str(raw_root), '--port', '0', '--device', device,
                                     '--model-type', 'diffusion', '--output-data-format',
                                     'all_frames', '--fused-inference', '--sample-steps',
                                     str(steps)])
    try:
        r = _post(url + '/predict', _b64_body(x2))
    finally:
        _stop(svc, server)
    extras['raw space'] = off_the_chain(r, chain(model, x2, target_space='raw'), 'raw space')
    print(f'[diffusion] serve extras: {extras}', flush=True)

    # 9c. analyze on a dev split of one trial (a trial of L frames holds L - 51
    # windows at window 50 / stride 5); the command's chains take 50 steps
    home = root / 'diffusion_analyze'
    (home / 'train').mkdir(parents=True)
    (home / 'dev').mkdir()
    port.write_synthetic_subject(str(home / 'dev' / 'subject.b3d'), num_trials=1,
                                 trial_length=frames, seed=seed + 303)
    windows = frames - 51

    def analyze(extra=()):
        args = port.parser().parse_args([
            'analyze', '--dataset-home', str(home), '--checkpoint-dir', str(ckpt_root),
            '--no-wandb', '--device', device, '--model-type', 'diffusion',
            '--output-data-format', 'all_frames', *extra])
        csv_path = ckpt_root / 'diffusion' / 'dev_analysis.csv'
        if csv_path.exists():
            csv_path.unlink()
        fe.launches = fm.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = port.analyze(args)
        launches = (fe.launches, fm.launches)
        dev = result['dev']
        _check(dev['windows'] == windows and np.isfinite(list(dev['summary'].values())).all(),
               f'analyze diffusion {extra}: {dev}')
        with open(csv_path) as f:
            return dev, list(csv.reader(f)), launches

    dev, rows, (launches, _) = analyze(['--fused-inference'])
    _check(not on_card or launches == layers * 50 * windows,
           f'analyze: {launches} K2 launches for {windows} chains of 50 steps')
    _, rows2, _ = analyze(['--fused-inference'])
    _check(rows2 == rows and len(rows) == windows, 'analyze rows differ run to run')
    # partial chains from the feedforward proposal (K1 once a batch), each
    # row's metrics against the plain chains' within DIFF_REL x the column's max
    partial = ['--fused-inference', '--diffusion-partial', '0.3', '--init-checkpoint',
               str(root / 'proposal')]
    _, prows, part_launches = analyze(partial)
    _check(not on_card or part_launches == (layers * n_part * windows, windows),
           f'analyze --diffusion-partial: (K2, K1) launches {part_launches}')
    with _plain_forwards(fm, fe, fg):
        _, plain_rows, plain_launches = analyze(partial)
    _check(plain_launches == (0, 0), f'plain chain launched {plain_launches}')
    _check([r[:2] for r in prows] == [r[:2] for r in plain_rows], 'partial rows\' windows')
    g, w = (np.asarray([r[2:] for r in x], float) for x in (prows, plain_rows))
    rows_rel = float((np.abs(g - w) / np.abs(w).max(axis=0)).max())
    _check(rows_rel <= DIFF_REL, f'analyze --diffusion-partial: rows off the plain chains by '
                                 f'{rows_rel} x the column\'s max (limit {DIFF_REL})')
    rate = windows / dev['seconds']
    print(f'[diffusion] analyze --fused-inference: {windows} windows at B=1 in '
          f'{dev["seconds"]} s = {rate} windows/s; K2 launches {launches} == {layers} x '
          f'50 x {windows}; rows equal run to run; --diffusion-partial 0.3: (K2, K1) '
          f'launches {part_launches}, rows vs the plain chains {rows_rel:.3g} x the column\'s '
          f'max (limit {DIFF_REL}) ({card})', flush=True)
    return dict(chains=chains, chain_b1=dict(traced=traced, busy_us=busy, host_p50_ms=chain_ms),
                serve=dict(served, predict_p50_ms=p50,
                           windows_per_sec_b4096=big / p50[str(big)] * 1e3),
                extras=extras,
                analyze=dict(windows=windows, seconds=dev['seconds'], windows_per_sec_b1=rate,
                             k2_launches=launches, partial_launches=part_launches,
                             partial_rows_rel_vs_plain=rows_rel))


def phase_diffusion_train(torch, port, fe, fm, fg, step_mod, diffusion, root, seed, card,
                          big_home, device='cuda', batch=64, big=4096, trial_length=4800,
                          size_flags=(), chunks=3):
    """10. Diffusion training at full width through the ``train`` command
    (``--model-type diffusion --output-data-format all_frames --ema-decay
    0.999 --cond-dropout 0.1 --fused-inference``): at ``batch`` on one
    subject of two trials of ``trial_length`` frames (two chunks of 64 and a
    remainder an epoch) with a dev split of one batch, 2 epochs traced: one
    capture, a replay a step after the first two, no K3, and the dev eval's
    K2 launches (50-step chains, 4 a step) counted by the wrappers and by name
    in the trace; the loss falls; the same run step by step, and stopped
    after epoch 0 and resumed (epoch-granular), bitwise (parameters,
    optimizer state, EMA); ``serve --use-ema`` and ``analyze --use-ema`` of
    the trained checkpoint; a dev chain's eps through K2 on the plain chain's
    own x_t at every step, and a partial chain's answers element by element,
    within DIFF_REL of the plain layer; at ``big`` on ``big_home`` (phase 7's
    40 subjects and its dev subject), 2 epochs; the chunked step's ms by the
    host clock, device busy ms and idle share at both batches (chunks of 64
    at ``batch``, of 16 at ``big``), and the dev eval's seconds a batch.
    ``device`` 'cpu' with ``size_flags`` rehearses it (no launch counts, no
    traces). Returns the numbers for the report."""
    on_card = device == 'cuda'
    flags = ['--model-type', 'diffusion', '--output-data-format', 'all_frames',
             '--ema-decay', '0.999', '--cond-dropout', '0.1', '--fused-inference', *size_flags]
    cfg = port.config_from_args(port.parser().parse_args(['train', *flags]))
    layers, warmup = cfg.num_layers, step_mod.GraphedStep.WARMUP_STEPS
    per_chain = layers * 50
    home, solo = root / 'diffusion_train', root / 'diffusion_train_dev'
    for d in (home / 'train', home / 'dev', solo / 'train', solo / 'dev'):
        d.mkdir(parents=True)
    port.write_synthetic_subject(str(home / 'train' / 'subject_0.b3d'), num_trials=2,
                                 trial_length=trial_length, seed=seed + 300)
    # one trial of 140 frames: 89 windows, one dev batch of 64
    port.write_synthetic_subject(str(home / 'dev' / 'subject_0.b3d'), num_trials=1,
                                 trial_length=140, seed=seed + 310)
    shutil.copy(home / 'dev' / 'subject_0.b3d', solo / 'dev' / 'subject_0.b3d')

    def split(where, name):
        return port.WindowDataset(str(where / name), window_size=cfg.window_size,
                                  stride=cfg.stride, output_data_format='all_frames',
                                  skip_loading_skeletons=True)

    def run(where, ckpt, extra, epochs, b):
        return port.run_training(port.parser().parse_args([
            'train', '--dataset-home', str(where), '--checkpoint-dir', str(ckpt),
            '--batch-size', str(b), '--epochs', str(epochs), '--device', device,
            '--seed', str(seed), *flags, *extra]))

    def counted(fn):
        """``fn()`` with the counts set to 0 just before and read just after,
        traced on the card: (result, K2 and K3 launches by the wrappers,
        captures, replays, the trace's counts or None, seconds)."""
        fe.launches = fe.bwd_launches = 0
        replays, captures = step_mod.replays, step_mod.captures
        t0 = time.perf_counter()
        result, traced, _ = _traced(torch, fn) if on_card else (fn(), None, None)
        seconds = time.perf_counter() - t0
        return (result, (fe.launches, fe.bwd_launches), step_mod.captures - captures,
                step_mod.replays - replays, traced, seconds)

    train_ds, dev_ds = split(home, 'train'), split(home, 'dev')
    dev_batches = len(dev_ds) // batch
    per_epoch = len(train_ds) // batch
    _check(dev_batches >= 1 and per_epoch > 2 * 64 and per_epoch % 64,
           f'{len(train_ds)} / {len(dev_ds)} windows: not two chunks of 64 and a remainder, '
           f'one dev batch')
    loop_log = logging.getLogger('inferbiomechanics_tpu_torch.train.diffusion_loop')
    loop_log.setLevel(logging.INFO)
    handler = _LossLog()
    loop_log.addHandler(handler)
    step_log = logging.getLogger('inferbiomechanics_tpu_torch.train.step')
    step_log.addHandler(handler)
    try:
        # the main path
        (main, (k2, k3), captures, replays, traced, main_s) = counted(
            lambda: run(home, root / 'dckpt_a', [], 2, batch))
        logged, capture_s = list(handler.steps), list(handler.captures)
    finally:
        loop_log.removeHandler(handler)
        step_log.removeHandler(handler)
    steps, evals = main.windows_seen // batch, 2
    dev_k2 = per_chain * dev_batches * evals
    _check(main.epochs_run == 2 and steps == 2 * per_epoch, f'diffusion B={batch}: {main}')
    _check(not on_card or (captures == 1 and replays == steps - warmup),
           f'diffusion B={batch}: {captures} captures, {replays} replays for {steps} steps')
    _check(not on_card or (k2 == dev_k2 and k3 == 0),
           f'diffusion B={batch}: wrappers K2 {k2}, K3 {k3}; want K2 {dev_k2} (dev eval), K3 0')
    if on_card:
        want = {'fused_encoder_kernel': dev_k2, **{k: 0 for k in ENC_KERNELS[1:]}}
        _check(all(traced[k] == v for k, v in want.items()),
               f'diffusion B={batch}: traced {traced}, want {want}')
    losses = [s[2] for s in logged]
    _check(len(losses) >= 2 and np.isfinite(losses).all() and losses[-1] < losses[0]
           and np.isfinite(main.final_train_metrics['eps_mse'])
           and np.isfinite(main.final_dev_metrics['loss']),
           f'diffusion B={batch}: logged eps-mse {logged}, {main.final_train_metrics}, '
           f'dev {main.final_dev_metrics}')
    final = torch.load(str(root / 'dckpt_a' / 'diffusion' / 'epoch_1_batch_0.torch.pt'),
                       map_location='cpu', weights_only=True)
    _check(set(final.get('ema_params', {})) == set(final['model_state_dict']),
           'the checkpoint carries no EMA of every parameter')
    print(f'[diffusion train] B={batch}, {steps} steps in 2 epochs (chunks of 64, the last '
          f'{per_epoch % 64}), {dev_batches} dev batch an eval, {evals} evals ({card}): '
          f'{captures} capture, {replays} replays after {warmup} eager steps; wrappers: K2 '
          f'{k2} == {layers} x 50 x {dev_batches} x {evals} (the dev chains), K3 {k3}; trace '
          f'{traced}; eps-mse logged {[round(x, 4) for x in losses]} (falls); dev loss '
          f'{main.final_dev_metrics["loss"]:.4g}; {main.windows_per_sec:.0f} windows/s '
          f'(traced); {main_s:.1f} s; capture {capture_s} s', flush=True)

    # the same run step by step, and stopped after epoch 0 and resumed
    per_step = run(home, root / 'dckpt_s', ['--device-chunk-steps', '1'], 2, batch)
    _check(per_step.windows_seen == main.windows_seen, 'step-by-step run: windows')
    vs_step = _compare_final(torch, root / 'dckpt_a' / 'diffusion',
                             root / 'dckpt_s' / 'diffusion', 1)
    run(home, root / 'dckpt_b', [], 1, batch)
    resumed = run(home, root / 'dckpt_b', [], 2, batch)
    _check(resumed.epochs_run == 1, f'the resumed run ran {resumed.epochs_run} epochs')
    vs_resume = _compare_final(torch, root / 'dckpt_a' / 'diffusion',
                               root / 'dckpt_b' / 'diffusion', 1)
    print(f'[diffusion train] B={batch}, chunked against step by step ({card}): '
          f'{vs_step["verdict"]}; stopped after epoch 0 and resumed against uninterrupted: '
          f'{vs_resume["verdict"]}; windows/s chunked {main.windows_per_sec:.0f} (traced), '
          f'step by step {per_step.windows_per_sec:.0f}, resumed {resumed.windows_per_sec:.0f}',
          flush=True)

    # serve --use-ema and analyze --use-ema of the trained checkpoint
    net = port.build_model_for_dataset(cfg, dev_ds, device=device).eval()
    net.load_state_dict(final['model_state_dict'])
    ema_net = port.build_model_for_dataset(cfg, dev_ds, device=device).eval()
    ema_net.load_state_dict(final['ema_params'])
    x2 = dev_ds.gather(np.arange(2)).inputs
    want = diffusion.make_sampler(ema_net, num_steps=50, fused_inference=True)(
        ema_net, torch.from_numpy(x2).to(device), torch.Generator(device=device).manual_seed(0))
    fe.launches = 0
    svc, server, url = _serve(port, ['serve', '--dataset-home', str(home), '--checkpoint-dir',
                                     str(root / 'dckpt_a'), '--port', '0', '--device', device,
                                     *flags, '--use-ema'])
    try:
        s = _get(url + '/schema')
        r = _post(url + '/predict', _b64_body(x2))
        forwards = _get(url + '/metrics')['device_forwards']
        serve_k2 = fe.launches
    finally:
        _stop(svc, server)
    got = _decode(r['outputs'])
    serve_err = max(float(np.abs(got[k] - want[k].cpu().numpy()).max()) for k in want)
    _check(s['use_ema'] is True and serve_err <= 1e-5 * max(float(v.abs().max())
                                                            for v in want.values()),
           f'serve --use-ema of the trained checkpoint: off its EMA chain by {serve_err}')
    _check(not on_card or serve_k2 == per_chain * forwards == per_chain,
           f'serve --use-ema: {serve_k2} K2 launches for {forwards} forwards')
    args = port.parser().parse_args(['analyze', '--dataset-home', str(solo), '--checkpoint-dir',
                                     str(root / 'dckpt_a'), '--no-wandb', '--device', device,
                                     '--batch-size', str(batch), *flags, '--use-ema'])
    fe.launches = 0
    with contextlib.redirect_stdout(io.StringIO()) as out:
        analyzed = port.analyze(args)['dev']
    analyze_k2 = fe.launches
    analyze_batches = -(-len(dev_ds) // batch)
    _check(analyzed['windows'] == len(dev_ds) and 'evaluating EMA parameters' in out.getvalue()
           and np.isfinite(list(analyzed['summary'].values())).all(),
           f'analyze --use-ema of the trained checkpoint: {analyzed}')
    _check(not on_card or analyze_k2 == per_chain * analyze_batches,
           f'analyze --use-ema: {analyze_k2} K2 launches for {analyze_batches} batches')
    print(f'[diffusion train] serve --use-ema of the trained checkpoint: /predict B=2 off the '
          f'EMA weights\' chain by {serve_err:.3g}, K2 {serve_k2}; analyze --use-ema: '
          f'{analyzed["windows"]} windows, K2 {analyze_k2} == {layers} x 50 x {analyze_batches} '
          f'batches, summary {analyzed["summary"]}', flush=True)

    # a dev chain of the trained weights through K2 against the plain chain
    b = dev_ds.gather(np.arange(batch))
    xb = torch.from_numpy(b.inputs).to(device)
    init = diffusion.diffusion_targets_from_labels(
        torch.from_numpy(b.labels).to(device), dev_ds.lab_offsets, net.num_contact_bodies)
    eval_seed = seed * 1_000_003 + 777 + 2
    whole = diffusion.make_sampler(net, num_steps=50, fused_inference=True)
    part = diffusion.make_sampler(net, num_steps=50, fused_inference=True, partial_frac=0.3)

    def gen():
        return torch.Generator(device=device).manual_seed(eval_seed)

    got_part = part(net, xb, gen(), init=init)
    trace = []
    with _plain_forwards(fm, fe, fg):
        whole(net, xb, gen(), trace=trace)
        want_part = part(net, xb, gen(), init=init)
    worst = 0.0
    with torch.no_grad():
        for t, xt in trace:
            tb = torch.full((xt.shape[0],), t, device=device)
            a = diffusion.fused_denoiser_eps(net, xt, tb, xb)
            r = diffusion.fused_denoiser_eps(net, xt, tb, xb, use_kernel=False)
            worst = max(worst, float((a - r).abs().max() / r.abs().max()))
    heads_part = _heads_vs(got_part, want_part)
    _check(len(trace) == 50 and worst <= DIFF_REL,
           f'dev chain: a step\'s eps through K2 off the plain layer by {worst} x max')
    _check(all(share == 1.0 for _, _, share in heads_part.values()),
           f'dev partial chain vs the plain one: {heads_part}')
    print(f'[diffusion train] the trained weights\' dev chain B={batch} (eval seed of epoch 2), '
          f'teacher-forced: each step\'s eps through K2 vs the plain layer on the plain '
          f'chain\'s x_t: max {worst:.3g} x max|plain| (limit {DIFF_REL}); partial chain '
          f'(0.3, from the dev labels) per head (max abs err, over max|plain|, share within '
          f'{DIFF_REL} x max, held at 1.0): {heads_part}', flush=True)

    # at B=big on phase 7's 40 subjects
    big_ds, big_dev = split(big_home, 'train'), split(big_home, 'dev')
    (large, (k2_big, _), captures_big, replays_big, traced_big, big_s) = counted(
        lambda: run(big_home, root / 'dckpt_big', [], 2, big))
    big_steps, big_dev_batches = large.windows_seen // big, len(big_dev) // big
    _check(large.epochs_run == 2 and big_steps == 2 * (len(big_ds) // big)
           and np.isfinite(large.final_train_metrics['eps_mse']), f'diffusion B={big}: {large}')
    _check(not on_card or (captures_big == 1 and replays_big == big_steps - warmup
                           and k2_big == per_chain * big_dev_batches * 2
                           == traced_big['fused_encoder_kernel']),
           f'diffusion B={big}: {captures_big} captures, {replays_big} replays, K2 {k2_big}, '
           f'traced {traced_big}')
    print(f'[diffusion train] B={big}, {big_steps} steps in 2 epochs, {big_dev_batches} dev '
          f'batch an eval ({card}): {captures_big} capture, {replays_big} replays; K2 {k2_big} '
          f'(the dev chains), trace {traced_big}; eps-mse {large.final_train_metrics}; '
          f'{large.windows_per_sec:.0f} windows/s (traced); {big_s:.1f} s', flush=True)

    # the chunked step alone, and a dev eval's chain, at both batches
    times = {}
    for b, ds, k in ((batch, train_ds, 64), (big, big_ds, 16)):
        model = port.build_model_for_dataset(
            cfg, ds, generator=torch.Generator().manual_seed(seed), device=device)
        state = port.create_train_state(model, port.make_optimizer(
            model.named_parameters(), cfg.opt_type, cfg.learning_rate))
        state.dropout_gen = torch.Generator(device=device)
        state.ema = port.ParamEMA(model, cfg.ema_decay)
        chunked = port.make_device_diffusion_chunked_step(
            model, port.DeviceResidentData(ds, device, pack_windows=True),
            diffusion.DDPMSchedule(cfg.diffusion_timesteps, device=device), cfg.cond_dropout)
        rng = np.random.default_rng(seed)
        idx = np.stack([rng.permutation(len(ds))[:b] for _ in range(k)])

        def one():
            chunked(state, idx).rows()     # waits for the chunk's last metrics  # noqa: B023

        one()                              # the eager first steps and the capture
        wall = _host_p50_ms(one, chunks) / k
        busy = idle = None
        if on_card:
            _, tr, busy_us = _traced(torch, one)
            busy = busy_us / 1e3 / k
            idle = max(wall - busy, 0.0) / wall
        sampler = diffusion.make_sampler(model.eval(), num_steps=50, fused_inference=True)
        x = torch.from_numpy(ds.gather(np.arange(b)).inputs).to(device)
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        eval_ms = _host_p50_ms(lambda: (sampler(model, x, torch.Generator(  # noqa: B023
            device=device).manual_seed(0)), sync()), chunks)
        times[str(b)] = dict(step_ms=wall, device_busy_ms=busy, idle_share=idle,
                             windows_per_sec=b / wall * 1e3, chunk=k,
                             dev_eval_s_a_batch=eval_ms / 1e3)
        print(f'[diffusion train] train step B={b} in chunks of {k} ({card}): {wall:.3f} ms a '
              f'step by the host clock (p50 of {chunks} chunks) = {b / wall * 1e3:.0f} '
              f'windows/s; device busy '
              + ('not measured' if busy is None else f'{busy:.3f} ms a step, idle share '
                 f'{idle:.3f}')
              + f'; dev eval, a 50-step chain of one batch of {b} through K2: '
              f'{eval_ms / 1e3:.3f} s (p50 of {chunks})', flush=True)
        del model, state, chunked, sampler
    return dict(batch=dict(steps=steps, captures=captures, replays=replays, k2_launches=k2,
                           k3_launches=k3, traced=traced, dev_batches=dev_batches, evals=evals,
                           eps_mse_logged=losses, windows_per_sec=main.windows_per_sec,
                           windows_per_sec_step_by_step=per_step.windows_per_sec,
                           vs_step_by_step=vs_step, resume=vs_resume, seconds=main_s),
                big=dict(steps=big_steps, captures=captures_big, replays=replays_big,
                         k2_launches=k2_big, traced=traced_big, windows_per_sec=large.windows_per_sec,
                         seconds=big_s),
                serve_use_ema=dict(err=serve_err, k2=serve_k2),
                analyze_use_ema=dict(windows=analyzed['windows'], k2=analyze_k2),
                dev_chain=dict(step_eps_rel=worst, partial_heads=heads_part),
                chunk_times=times)


def phase_step_times(torch, port, fe, ds, make_device_train_step, make_optimizer,
                     create_train_state, card, seed, batch=4096, attns=('pallas', 'vpu'),
                     parts_alone=True):
    """A whole train step at full width on device-resident data (``pallas``
    and ``vpu`` transformers): time by the host clock around synchronised
    steps, device time by kernel, the kernels' launches by shape in those
    steps (counts set to 0 just before, read just after) and, with
    ``parts_alone``, the parts timed alone by CUDA events."""
    out = {}
    idx = torch.from_numpy(np.random.default_rng(seed).permutation(len(ds))[:batch]).cuda()
    data = port.DeviceResidentData(ds, 'cuda', pack_windows=True)
    for attn in attns:
        cfg = port.config_from_args(port.parser().parse_args(
            ['train', '--model-type', 'transformer', '--attn-impl', attn]))
        model = port.build_model_for_dataset(
            cfg, ds, generator=torch.Generator().manual_seed(seed), device='cuda')
        lc = port.loss_config_from(cfg)
        state = create_train_state(model, make_optimizer(
            model.named_parameters(), cfg.opt_type, cfg.learning_rate))
        step = make_device_train_step(model, data, lc)

        def one():
            return step(state, idx)                       # noqa: B023

        def synced():
            one()
            torch.cuda.synchronize()

        fe.launches = fe.bwd_launches = 0
        fe.bwd_shape_launches.update(small=0, large=0)
        wall = _host_p50_ms(synced, 10)
        parts = _device_us_by_name(torch, one, (
            'fused_encoder_kernel', 'encoder_bwd_tile_kernel_cluster',
            'encoder_bwd_tile_kernel', 'encoder_wgrad_kernel', 'encoder_bwd_reduce_kernel'),
            iters=5)
        launched = dict(k2=fe.launches, k3=fe.bwd_launches,
                        k3_by_shape=dict(fe.bwd_shape_launches))
        busy = sum(parts.values()) / 1e3
        out[attn] = dict(step_ms=wall, device_busy_ms=busy, device_us_by_kernel=parts,
                         windows_per_sec=batch / wall * 1e3, launches=launched,
                         idle_share=max(wall - busy, 0.0) / wall)
        print(f'[times] train step {attn} transformer B={batch} step by step ({card}): '
              f'{wall:.2f} ms by the host clock (p50 of 10 synchronised steps) = '
              f'{batch / wall * 1e3:.0f} windows/s; device busy {busy:.2f} ms a step (host '
              f'gaps {max(wall - busy, 0.0):.2f} ms, idle share '
              f'{max(wall - busy, 0.0) / wall:.3f}): '
              + ', '.join(f'{k} {v:.1f} us' for k, v in parts.items())
              + f'; launches {launched}', flush=True)
        if attn == 'pallas' and parts_alone:
            inputs, labels = data.gather(idx)
            with torch.no_grad():
                outputs = {k: v.clone().requires_grad_(True)
                           for k, v in model.eval()(inputs).items()}

            def loss_fb():
                loss, _ = port.loss_and_metrics(outputs, port.unpack(labels, data.lab_offsets), lc)
                loss.backward()

            alone = {
                'gather': _cuda_ms(torch, lambda: data.gather(idx), iters=10),
                'loss and metrics, forward and backward': _cuda_ms(torch, loss_fb, iters=10),
                'optimizer update': _cuda_ms(torch, state.optimizer.step, iters=10),
                'packing': _cuda_ms(torch, lambda: [
                    fe.pack_encoder_params(model.layer_params(i), 'cuda', transposes=True)
                    for i in range(model.num_layers)], iters=10),
            }
            out[attn]['alone_ms'] = alone
            print('[times] parts of the pallas step alone, CUDA events: '
                  + ', '.join(f'{k} {v * 1e3:.1f} us' for k, v in alone.items()), flush=True)
        del model, state, step
    return out


def phase_chunk_times(torch, port, fe, ds, card, seed, batch, chunk=64, chunks=5):
    """The ``pallas`` train step at full width in chunks of ``chunk`` on
    device-resident data: one step by the host clock (p50 over ``chunks``
    chunks, each ended by reading its metrics back), the device busy time a
    step and the idle share, with the K2 and K3 kernels of the chunk's
    replays (profiler, over one chunk; the wrappers' counts set to 0 just
    before and read just after stay 0: a replay runs no wrapper)."""
    cfg = port.config_from_args(port.parser().parse_args(
        ['train', '--model-type', 'transformer', '--attn-impl', 'pallas']))
    model = port.build_model_for_dataset(
        cfg, ds, generator=torch.Generator().manual_seed(seed), device='cuda')
    state = port.create_train_state(model, port.make_optimizer(
        model.named_parameters(), cfg.opt_type, cfg.learning_rate))
    data = port.DeviceResidentData(ds, 'cuda', pack_windows=True)
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(len(ds))[:batch] for _ in range(chunk)])
    run = port.make_device_chunked_step(model, data, port.loss_config_from(cfg))

    def one():
        run(state, idx).rows()      # waits for the chunk's last metrics

    one()                           # the eager first steps and the capture
    fe.launches = fe.bwd_launches = 0
    wall = _host_p50_ms(one, chunks) / chunk
    _, traced, busy_us = _traced(torch, one)
    layers = cfg.num_layers
    _check(fe.launches == fe.bwd_launches == 0, f'chunk timing: wrappers ran in a replay: '
                                                f'K2 {fe.launches}, K3 {fe.bwd_launches}')
    k3_shape = fe.plan_encoder_bwd(batch, cfg.window_size // cfg.stride, cfg.d_model,
                                   cfg.d_model * ENC_FULL['mlp_ratio'], cfg.num_heads).shape
    _check_traced(traced, layers, chunk, 0, k3_shape, f'chunk timing B={batch}')
    k2, k3 = traced['fused_encoder_kernel'], sum(traced[k] for k in ENC_KERNELS[1:])
    busy = busy_us / 1e3 / chunk if busy_us > 0 else None
    idle = None if busy is None else max(wall - busy, 0.0) / wall
    print(f'[times] train step pallas transformer B={batch} in chunks of {chunk} ({card}): '
          f'{wall:.3f} ms a step by the host clock (p50 of {chunks} chunks) = '
          f'{batch / wall * 1e3:.0f} windows/s; device busy '
          + ('not measured' if busy is None else f'{busy:.3f} ms a step, idle share '
             f'{idle:.3f}') + f'; in the profiler trace of that chunk: K2 {k2} == {layers} x '
          f'{chunk} steps, K3 {k3} == {layers} x {fe.BWD_LAUNCHES_PER_LAYER} x {chunk} '
          f'({k3_shape} shape), all graph replays (the wrappers counted none)', flush=True)
    return dict(step_ms=wall, device_busy_ms=busy, idle_share=idle,
                windows_per_sec=batch / wall * 1e3,
                traced=dict(k2=k2, k3=k3, steps=chunk, by_kernel=traced))


def _chunk_step_times(torch, port, flags, ds, batch, seed, chunk=16, chunks=3):
    """``phase_chunk_times``' method for the model and options ``flags``
    (train flags, augmentation included) on device-resident ``ds``: one step
    by the host clock (p50 over ``chunks`` chunks of ``chunk``, each ended by
    reading its metrics back), the device busy time a step from a profiler
    trace of one chunk, and the idle share."""
    cfg = port.config_from_args(port.parser().parse_args(['train', *flags]))
    model = port.build_model_for_dataset(
        cfg, ds, generator=torch.Generator().manual_seed(seed), device='cuda')
    state = port.create_train_state(model, port.make_optimizer(
        model.named_parameters(), cfg.opt_type, cfg.learning_rate))
    augment = port.per_step_generators(cfg, state, ds, 'cuda')
    data = port.DeviceResidentData(ds, 'cuda', pack_windows=True)
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(len(ds))[:batch] for _ in range(chunk)])
    run = port.make_device_chunked_step(model, data, port.loss_config_from(cfg), augment=augment)

    def one():
        run(state, idx).rows()

    one()                           # the eager first steps and the capture
    wall = _host_p50_ms(one, chunks) / chunk
    _, traced, busy_us = _traced(torch, one)
    busy = busy_us / 1e3 / chunk if busy_us > 0 else None
    idle = None if busy is None else max(wall - busy, 0.0) / wall
    del model, state, run, data
    return dict(step_ms=wall, device_busy_ms=busy, idle_share=idle,
                windows_per_sec=batch / wall * 1e3, traced=traced)


def phase_regularised(torch, port, fe, fm, step_mod, augment_mod, root, seed, card,
                      device='cuda', big=4096, batch=64, size_flags=()):
    """11. The training options beside the JAX defaults, through the
    ``train``, ``serve`` and ``analyze`` commands at full width: the
    feedforward model with ``--batchnorm --dropout --dropout-prob 0.1
    --augment-mirror --augment-noise-std 0.05`` at ``big`` on phase 7's 40
    subjects (one chunk an epoch, 2 epochs; K1 in the dev eval), chunked
    against step by step and resumed after epoch 0 against uninterrupted,
    bitwise (parameters, running statistics, optimizer state); at ``batch``
    on phase 7d's subject, chunked against step by step, also with
    ``--grad-accum-steps 2``; its eval through K1 on the folded packing
    against the plain version on it, and ``serve`` and ``analyze`` of its
    checkpoint through K1 (launches counted); the augmentation's coins
    recorded inside a chunk's replays; the ``pallas`` transformer augmented at
    ``big`` for one epoch, its K2 and K3 kernels counted by name in a
    profiler trace against the same run unaugmented; the ``vpu`` transformer
    with dropout at ``batch``, then served with ``--fused-inference`` (K2);
    the denoiser with ``--augment-mirror`` at ``batch``, chunked against step
    by step with its EMA; train windows/s with and without augmentation, the
    chunked step's ms, device busy ms and idle share, the folded K1's us.
    ``device`` 'cpu' with smaller batches and ``size_flags`` (the
    transformers' width) rehearses it (no launch counts, traces or times).
    Returns the numbers for the report."""
    t_phase = time.perf_counter()
    on_card = device == 'cuda'
    big_home, small_home = root / 'train_data', root / 'chunk_data'
    ff = ['--model-type', 'feedforward', '--batchnorm', '--dropout', '--dropout-prob', '0.1']
    aug = ['--augment-mirror', '--augment-noise-std', '0.05']
    pallas = ['--model-type', 'transformer', '--attn-impl', 'pallas', *size_flags]
    warmup = step_mod.GraphedStep.WARMUP_STEPS

    def run(home, ckpt, flags, epochs, b):
        return port.run_training(port.parser().parse_args([
            'train', '--dataset-home', str(home), '--checkpoint-dir', str(root / ckpt),
            '--batch-size', str(b), '--epochs', str(epochs), '--device', device,
            '--seed', str(seed), *flags]))

    def final(ckpt, model_type):
        return root / ckpt / model_type

    def split(home, name):
        return port.WindowDataset(str(home / name), window_size=50, stride=5,
                                  skip_loading_skeletons=True)

    out = {}
    # 11a. the main path: the batchnorm + dropout + augmented feedforward model
    # at big, counts set to 0 just before, read just after
    train_ds, small_ds = split(big_home, 'train'), split(small_home, 'train')
    dev_windows = len(split(big_home, 'dev'))
    dev_batches = dev_windows // big
    fm.launches = 0
    replays, captures = step_mod.replays, step_mod.captures
    a = run(big_home, 'r_ff_a', [*ff, *aug], 2, big)
    k1_train = fm.launches
    replays, captures = step_mod.replays - replays, step_mod.captures - captures
    steps = a.windows_seen // big
    _check(a.epochs_run == 2 and steps == 2 * (len(train_ds) // big) and steps >= 8
           and dev_batches >= 1,
           f'feedforward batchnorm B={big}: {a.epochs_run} epochs, {steps} steps, '
           f'{dev_batches} dev batches')
    _check(not on_card or (captures == 1 and replays == steps - warmup),
           f'feedforward batchnorm B={big}: {captures} captures, {replays} replays')
    _check(not on_card or k1_train == 2 * dev_batches,
           f'feedforward batchnorm B={big}: K1 launches {k1_train}, want {2 * dev_batches} '
           f'(the dev evals)')
    _check(np.isfinite(a.final_train_metrics['loss']) and np.isfinite(a.final_dev_metrics['loss']),
           f'feedforward batchnorm: {a.final_train_metrics} / {a.final_dev_metrics}')
    s = run(big_home, 'r_ff_s', [*ff, *aug, '--device-chunk-steps', '1'], 2, big)
    run(big_home, 'r_ff_b', [*ff, *aug], 1, big)
    b = run(big_home, 'r_ff_b', [*ff, *aug], 2, big)
    _check(s.windows_seen == a.windows_seen == 2 * b.windows_seen, 'feedforward batchnorm runs')
    ff_step = _compare_final(torch, final('r_ff_a', 'feedforward'),
                             final('r_ff_s', 'feedforward'), 1)
    ff_resume = _compare_final(torch, final('r_ff_a', 'feedforward'),
                               final('r_ff_b', 'feedforward'), 1)
    noaug = run(big_home, 'r_ff_n', ff, 2, big)
    print(f'[regularised] feedforward --batchnorm --dropout 0.1 --augment-mirror '
          f'--augment-noise-std 0.05, B={big}, {steps} steps in 2 epochs, one chunk an epoch '
          f'({card}): {captures} capture, {replays} replays; K1 launches {k1_train} == 2 dev '
          f'evals x {dev_batches}; chunked against step by step: {ff_step["verdict"]}; '
          f'resumed after epoch 0 against uninterrupted: {ff_resume["verdict"]}; windows/s '
          f'{a.windows_per_sec:.0f} augmented, {noaug.windows_per_sec:.0f} not augmented, '
          f'{s.windows_per_sec:.0f} augmented step by step', flush=True)
    out['feedforward_big'] = dict(steps=steps, captures=captures, replays=replays,
                                  k1_launches=k1_train, vs_step_by_step=ff_step,
                                  resume=ff_resume, windows_per_sec=a.windows_per_sec,
                                  windows_per_sec_not_augmented=noaug.windows_per_sec,
                                  windows_per_sec_step_by_step=s.windows_per_sec)

    # 11b. at the default batch on phase 7d's subject, and with grad accumulation
    small = {}
    for name, extra in (('default', []), ('grad_accum_2', ['--grad-accum-steps', '2'])):
        c = run(small_home, f'r_ff64c_{name}', [*ff, *aug, *extra], 1, batch)
        p = run(small_home, f'r_ff64s_{name}', [*ff, *aug, *extra, '--device-chunk-steps', '1'],
                1, batch)
        _check(c.windows_seen == p.windows_seen, f'feedforward batchnorm B={batch} {extra}')
        cmp = _compare_final(torch, final(f'r_ff64c_{name}', 'feedforward'),
                             final(f'r_ff64s_{name}', 'feedforward'), 0)
        small[name] = dict(steps=c.windows_seen // batch, vs_step_by_step=cmp,
                           windows_per_sec=c.windows_per_sec)
        print(f'[regularised] feedforward batchnorm dropout augmented B={batch} {extra}, '
              f'{c.windows_seen // batch} steps in chunks of 64 against step by step ({card}): '
              f'{cmp["verdict"]}; windows/s {c.windows_per_sec:.0f} chunked, '
              f'{p.windows_per_sec:.0f} step by step', flush=True)
    out['feedforward_small'] = small

    # 11c. the batchnorm model's eval through K1 on the folded packing
    cfg = port.config_from_args(port.parser().parse_args(['train', *ff]))
    model, epoch, _ = port.load_model(cfg, train_ds, str(final('r_ff_a', 'feedforward')),
                                      device=device)
    _check(epoch == 1 and model.norms is not None, 'the batchnorm checkpoint')
    packed = model.packed()
    k1 = {}
    for bb in (1, big):
        x = torch.from_numpy(train_ds.gather(np.arange(bb)).inputs.reshape(bb, -1)).to(device)
        got = fm.fused_mlp_forward(x, packed, cfg.activation)
        ref = fm.mlp_reference(x, packed.layers, cfg.activation)
        err, top = float((got - ref).abs().max()), float(ref.abs().max())
        _check(err <= k1_limit(top), f'folded K1 B={bb}: {err} from the plain version (limit '
                                     f'{k1_limit(top)} for outputs up to {top})')
        k1[bb] = dict(max_abs_err=err, max_abs_plain=top, limit=k1_limit(top))
        if on_card:
            fns = (('kernel', lambda: fm.fused_mlp_forward(x, packed, cfg.activation)),  # noqa: B023
                   ('plain', lambda: fm.mlp_reference(x, packed.layers, cfg.activation)))  # noqa: B023
            k1[bb]['ms'] = {name: _cuda_ms(torch, fn) for name, fn in fns}
            k1[bb]['device_us'] = {name: _device_us(torch, fn) for name, fn in fns}
        fmt = lambda us: 'not measured' if us is None else f'{us:.1f} us'  # noqa: E731
        times = (f'profiler device time a call: kernel {fmt(k1[bb]["device_us"]["kernel"])}, '
                 f'plain {fmt(k1[bb]["device_us"]["plain"])} (PERF.md\'s K1 row: 78.1 / 24.2 us at '
                 f'B=4096 / 1); CUDA events: kernel {k1[bb]["ms"]["kernel"] * 1e3:.1f} '
                 f'us, plain {k1[bb]["ms"]["plain"] * 1e3:.1f} us' if on_card else 'not timed')
        print(f'[regularised] K1 on the folded batchnorm packing B={bb} ({card}): max abs err '
              f'{err:.3g} against the plain version on it (limit {k1_limit(top)}, outputs up '
              f'to {top:.3g}); {times}', flush=True)
    out['folded_k1'] = {str(k): v for k, v in k1.items()}

    # serve and analyze of that checkpoint: K1 once a forward
    x_big = train_ds.gather(np.arange(big)).inputs
    fm.launches = 0
    svc, server, url = _serve(port, ['serve', '--dataset-home', str(big_home),
                                     '--checkpoint-dir', str(root / 'r_ff_a'),
                                     '--use-run-config', '--port', '0', '--device', device])
    try:
        r = _post(url + '/predict', _b64_body(x_big))
        served_launches = fm.launches
    finally:
        _stop(svc, server)
    with torch.no_grad():
        xt = torch.from_numpy(x_big.reshape(big, -1)).to(device)
        want = port.slice_output_heads(fm.mlp_reference(xt, packed.layers, cfg.activation), 2, 1)
    served_err = _agree(r['outputs'], {k: v.cpu().numpy() for k, v in want.items()},
                        'served batchnorm model',
                        atol=k1_limit(max(float(v.abs().max()) for v in want.values())))
    _check(not on_card or served_launches == 1,
           f'served batchnorm model: K1 launches {served_launches}')
    home = root / 'reg_analyze'
    (home / 'train').mkdir(parents=True)
    shutil.copytree(big_home / 'dev', home / 'dev')
    fm.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        result = port.analyze(port.parser().parse_args([
            'analyze', '--dataset-home', str(home), '--checkpoint-dir', str(root / 'r_ff_a'),
            '--use-run-config', '--batch-size', '512', '--no-wandb', '--device', device]))
    analyze_launches, forwards = fm.launches, -(-dev_windows // 512)
    _check(result['dev']['windows'] == dev_windows
           and np.isfinite(list(result['dev']['summary'].values())).all()
           and (not on_card or analyze_launches == forwards),
           f'analyze of the batchnorm model: K1 launches {analyze_launches} for {forwards} '
           f'forwards, {result["dev"]}')
    print(f'[regularised] serve of the batchnorm checkpoint, /predict b64 B={big}: K1 launches '
          f'{served_launches}, max abs err {served_err:.3g} against the plain version; '
          f'analyze at B=512: K1 launches {analyze_launches} == {forwards} forwards, dev loss '
          f'{result["dev"]["summary"]["loss"]:.4g}', flush=True)
    out['serve'] = dict(k1_launches=served_launches, max_abs_err=served_err)
    out['analyze'] = dict(k1_launches=analyze_launches, forwards=forwards,
                          loss=result['dev']['summary']['loss'])
    del model

    # 11d. the augmentation is live inside replays: a chunk's coins recorded
    # inside the step (a device-side row counter)
    cfg_aug = port.config_from_args(port.parser().parse_args(['train', *ff, *aug]))
    model = port.build_model_for_dataset(cfg_aug, small_ds,
                                         generator=torch.Generator().manual_seed(seed),
                                         device=device)
    state = port.create_train_state(model, port.make_optimizer(model.named_parameters(),
                                                               'rmsprop', 1e-3))
    augment = port.per_step_generators(cfg_aug, state, small_ds, device)
    k = 16
    coins = torch.zeros(k, batch, dtype=torch.bool, device=device)
    row = torch.zeros(1, dtype=torch.int64, device=device)
    base = augment_mod.generator_aug_draws(state.aug_gen)

    def coin(n, p, dev):
        c = base.coin(n, p, dev)
        coins.index_copy_(0, row, c[None])
        row.add_(1)
        return c

    replays = step_mod.replays
    chunk = port.make_device_chunked_step(
        model, port.DeviceResidentData(small_ds, device), port.loss_config_from(cfg_aug),
        augment=augment, aug_draws=augment_mod.AugmentDraws(coin=coin, noise=base.noise))
    rng = np.random.default_rng(seed)
    chunk(state, np.stack([rng.permutation(len(small_ds))[:batch] for _ in range(k)])).rows()
    replays = step_mod.replays - replays
    seen = coins.cpu().numpy()
    distinct = len({r.tobytes() for r in seen})
    share = float(seen.mean())
    _check(int(row) == k and (not on_card or replays == k - warmup) and distinct == k
           and 0.35 < share < 0.65,
           f'augmentation in replays: {int(row)} rows, {replays} replays, {distinct} distinct, '
           f'share {share}')
    print(f'[regularised] augmentation inside a chunk of {k} steps at B={batch} ({replays} '
          f'replays): {distinct} distinct coin rows of {k}; mirrored share {share:.4f}',
          flush=True)
    out['coins'] = dict(steps=k, replays=replays, distinct=distinct, mirrored_share=share)
    del model, state, chunk

    # 11e. the pallas transformer augmented at big, one epoch, its K2 and K3
    # kernels counted by name in a profiler trace against the same run
    # unaugmented
    traced = {}
    for tag, extra in (('augmented', aug), ('not augmented', [])):
        def once():
            return run(big_home, f'r_pallas_{tag[:3]}', [*pallas, *extra], 1, big)  # noqa: B023
        result, counts, _ = _traced(torch, once) if on_card else (once(), {}, None)
        traced[tag] = dict(counts, windows_per_sec=result.windows_per_sec,
                           steps=result.windows_seen // big)
    pcfg = port.config_from_args(port.parser().parse_args(['train', *pallas]))
    p_steps = traced['augmented']['steps']
    enc = {tag: {n: t.get(n) for n in ENC_KERNELS} for tag, t in traced.items()}
    if on_card:
        k3_shape = fe.plan_encoder_bwd(big, 10, pcfg.d_model, pcfg.d_model * 4,
                                       pcfg.num_heads).shape
        _check_traced(traced['augmented'], pcfg.num_layers, p_steps, dev_batches, k3_shape,
                      'pallas augmented')
    _check(enc['augmented'] == enc['not augmented']
           and p_steps == traced['not augmented']['steps'],
           f'pallas K2/K3 launches with and without augmentation: {traced}')
    print(f'[regularised] pallas transformer B={big}, one epoch of {p_steps} steps and '
          f'{dev_batches} dev batch ({card}): K2/K3 kernels in the profiler trace augmented '
          f'{enc["augmented"]} == not augmented (4 a forward, 12 a step); windows/s augmented '
          f'{traced["augmented"]["windows_per_sec"]:.0f}, not augmented '
          f'{traced["not augmented"]["windows_per_sec"]:.0f} (traced runs)', flush=True)
    out['pallas'] = traced

    # 11f. the vpu transformer with dropout at the default batch, then served
    # through K2
    vpu = ['--model-type', 'transformer', '--attn-impl', 'vpu', '--dropout', '--dropout-prob',
           '0.1', *size_flags]
    v = run(small_home, 'r_vpu', vpu, 1, batch)
    _check(v.epochs_run == 1 and np.isfinite(v.final_train_metrics['loss']), f'vpu dropout {v}')
    fe.launches = 0
    svc, server, url = _serve(port, ['serve', '--dataset-home', str(small_home / 'train'),
                                     '--checkpoint-dir', str(root / 'r_vpu'),
                                     '--model-type', 'transformer', '--use-run-config',
                                     '--fused-inference', '--port', '0', '--device', device])
    try:
        xv = small_ds.gather(np.arange(37)).inputs
        r = _post(url + '/predict', json.dumps({'inputs': xv.tolist()}).encode())
        vpu_launches = fe.launches
        with torch.no_grad():
            want = port.fused_transformer_forward(svc.model, torch.from_numpy(xv).to(device),
                                                  use_kernel=False)
    finally:
        _stop(svc, server)
    vpu_err = _agree(r['outputs'], {name: t.cpu().numpy() for name, t in want.items()},
                     'served vpu dropout model', rel=HEAD_REL)
    vcfg = port.config_from_args(port.parser().parse_args(['train', *vpu]))
    _check(not on_card or vpu_launches == vcfg.num_layers,
           f'served vpu dropout model: K2 launches {vpu_launches}')
    print(f'[regularised] vpu transformer --dropout 0.1 B={batch}: {v.windows_seen // batch} '
          f'steps, loss {v.final_train_metrics["loss"]:.4g}; served with --fused-inference: K2 '
          f'launches {vpu_launches} a forward, {vpu_err:.3g} from the plain fused forward',
          flush=True)
    out['vpu_dropout'] = dict(windows_per_sec=v.windows_per_sec, served_k2=vpu_launches,
                              served_rel_err=vpu_err)

    # 11g. the denoiser with --augment-mirror at the default batch, with EMA
    dflags = ['--model-type', 'diffusion', '--output-data-format', 'all_frames',
              '--augment-mirror', '--ema-decay', '0.999', *size_flags]
    dc = run(small_home, 'r_diff_c', dflags, 1, batch)
    dp = run(small_home, 'r_diff_s', [*dflags, '--device-chunk-steps', '1'], 1, batch)
    _check(dc.windows_seen == dp.windows_seen, 'augmented denoiser runs')
    dcmp = _compare_final(torch, final('r_diff_c', 'diffusion'), final('r_diff_s', 'diffusion'), 0)
    print(f'[regularised] denoiser --augment-mirror --ema-decay 0.999 B={batch}, '
          f'{dc.windows_seen // batch} steps, chunked against step by step ({card}): '
          f'{dcmp["verdict"]}; windows/s {dc.windows_per_sec:.0f}', flush=True)
    out['denoiser'] = dict(vs_step_by_step=dcmp, windows_per_sec=dc.windows_per_sec)

    # 11h. the chunked step with and without augmentation at big
    if on_card:
        times = {}
        for name, flags in (('feedforward batchnorm dropout augmented', [*ff, *aug]),
                            ('feedforward batchnorm dropout', ff),
                            ('pallas augmented', [*pallas, *aug]), ('pallas', pallas)):
            times[name] = t = _chunk_step_times(torch, port, flags, train_ds, big, seed)
            print(f'[times] train step {name} B={big} in chunks of 16 ({card}): '
                  f'{t["step_ms"]:.3f} ms a step by the host clock = '
                  f'{t["windows_per_sec"]:.0f} windows/s; device busy '
                  + ('not measured' if t['device_busy_ms'] is None else
                     f'{t["device_busy_ms"]:.3f} ms a step, idle share {t["idle_share"]:.3f}'),
                  flush=True)
        out['chunk_times'] = times
    out['seconds'] = time.perf_counter() - t_phase
    print(f'[regularised] phase 11 took {out["seconds"]:.1f} s', flush=True)
    return out


# 12. the analytical and physics path: the skeleton's float32 functions on
# the card against the same code in float64 on the CPU, within PHYS_FK_REL
# (FK) and PHYS_DYN_REL (COM acceleration, tau, the reports) x max|float64|,
# the CPU tests' tolerances against the JAX package.
PHYS_FK_REL = 1e-5
PHYS_DYN_REL = 1e-4


def phase_physics(torch, port, fm, fg, step_mod, root, seed, card, wide=None,
                  analyze_length=101, train_length=600, device='cuda'):
    """The analytical and physics path through ``analyze`` and ``train``:
    two synthetic subjects with differently scaled standard skeletons
    (masses x 1.0 / 1.4, COMs x 1 + 0.1 i, as tests/test_skeleton.py builds
    them) and the coupled knee of ``tests/fixtures/knee_golden.osim``:

    - FK, COM acceleration and ``inverse_dynamics_from_predictions`` on the
      card against float64 on the CPU (400 frames of real windows; the knee
      on 400 random frames);
    - ``analyze --model-type analytical --compute-report`` at B=1 with
      ``--eval-chunk-steps`` 64 and 1 (rows and report equal), its first 8
      batches through the graphed runner bitwise equal to the eager step and
      against the float64 CPU step, the launches a batch eager and replayed
      (profiler trace), a chunk of 8 batches' idle share, and B=512 on
      ``wide`` (phase 8's split);
    - ``analyze --compute-report`` of phase 8's feedforward and GroundLink
      checkpoints (``root / 'ckpt_ff'``, ``'ckpt_gl'``): a K1 / K4 launch a
      forward, the rows those without the report, the report's host ms a
      batch, and the report against the float64 CPU report of the same
      outputs;
    - ``train --compute-report`` (feedforward, 2 epochs, B=64): the dev
      report's ``tau_avg_err`` is the report function's mean over the same
      dev batches of the checkpoint the dev eval scored.
    ``device`` 'cpu' (with shorter trials and no ``wide``) rehearses it."""
    from inferbiomechanics_tpu_torch.cli.analyze_cmd import analytical_eval_step
    from inferbiomechanics_tpu_torch.data.b3d import write_subject
    from inferbiomechanics_tpu_torch.data.loader import PrefetchLoader
    from inferbiomechanics_tpu_torch.data.osim import parse_osim
    from inferbiomechanics_tpu_torch.data.synthetic import (
        CONTACT_BODIES, standard_skeleton, synthetic_trial,
    )
    from inferbiomechanics_tpu_torch.loss.evaluator import LossConfig
    from inferbiomechanics_tpu_torch.loss.tau_report import make_tau_report_fn
    from inferbiomechanics_tpu_torch.models.analytical import (
        CONTACT_HEIGHT_THRESHOLD, kinematics, make_analytical_fn,
    )
    from inferbiomechanics_tpu_torch.ops.skeleton import compile_skeleton
    from inferbiomechanics_tpu_torch.ops.tune import traced_kernels
    from inferbiomechanics_tpu_torch.train.step import make_eval_step
    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    report = {}

    def home(name, length, splits=('dev',)):
        h = root / name
        for split in ('train', 'dev'):
            (h / split).mkdir(parents=True, exist_ok=True)
        for split in splits:
            for i, k in enumerate((1.0, 1.4)):
                sk = standard_skeleton()
                for b in sk.bodies:
                    b.mass *= k
                    b.com = [c * (1 + 0.1 * i) for c in b.com]
                write_subject(str(h / split / f's{i}.b3d'), num_dofs=23,
                              ground_force_bodies=list(CONTACT_BODIES), root_history_len=10,
                              trials=[synthetic_trial(
                                  'walk', length, rng=np.random.default_rng(seed + 1200 + i))],
                              skeleton=sk, mass_kg=70.0 * k)
        return h

    def dataset(h, split='dev'):
        return port.WindowDataset(str(h / split), window_size=50, stride=5)

    def rel(got, want):
        want = want.double().cpu()
        return float((got.double().cpu() - want).abs().max() / want.abs().max())

    ana, small = home('physics_analyze', analyze_length), home('physics_report', 60)
    ds = dataset(ana)
    windows = len(ds)
    _check(windows == 2 * (analyze_length - 51) and ds.skeletons[1].bodies[0].mass != ds.skeletons[0].bodies[0].mass,
           f'physics split: {windows} windows')

    # -- the card against float64 on the CPU --------------------------------
    b = ds.gather(np.arange(0, windows, max(1, windows // 40)))
    x, sidx = torch.from_numpy(b.inputs), torch.from_numpy(b.subject_indices.astype(np.int64))
    pred, pred64 = make_analytical_fn(ds, device), make_analytical_fn(ds, 'cpu', f64)
    _check(pred.skeletons.param_stack is not None, 'no per-subject stack')
    with torch.no_grad():
        w = pred(x.to(device), sidx.to(device))[
            'groundContactWrenchesInRootFrame'].float().cpu()
    sk, sk64 = (p.skeletons.for_rows(sidx.to(p.skeletons.device), frames=True)
                for p in (pred, pred64))
    cbi = pred.skeletons.contact_indices
    qs = [t.to(device) for t in (*kinematics(ds, x), w)]
    q64 = [t.double() for t in (*kinematics(ds, x), w)]
    knee, _ = parse_osim((REPO / 'tests' / 'fixtures' / 'knee_golden.osim').read_text())
    rng = np.random.default_rng(seed + 1201)
    kq = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.uniform(-2.0, 0.7, (400, 1)), rng.normal(size=(400, 1)), rng.normal(size=(400, 1)),
        rng.normal(size=(400, 12)) * 20)]
    cases = {'standard (2 scaled subjects)': (sk, sk64, qs, q64, cbi),
             'knee_golden (spline + linear couplings)': (
                 compile_skeleton(knee, device), compile_skeleton(knee, 'cpu', f64),
                 [t.to(device) for t in kq], [t.double() for t in kq], [0, 1])}
    vs_cpu = {}
    for name, (a, a64, qa, qb, ci) in cases.items():
        errs = {'fk': rel(a.fk(qa[0])[1], a64.fk(qb[0])[1]),
                'com_acceleration': rel(a.com_acceleration(*qa[:3]),
                                        a64.com_acceleration(*qb[:3])),
                'tau': rel(a.inverse_dynamics_from_predictions(*qa[:3], ci, qa[3]),
                           a64.inverse_dynamics_from_predictions(*qb[:3], ci, qb[3]))}
        _check(errs['fk'] <= PHYS_FK_REL and max(errs.values()) <= PHYS_DYN_REL,
               f'{name}: card against float64 {errs}')
        vs_cpu[name] = errs
        print(f'[physics] {name}, {qa[0].numel() // qa[0].shape[-1]} frames, card against '
              f'float64 on the CPU, max error / max|.|: ' + ', '.join(
                  f'{k} {v:.3g}' for k, v in errs.items()) + f' (limits {PHYS_FK_REL}, '
              f'{PHYS_DYN_REL})', flush=True)
    report['card_vs_cpu_float64'] = vs_cpu

    # -- analyze --model-type analytical --compute-report -------------------
    kernel_modules = (fm, fg)

    def run(h, flags, ckpt, expect):
        args = port.parser().parse_args([
            'analyze', '--dataset-home', str(h), '--checkpoint-dir', str(root / ckpt),
            '--no-wandb', '--device', device, *flags])
        csv_path = root / ckpt / args.model_type / 'dev_analysis.csv'
        if csv_path.exists():
            csv_path.unlink()
        for m in kernel_modules:
            m.launches = 0
        graphs = (step_mod.eval_captures, step_mod.eval_replays)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = port.analyze(args)
        launches = [m.launches for m in kernel_modules]
        dev = result['dev']
        _check(set(result) == {'dev'} and dev['windows'] == expect
               and np.isfinite(list(dev['summary'].values())).all(),
               f'analyze {flags}: {result}')
        with open(csv_path) as f:
            rows = list(csv.reader(f))
        _check(len(rows) == expect, f'{len(rows)} rows for {expect} windows')
        return dict(dev, rows=rows, launches=launches, args=args,
                    captures=step_mod.eval_captures - graphs[0],
                    replays=step_mod.eval_replays - graphs[1])

    ana_flags = ['--model-type', 'analytical', '--compute-report']
    r64 = run(ana, ana_flags, 'physics_ckpt_ana', windows)
    r1 = run(ana, ana_flags + ['--eval-chunk-steps', '1'], 'physics_ckpt_ana', windows)
    graphed = device == 'cuda'
    for r in (r64, r1):
        _check(r['launches'] == [0, 0] and 'tau_avg_err' in r['summary'], f'analytical: {r}')
        _check(not graphed or (r['captures'], r['replays']) == (1, windows - 1),
               f'analytical B=1: {r["captures"]} captures, {r["replays"]} replays for '
               f'{windows} batches')
    _check(r64['rows'] == r1['rows'] and r64['summary'] == r1['summary'],
           'analytical: rows or report in chunks of 64 differ from chunks of 1')

    # the first 8 batches: the graphed runner, the eager step, float64 on the CPU
    lc = port.loss_config_from(port.config_from_args(r64['args']))
    tau_fn = make_tau_report_fn(ds, device)
    step = analytical_eval_step(ds, lc, pred, tau_fn, True)
    step64 = analytical_eval_step(ds, lc, pred64, make_tau_report_fn(ds, 'cpu', f64), True)
    runner = step_mod.make_graphed_chunk_runner(step, (f32, f32, torch.int64), device)
    batches = list(ds.batches(1, shuffle=False, drop_last=False))
    first = batches[:8]
    xs, ys, ss = (np.stack([getattr(bt, a) for bt in first])
                  for a in ('inputs', 'labels', 'subject_indices'))
    got = runner(xs, ys, ss)
    scalars = ('loss', 'force_avg_err', 'com_acc_avg_err', 'cop_avg_err', 'moment_avg_err',
               'wrench_avg_err', 'wrench_moment_avg_err', 'tau_report')
    eager, cpu, eager_s = [], [], 0.0
    for k in range(len(first)):
        args = [torch.from_numpy(np.ascontiguousarray(a[k])) for a in (xs, ys, ss.astype(np.int64))]
        t0 = time.perf_counter()
        eager.append({n: v.float().cpu().numpy()
                      for n, v in step(*(t.to(device) for t in args)).items()})
        eager_s += time.perf_counter() - t0
        cpu.append({n: float(v) for n, v in step64(*args).items() if n in scalars})
    _check(all(np.array_equal(got[n][k], eager[k][n]) for k in range(len(first)) for n in got),
           'analytical: the graphed step differs from the eager step')
    for k, row in enumerate(r64['rows'][:len(first)]):
        _check([float(v) for v in row[2:]] == [float(got[n][k]) for n in ('loss', 'force_avg_err',
                                                                            'com_acc_avg_err')],
               f'analytical: row {k} differs from the graphed step')
    # a window whose last frame's contact height lies within 1e-6 m of the
    # threshold may flip between float32 and float64: counted, left out
    heights = []
    for bt in first:
        q = kinematics(ds, torch.from_numpy(bt.inputs[:, -1]).double())[0]
        ps = pred64.skeletons.for_rows(torch.from_numpy(bt.subject_indices.astype(np.int64)),
                                       frames=False).fk(q)[1]
        heights.append(float((ps[..., cbi, 1] - CONTACT_HEIGHT_THRESHOLD).abs().min()))
    keep = [k for k, h in enumerate(heights) if h >= 1e-6]
    worst = max(abs(np.mean([float(got[n][k]) for k in keep]) - np.mean([cpu[k][n] for k in keep]))
                / max(abs(np.mean([cpu[k][n] for k in keep])), 1e-6) for n in scalars)
    _check(worst <= PHYS_DYN_REL, f'analytical: report of the first batches off float64 by {worst}')
    report['analytical'] = dict(
        windows=windows, windows_per_sec_b1=windows / r64['seconds'],
        windows_per_sec_b1_per_batch=windows / r1['seconds'], seconds_b1=r64['seconds'],
        seconds_b1_chunks_of_1=r1['seconds'], tau_avg_err=r64['summary']['tau_avg_err'],
        report_rel_vs_cpu_float64=worst, batches_near_threshold=len(first) - len(keep))
    print(f'[physics] analyze --model-type analytical --compute-report, {windows} windows at '
          f'B=1: {r64["seconds"]} s in chunks of 64 ({report["analytical"]["windows_per_sec_b1"]} '
          f'windows/s), {r1["seconds"]} s in chunks of 1 ({report["analytical"]["windows_per_sec_b1_per_batch"]} '
          f'windows/s); one capture, {r64["replays"]} replays; rows and report equal in both; '
          f'the first {len(first)} batches graphed == eager bitwise, report against float64 on '
          f'the CPU {worst:.3g} relative ({len(first) - len(keep)} batches near the contact '
          f'threshold left out) ({card})', flush=True)

    if graphed:
        one = [torch.from_numpy(np.ascontiguousarray(a[0])).to(device)
               for a in (xs, ys, ss.astype(np.int64))]
        _, eager_k = traced_kernels(lambda: step(*one))
        graph = list(runner.graphs.values())[0]
        row = graph.row.clone()
        _, replay_k = traced_kernels(lambda: graph(row))
        chunk = batches[:8]      # a trace of 64 replays holds 843k launches
        cx, cy, cs = (np.stack([getattr(bt, a) for bt in chunk])
                      for a in ('inputs', 'labels', 'subject_indices'))
        # the wall clock untraced (tracing 13k launches a replay slows the
        # host), the busy time from the trace
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            runner(cx, cy, cs)
            walls.append(time.perf_counter() - t0)
        wall = {'s': statistics.median(walls)}
        _, chunk_k = traced_kernels(lambda: runner(cx, cy, cs))
        busy = sum(us for _, us in chunk_k) / 1e6
        report['analytical'].update(
            eager_ms_per_batch_b1=eager_s / len(first) * 1e3,
            replayed_ms_per_batch_b1=wall['s'] / len(chunk) * 1e3,
            launches_eager=len(eager_k), launches_replayed=len(replay_k),
            device_us_eager=sum(us for _, us in eager_k),
            device_us_replayed=sum(us for _, us in replay_k),
            chunk_of_8=dict(wall_ms=wall['s'] * 1e3, busy_ms=busy * 1e3,
                             idle_share=1 - busy / wall['s'], launches=len(chunk_k)))
        _check(abs(len(replay_k) - len(eager_k)) <= 8,
               f'a replay ran {len(replay_k)} kernels, the eager step {len(eager_k)}')
        print(f'[physics] analytical step at B=1, profiler trace: {len(eager_k)} launches '
              f'eager ({report["analytical"]["device_us_eager"]:.1f} us device), '
              f'{len(replay_k)} replayed ({report["analytical"]["device_us_replayed"]:.1f} '
              f'us device); a chunk of {len(chunk)} batches: {wall["s"] * 1e3:.2f} ms wall '
              f'(untraced), '
              f'{busy * 1e3:.2f} ms busy (traced), idle share {1 - busy / wall["s"]:.3f}; '
              f'a batch eagerly {eager_s / len(first) * 1e3:.2f} ms, replayed '
              f'{wall["s"] / len(chunk) * 1e3:.2f} ms ({card})',
              flush=True)
    if wide is not None:
        wide_ds = port.WindowDataset(str(wide / 'dev'), window_size=50, stride=5,
                                     skip_loading_skeletons=True)
        r512 = run(wide, ana_flags + ['--batch-size', '512'], 'physics_ckpt_wide', len(wide_ds))
        _check(r512['captures'] == 1 and r512['replays'] == len(wide_ds) // 512 - 1,
               f'B=512: {r512["captures"]} captures, {r512["replays"]} replays')
        report['analytical'].update(windows_per_sec_b512=len(wide_ds) / r512['seconds'],
                                    seconds_b512=r512['seconds'], windows_b512=len(wide_ds))
        # the step alone at B=512: eagerly and replayed, 2 batches each
        wds = port.WindowDataset(str(wide / 'dev'), window_size=50, stride=5)
        wstep = analytical_eval_step(wds, lc, make_analytical_fn(wds, device),
                                     make_tau_report_fn(wds, device), True)
        wb = [wds.gather(np.arange(k * 512, (k + 1) * 512)) for k in range(2)]
        wx, wy, ws_ = (np.stack([getattr(bt, a) for bt in wb])
                       for a in ('inputs', 'labels', 'subject_indices'))
        wargs = [[torch.from_numpy(np.ascontiguousarray(a[k])).to(device)
                  for a in (wx, wy, ws_.astype(np.int64))] for k in range(2)]
        wstep(*wargs[0])          # the shape's first call (allocations)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in wargs:
            wstep(*a)
        torch.cuda.synchronize()
        eager512 = (time.perf_counter() - t0) / 2
        wrun = step_mod.make_graphed_chunk_runner(wstep, (f32, f32, torch.int64), device)
        wrun(wx, wy, ws_)         # the first call eager, the second captured
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            wrun(wx, wy, ws_)
            walls.append((time.perf_counter() - t0) / 2)
        replay512 = statistics.median(walls)
        report['analytical'].update(eager_ms_per_batch_b512=eager512 * 1e3,
                                    replayed_ms_per_batch_b512=replay512 * 1e3)
        print(f'[physics] analyze --model-type analytical --compute-report at B=512: '
              f'{len(wide_ds)} windows in {r512["seconds"]} s '
              f'({len(wide_ds) / r512["seconds"]} windows/s, capture included); the step '
              f'alone {eager512 * 1e3:.2f} ms a batch eagerly ({512 / eager512:.1f} windows/s), '
              f'{replay512 * 1e3:.2f} ms replayed ({512 / replay512:.1f} windows/s) ({card})',
              flush=True)

    # -- analyze --compute-report of the learned checkpoints -----------------
    small_ds = dataset(small)
    tau64 = make_tau_report_fn(small_ds, 'cpu', f64)
    for name, ckpt, flags, module in (('feedforward (K1)', 'ckpt_ff', [], fm),
                                      ('groundlink (K4)', 'ckpt_gl',
                                       ['--model-type', 'groundlink'], fg)):
        plain = run(ana, flags, ckpt, windows)
        rep = run(ana, flags + ['--compute-report'], ckpt, windows)
        want = [windows if m is module and graphed else 0 for m in kernel_modules]
        _check(plain['launches'] == want and rep['launches'] == want,
               f'{name}: launches {plain["launches"]} / {rep["launches"]}, expected {want}')
        # batch by batch with the report, in chunks without it: phase 8's
        # limit between the two
        a, b = (np.asarray([r[2:] for r in r_['rows']], float) for r_ in (rep, plain))
        row_err = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())
        _check([r[:2] for r in rep['rows']] == [r[:2] for r in plain['rows']]
               and row_err <= 1e-5 and 'tau_avg_err' in rep['summary']
               and all(abs(rep['summary'][k] - v) <= 1e-5 * max(abs(v), 1e-30)
                       for k, v in plain['summary'].items()),
               f'{name}: the report moved the rows ({row_err}) or the other metrics')
        ms_per_batch = (rep['seconds'] - plain['seconds']) / windows * 1e3
        held = run(small, flags + ['--compute-report'], ckpt, len(small_ds))
        model = port.load_model(port.config_from_args(held['args']), small_ds,
                                str(root / ckpt / held['args'].model_type), device=device)[0]
        values = []
        with torch.no_grad():
            for bt in small_ds.batches(1, shuffle=False, drop_last=False):
                out = model(torch.from_numpy(bt.inputs).to(device))
                values.append(tau64(torch.from_numpy(bt.inputs).double(),
                                    {k: v.double().cpu() for k, v in out.items()},
                                    small_ds.unpack_labels(torch.from_numpy(bt.labels).double()),
                                    bt.subject_indices))
        err = abs(held['summary']['tau_avg_err'] - np.mean(values)) / abs(np.mean(values))
        _check(err <= PHYS_DYN_REL, f'{name}: report off float64 by {err}')
        report[name] = dict(launches=rep['launches'], report_ms_per_batch=ms_per_batch,
                            rows_rel_vs_without=row_err,
                            seconds=rep['seconds'], seconds_without=plain['seconds'],
                            tau_avg_err=rep['summary']['tau_avg_err'],
                            report_rel_vs_cpu_float64=err)
        print(f'[physics] analyze {name} --compute-report, {windows} windows at B=1: launches '
              f'{rep["launches"]} (one a forward), {rep["seconds"]} s against '
              f'{plain["seconds"]} s without the report: {ms_per_batch:.3f} host ms a batch; '
              f'rows {row_err:.3g} relative from those without; report against float64 on the CPU of the same outputs '
              f'({len(small_ds)} windows) {err:.3g} relative ({card})', flush=True)

    # -- train --compute-report ----------------------------------------------
    th = home('physics_train', train_length, ('train', 'dev'))
    ckpt_dir = root / 'physics_ckpt_train'
    args = port.parser().parse_args([
        'train', '--dataset-home', str(th), '--checkpoint-dir', str(ckpt_dir), '--epochs', '2',
        '--compute-report', '--no-wandb', '--device', device])
    fm.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = port.run_training(args)
    dev_ds = dataset(th)
    cfg = port.config_from_args(args)
    dev_batches = len(dev_ds) // cfg.batch_size
    _check(fm.launches == (2 * dev_batches if graphed else 0), f'train: {fm.launches} K1 launches for 2 dev evals '
                                           f'of {dev_batches} batches')
    tau = result.final_dev_metrics.get('tau_avg_err')
    _check(tau is not None and np.isfinite(tau)
           and out.getvalue().count('Non-root Joint Torques (Inverse Dynamics) Avg Err') == 2,
           f'train --compute-report: dev report {result.final_dev_metrics}')
    # the last dev eval scored the state after epoch 0
    model = port.load_model(cfg, dev_ds, device=device, checkpoint_file=str(
        ckpt_dir / 'feedforward' / 'epoch_0_batch_0.torch.pt'))[0]
    step = make_eval_step(model, dev_ds.lab_offsets, port.loss_config_from(cfg))
    dev_tau = make_tau_report_fn(dev_ds, device)
    values = []
    for bt in PrefetchLoader(dev_ds, cfg.batch_size, device=device, shuffle=False).epoch(
            seed=cfg.seed * 1_000_003 + 1):
        outputs, _ = step(None, bt.inputs, bt.labels)
        values.append(dev_tau(bt.inputs, outputs, port.unpack(bt.labels, dev_ds.lab_offsets),
                              bt.subject_indices))
    err = abs(tau - np.mean(values)) / abs(np.mean(values))
    _check(len(values) == dev_batches and err <= 1e-6,
           f'train: dev tau_avg_err {tau} against {np.mean(values)} over the same batches')
    report['train'] = dict(tau_avg_err=tau, dev_batches=dev_batches, k1_launches=2 * dev_batches,
                           windows_per_sec=result.windows_per_sec, rel_vs_recomputed=err)
    report['seconds'] = time.perf_counter() - t_phase
    print(f'[physics] train --compute-report (feedforward, B=64, 2 epochs): dev tau_avg_err '
          f'{tau}, the report function over the same {dev_batches} dev batches {np.mean(values)} '
          f'({err:.3g} relative); K1 {2 * dev_batches} launches in the dev evals; '
          f'{result.windows_per_sec} windows/s; phase 12 took {report["seconds"]:.1f} s ({card})',
          flush=True)
    return report


# 13. checkpoints across frameworks: JAX-format files served, scored and
# resumed through the port's loader, the asynchronous writer, soups
_SLOW_TRAIN = """
import os, sys, time
import torch
from inferbiomechanics_tpu_torch.cli import train_cmd
from inferbiomechanics_tpu_torch.train import checkpoint as ckpt
marker, argv = sys.argv[1], sys.argv[2:]
write = ckpt._write_payload

def slow_write(payload, path):
    with open(marker, 'a') as f:
        f.write(os.path.basename(path) + '\\n')
    time.sleep(2.0)
    return write(payload, path)

ckpt._write_payload = slow_write
from_args = train_cmd.config_from_args

def every_two(args):
    cfg = from_args(args)
    cfg.checkpoint_every_batches = 2
    return cfg

train_cmd.config_from_args = every_two
from inferbiomechanics_tpu_torch.__main__ import build_parser
result = train_cmd.run_training(build_parser().parse_args(argv))
print('preempted', result.preempted, flush=True)
"""


def phase_checkpoints(torch, port, fm, fe, fg, step_mod, root, seed, card, device='cuda',
                      big_home=None, small_home=None, ff_batch=4096, pallas_batch=64,
                      size_flags=()):
    """The checkpoints of other frameworks and the asynchronous writer
    (``train/checkpoint.py``, ``weights.py``, ``utils/flax_msgpack.py``,
    ``convert-checkpoint``):

    - JAX-format files of every family (the port's writer; seeded weights,
      an rmsprop ``nu`` tree, the denoiser's EMA) served by ``serve
      --checkpoint-file x.ckpt`` and scored by ``analyze --checkpoint-file``
      (the transformer in the ``pallas`` tree, which both commands run
      through K2): K1 once, K2 4 times (the denoiser: 4 a DDIM step), K4 once
      a forward,
      the answers and reports bitwise those of the same weights in a
      ``.torch.pt``;
    - ``train --async-checkpoint`` against ``train`` (a checkpoint every 2
      batches): feedforward at ``ff_batch`` on ``big_home`` (phase 7's 40
      subjects), 2 epochs in chunks, and the ``pallas`` transformer at
      ``pallas_batch`` on ``small_home`` (phase 7d's subject); the
      checkpoints bitwise equal; the caller's ms a checkpoint (the snapshot)
      against the synchronous write's, the worker's write ms, and the
      chunked step's ms with and without the flag;
    - a SIGTERM sent to a ``train`` subprocess while its (slowed) write is
      in flight: exit 0, the newest checkpoint loads;
    - a JAX-format ``pallas`` payload converted by ``convert-checkpoint`` and
      resumed by ``train``: its K2 and K3 kernels counted by name in a
      profiler trace (12 K3 launches a step), the run bitwise the one
      resumed from the port's own ``.torch.pt`` of the same state;
    - a soup of the feedforward run's two epoch checkpoints served through
      K1, against the plain version within ``k1_limit``.
    ``device`` 'cpu' (small homes, ``size_flags`` narrowing the encoder)
    rehearses it without launch counts."""
    from inferbiomechanics_tpu_torch import weights
    from inferbiomechanics_tpu_torch.__main__ import main as port_main
    from inferbiomechanics_tpu_torch.cli import train_cmd
    from inferbiomechanics_tpu_torch.train import checkpoint as ckpt_mod
    from inferbiomechanics_tpu_torch.train import loop as loop_mod
    from inferbiomechanics_tpu_torch.utils import flax_msgpack
    t_phase = time.perf_counter()
    on_card = device == 'cuda'
    big_home = big_home or root / 'train_data'
    small_home = small_home or root / 'chunk_data'
    report = {'card': card}

    # -- 13a. JAX-format files of every family, served and scored -----------
    home = root / 'ckpt_home'
    for split, length, s in (('dev', 170, 1301), ('train', 60, 1302)):
        (home / split).mkdir(parents=True)
        port.write_synthetic_subject(str(home / split / 's.b3d'), num_trials=1,
                                     trial_length=length, seed=seed + s)
    wide = ['--fused-inference', *size_flags]
    families = {      # name: (flags, kernel module, launches a forward)
        'feedforward': ([], fm, 1),
        'transformer': (['--model-type', 'transformer', '--attn-impl', 'pallas',
                         *size_flags], fe, None),
        'groundlink': (['--model-type', 'groundlink'], fg, 1),
        'diffusion': (['--model-type', 'diffusion', '--output-data-format', 'all_frames',
                       '--use-ema', *wide], fe, None),
    }
    sample_steps = 2
    served = {}
    for i, (name, (flags, counter, per_forward)) in enumerate(families.items()):
        args = port.parser().parse_args(['train', *[f for f in flags if f != '--use-ema']])
        cfg = port.config_from_args(args)
        ds = port.WindowDataset(str(home / 'dev'), window_size=cfg.window_size,
                                stride=cfg.stride, output_data_format=cfg.output_data_format,
                                skip_loading_skeletons=True)
        gen = torch.Generator().manual_seed(seed + 1310 + i)
        model = port.build_model_for_dataset(cfg, ds, generator=gen, device=device)
        opt = port.make_optimizer(model.named_parameters(), 'rmsprop', cfg.learning_rate)
        for p in model.parameters():
            opt.state[p]['nu'] = (torch.rand(p.shape, generator=gen) * 1e-4).to(device)
        ema = ({n: (p.detach() + 1e-3 * torch.randn(p.shape, generator=gen).to(device))
                for n, p in model.named_parameters()} if name == 'diffusion' else None)
        jax_path = root / 'jax_files' / name / 'epoch_1_batch_0.ckpt'
        jax_path.parent.mkdir(parents=True)
        t0 = time.perf_counter()
        blob = flax_msgpack.dumps(weights.jax_payload(model, opt, 1, 0, step=7, ema_params=ema))
        write_ms = (time.perf_counter() - t0) * 1e3
        jax_path.write_bytes(blob)
        t0 = time.perf_counter()
        tree = flax_msgpack.loads(jax_path.read_bytes())
        read_ms = (time.perf_counter() - t0) * 1e3
        _check(flax_msgpack.dumps(tree) == blob, f'{name}: the reader and the writer disagree')
        port.save_run_config(str(jax_path.parent), cfg)
        torch_path = port.save_checkpoint(str(root / 'torch_files' / name), model, 1, 0,
                                          ema_params=ema)
        port.save_run_config(str(root / 'torch_files' / name), cfg)
        x = np.asarray(ds.gather(np.arange(16)).inputs, np.float32)
        per = (cfg.num_layers * (sample_steps if name == 'diffusion' else 1)
               if per_forward is None else per_forward)
        answers, scores, launches = [], [], []
        for path in (jax_path, torch_path):
            svc, server = port.start(port.build_parser().parse_args([
                'serve', '--dataset-home', str(home), '--checkpoint-dir', str(root / 'unused'),
                '--device', device, '--port', '0', '--checkpoint-file', str(path),
                '--sample-steps', str(sample_steps), *flags]))
            try:
                _check((svc.epoch, svc.batch) == (1, 0), f'{name}: served {svc.epoch}')
                counter.launches = 0
                answers.append(svc.predict_packed(x))
                launches.append(counter.launches)
            finally:
                server.server_close()
                svc.close()
            counter.launches = 0
            out = port.analyze(port.parser().parse_args([
                'analyze', '--dataset-home', str(home), '--device', device, '--no-wandb',
                '--checkpoint-dir', str(root / f'scored_{name}_{len(scores)}'),
                '--checkpoint-file', str(path), *flags]))
            scores.append((out['dev']['summary'], out['dev']['windows'], counter.launches))
        _check(all(np.array_equal(answers[0][k], answers[1][k]) for k in answers[0])
               and set(answers[0]) == set(answers[1]),
               f'{name}: the .ckpt and the .torch.pt answers differ')
        _check(scores[0] == scores[1], f'{name}: analyze of the .ckpt {scores[0]} and of the '
                                       f'.torch.pt {scores[1]}')
        if on_card:
            _check(launches == [per, per], f'{name}: {launches} launches a forward, want {per}')
            _check(scores[0][2] > 0, f'{name}: analyze launched nothing')
        served[name] = dict(bytes=len(blob), write_ms=write_ms, read_ms=read_ms,
                            serve_launches=launches[0], analyze_launches=scores[0][2],
                            analyze_windows=scores[0][1],
                            analyze_loss=float(scores[0][0]['loss']))
        print(f'[checkpoints] {name}: a JAX-format file of {len(blob)} bytes (written by the '
              f'port in {write_ms:.1f} ms, read in {read_ms:.1f} ms), served through '
              f'--checkpoint-file with {launches[0]} launches a forward and scored by analyze '
              f'({scores[0][1]} windows, {scores[0][2]} launches); answers and report bitwise '
              f'those of the .torch.pt ({card})', flush=True)
    report['families'] = served

    # -- 13b. train --async-checkpoint against train -------------------------
    times = {'sync': [], 'save': [], 'snapshot': [], 'write': []}
    orig = dict(sync=loop_mod.save_checkpoint, save=ckpt_mod.AsyncCheckpointer.save,
                snapshot=ckpt_mod.AsyncCheckpointer.snapshot, write=ckpt_mod._write_payload,
                from_args=train_cmd.config_from_args)

    def timed(key, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    def every_two(args):
        cfg = orig['from_args'](args)
        cfg.checkpoint_every_batches = 2
        return cfg

    def run(home_dir, ckpt, flags, b, epochs):
        return port.run_training(port.parser().parse_args([
            'train', '--dataset-home', str(home_dir), '--checkpoint-dir', str(ckpt),
            '--batch-size', str(b), '--epochs', str(epochs), '--device', device,
            '--seed', str(seed), *flags]))

    def files(d):
        return [Path(p).name for _, _, p in ckpt_mod.list_checkpoints(str(d))]

    def same_files(a, b, what):
        names = files(a)
        _check(names == files(b) and names, f'{what}: {names} against {files(b)}')
        same_bytes = True
        for n in names:
            pa, pb = (torch.load(str(d / n), map_location='cpu', weights_only=True)
                      for d in (a, b))
            _check(pa['step'] == pb['step'] and all(
                torch.equal(v, pb['model_state_dict'][k]) for k, v in
                pa['model_state_dict'].items()) and all(
                torch.equal(v, pb['optimizer_state_dict']['state'][i][k])
                for i, st in pa['optimizer_state_dict']['state'].items()
                for k, v in st.items()), f'{what}: {n} differs')
            same_bytes &= (a / n).read_bytes() == (b / n).read_bytes()
        return names, same_bytes

    async_report = {}
    loop_mod.save_checkpoint = timed('sync', orig['sync'])
    ckpt_mod.AsyncCheckpointer.save = timed('save', orig['save'])
    ckpt_mod.AsyncCheckpointer.snapshot = timed('snapshot', orig['snapshot'])
    ckpt_mod._write_payload = timed('write', orig['write'])
    train_cmd.config_from_args = every_two
    try:
        chunks = ['--device-chunk-steps', '4']     # a checkpoint a chunk
        for tag, home_dir, flags, b, epochs in (
                ('feedforward', big_home, chunks, ff_batch, 2),
                ('transformer', small_home, ['--model-type', 'transformer', '--attn-impl',
                                             'pallas', *size_flags, *chunks], pallas_batch, 1)):
            results = {}
            for mode in ('sync', 'async'):
                for v in times.values():
                    v.clear()
                t0 = time.perf_counter()
                results[mode] = run(home_dir, root / f'{mode}_{tag}',
                                    flags + (['--async-checkpoint'] if mode == 'async' else []),
                                    b, epochs)
                wall = time.perf_counter() - t0
                steps = results[mode].windows_seen // b
                results[mode] = dict(
                    wall_s=wall, steps=steps, windows_per_sec=results[mode].windows_per_sec,
                    step_ms=1e3 * b / results[mode].windows_per_sec,
                    checkpoints=len(times['sync'] or times['save']),
                    caller_ms=statistics.median(times['sync'] or times['save']),
                    snapshot_ms=statistics.median(times['snapshot']) if times['snapshot'] else None,
                    write_ms=statistics.median(times['write']))
            names, same_bytes = same_files(root / f'sync_{tag}' / tag, root / f'async_{tag}' / tag,
                                           f'{tag} async / sync')
            s, a = results['sync'], results['async']
            async_report[tag] = dict(batch=b, checkpoints=names, same_bytes=same_bytes, **{
                f'{k}_{m}': results[m][k] for m in ('sync', 'async') for k in results[m]})
            print(f'[checkpoints] train --async-checkpoint, {tag} at B={b} ({s["steps"]} steps, '
                  f'{s["checkpoints"]} checkpoints, a checkpoint every 2 batches, in chunks): '
                  f'the checkpoints bitwise the synchronous run\'s ({len(names)} files; bytes '
                  f'{"equal" if same_bytes else "differ"}); the caller\'s ms a checkpoint '
                  f'{a["caller_ms"]:.2f} (snapshot {a["snapshot_ms"]:.2f}) against the '
                  f'synchronous write\'s {s["caller_ms"]:.2f}; the worker\'s write '
                  f'{a["write_ms"]:.2f} ms; chunked step {s["step_ms"]:.3f} ms without the '
                  f'flag, {a["step_ms"]:.3f} ms with it; wall {s["wall_s"]:.2f} / '
                  f'{a["wall_s"]:.2f} s ({card})', flush=True)
    finally:
        loop_mod.save_checkpoint = orig['sync']
        ckpt_mod.AsyncCheckpointer.save = orig['save']
        ckpt_mod.AsyncCheckpointer.snapshot = orig['snapshot']
        ckpt_mod._write_payload = orig['write']
        train_cmd.config_from_args = orig['from_args']
    report['async'] = async_report

    # a SIGTERM while the (slowed) write is in flight
    marker, cut = root / 'sigterm_writes', root / 'sigterm_run'
    proc = subprocess.Popen(
        [sys.executable, '-c', _SLOW_TRAIN, str(marker), 'train', '--dataset-home',
         str(small_home), '--checkpoint-dir', str(cut), '--batch-size', str(pallas_batch),
         '--epochs', '2', '--device', device, '--seed', str(seed), '--async-checkpoint'],
        cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 240
        while not marker.exists() and time.time() < deadline and proc.poll() is None:
            time.sleep(0.05)
        _check(marker.exists(), 'SIGTERM run: no write began: ' + (
            proc.communicate(timeout=60)[0][-3000:] if proc.poll() is not None else 'timeout'))
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    exit_s = time.perf_counter() - t_term
    newest = ckpt_mod.resolve_checkpoint_path(str(cut / 'feedforward'))
    _check(proc.returncode == 0 and 'preempted True' in out and newest is not None,
           f'SIGTERM run: exit {proc.returncode}, newest {newest}: {out[-3000:]}')
    scfg = port.config_from_args(port.parser().parse_args(['train']))
    sds = port.WindowDataset(str(small_home / 'train'), window_size=scfg.window_size,
                             stride=scfg.stride, skip_loading_skeletons=True)
    smodel = port.build_model_for_dataset(scfg, sds, device=device)
    state = port.create_train_state(smodel, port.make_optimizer(
        smodel.named_parameters(), scfg.opt_type, scfg.learning_rate))
    at = ckpt_mod.load_checkpoint_file(state, newest)
    writes = marker.read_text().split()
    report['sigterm'] = dict(exit=proc.returncode, newest=Path(newest).name, at=list(at),
                             writes=writes, exit_s=exit_s, step=state.step)
    print(f'[checkpoints] SIGTERM during an asynchronous write ({writes[0]} in flight, slowed '
          f'2 s): exit 0 after {exit_s:.1f} s, the newest checkpoint {Path(newest).name} '
          f'loads (step {state.step}); writes {writes} ({card})', flush=True)

    # -- 13c. a JAX-format pallas payload resumed by train -------------------
    pflags = ['--model-type', 'transformer', '--attn-impl', 'pallas', *size_flags]
    pcfg = port.config_from_args(port.parser().parse_args(
        ['train', *pflags, '--batch-size', str(pallas_batch), '--seed', str(seed)]))
    pds = port.WindowDataset(str(small_home / 'train'), window_size=pcfg.window_size,
                             stride=pcfg.stride, skip_loading_skeletons=True)
    gen = torch.Generator().manual_seed(seed + 1330)
    pmodel = port.build_model_for_dataset(pcfg, pds, generator=gen, device=device)
    popt = port.make_optimizer(pmodel.named_parameters(), 'rmsprop', pcfg.learning_rate)
    for p in pmodel.parameters():
        popt.state[p]['nu'] = (torch.rand(p.shape, generator=gen) * 1e-5).to(device)
    pstate = port.create_train_state(pmodel, popt)
    pstate.step = 29
    jax_run = root / 'jax_run' / 'transformer'
    jax_run.mkdir(parents=True)
    (jax_run / 'epoch_0_batch_0.ckpt').write_bytes(flax_msgpack.dumps(
        weights.jax_payload(pmodel, popt, 0, 0, step=pstate.step)))
    port.save_run_config(str(jax_run), pcfg)
    port.save_checkpoint(str(root / 'own_run' / 'transformer'), pstate, 0, 0)
    port.save_run_config(str(root / 'own_run' / 'transformer'), pcfg)
    _check(port_main(['convert-checkpoint', str(jax_run), '--out-dir',
                      str(root / 'conv_run' / 'transformer')]) == 0, 'convert-checkpoint')
    fe.launches = fe.bwd_launches = 0
    fe.bwd_shape_launches.update(small=0, large=0)
    if on_card:
        resumed, traced, _ = _traced(torch, lambda: run(small_home, root / 'conv_run', pflags,
                                                        pallas_batch, 2))
    else:
        resumed, traced = run(small_home, root / 'conv_run', pflags, pallas_batch, 2), None
    k2, k3 = fe.launches, fe.bwd_launches
    own = run(small_home, root / 'own_run', pflags, pallas_batch, 2)
    steps = resumed.windows_seen // pallas_batch
    _check(resumed.epochs_run == 1 and own.epochs_run == 1 and steps > 0,
           f'resumed runs: {resumed.epochs_run} / {own.epochs_run} epochs')
    verdict = _compare_final(torch, root / 'conv_run' / 'transformer',
                             root / 'own_run' / 'transformer', 1)
    _check(verdict['bitwise'], f'the converted JAX run: {verdict["verdict"]}')
    k3_shape = fe.plan_encoder_bwd(pallas_batch, pcfg.window_size // pcfg.stride,
                                   pcfg.d_model, pcfg.d_model * ENC_FULL['mlp_ratio'],
                                   pcfg.num_heads).shape
    if on_card:
        _check_traced(traced, pcfg.num_layers, steps, 0, k3_shape, 'the resumed JAX run')
        k3_traced = sum(traced[k] for k in ENC_KERNELS[1:])
        _check(k3_traced == pcfg.num_layers * fe.BWD_LAUNCHES_PER_LAYER * steps,
               f'K3 {k3_traced} traced for {steps} steps')
    report['jax_resume'] = dict(steps=steps, k2_wrapper=k2, k3_wrapper=k3, traced=traced,
                                k3_traced_per_step=(pcfg.num_layers * fe.BWD_LAUNCHES_PER_LAYER),
                                verdict=verdict['verdict'])
    print(f'[checkpoints] a JAX-format pallas payload (rmsprop nu, step {pstate.step}) '
          f'converted by convert-checkpoint and resumed by train at B={pallas_batch}: '
          f'{steps} steps, traced kernels {traced} '
          f'({pcfg.num_layers * fe.BWD_LAUNCHES_PER_LAYER} K3 launches a step); against the '
          f'run resumed from the port\'s own .torch.pt of the state: {verdict["verdict"]} '
          f'({card})', flush=True)

    # -- 13d. a soup of the feedforward run's two epoch checkpoints, through K1
    members = [root / 'sync_feedforward' / 'feedforward' / f'epoch_{e}_batch_0.torch.pt'
               for e in (0, 1)]
    soup = root / 'soup' / 'soup.torch.pt'
    _check(port_main(['convert-checkpoint', *map(str, members), '--soup', str(soup)]) == 0,
           'convert-checkpoint --soup')
    a, b = (torch.load(str(m), map_location='cpu', weights_only=True)['model_state_dict']
            for m in members)
    souped = torch.load(str(soup), map_location='cpu', weights_only=True)['model_state_dict']
    _check(all(torch.equal(v, ((a[k].double() + b[k].double()) / 2).float())
               for k, v in souped.items()), 'the soup is not the members\' mean')
    svc, server = port.start(port.build_parser().parse_args([
        'serve', '--dataset-home', str(home), '--checkpoint-dir', str(root / 'unused'),
        '--device', device, '--port', '0', '--checkpoint-file', str(soup)]))
    try:
        fds = port.WindowDataset(str(home / 'dev'), window_size=50, stride=5,
                                 skip_loading_skeletons=True)
        x = np.asarray(fds.gather(np.arange(len(fds))).inputs, np.float32)
        fm.launches = 0
        got = svc.predict_packed(x)
        soup_launches = fm.launches
        with torch.no_grad():
            plain = port.slice_output_heads(fm.mlp_reference(
                torch.from_numpy(x).to(device).reshape(len(x), -1),
                svc.model.layer_params(), 'sigmoid'), 2, 1)
        err = max(float(np.abs(got[k] - v.cpu().numpy()).max()) for k, v in plain.items())
        limit = k1_limit(max(float(v.abs().max()) for v in plain.values()))
    finally:
        server.server_close()
        svc.close()
    _check(err <= limit, f'the soup through K1: {err} > {limit}')
    if on_card:
        _check(soup_launches == 1, f'the soup: {soup_launches} K1 launches for one forward')
    report['soup'] = dict(members=[m.name for m in members], windows=len(x),
                          launches=soup_launches, max_abs_err=err, limit=limit)
    report['seconds'] = time.perf_counter() - t_phase
    print(f'[checkpoints] a soup of the feedforward run\'s epoch 0 and 1 checkpoints served '
          f'through K1 ({soup_launches} launch for {len(x)} windows): max abs err {err:.3g} '
          f'against the plain version (limit {limit:.3g}); phase 13 took '
          f'{report["seconds"]:.1f} s ({card})', flush=True)
    return report


# 14. scale-out on one card: --device-data stream in both loops, and the
# sweep command (an lr x seed grid in one captured step, PBT, resume)
class _SigtermAfterEpoch0:
    """A sweep's metric logger that sends this process SIGTERM once epoch 0
    is scored: the sweep saves its grid at the end of that epoch and stops."""

    def log(self, row):
        if row.get('epoch') == 0:
            os.kill(os.getpid(), signal.SIGTERM)


def phase_scale_out(torch, port, fm, fe, fg, step_mod, root, seed, card, device='cuda',
                    big_home=None, small_home=None, ff_batch=4096, small_batch=64,
                    size_flags=()):
    """``--device-data stream`` (``train/streaming_data.py``, the segment
    buffer of ``train/device_data.py``) in both train loops, and ``sweep``
    (``train/sweep.py``, ``cli/sweep_cmd.py``):

    - the regression loop streamed from ``big_home`` (phase 7's 40 subjects)
      under a ``--device-data-max-bytes`` that cuts it into at least 4
      segments: the ``pallas`` transformer at ``ff_batch`` for an epoch, its
      K2 and K3 kernels counted by name in a profiler trace; feedforward for
      2 epochs in chunks of 64 against chunks of 1, and on demand
      (``--no-materialize-features``), each epoch's losses and the final
      checkpoints bitwise; windows/s beside the device-resident runs, a
      segment's upload, training and build ms, and a streamed epoch's idle
      share; the denoiser at ``small_batch`` with EMA streamed from phase
      7d's subject, its dev chains through K2 (200 launches a dev batch);
    - sweeps through the ``sweep`` command: feedforward at ``ff_batch``, 3 x 2
      configs for 2 epochs, then with ``--pbt-every 1``; the ``pallas``
      transformer at ``small_batch``, 2 x 2, an epoch of phase 7d's subject;
      GroundLink and the denoiser at ``small_batch``, 2 x 1, GroundLink's
      also step by step (chunks of 1, whose metrics stay on the device) on
      the device and the host tier, bitwise the chunked sweeps. In each, config
      i bitwise a one-config sweep of (lr_i, seed_i); the kernels' launches K
      times a one-config sweep's (``pallas``: 4K K2 and 12K K3 a step in a
      profiler trace; K1 / K4 K a dev batch); a sweep stopped by SIGTERM
      after epoch 0 and rerun, its dev curves and checkpoints bitwise the
      uninterrupted PBT sweep's; a point's checkpoint served through K1 (one
      launch a forward); the aggregate windows/s against K x one config's,
      the chunked step's ms against K, and the captures' seconds.
    ``device`` 'cpu' (small homes, ``size_flags`` narrowing the encoder)
    rehearses it without launch counts or traces."""
    from inferbiomechanics_tpu_torch.__main__ import main as port_main
    from inferbiomechanics_tpu_torch.train import streaming_data as sd_mod
    from inferbiomechanics_tpu_torch.train import sweep as sweep_mod
    from inferbiomechanics_tpu_torch.train.step import ChunkedStep, as_train_step
    t_phase = time.perf_counter()
    on_card = device == 'cuda'
    big_home = big_home or root / 'train_data'
    small_home = small_home or root / 'chunk_data'
    report = {'card': card}
    # phase 7d's subject with a dev subject beside it
    home = root / 'scale_home'
    (home / 'train').mkdir(parents=True)
    (home / 'dev').mkdir()
    shutil.copy(small_home / 'train' / 'subject_0.b3d', home / 'train' / 'subject_0.b3d')
    port.write_synthetic_subject(str(home / 'dev' / 'subject_0.b3d'), num_trials=1,
                                 trial_length=140, seed=seed + 1401)

    def split(where, name, fmt='last_frame', **kw):
        return port.WindowDataset(str(where / name), window_size=50, stride=5,
                                  output_data_format=fmt, skip_loading_skeletons=True, **kw)

    big, big_dev = split(big_home, 'train'), split(big_home, 'dev')
    row_bytes = (big.num_input_channels + big.num_label_channels) * 4
    budget = (big.labels_all.shape[0] // 5 + 1) * row_bytes
    plan = sd_mod.StreamingPlan(big, budget)
    _check(len(plan.segments) >= 4, f'{len(plan.segments)} segments under {budget} bytes')
    stream = ['--device-data', 'stream', '--device-data-max-bytes', str(budget)]
    pallas = ['--model-type', 'transformer', '--attn-impl', 'pallas', *size_flags]
    enc = port.config_from_args(port.parser().parse_args(['train', *pallas]))

    def train(where, ckpt, flags, b, epochs):
        return port.run_training(port.parser().parse_args([
            'train', '--dataset-home', str(where), '--checkpoint-dir', str(ckpt),
            '--batch-size', str(b), '--epochs', str(epochs), '--device', device,
            '--seed', str(seed), *flags]))

    # the streamed epochs' segments and losses, the captures' seconds, and
    # each sweep's result (its aggregate windows/s: every config's windows
    # over the sweep's wall clock, dev evals included)
    epochs_seen, captures, sweeps_seen = [], [], []
    orig_call, orig_capture = sd_mod.StreamingEpoch.__call__, step_mod.GraphedStep._capture
    orig_sweep = sweep_mod.run_sweep

    def recorded_sweep(*a, **kw):
        sweeps_seen.append(orig_sweep(*a, **kw))
        return sweeps_seen[-1]

    def recording(self, state, host_seed):
        out = orig_call(self, state, host_seed)
        epochs_seen.append(dict(stats=list(self.stats), loss=out['loss'].copy()))
        return out

    def timed_capture(self, state):
        t0 = time.perf_counter()
        orig_capture(self, state)
        captures.append((getattr(state, 'states', None) and len(state.states) or 1,
                         time.perf_counter() - t0))

    sd_mod.StreamingEpoch.__call__ = recording
    step_mod.GraphedStep._capture = timed_capture
    sweep_mod.run_sweep = recorded_sweep
    try:
        # -- 14a. the streaming tier -------------------------------------------
        layers = enc.num_layers
        k3_shape = fe.plan_encoder_bwd(ff_batch, 10, enc.d_model, enc.d_model * 4,
                                       enc.num_heads).shape
        fe.launches = fe.bwd_launches = 0
        epochs_seen.clear()
        if on_card:
            res, traced, _ = _traced(torch, lambda: train(big_home, root / 's_pallas',
                                                          pallas + stream, ff_batch, 1))
        else:
            res, traced = train(big_home, root / 's_pallas', pallas + stream, ff_batch, 1), None
        k2_streamed = fe.launches     # before the device-resident run adds its own
        steps = sum(s.steps for s in epochs_seen[-1]['stats'])
        pallas_steady = _steady_windows_per_sec(epochs_seen)
        dev_batches = len(big_dev) // ff_batch
        if on_card:
            _check_traced(traced, layers, steps, dev_batches, k3_shape, 'the streamed pallas run')
        resident = train(big_home, root / 'r_pallas', pallas, ff_batch, 1)
        report['pallas'] = dict(
            segments=len(plan.segments), rows_pad=plan.rows_pad, steps=steps, traced=traced,
            k2_wrapper=k2_streamed, windows_per_sec=res.windows_per_sec,
            steady_windows_per_sec=pallas_steady,
            resident_windows_per_sec=resident.windows_per_sec,
            segments_visited=[dataclasses.asdict(s) for s in epochs_seen[-1]['stats']])
        print(f'[scale-out] train --device-data stream, pallas at B={ff_batch} on {len(big)} '
              f'windows: {len(plan.segments)} segments of {plan.rows_pad} rows under {budget} '
              f'bytes, {steps} steps; traced kernels {traced} ({layers} K2 and '
              f'{layers * fe.BWD_LAUNCHES_PER_LAYER} K3 launches a step, {dev_batches} dev '
              f'batch); {res.windows_per_sec:.0f} windows/s (after each epoch\'s first segment '
              f'{pallas_steady:.0f}) against {resident.windows_per_sec:.0f} device-resident '
              f'({card})', flush=True)

        runs = {}
        for tag, flags in (('chunks of 64', stream), ('chunks of 1',
                           stream + ['--device-chunk-steps', '1']),
                           ('on demand', stream + ['--no-materialize-features'])):
            epochs_seen.clear()
            ckpt = root / f's_ff_{len(runs)}'
            r = train(big_home, ckpt, flags, ff_batch, 2)
            runs[tag] = dict(result=r, ckpt=ckpt / 'feedforward',
                             losses=[e['loss'].item() for e in epochs_seen],
                             stats=[s for e in epochs_seen for s in e['stats']],
                             steady=_steady_windows_per_sec(epochs_seen))
        base = runs['chunks of 64']
        for tag in ('chunks of 1', 'on demand'):
            _check(runs[tag]['losses'] == base['losses'],
                   f'streamed feedforward {tag}: epoch losses {runs[tag]["losses"]} against '
                   f'{base["losses"]}')
            verdict = _compare_final(torch, base['ckpt'], runs[tag]['ckpt'], 1)
            _check(verdict['bitwise'], f'streamed feedforward {tag}: {verdict["verdict"]}')
        ff_resident = train(big_home, root / 'r_ff', [], ff_batch, 2)

        def med(rows, key):
            vals = [getattr(s, key) for s in rows if getattr(s, key) is not None]
            return statistics.median(vals) if vals else None

        st = base['stats']
        report['feedforward'] = dict(
            epoch_losses=base['losses'], windows_per_sec=base['result'].windows_per_sec,
            steady_windows_per_sec=base['steady'],
            resident_windows_per_sec=ff_resident.windows_per_sec,
            windows_per_sec_chunks_of_1=runs['chunks of 1']['result'].windows_per_sec,
            upload_ms=med(st, 'upload_ms'), stage_ms=med(st, 'stage_ms'),
            train_ms=med(st, 'train_ms'), steps_a_segment=med(st, 'steps'),
            build_ms=med(st, 'build_ms'), build_ms_on_demand=med(runs['on demand']['stats'],
                                                                 'build_ms'),
            windows_per_sec_on_demand=runs['on demand']['result'].windows_per_sec)
        f = report['feedforward']
        print(f'[scale-out] train --device-data stream, feedforward at B={ff_batch}, 2 epochs: '
              f'epoch losses {base["losses"]} bitwise in chunks of 64, of 1 and on demand, the '
              f'final checkpoints bitwise; {f["windows_per_sec"]:.0f} windows/s (chunks of 1 '
              f'{f["windows_per_sec_chunks_of_1"]:.0f}, on demand '
              f'{f["windows_per_sec_on_demand"]:.0f}; after each epoch\'s first segment '
              f'{f["steady_windows_per_sec"]:.0f}) against {f["resident_windows_per_sec"]:.0f}'
              f' device-resident; a segment (median): upload {f["upload_ms"]} ms, staging '
              f'{f["stage_ms"]:.2f} ms, training {f["train_ms"]:.2f} ms ({f["steps_a_segment"]} '
              f'steps), build {f["build_ms"]:.2f} ms materialized / '
              f'{f["build_ms_on_demand"]:.2f} ms on demand ({card})', flush=True)

        # a streamed epoch's idle share, in process (the capture before
        # it): its wall clock untraced, the device busy time of the next
        # epoch (the same steps) in a profiler trace
        cfg = port.config_from_args(port.parser().parse_args(['train']))
        lc = port.loss_config_from(cfg)
        model = port.build_model_for_dataset(cfg, big, device=device,
                                             generator=torch.Generator().manual_seed(seed))
        state = port.create_train_state(model, port.make_optimizer(
            model.named_parameters(), cfg.opt_type, cfg.learning_rate))
        epoch = sd_mod.make_streaming_epoch(model, big, plan, lc, ff_batch, device,
                                            chunk_steps=64)
        epoch(state, 0)
        t0 = time.perf_counter()
        epoch(state, 1)
        wall = (time.perf_counter() - t0) * 1e3
        f['epoch_ms'] = wall
        if on_card:
            _, _, busy = _traced(torch, lambda: epoch(state, 2))
            f['epoch_busy_ms'] = busy / 1e3
            f['idle_share'] = max(wall - busy / 1e3, 0.0) / wall
            print(f'[scale-out] a streamed feedforward epoch at B={ff_batch} in chunks of 64: '
                  f'{wall:.1f} ms by the host clock ({len(plan.segments)} segments, '
                  f'{sum(x.steps for x in epoch.stats)} steps), device busy {busy / 1e3:.1f} ms '
                  f'in a trace of the next, idle share {f["idle_share"]:.3f} ({card})', flush=True)

        # the denoiser streamed, its dev chains through K2
        dflags = ['--model-type', 'diffusion', '--output-data-format', 'all_frames',
                  '--ema-decay', '0.999', '--fused-inference', *size_flags]
        sub = split(home, 'train', 'all_frames')
        dbudget = (sub.labels_all.shape[0] // 2 + 1) * row_bytes
        fe.launches = 0
        epochs_seen.clear()
        dres = train(home, root / 's_diff', dflags + ['--device-data', 'stream',
                                                       '--device-data-max-bytes', str(dbudget)],
                     small_batch, 1)
        ddev = len(split(home, 'dev', 'all_frames')) // small_batch
        dcfg = port.config_from_args(port.parser().parse_args(['train', *dflags]))
        if on_card:
            _check(fe.launches == dcfg.num_layers * 50 * ddev,
                   f'streamed denoiser: {fe.launches} K2 launches for {ddev} dev batches')
        _check(np.isfinite(dres.final_train_metrics['eps_mse']), 'streamed denoiser: eps-mse')
        report['diffusion'] = dict(segments=len(epochs_seen[-1]['stats']), dev_batches=ddev,
                                   k2_launches=fe.launches,
                                   eps_mse=dres.final_train_metrics['eps_mse'],
                                   windows_per_sec=dres.windows_per_sec)
        print(f'[scale-out] train --device-data stream, the denoiser at B={small_batch} with '
              f'EMA: {len(epochs_seen[-1]["stats"])} segments, eps-mse '
              f'{dres.final_train_metrics["eps_mse"]:.4f}, {dres.windows_per_sec:.0f} windows/s;'
              f' the dev eval {fe.launches} K2 launches for {ddev} dev batch(es) ({card})',
              flush=True)

        # -- 14b. sweeps -------------------------------------------------------
        def sweep_cli(where, ckpt, flags, b, epochs, lrs, seeds, extra=()):
            argv = ['sweep', '--dataset-home', str(where), '--checkpoint-dir', str(ckpt),
                    '--batch-size', str(b), '--epochs', str(epochs), '--device', device,
                    '--seed', str(seed), '--no-wandb', '--lrs', *map(str, lrs),
                    '--seeds', *map(str, seeds), *flags, *extra]
            t0 = time.perf_counter()
            _check(port_main(argv) == 0, f'sweep {argv}')
            cfg = port.config_from_args(port.parser().parse_args(argv))
            out = json.loads((ckpt / 'sweep' / cfg.model_type / 'sweep_results.json').read_text())
            out['wall_s'] = time.perf_counter() - t0
            out['windows_per_sec'] = sweeps_seen[-1].windows_per_sec
            return out, cfg

        def same_sweeps(tag, a, b):
            """Two sweeps of one grid: dev curves, final train losses and
            each point's final checkpoint bitwise."""
            for i, (p, q) in enumerate(zip(a['points'], b['points'])):
                _check(p['dev_curve'] == q['dev_curve'] and
                       p['final_train_loss'] == q['final_train_loss'],
                       f'{tag} config {i}: {p["dev_curve"]} / {p["final_train_loss"]} against '
                       f'{q["dev_curve"]} / {q["final_train_loss"]}')
                epoch = int(Path(p['checkpoint_path']).name.split('_')[1])
                verdict = _compare_final(torch, Path(p['checkpoint_path']).parent,
                                         Path(q['checkpoint_path']).parent, epoch)
                _check(verdict['bitwise'], f'{tag} config {i}: {verdict["verdict"]}')

        def one_config(cfg, ds, dev, lr, sd_, where):
            c = dataclasses.replace(cfg, checkpoint_dir=str(where))
            return sweep_mod.run_sweep(c, ds, dev, [lr], [sd_], device=device)

        def same_as_one_configs(tag, grid_out, cfg, ds, dev, counter=None):
            """Config i of the grid against a one-config sweep of (lr_i,
            seed_i): dev curve, final train loss, final checkpoint."""
            singles, launches = [], []
            for i, p in enumerate(grid_out['points']):
                if counter is not None:
                    counter.launches = 0
                one = one_config(cfg, ds, dev, p['learning_rate'], p['seed'],
                                 root / f'one_{tag}_{i}')
                launches.append(None if counter is None else counter.launches)
                q = one.points[0]
                _check(q.dev_curve == p['dev_curve'] and q.final_train_loss ==
                       p['final_train_loss'], f'{tag} config {i}: {q.dev_curve} / '
                       f'{q.final_train_loss} alone, {p["dev_curve"]} / '
                       f'{p["final_train_loss"]} in the grid')
                pdir = Path(p['checkpoint_path']).parent
                epoch = int(Path(p['checkpoint_path']).name.split('_')[1])
                verdict = _compare_final(torch, pdir, Path(q.checkpoint_path).parent, epoch)
                _check(verdict['bitwise'], f'{tag} config {i}: {verdict["verdict"]}')
                singles.append(one.windows_per_sec)
            return singles, launches

        grid = dict(lrs=[1e-4, 3e-4, 1e-3], seeds=[0, 1])
        k = 6
        big_sweep = port.config_from_args(port.parser().parse_args(
            ['sweep', '--batch-size', str(ff_batch), '--epochs', '2', '--seed', str(seed)]))
        fm.launches = 0
        ff, _ = sweep_cli(big_home, root / 'sw_ff', [], ff_batch, 2, **grid)
        k1_grid = fm.launches
        singles, k1_single = same_as_one_configs('ff', ff, big_sweep, big, big_dev, counter=fm)
        if on_card:
            want = 2 * (len(big_dev) // ff_batch)
            _check(k1_grid == k * want and all(n == want for n in k1_single),
                   f'sweep K1 launches {k1_grid} for {k} configs, {k1_single} alone; want '
                   f'{want} a config')
        pbt, _ = sweep_cli(big_home, root / 'sw_ff_pbt', [], ff_batch, 2, **grid,
                           extra=['--pbt-every', '1'])
        _check(len(pbt['pbt_events']) == 1, f'PBT events {pbt["pbt_events"]}')
        term_dir = root / 'sw_ff_term'
        cut = sweep_mod.run_sweep(
            dataclasses.replace(big_sweep, checkpoint_dir=str(term_dir / 'sweep' / 'feedforward'
                                                              / 'base')),
            big, big_dev, grid['lrs'], grid['seeds'], pbt_every=1,
            metric_logger=_SigtermAfterEpoch0(), device=device)
        _check(cut.preempted and len(cut.points[0].dev_curve) == 1,
               f'the SIGTERM sweep: preempted {cut.preempted}, {cut.points[0].dev_curve}')
        rerun, _ = sweep_cli(big_home, term_dir, [], ff_batch, 2, **grid,
                             extra=['--pbt-every', '1'])
        _check([p['dev_curve'] for p in rerun['points']] == [p['dev_curve'] for p in
                                                            pbt['points']]
               and rerun['pbt_events'] == pbt['pbt_events'],
               'the sweep stopped by SIGTERM and rerun: dev curves or PBT events differ')
        for p, q in zip(rerun['points'], pbt['points']):
            verdict = _compare_final(torch, Path(p['checkpoint_path']).parent,
                                     Path(q['checkpoint_path']).parent, 1)
            _check(verdict['bitwise'], f'the rerun sweep: {verdict["verdict"]}')

        # the chunked sweep step's ms against K, and the captures' seconds
        step_ms = {}
        data = port.DeviceResidentData(big, device)
        idx = np.random.default_rng(seed).integers(0, len(big), size=(64, ff_batch))
        for kk, lrs, seeds in ((1, [1e-4], [0]), (3, grid['lrs'], [0]),
                               (6, grid['lrs'], grid['seeds'])):
            sstate = sweep_mod.init_sweep_states(big_sweep, big, sweep_mod.sweep_grid(
                lrs, seeds), device)
            chunked = ChunkedStep(as_train_step(sweep_mod.make_sweep_grads(
                sstate.models, big.lab_offsets, lc, gather=data.gather)), (torch.int64,), device)
            chunked(sstate, idx).rows()
            t0 = time.perf_counter()
            for _ in range(3):
                chunked(sstate, idx).rows()
            step_ms[str(kk)] = (time.perf_counter() - t0) * 1e3 / (3 * 64)
        by_k = {}
        for kk, s in captures:
            by_k.setdefault(str(kk), []).append(s)
        report['sweep_feedforward'] = dict(
            configs=k, aggregate_windows_per_sec=ff['windows_per_sec'],
            one_config_windows_per_sec=singles, train_windows_per_sec=ff_resident.windows_per_sec,
            k1_launches=k1_grid, k1_launches_alone=k1_single, pbt_events=pbt['pbt_events'],
            wall_s=ff['wall_s'], chunked_step_ms=step_ms, capture_s=by_k)
        sf = report['sweep_feedforward']
        print(f'[scale-out] sweep feedforward at B={ff_batch}, 3 lrs x 2 seeds, 2 epochs: each '
              f'config bitwise a one-config sweep; K1 {k1_grid} launches ({k1_single[0]} a '
              f'config alone); aggregate {sf["aggregate_windows_per_sec"]:.0f} windows/s '
              f'against K x one config\'s {k * statistics.mean(singles):.0f} and K x train\'s '
              f'{k * ff_resident.windows_per_sec:.0f}; the chunked step '
              + ', '.join(f'K={kk} {v:.3f} ms' for kk, v in step_ms.items())
              + f'; captures (s) by K {by_k}; PBT events {pbt["pbt_events"]}; stopped by SIGTERM'
              f' after epoch 0 and rerun: dev curves, PBT events and checkpoints bitwise the '
              f'uninterrupted sweep\'s ({card})', flush=True)

        # a point's checkpoint served through K1
        point = ff['points'][ff['best']['index']]['checkpoint_path'] if ff['best'] else \
            ff['points'][0]['checkpoint_path']
        svc, server = port.start(port.build_parser().parse_args([
            'serve', '--dataset-home', str(big_home), '--checkpoint-dir', str(root / 'unused'),
            '--device', device, '--port', '0', '--checkpoint-file', point]))
        try:
            x = np.asarray(big_dev.gather(np.arange(64)).inputs, np.float32)
            fm.launches = 0
            got = svc.predict_packed(x)
            served_launches = fm.launches
            with torch.no_grad():
                plain = port.slice_output_heads(fm.mlp_reference(
                    torch.from_numpy(x).to(device).reshape(len(x), -1),
                    svc.model.layer_params(), 'sigmoid'), 2, 1)
            err = max(float(np.abs(got[kk] - v.cpu().numpy()).max()) for kk, v in plain.items())
            limit = k1_limit(max(float(v.abs().max()) for v in plain.values()))
        finally:
            server.server_close()
            svc.close()
        _check(err <= limit, f'the sweep point through K1: {err} > {limit}')
        if on_card:
            _check(served_launches == 1, f'the sweep point: {served_launches} K1 launches')
        report['served_point'] = dict(path=Path(point).parent.name, launches=served_launches,
                                      max_abs_err=err, limit=limit)
        print(f'[scale-out] serve --checkpoint-file {Path(point).parent.name}/'
              f'{Path(point).name}: {served_launches} K1 launch for 64 windows, max abs err '
              f'{err:.3g} against the plain version (limit {limit:.3g}) ({card})', flush=True)

        # pallas 2 x 2 at B=64, an epoch of phase 7d's subject, traced
        small = split(small_home, 'train')
        pcfg = port.config_from_args(port.parser().parse_args(
            ['sweep', *pallas, '--batch-size', str(small_batch), '--epochs', '1',
             '--seed', str(seed)]))
        pk3 = fe.plan_encoder_bwd(small_batch, 10, pcfg.d_model, pcfg.d_model * 4,
                                  pcfg.num_heads).shape
        psteps = max(1, len(small) // small_batch)
        pgrid = dict(lrs=[1e-4, 3e-4], seeds=[0, 1])
        if on_card:
            (pout, _), ptraced, _ = _traced(torch, lambda: sweep_cli(
                small_home, root / 'sw_pallas', pallas, small_batch, 1, **pgrid))
            _check_traced(ptraced, 4 * layers, psteps, 0, pk3, 'the pallas sweep')
        else:
            (pout, _), ptraced = sweep_cli(small_home, root / 'sw_pallas', pallas, small_batch,
                                           1, **pgrid), None
        psingles, _ = same_as_one_configs('pallas', pout, pcfg, small, None)
        if on_card:
            _, one_traced, _ = _traced(torch, lambda: one_config(
                pcfg, small, None, 1e-4, 0, root / 'one_pallas_traced'))
            _check_traced(one_traced, layers, psteps, 0, pk3, 'a one-config pallas sweep')
        report['sweep_pallas'] = dict(configs=4, steps=psteps, traced=ptraced,
                                      aggregate_windows_per_sec=pout['windows_per_sec'],
                                      one_config_windows_per_sec=psingles,
                                      wall_s=pout['wall_s'])
        print(f'[scale-out] sweep pallas at B={small_batch}, 2 x 2, {psteps} steps: each config '
              f'bitwise a one-config sweep; traced kernels {ptraced} (4 x {layers} K2 and 4 x '
              f'{layers * fe.BWD_LAUNCHES_PER_LAYER} K3 a step; a one-config sweep traced a '
              f'quarter of that); aggregate '
              f'{report["sweep_pallas"]["aggregate_windows_per_sec"]:.0f} windows/s against 4 x '
              f'one config\'s {4 * statistics.mean(psingles):.0f} ({card})', flush=True)

        # GroundLink and the denoiser, 2 x 1 at B=64, with a dev split
        for tag, flags, fmt, counter in (
                ('groundlink', ['--model-type', 'groundlink'], 'last_frame', fg),
                ('diffusion', ['--model-type', 'diffusion', '--output-data-format', 'all_frames',
                               *size_flags], 'all_frames', None)):
            scfg = port.config_from_args(port.parser().parse_args(
                ['sweep', *flags, '--batch-size', str(small_batch), '--epochs', '1',
                 '--seed', str(seed)]))
            sds, sdev = split(home, 'train', fmt), split(home, 'dev', fmt)
            if counter is not None:
                counter.launches = 0
            out, _ = sweep_cli(home, root / f'sw_{tag}', flags, small_batch, 1,
                               lrs=[1e-4, 3e-4], seeds=[0])
            grid_launches = None if counter is None else counter.launches
            if tag == 'groundlink':
                # the sweep's eager steps (--device-chunk-steps 1, and the
                # host tier's --host-chunk-steps 1), whose metrics stay on the
                # device, bitwise the chunked sweeps of the same tier
                host = ['--device-data', 'off']
                for what, eager, chunked in (
                        ('device tier', flags + ['--device-chunk-steps', '1'], out),
                        ('host tier', flags + host + ['--host-chunk-steps', '1'],
                         sweep_cli(home, root / 'sw_gl_host', flags + host + [
                             '--host-chunk-steps', '16'], small_batch, 1, lrs=[1e-4, 3e-4],
                             seeds=[0])[0])):
                    one_by_one, _ = sweep_cli(home, root / f'sw_gl_eager_{what[0]}', eager,
                                              small_batch, 1, lrs=[1e-4, 3e-4], seeds=[0])
                    same_sweeps(f'groundlink sweep, {what}, chunks of 1', one_by_one, chunked)
                print(f'[scale-out] sweep groundlink step by step (chunks of 1) on the device '
                      f'tier and on the host tier: bitwise the chunked sweeps ({card})',
                      flush=True)
            singles, alone = same_as_one_configs(tag, out, scfg, sds, sdev, counter=counter)
            dev_b = len(sdev) // small_batch
            if on_card and counter is not None:
                _check(grid_launches == 2 * dev_b and alone == [dev_b, dev_b],
                       f'{tag} sweep: K4 {grid_launches} launches, {alone} alone, for {dev_b} '
                       f'dev batch(es)')
            report[f'sweep_{tag}'] = dict(configs=2, launches=grid_launches,
                                          launches_alone=alone,
                                          dev_curves=[p['dev_curve'] for p in out['points']],
                                          aggregate_windows_per_sec=out['windows_per_sec'],
                                          one_config_windows_per_sec=singles)
            print(f'[scale-out] sweep {tag} at B={small_batch}, 2 lrs x 1 seed: each config '
                  f'bitwise a one-config sweep; dev curves '
                  f'{report[f"sweep_{tag}"]["dev_curves"]}; '
                  + (f'K4 {grid_launches} launches ({alone} alone) for {dev_b} dev batch(es); '
                     if counter is not None else '')
                  + f'aggregate {report[f"sweep_{tag}"]["aggregate_windows_per_sec"]:.0f} '
                  f'windows/s ({card})', flush=True)
    finally:
        sd_mod.StreamingEpoch.__call__ = orig_call
        step_mod.GraphedStep._capture = orig_capture
        sweep_mod.run_sweep = orig_sweep
    report['seconds'] = time.perf_counter() - t_phase
    print(f'[scale-out] phase 14 took {report["seconds"]:.1f} s ({card})', flush=True)
    return report


def _dp_steps(job):
    """One rank's part of phase 15's step runs (``parallel/dist.py::spawn``
    runs it on each rank of two; the phase runs it in its own process, with no
    process group, for the one-process reference): a model of the train
    ``flags`` from ``seed``, ``steps`` eager SGD steps of the device tier's
    step on this rank's rows of each global index vector of ``batch``
    windows, then the gradient all-reduce alone and the eval forward of a
    feedforward and a GroundLink model of the same seed on 64 dev windows
    (K1 and K4, each held to its plain version). Returns the parameters, the
    kernels' launches by wrapper, the step's and the all-reduce's ms (host
    clock, synchronised) and the eval forwards' errors."""
    import torch

    from inferbiomechanics_tpu_torch.__main__ import build_parser
    from inferbiomechanics_tpu_torch.config import config_from_args
    from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
    from inferbiomechanics_tpu_torch.models import build_model_for_dataset
    from inferbiomechanics_tpu_torch.models.common import slice_output_heads
    from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
    from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg
    from inferbiomechanics_tpu_torch.ops import fused_mlp as fm
    from inferbiomechanics_tpu_torch.parallel import dist
    from inferbiomechanics_tpu_torch.train.device_data import (
        DeviceResidentData, make_device_train_step,
    )
    from inferbiomechanics_tpu_torch.train.loop import loss_config_from
    from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
    from inferbiomechanics_tpu_torch.train.state import create_train_state
    device = torch.device('cuda', torch.cuda.current_device()) if job['device'] == 'cuda' \
        else torch.device('cpu')
    sync = torch.cuda.synchronize if device.type == 'cuda' else (lambda: None)
    r, n = dist.rank(), dist.world_size()
    cfg = config_from_args(build_parser().parse_args(['train', *job['flags']]))
    ds = WindowDataset(job['home'] + '/train', window_size=cfg.window_size, stride=cfg.stride,
                       skip_loading_skeletons=True)
    model = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(job['seed']),
                                    device=device)
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'sgd', job['lr']))
    dist.attach(state, model)
    data = DeviceResidentData(ds, device, pack_windows=True)
    step = make_device_train_step(model, data, loss_config_from(cfg))
    rng = np.random.default_rng(job['seed'])
    b = job['batch'] // n
    before = (fm.launches, fe.launches, fe.bwd_launches, fg.launches)
    times = []
    for _ in range(job['steps']):
        idx = rng.permutation(len(ds))[:job['batch']][r * b:(r + 1) * b]
        sync()
        t0 = time.perf_counter()
        step(state, torch.from_numpy(idx).to(device))
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    after = (fm.launches, fe.launches, fe.bwd_launches, fg.launches)
    out = dict(rank=r, world=n, params={k: v.detach().float().cpu().numpy()
                                        for k, v in model.state_dict().items()},
               launches=dict(zip(('k1', 'k2', 'k3', 'k4'),
                                 (a - c for a, c in zip(after, before)))),
               step_ms=statistics.median(times[1:]) if len(times) > 1 else times[0])
    if state.grad_sync is not None:            # the all-reduce alone, on this step's gradients
        metrics = {'loss': torch.zeros((), device=device)}
        ms = []
        for _ in range(10):
            sync()
            t0 = time.perf_counter()
            state.grad_sync(metrics)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        out['allreduce_ms'] = statistics.median(ms)
    # K1 and K4: an eval forward of each on 64 dev windows, against the plain version
    dev = WindowDataset(job['home'] + '/dev', window_size=cfg.window_size, stride=cfg.stride,
                        skip_loading_skeletons=True)
    x = torch.from_numpy(dev.gather(np.arange(64)).inputs).to(device)
    errs, counts = {}, {}
    for name, flags in (('k1', []), ('k4', ['--model-type', 'groundlink'])):
        ecfg = config_from_args(build_parser().parse_args(['train', *flags]))
        m = build_model_for_dataset(ecfg, ds, generator=torch.Generator().manual_seed(
            job['seed']), device=device).eval()
        with torch.no_grad():
            k0 = (fm.launches, fg.launches)
            got = m(x)
            counts[name] = (fm.launches - k0[0]) + (fg.launches - k0[1])
            if name == 'k1':
                ref = fm.mlp_reference(x.reshape(len(x), -1), m.layer_params(), ecfg.activation)
                want = slice_output_heads(ref, 2, 1)
            else:
                ref = fg.groundlink_reference(x, m.layer_params(), ecfg.output_data_format,
                                              GL_FULL['fc_depth'])
                want = slice_output_heads(ref, 2, ref.shape[1])
        errs[name] = (max(float((got[k].float() - want[k].float()).abs().max()) for k in want),
                      max(float(want[k].abs().max()) for k in want))
    out['eval_launches'], out['eval_err'] = counts, errs
    return out


def _dp_rank(jobs):
    """What each rank of phase 15's two-rank runs does: :func:`_dp_steps` for
    each job."""
    return [_dp_steps(job) for job in jobs]


def _torchrun(argv, env_backend, cwd, timeout=600):
    """``IB_MULTIHOST=<env_backend> torchrun --standalone --nproc-per-node 2
    -m inferbiomechanics_tpu_torch <argv>``: the user's data-parallel command.
    Returns (seconds, stdout); fails the run on a non-zero exit."""
    env = dict(os.environ, IB_MULTIHOST=env_backend, PYTHONPATH=str(REPO),
               OMP_NUM_THREADS='4')
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone', '--nproc-per-node',
           '2', '-m', 'inferbiomechanics_tpu_torch', *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout,
                          cwd=str(cwd))
    seconds = time.perf_counter() - t0
    _check(proc.returncode == 0, f'torchrun {" ".join(argv[:3])}: exit {proc.returncode}\n'
                                 f'{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')
    return seconds, proc.stdout


def phase_data_parallel(torch, port, fm, fe, fg, step_mod, root, seed, card, device='cuda',
                        big=4096, small=64, subjects=16, size_flags=()):
    """15. Data parallelism over processes (``parallel/dist.py``, the
    all-reduce in ``train/step.py``, ``train/sharded_data.py``):

    - world 1 on NCCL, in this process: the ``pallas`` transformer and
      feedforward at ``big`` in chunks of 8 captured steps, with the
      gradient all-reduce inside the graph, bitwise the same chunks without a
      process group (parameters and every step's metrics); the K2, K3 and
      NCCL kernels of a chunk counted by name in a profiler trace; a step's
      ms with and without the process group (in turns), and the all-reduce's
      ms alone;
    - two ranks sharing the card over gloo (NCCL when there are two GPUs):
      feedforward at ``big`` and ``pallas`` at 2 x ``small`` windows, four
      eager steps each, the ranks' parameters bitwise equal and within 2e-2
      x max of one process at the global batch (the parameters' change, SGD);
      in every rank K2 4 and K3 12 launches a ``pallas`` step, and K1 and K4
      one launch an eval forward, each held to its plain version; the
      all-reduce's ms and windows/s;
    - the ``train`` command under ``IB_MULTIHOST=gloo torchrun
      --nproc-per-node 2``: feedforward at ``big`` on ``--device-data
      sharded`` with ``--grad-allreduce-dtype bf16``, rank 0's checkpoint
      served through K1 in one launch; the denoiser at ``small`` on the
      shards of two of the subjects with ``--ema-decay`` and its dev chains
      through K2.
    ``device`` 'cpu' rehearses it (gloo, no traces, no launch counts
    checked)."""
    from inferbiomechanics_tpu_torch.parallel import dist
    from inferbiomechanics_tpu_torch.train.checkpoint import read_payload
    t_phase = time.perf_counter()
    on_card = device == 'cuda'
    report = {'card': card}
    home = root / 'dp_data'
    for split, n, length, first in (('train', subjects, 2100, 1500), ('dev', 1, 800, 1600)):
        (home / split).mkdir(parents=True)
        for i in range(n):
            port.write_synthetic_subject(str(home / split / f'subject_{i}.b3d'), num_trials=2,
                                         trial_length=length, seed=seed + first + i)
    ds = port.WindowDataset(str(home / 'train'), window_size=50, stride=5,
                            skip_loading_skeletons=True)
    pallas = ['--model-type', 'transformer', '--attn-impl', 'pallas', *size_flags]

    # -- world 1 on NCCL: the captured chunk with its all-reduce, bitwise ----
    backend = 'nccl' if on_card else 'gloo'
    dist.init(backend, 0, 1, f'tcp://127.0.0.1:{dist.free_port()}', device)
    try:
        data = port.DeviceResidentData(ds, device, pack_windows=True)
        rng = np.random.default_rng(seed + 15)
        idx = np.stack([rng.permutation(len(ds))[:big] for _ in range(8)])
        world1 = {}
        for name, flags in (('pallas', pallas), ('feedforward', [])):
            cfg = port.config_from_args(port.parser().parse_args(['train', *flags]))
            runs = []
            for synced in (False, True):
                model = port.build_model_for_dataset(
                    cfg, ds, generator=torch.Generator().manual_seed(seed), device=device)
                state = port.create_train_state(model, port.make_optimizer(
                    model.named_parameters(), cfg.opt_type, cfg.learning_rate))
                if synced:
                    dist.attach(state, model)
                run = port.make_device_chunked_step(model, data, port.loss_config_from(cfg))
                rows = run(state, idx).rows()
                runs.append(dict(model=model, state=state, run=run, rows=rows))
            plain, synced = runs
            for k, v in plain['model'].state_dict().items():
                _check(torch.equal(v, synced['model'].state_dict()[k]),
                       f'world 1 {name}: {k} differs from the run without a process group')
            _check(all(np.array_equal(a[k], b[k]) for a, b in zip(plain['rows'], synced['rows'])
                       for k in a), f'world 1 {name}: metrics differ')
            entry = dict(bitwise=True, steps=len(idx), batch=big)
            if on_card:
                def chunk(r):
                    return lambda: r['run'](r['state'], idx).rows()      # noqa: B023
                ms = {}
                for which in ('plain', 'synced', 'synced', 'plain'):
                    r = plain if which == 'plain' else synced
                    ms[which] = min(ms.get(which, float('inf')),
                                    _host_p50_ms(chunk(r), 3) / len(idx))
                fe.launches = fe.bwd_launches = 0
                _, traced, busy_us = _traced(torch, chunk(synced),
                                             names=(*ENC_KERNELS, 'nccl'))
                _check(fe.launches == fe.bwd_launches == 0,
                       f'world 1 {name}: wrappers ran in a replay')
                if name == 'pallas':
                    k3_shape = fe.plan_encoder_bwd(big, 10, cfg.d_model, cfg.d_model * 4,
                                                   cfg.num_heads).shape
                    _check_traced({k: v for k, v in traced.items() if k != 'nccl'},
                                  cfg.num_layers, len(idx), 0, k3_shape, f'world 1 {name}')
                grads = {'loss': torch.zeros((), device=device)}
                allreduce_ms = _cuda_ms(torch, lambda: synced['state'].grad_sync(grads))  # noqa: B023
                entry.update(step_ms=ms['plain'], step_ms_synced=ms['synced'],
                             allreduce_ms=allreduce_ms, nccl_kernels_traced=traced['nccl'],
                             traced=traced, windows_per_sec=big / ms['synced'] * 1e3)
                print(f'[data-parallel] world 1, backend {backend}, {name} B={big} in chunks of '
                      f'{len(idx)} captured steps ({card}): bitwise the chunks without a '
                      f'process group; a step {ms["synced"]:.3f} ms with the group against '
                      f'{ms["plain"]:.3f} ms without (p50 of 3 chunks by the host clock, in '
                      f'turns) = {big / ms["synced"] * 1e3:.0f} windows/s; the all-reduce '
                      f'alone {allreduce_ms:.3f} ms (CUDA events, median of 30); in a profiler '
                      f'trace of a chunk: {traced}', flush=True)
            world1[name] = entry
            del runs, plain, synced
        report['world1'] = world1
    finally:
        dist.shutdown()

    # -- two ranks on the card (gloo), against one process at the global batch
    two_backend = 'nccl' if on_card and torch.cuda.device_count() >= 2 else 'gloo'
    jobs = [dict(flags=[], batch=big, steps=4, lr=1e-3),
            dict(flags=pallas, batch=2 * small, steps=4, lr=1e-3)]
    jobs = [dict(j, home=str(home), seed=seed, device=device) for j in jobs]
    t0 = time.perf_counter()
    ranks = dist.spawn(_dp_rank, 2, jobs, backend_name=two_backend, device=device,
                       init_file=str(root / 'dp_rendezvous'), timeout_s=600)
    spawn_s = time.perf_counter() - t0
    one = _dp_rank(jobs)
    two = {}
    for j, (name, job) in enumerate(zip(('feedforward', 'pallas'), jobs)):
        r0, r1 = ranks[0][j], ranks[1][j]
        for k in r0['params']:
            _check(np.array_equal(r0['params'][k], r1['params'][k]),
                   f'two ranks {name}: {k} differs between the ranks')
        start = _dp_start_params(torch, port, job, ds, device)
        worst = 0.0
        for k, want in one[j]['params'].items():
            dw = want.astype(np.float64) - start[k]
            dg = r0['params'][k].astype(np.float64) - start[k]
            scale = np.abs(dw).max()
            if scale > 0:
                worst = max(worst, float(np.abs(dg - dw).max() / scale))
        _check(worst <= 2e-2, f'two ranks {name}: change {worst:.3g} x max from one process')
        layers = ENC_FULL['layers']
        for r in (r0, r1):
            if on_card and name == 'pallas':
                _check(r['launches']['k2'] == layers * job['steps'] and
                       r['launches']['k3'] == layers * fe.BWD_LAUNCHES_PER_LAYER * job['steps'],
                       f'rank {r["rank"]} pallas launches {r["launches"]}')
            if on_card:
                _check(r['eval_launches'] == {'k1': 1, 'k4': 1},
                       f'rank {r["rank"]} eval launches {r["eval_launches"]}')
            (e1, m1), (e4, m4) = r['eval_err']['k1'], r['eval_err']['k4']
            _check(e1 <= k1_limit(m1) and e4 <= GL_REL * m4,
                   f'rank {r["rank"]} eval errors K1 {e1} (max {m1}), K4 {e4} (max {m4})')
        two[name] = dict(
            backend=two_backend, global_batch=job['batch'], steps=job['steps'],
            change_vs_one_process=worst, launches=[r0['launches'], r1['launches']],
            eval_launches=[r0['eval_launches'], r1['eval_launches']],
            eval_err=[r0['eval_err'], r1['eval_err']],
            step_ms=max(r0['step_ms'], r1['step_ms']), one_process_step_ms=one[j]['step_ms'],
            allreduce_ms=max(r0.get('allreduce_ms', 0.0), r1.get('allreduce_ms', 0.0)),
            windows_per_sec=job['batch'] / max(r0['step_ms'], r1['step_ms']) * 1e3)
        print(f'[data-parallel] two ranks on {torch.cuda.device_count() if on_card else 0} '
              f'GPU(s), backend {two_backend}, {name} at a global batch of {job["batch"]} '
              f'({card}): ranks bitwise equal, change {worst:.3g} x max from one process at '
              f'the global batch; eager step {two[name]["step_ms"]:.3f} ms '
              f'({two[name]["windows_per_sec"]:.0f} windows/s) against '
              f'{one[j]["step_ms"]:.3f} ms in one process; the all-reduce alone '
              f'{two[name]["allreduce_ms"]:.3f} ms; launches by rank {two[name]["launches"]}, '
              f'eval forwards K1 / K4 {two[name]["eval_launches"]} with (max abs err, max '
              f'|plain|) {two[name]["eval_err"]}', flush=True)
    two['spawn_seconds'] = spawn_s
    report['two_ranks'] = two

    # -- the train command under torchrun ------------------------------------
    base = ['train', '--dataset-home', str(home), '--device', device, '--epochs', '1',
            '--seed', str(seed), '--geometry-folder', str(root), '--no-wandb']
    ckpt = root / 'dp_ckpt'
    seconds, out = _torchrun([*base, '--checkpoint-dir', str(ckpt), '--batch-size', str(big),
                              '--device-data', 'sharded', '--grad-allreduce-dtype', 'bf16'],
                             'gloo', root)
    _check('process group: 2 ranks, backend gloo' in out and out.count('Training done') == 2,
           f'torchrun feedforward: {out[-2000:]}')
    rates = [float(m.replace(',', '')) for m in re.findall(r'epochs, ([\d,.]+) windows/sec', out)]
    files = sorted(os.listdir(ckpt / 'feedforward'))
    _check('epoch_0_batch_0.torch.pt' in files and 'run_config.json' in files,
           f'torchrun feedforward: {files}')
    svc, server = port.start(port.build_parser().parse_args([
        'serve', '--dataset-home', str(home), '--checkpoint-dir', str(ckpt), '--device', device,
        '--port', '0']))
    try:
        dev = port.WindowDataset(str(home / 'dev'), window_size=50, stride=5,
                                 skip_loading_skeletons=True)
        x = np.asarray(dev.gather(np.arange(64)).inputs, np.float32)
        fm.launches = 0
        got = svc.predict_packed(x)
        served = fm.launches
        with torch.no_grad():
            plain = port.slice_output_heads(fm.mlp_reference(
                torch.from_numpy(x).to(device).reshape(len(x), -1),
                svc.model.layer_params(), 'sigmoid'), 2, 1)
        err = max(float(np.abs(got[kk] - v.cpu().numpy()).max()) for kk, v in plain.items())
        limit = k1_limit(max(float(v.abs().max()) for v in plain.values()))
    finally:
        server.server_close()
        svc.close()
    _check(err <= limit and (served == 1 or not on_card),
           f'rank 0\'s checkpoint through K1: {served} launches, err {err} > {limit}')
    report['torchrun_feedforward'] = dict(seconds=seconds, windows_per_sec=rates,
                                          served_k1_launches=served, served_err=err)
    print(f'[data-parallel] IB_MULTIHOST=gloo torchrun --nproc-per-node 2 train --device-data '
          f'sharded --grad-allreduce-dtype bf16 --batch-size {big} ({card}): {seconds:.1f} s '
          f'with start-up, windows/s by rank {rates}; rank 0\'s checkpoint served through K1 '
          f'({served} launch for 64 windows, max abs err {err:.3g})', flush=True)
    # the denoiser on two of the subjects (25 steps of 64 windows an epoch)
    few = root / 'dp_few'
    (few / 'train').mkdir(parents=True)
    for i in range(2):
        shutil.copy(home / 'train' / f'subject_{i}.b3d', few / 'train' / f'subject_{i}.b3d')
    shutil.copytree(home / 'dev', few / 'dev')
    base[2] = str(few)
    seconds, out = _torchrun([*base, '--checkpoint-dir', str(ckpt), '--batch-size', str(small),
                              '--model-type', 'diffusion', '--output-data-format', 'all_frames',
                              '--ema-decay', '0.999', '--fused-inference', '--device-data',
                              'sharded', *size_flags], 'gloo', root)
    _check(out.count('Training done') == 2 and 'dev report (sampled' in out,
           f'torchrun diffusion: {out[-2000:]}')
    payload = read_payload(str(ckpt / 'diffusion' / 'epoch_0_batch_0.torch.pt'))
    _check('ema_params' in payload, 'torchrun diffusion: no EMA in rank 0\'s checkpoint')
    rates = [float(m.replace(',', '')) for m in re.findall(r'epochs, ([\d,.]+) windows/sec', out)]
    report['torchrun_diffusion'] = dict(seconds=seconds, windows_per_sec=rates)
    print(f'[data-parallel] IB_MULTIHOST=gloo torchrun --nproc-per-node 2 train --model-type '
          f'diffusion --device-data sharded --ema-decay 0.999 --fused-inference --batch-size '
          f'{small} ({card}): {seconds:.1f} s with start-up, windows/s by rank {rates}; rank 0\'s '
          f'checkpoint holds the EMA; the dev chains ran through K2', flush=True)
    report['seconds'] = time.perf_counter() - t_phase
    print(f'[data-parallel] phase 15 took {report["seconds"]:.1f} s ({card})', flush=True)
    return report


# -- phase 16: model parallelism and sharded sweeps ----------------------------


def _captured_states(modules):
    """Patch ``create_train_state`` in ``modules`` to keep every train state
    made; returns (the list, a function that undoes the patch)."""
    made, saved = [], [(m, m.create_train_state) for m in modules]

    def keep(model, optimizer):
        made.append(saved[0][1](model, optimizer))
        return made[-1]

    for m, _ in saved:
        m.create_train_state = keep
    return made, lambda: [setattr(m, 'create_train_state', f) for m, f in saved]


def _timed_dispatches(sweep_mod, sync):
    """Patch the sweep's ``make_dispatch`` so that every dispatch is timed
    (host clock, synchronised before and after); returns the list of (steps,
    seconds) it fills and a function that undoes the patch."""
    seen, orig = [], sweep_mod.make_dispatch

    def timed(*a, **kw):
        dispatch = orig(*a, **kw)

        def run(group):
            sync()
            t0 = time.perf_counter()
            out = dispatch(group)
            if hasattr(out, 'rows'):
                out.rows()
            sync()
            seen.append((len(group), time.perf_counter() - t0))
            return out
        return run

    sweep_mod.make_dispatch = timed
    return seen, lambda: setattr(sweep_mod, 'make_dispatch', orig)


def _mp_train(job):
    """``train --model-parallel 2`` of ``job['argv']`` on this rank (the
    ``train`` command's ``run_training`` inside the rank's process group),
    the whole run in a profiler trace on the card; its final parameters
    held bitwise against the one-process run's (``job['one']``, an ``.npz``);
    then ``parallel/sharding_rules.py`` on the ``model`` axis: the rank's
    shard of the trained state and of a feedforward state (one update), each
    gathered back over the ``model`` group. Returns the traced kernels, the
    wrappers' launches, the steps, the first parameter that differs from one
    process (None: bitwise), and by state the shard's and the whole state's
    bytes and whether the gather was bitwise the state."""
    import torch

    from inferbiomechanics_tpu_torch.__main__ import build_parser
    from inferbiomechanics_tpu_torch.cli.train_cmd import run_training
    from inferbiomechanics_tpu_torch.config import Config
    from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
    from inferbiomechanics_tpu_torch.models import build_model_for_dataset
    from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
    from inferbiomechanics_tpu_torch.parallel import sharding_rules as sr
    from inferbiomechanics_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh
    from inferbiomechanics_tpu_torch.train import loop as loop_mod
    from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
    from inferbiomechanics_tpu_torch.train.state import create_train_state
    made, undo = _captured_states([loop_mod])
    fe.launches = fe.bwd_launches = 0
    args = build_parser().parse_args(job['argv'])
    try:
        if job['device'] == 'cuda':
            _, traced, busy = _traced(torch, lambda: run_training(args))
        else:
            run_training(args)
            traced, busy = None, None
    finally:
        undo()
    state = made[-1]
    one = np.load(job['one'])
    got = {k: v.detach().float().cpu().numpy() for k, v in state.model.state_dict().items()}
    differs = next((k for k in one.files if not np.array_equal(one[k], got[k])), None)
    out = dict(traced=traced, busy_us=busy, steps=state.step, differs=differs,
               launches=dict(k2=fe.launches, k3=fe.bwd_launches))
    layout = make_mesh(model_parallel=2)
    ds = WindowDataset(job['home'] + '/train', window_size=50, stride=5,
                       skip_loading_skeletons=True)
    ff = build_model_for_dataset(Config(), ds, generator=torch.Generator().manual_seed(1),
                                 device=next(state.model.parameters()).device)
    ff_state = create_train_state(ff, make_optimizer(ff.named_parameters(), 'rmsprop', 1e-3))
    for prm in ff.parameters():
        prm.grad = torch.ones_like(prm)
    ff_state.optimizer.step()
    out['sharding'] = {}
    for name, st in (('pallas', state), ('feedforward', ff_state)):
        shard = sr.shard_state(st, 2, layout.coord(MODEL_AXIS))
        whole = sr.gather_state(shard, layout.group(MODEL_AXIS))
        full = sr.shard_state(st, 1, 0)
        equal = (all(torch.equal(whole.params[n], t) for n, t in full.params.items())
                 and all(torch.equal(whole.moments[n][k], t)
                         for n, m in full.moments.items() for k, t in m.items()))
        out['sharding'][name] = dict(
            shard_bytes=shard.nbytes(), full_bytes=full.nbytes(), gathered_bitwise=equal,
            split=sorted(n for n, d in shard.param_dims.items() if d is not None))
    return out


def _mp_sweep(job):
    """The ``sweep`` command of ``job['argv']`` on this rank (inside the
    rank's process group); with ``job['trace']`` the run in a profiler
    trace, each dispatch timed. Returns its exit code, K1's launches, and the
    traced kernels and dispatches (steps, seconds)."""
    import torch

    from inferbiomechanics_tpu_torch.__main__ import main as port_main
    from inferbiomechanics_tpu_torch.ops import fused_mlp as fm
    from inferbiomechanics_tpu_torch.train import sweep as sweep_mod
    fm.launches = 0
    if not job.get('trace'):
        return dict(rc=port_main(job['argv']), k1=fm.launches)
    dispatches, undo = _timed_dispatches(sweep_mod, torch.cuda.synchronize)
    try:
        rc, traced, busy = _traced(torch, lambda: port_main(job['argv']))
    finally:
        undo()
    return dict(rc=rc, k1=fm.launches, traced=traced, busy_us=busy, dispatches=dispatches)


def _mp_pipeline(job):
    """``train --pipeline-parallel 2`` of ``job['argv']`` on this rank (the
    ``train`` command's ``run_training`` inside the rank's process group):
    every step timed (host clock, synchronised; the loop's eager steps), the
    point-to-point traffic of ``parallel/dist.py`` (calls, bytes, host
    seconds) and the encoder kernels' wrapper launches. Returns those, the
    steps and the run's final train metrics."""
    import torch

    from inferbiomechanics_tpu_torch.__main__ import build_parser
    from inferbiomechanics_tpu_torch.cli.train_cmd import run_training
    from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
    from inferbiomechanics_tpu_torch.parallel import dist
    from inferbiomechanics_tpu_torch.train import loop as loop_mod
    sync = torch.cuda.synchronize if job['device'] == 'cuda' else (lambda: None)
    made, undo_states = _captured_states([loop_mod])
    dispatches, undo = _timed_dispatches(loop_mod, sync)
    fe.launches = fe.bwd_launches = 0
    dist.reset_p2p_stats()
    t0 = time.perf_counter()
    try:
        result = run_training(build_parser().parse_args(job['argv']))
    finally:
        undo()
        undo_states()
    return dict(step_ms=[sec * 1e3 for _, sec in dispatches], steps=made[-1].step,
                wall_s=time.perf_counter() - t0, p2p=dict(dist.p2p_stats),
                launches=dict(k2=fe.launches, k3=fe.bwd_launches),
                final_train={k: float(np.mean(v)) for k, v in
                             result.final_train_metrics.items()})


_MP_JOBS = {'train': _mp_train, 'sweep': _mp_sweep, 'pipeline': _mp_pipeline}


def rank_jobs(out_path: str) -> int:
    """A rank of ``torchrun chip_smoke.py --rank-jobs OUT``: joins the
    process group from torchrun's environment (``IB_MULTIHOST``), runs the
    jobs of ``OUT.jobs.json`` (phase 16's commands, each as a user calls it)
    and writes their results to ``OUT.<rank>.json``."""
    sys.path.insert(0, str(REPO))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from inferbiomechanics_tpu_torch.parallel import dist
    jobs = json.loads(Path(f'{out_path}.jobs.json').read_text())
    dist.start_from_env(jobs[0]['device'])
    try:
        results = [_MP_JOBS[job['fn']](job) for job in jobs]
    finally:
        dist.shutdown()
    Path(f'{out_path}.{os.environ["RANK"]}.json').write_text(json.dumps(results))
    return 0


def _step_ms(dispatches, skip: int = 1) -> float:
    """The median ms of a step over the timed dispatches after the first
    ``skip`` (a capture, the first eager steps)."""
    rows = dispatches[skip:] or dispatches[-1:]
    return statistics.median(sec / n for n, sec in rows) * 1e3


def _rank_jobs_run(out, jobs, nproc: int, on_card: bool, cwd):
    """``IB_MULTIHOST=gloo torchrun --standalone --nproc-per-node nproc
    chip_smoke.py --rank-jobs out``: every rank runs ``jobs``
    (:func:`rank_jobs`). Returns (seconds with start-up, each rank's
    results); fails the run on a non-zero exit."""
    Path(f'{out}.jobs.json').write_text(json.dumps(jobs))
    # on the CPU one thread a rank, as in this process, so that the sums agree
    env = dict(os.environ, IB_MULTIHOST='gloo', PYTHONPATH=str(REPO),
               OMP_NUM_THREADS='4' if on_card else '1')
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone', '--nproc-per-node',
           str(nproc), str(REPO / 'chip_smoke.py'), '--rank-jobs', str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600,
                          cwd=str(cwd))
    seconds = time.perf_counter() - t0
    _check(proc.returncode == 0, f'torchrun --nproc-per-node {nproc} --rank-jobs: exit '
                                 f'{proc.returncode}\n{proc.stdout[-3000:]}\n'
                                 f'{proc.stderr[-3000:]}')
    return seconds, [json.loads(Path(f'{out}.{r}.json').read_text()) for r in range(nproc)]


# train --pipeline-parallel 2 against the run of the same flags in one
# process: the same host-loader batches and the same math on microbatches
# (row-independent), so only bf16 rounding moves the epoch's mean train
# metrics (PP_REL); the two trained models' outputs differ by what RMSprop's
# near +-10 lr first updates make of those roundings (PP_OUT_REL x max).
PP_REL = 2e-2
PP_OUT_REL = 0.1


def _pipeline_report(port, ranks, one_train, home, root, windows, batch, device, card,
                     size_flags):
    """16d. ``train --pipeline-parallel 2`` on the two ranks (the last job
    of phase 16's torchrun start-up): each rank's steps, wrapper launches
    (no K2 or K3: the stages run the plain bf16 forward), step ms and p2p
    ms; both ranks' train metrics (the last stage's, replicated) against the
    one-process run's; rank 0's canonical checkpoint served in one process
    against the one-process run's checkpoint."""
    from inferbiomechanics_tpu_torch.cli.serve_cmd import build_parser as serve_parser
    from inferbiomechanics_tpu_torch.cli.serve_cmd import start
    pp = [r[3] for r in ranks]
    steps = windows(home / 'train') // batch
    for r, got in enumerate(pp):
        _check(got['steps'] == steps, f'--pipeline-parallel 2 rank {r}: {got["steps"]} steps, '
                                      f'want {steps}')
        _check(got['launches'] == dict(k2=0, k3=0),
               f'--pipeline-parallel 2 rank {r}: wrapper launches {got["launches"]}')
        _check(got['final_train'] == pp[0]['final_train'],
               f'--pipeline-parallel 2: rank {r} metrics {got["final_train"]} differ')
        _check(got['p2p']['calls'] > 0, f'--pipeline-parallel 2 rank {r}: no p2p')
    for k, v in one_train.items():
        _check(abs(pp[0]['final_train'][k] - v) <= PP_REL * abs(v),
               f'--pipeline-parallel 2 train {k} {pp[0]["final_train"][k]} against one '
               f'process {v}')
    x = port.WindowDataset(str(home / 'dev'), window_size=50, stride=5,
                           skip_loading_skeletons=True).gather(np.arange(8)).inputs
    served = {}
    for name, ckpt in (('pipeline', root / 'pp_ckpt'), ('one', root / 'pp_one')):
        svc, server = start(serve_parser().parse_args(
            ['serve', '--dataset-home', str(home), '--checkpoint-dir', str(ckpt), '--port', '0',
             '--device', device, '--model-type', 'transformer', *size_flags]))
        try:
            _check(svc.epoch == 0, f'serve {name}: epoch {svc.epoch}')
            served[name] = svc.predict_packed(x)
        finally:
            server.server_close()
            svc.close()
    out_rel = 0.0
    for k, want in served['one'].items():
        got = served['pipeline'][k]
        _check(got.shape == want.shape and np.isfinite(got).all(), f'served {k} {got.shape}')
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        _check(rel <= PP_OUT_REL, f'pipeline checkpoint served: {k} {rel} x max from the '
                                  f'one-process run\'s')
        out_rel = max(out_rel, rel)
    step_ms = [statistics.median(g['step_ms'][1:] or g['step_ms']) for g in pp]
    p2p_ms = [g['p2p']['seconds'] * 1e3 / steps for g in pp]
    entry = dict(steps=steps, batch=batch, microbatches=4, stages=2, step_ms=step_ms,
                 first_step_ms=[g['step_ms'][0] for g in pp], p2p_ms_per_step=p2p_ms,
                 p2p_calls=[g['p2p']['calls'] for g in pp],
                 p2p_bytes=[g['p2p']['bytes'] for g in pp],
                 launches=[g['launches'] for g in pp], final_train=pp[0]['final_train'],
                 one_process_train=one_train, served_rel_to_one_process=out_rel,
                 wall_s=[g['wall_s'] for g in pp])
    print(f'[pipeline] train --pipeline-parallel 2 on two gloo ranks sharing the card, vpu '
          f'transformer full width (2 layers a stage), B={batch}, 4 microbatches, {steps} '
          f'steps ({card}): a step {step_ms[0]:.2f} / {step_ms[1]:.2f} ms by rank (host '
          f'clock, synchronised; the median after the first, which took '
          f'{entry["first_step_ms"]} ms), p2p '
          f'{p2p_ms[0]:.2f} / {p2p_ms[1]:.2f} ms a step by rank ({entry["p2p_calls"]} sends and '
          f'receives through host memory, {entry["p2p_bytes"]} bytes); no K2 or K3 '
          f'({entry["launches"]}); train loss {pp[0]["final_train"]["loss"]:.6f} against '
          f'{one_train["loss"]:.6f} in one process (within {PP_REL} of each metric); rank 0\'s '
          f'canonical checkpoint served in one process within {out_rel:.4f} x max of the '
          f'one-process run\'s', flush=True)
    return entry


def phase_model_parallel(torch, port, fm, fe, fg, root, seed, card, device='cuda',
                         small=64, wide=512, size_flags=()):
    """16. Model parallelism and sharded sweeps (``parallel/mesh.py``,
    ``parallel/sharding_rules.py``, ``train/sweep.py``), every rank a gloo
    rank sharing the card. Under ``IB_MULTIHOST=gloo torchrun
    --nproc-per-node 2`` (``rank_jobs``; one start-up for three commands):

    - ``train --model-parallel 2``: the ``pallas`` transformer at full
      width, B=``small``, one epoch; the two ranks form one ``data`` row, so
      each runs step by step (the JAX chunk policy at world 2) with no
      collective in its step: both ranks bitwise the run in one process (in
      chunks of captured steps); in each rank's profiler trace 4 K2 and 12
      K3 a step; ``sharding_rules``: the bytes a rank holds of the
      column-split trained state and of a feedforward state against the
      whole, each gathered back bitwise;
    - ``sweep --device-data sharded``: feedforward K=2 at B=``wide`` on the
      trials split over the two ranks (the 1-D layout);
    - ``sweep --shard-configs``: ``pallas`` K=4 (2 lrs x 2 seeds) at
      B=``small``, 2 epochs, ``--pbt-every 1``, bitwise the one-process K=4
      sweep (dev curves, losses, PBT events, final checkpoints); in each
      rank's trace 8 K2 and 24 K3 a step (and 8 K2 a dev batch); a rank's
      step ms (its two configs, in chunks of captured steps: the step holds
      no collective) against the one-process K=4 step's.

    Then the 2-D (config, data) layout on 4 ranks (the same ``torchrun``
    with ``--nproc-per-node 4``): the same feedforward ``sweep --device-data
    sharded --shard-configs``, bitwise the 1-D sweep, K1 in its dev evals.
    ``device`` 'cpu' rehearses it (no traces, no launch counts checked)."""
    from inferbiomechanics_tpu_torch.__main__ import main as port_main
    from inferbiomechanics_tpu_torch.train import loop as loop_mod
    from inferbiomechanics_tpu_torch.train import sweep as sweep_mod
    t_phase = time.perf_counter()
    on_card = device == 'cuda'
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    layers = ENC_FULL['layers']
    report = {'card': card}
    home = root / 'mp_data'
    # 5 steps of B=64 an epoch, 2 dev batches: the phase stays near phase 15's 90 s
    # (its time is the ranks' start-up and their profiler traces)
    for split, n, trials, length in (('train', 1, 1, 600), ('dev', 1, 1, 400)):
        (home / split).mkdir(parents=True)
        for i in range(n):
            port.write_synthetic_subject(str(home / split / f'subject_{i}.b3d'),
                                         num_trials=trials, trial_length=length,
                                         seed=seed + 1600 + i + (10 if split == 'dev' else 0))
    bare = root / 'mp_train_only'             # no dev split: the trace holds the steps only
    (bare / 'train').mkdir(parents=True)
    shutil.copy(home / 'train' / 'subject_0.b3d', bare / 'train' / 'subject_0.b3d')
    wide_home = root / 'mp_wide'
    for split, n in (('train', 4), ('dev', 1)):
        (wide_home / split).mkdir(parents=True)
        for i in range(n):
            port.write_synthetic_subject(str(wide_home / split / f'subject_{i}.b3d'),
                                         num_trials=2, trial_length=1100,
                                         seed=seed + 1700 + i + (10 if split == 'dev' else 0))
    windows = lambda where: len(port.WindowDataset(  # noqa: E731
        str(where), window_size=50, stride=5, skip_loading_skeletons=True))
    steps = windows(bare / 'train') // small
    dev_b = windows(home / 'dev') // small
    pallas = ['--model-type', 'transformer', '--attn-impl', 'pallas', *size_flags]
    k3_shape = fe.plan_encoder_bwd(small, ENC_FULL['t'], ENC_FULL['d'],
                                   ENC_FULL['d'] * ENC_FULL['mlp_ratio'], ENC_FULL['heads']).shape

    def train_argv(ckpt, *more):
        return ['train', '--dataset-home', str(bare), '--checkpoint-dir', str(ckpt),
                '--device', device, '--batch-size', str(small), '--epochs', '1',
                '--seed', str(seed), *pallas, *more]

    def wide_sweep_argv(ckpt, *more):
        return ['sweep', '--dataset-home', str(wide_home), '--checkpoint-dir', str(ckpt),
                '--device', device, '--batch-size', str(wide), '--epochs', '1',
                '--seed', str(seed), '--no-wandb', '--lrs', '1e-3', '--seeds', '0', '1',
                '--device-data', 'sharded', *more]

    def sweep_argv(ckpt, *more):
        return ['sweep', '--dataset-home', str(home), '--checkpoint-dir', str(ckpt),
                '--device', device, '--batch-size', str(small), '--epochs', '2',
                '--seed', str(seed), '--no-wandb', '--lrs', '1e-4', '3e-4', '--seeds', '0', '1',
                '--pbt-every', '1', *pallas, *more]

    # -- the one-process references -------------------------------------------
    made, undo = _captured_states([loop_mod])
    try:
        port.run_training(port.parser().parse_args(train_argv(root / 'mp_one')))
    finally:
        undo()
    np.savez(root / 'mp_one.npz', **{k: v.detach().float().cpu().numpy()
                                     for k, v in made[-1].model.state_dict().items()})
    dispatches, undo = _timed_dispatches(sweep_mod, sync)
    try:
        _check(port_main(sweep_argv(root / 'sw_one')) == 0, 'the one-process sweep')
    finally:
        undo()
    one_ms = _step_ms(dispatches)

    def pp_argv(ckpt, *more):
        return ['train', '--dataset-home', str(home), '--checkpoint-dir', str(ckpt),
                '--device', device, '--batch-size', str(small), '--epochs', '1',
                '--seed', str(seed), '--model-type', 'transformer', '--device-data', 'off',
                *size_flags, *more]

    pp_one = port.run_training(port.parser().parse_args(pp_argv(root / 'pp_one')))
    pp_one_train = {k: float(np.mean(v)) for k, v in pp_one.final_train_metrics.items()}

    # -- 16a-d. four commands on two ranks under torchrun ----------------------
    out = root / 'mp_ranks'
    jobs = [dict(fn='train', argv=train_argv(root / 'mp_ckpt', '--model-parallel', '2'),
                 home=str(bare), device=device, one=str(root / 'mp_one.npz')),
            dict(fn='sweep', argv=wide_sweep_argv(root / 'sw_1d'), device=device),
            dict(fn='sweep', argv=sweep_argv(root / 'sw_two', '--shard-configs'), device=device,
                 trace=on_card),
            dict(fn='pipeline', argv=pp_argv(root / 'pp_ckpt', '--pipeline-parallel', '2'),
                 device=device)]
    torchrun_s, ranks = _rank_jobs_run(out, jobs, 2, on_card, root)
    report['train_pp2'] = _pipeline_report(port, ranks, pp_one_train, home, root, windows,
                                           small, device, card, size_flags)

    # 16a. train --model-parallel 2
    r0, r1 = ranks[0][0], ranks[1][0]
    for r in (r0, r1):
        _check(r['steps'] == steps, f'--model-parallel 2 rank steps {r["steps"]}, want {steps}')
        _check(r['differs'] is None, f'--model-parallel 2: {r["differs"]} differs from one '
                                     f'process')
        if on_card:
            _check_traced(r['traced'], layers, steps, 0, k3_shape, '--model-parallel 2 rank')
            _check(r['launches'] == dict(k2=layers * steps,
                                         k3=layers * fe.BWD_LAUNCHES_PER_LAYER * steps),
                   f'--model-parallel 2 wrapper launches {r["launches"]}')
        for name, sh in r['sharding'].items():
            _check(sh['gathered_bitwise'], f'sharding_rules {name}: the gather differs')
    report['train_mp2'] = dict(steps=steps, batch=small, bitwise_one_process=True,
                               traced=r0['traced'], launches=[r0['launches'], r1['launches']],
                               busy_us=[r0['busy_us'], r1['busy_us']], sharding=r0['sharding'])
    print(f'[model-parallel] train --model-parallel 2 on two gloo ranks, pallas full width '
          f'B={small}, {steps} steps step by step ({card}): both ranks bitwise the run in one '
          f'process in chunks of captured steps; traced kernels a rank {r0["traced"]} '
          f'({layers} K2 and {layers * fe.BWD_LAUNCHES_PER_LAYER} K3 a step); device busy '
          f'{r0["busy_us"]} us (rank 0) for the run', flush=True)
    for name, sh in r0['sharding'].items():
        print(f'[model-parallel] sharding_rules {name}: a rank of the model axis holds '
              f'{sh["shard_bytes"]} of the state\'s {sh["full_bytes"]} bytes (split: '
              f'{sh["split"]}); gathered back over the model group bitwise ({card})',
              flush=True)

    # 16b. sweep --shard-configs
    a = json.loads((root / 'sw_one' / 'sweep' / 'transformer' / 'sweep_results.json').read_text())
    b = json.loads((root / 'sw_two' / 'sweep' / 'transformer' / 'sweep_results.json').read_text())
    _check(a['pbt_events'] == b['pbt_events'] and len(a['pbt_events']) == 1,
           f'sharded sweep PBT events {b["pbt_events"]} against {a["pbt_events"]}')
    for i, (p, q) in enumerate(zip(a['points'], b['points'])):
        _check(p['dev_curve'] == q['dev_curve'] and p['final_train_loss'] ==
               q['final_train_loss'] and p['final_learning_rate'] == q['final_learning_rate'],
               f'sharded sweep config {i}: {q["dev_curve"]} against {p["dev_curve"]}')
        verdict = _compare_final(torch, Path(p['checkpoint_path']).parent,
                                 Path(q['checkpoint_path']).parent, 1)
        _check(verdict['bitwise'], f'sharded sweep config {i}: {verdict["verdict"]}')
    entry = dict(configs=4, steps_per_epoch=steps, epochs=2, dev_batches=dev_b,
                 pbt_events=b['pbt_events'], bitwise_one_process=True,
                 torchrun_seconds=torchrun_s, one_process_step_ms=one_ms)
    if on_card:
        swept = [r[2] for r in ranks]
        for r, got in enumerate(swept):
            _check(got['rc'] == 0, f'traced sweep rank {r}: exit {got["rc"]}')
            # two configs a rank: 8 K2 and 24 K3 a step, 8 K2 a dev batch (2 evals)
            _check_traced(got['traced'], 2 * layers, 2 * steps, 2 * dev_b, k3_shape,
                          f'sharded sweep rank {r}')
        entry.update(traced=[g['traced'] for g in swept],
                     rank_step_ms=[_step_ms(g['dispatches']) for g in swept],
                     busy_us=[g['busy_us'] for g in swept])
    report['sweep_shard_configs'] = entry
    print(f'[model-parallel] IB_MULTIHOST=gloo torchrun --nproc-per-node 2 sweep '
          f'--shard-configs --pbt-every 1, pallas K=4 at B={small}, 2 epochs of {steps} '
          f'steps ({card}): bitwise the one-process K=4 sweep (dev curves, losses, PBT event '
          f'{b["pbt_events"]}, final checkpoints); traced kernels by rank '
          f'{entry.get("traced")} (8 K2 and 24 K3 a step, 8 K2 a dev batch); a step '
          f'{entry.get("rank_step_ms")} ms by rank (host clock, synchronised, two configs) '
          f'against {one_ms:.3f} ms in one process (four configs), both in chunks of captured '
          f'steps; the three commands\' torchrun {torchrun_s:.1f} s with start-up', flush=True)

    # 16c. the 2-D (config, data) layout on four ranks against the 1-D sweep
    torchrun4_s, ranks4 = _rank_jobs_run(root / 'mp_ranks4', [dict(
        fn='sweep', argv=wide_sweep_argv(root / 'sw_2d', '--shard-configs'), device=device)],
        4, on_card, root)
    one_d = json.loads((root / 'sw_1d' / 'sweep' / 'feedforward' / 'sweep_results.json')
                       .read_text())
    two_d = json.loads((root / 'sw_2d' / 'sweep' / 'feedforward' / 'sweep_results.json')
                       .read_text())
    for i, (p, q) in enumerate(zip(one_d['points'], two_d['points'])):
        _check(p['dev_curve'] == q['dev_curve'] and p['final_train_loss'] ==
               q['final_train_loss'], f'2-D config {i}: {q["dev_curve"]} against the 1-D '
                                      f'{p["dev_curve"]}')
        verdict = _compare_final(torch, Path(p['checkpoint_path']).parent,
                                 Path(q['checkpoint_path']).parent, 0)
        _check(verdict['bitwise'], f'2-D config {i}: {verdict["verdict"]}')
    k1_2d, k1_1d = [r[0]['k1'] for r in ranks4], [r[1]['k1'] for r in ranks]
    wide_dev_b = windows(wide_home / 'dev') // wide
    if on_card:
        _check(all(r[0]['rc'] == 0 for r in ranks4) and k1_2d == [wide_dev_b] * 4
               and k1_1d == [2 * wide_dev_b] * 2,
               f'sweeps: K1 launches by rank {k1_2d} (2-D) and {k1_1d} (1-D), want '
               f'{wide_dev_b} a config a rank')
    report['sweep_2d'] = dict(configs=2, layout='2 config x 2 data', batch=wide,
                              k1_launches_by_rank=k1_2d, k1_launches_1d=k1_1d,
                              dev_curves=[q['dev_curve'] for q in two_d['points']],
                              torchrun_seconds=torchrun4_s)
    print(f'[model-parallel] sweep --device-data sharded --shard-configs on four gloo ranks '
          f'(config 2 x data 2), feedforward K=2 at B={wide} ({card}): bitwise the 1-D '
          f'sharded sweep on two ranks (dev curves, losses, final checkpoints); K1 {k1_2d} '
          f'launches by rank in the dev evals ({wide_dev_b} dev batches, one config a rank), '
          f'the 1-D ranks {k1_1d}; torchrun --nproc-per-node 4 {torchrun4_s:.1f} s with '
          f'start-up', flush=True)
    report['seconds'] = time.perf_counter() - t_phase
    print(f'[model-parallel] phase 16 took {report["seconds"]:.1f} s ({card})', flush=True)
    return report


# 17. inference and serving extras. The int8 forward on the card against the
# same forward on the CPU: both sum in int32 exactly and divide and multiply
# in IEEE f32, so they differ only where the sigmoid between layers rounds
# an activation one ulp apart and that moves an activation's int8 rounding
# (or a row's scale); such a flip moves an output by a quantisation step of
# the layer's input (the row's scale) times a weight. INT8_STEPS of the
# head's own steps bound a few flips. Against the f32 plain forward the
# JAX suite's bound: 5% of the output's range (tests/test_quant.py).
INT8_STEPS = 4
INT8_F32_REL = 5e-2
# save-prediction-csv through K1 against the plain version: a force share
# within this of the 0.3 rule may fall on either side of it
SHARE_TIE = 2e-2


def _op_vs_direct_us(torch, fm, library, device, gen, n=500):
    """Host microseconds a call of K1 at B=1 through the ``ib_torch::
    fused_mlp`` operator and directly (``fused_mlp_forward``), each the
    better of two runs of ``n`` calls ended by a synchronize (direct, op,
    op, direct); the two outputs are bitwise equal."""
    packed = fm.pack_mlp_params(_random_params(torch, FULL_DIMS, gen), device)
    x = torch.randn(1, FULL_DIMS[0], generator=gen).to(device)
    fns = {'direct': lambda: fm.fused_mlp_forward(x, packed, 'sigmoid'),
           'op': lambda: library.mlp(x, packed, 'sigmoid')}
    _check(torch.equal(fns['direct'](), fns['op']()), 'K1 through the operator != direct')
    sync = torch.cuda.synchronize if device == 'cuda' else (lambda: None)
    us = {}
    for name in ('direct', 'op', 'op', 'direct'):
        fns[name]()
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fns[name]()
        sync()
        us[name] = min(us.get(name, float('inf')), (time.perf_counter() - t0) / n * 1e6)
    return us


def phase_inference(torch, port, fm, fe, fg, root, seed, card, data=None, device='cuda'):
    """17. ``serve`` and ``analyze --quantize int8``, ``export`` through K1 /
    K2 / K4 and loaded back, the diffusion chain's export, the custom op's
    dispatch against the direct call, ``save-prediction-csv`` and the
    ``Predictor``, at full width on seeded random weights. ``data``: a
    dataset home of at least 4096 windows (phase 4's), else written here."""
    t_phase = time.perf_counter()
    root = root / 'inference'
    root.mkdir()
    if data is None:
        data = root / 'data'
        data.mkdir()
        for s in range(2):
            port.write_synthetic_subject(str(data / f'subject_{s}.b3d'), num_trials=2,
                                         trial_length=1100, seed=seed + s)
    ds = port.WindowDataset(str(data), window_size=50, stride=5, skip_loading_skeletons=True)
    _check(len(ds) >= 4096, f'only {len(ds)} windows')
    ck = root / 'ckpt'
    cfgs = {}
    for name, flags in (('feedforward', []),
                        ('transformer', ['--model-type', 'transformer', '--attn-impl', 'pallas']),
                        ('groundlink', ['--model-type', 'groundlink'])):
        cfgs[name] = port.config_from_args(port.parser().parse_args(['train', *flags]))
        port.save_checkpoint(str(ck / name), port.build_model_for_dataset(
            cfgs[name], ds, generator=torch.Generator().manual_seed(seed + 170), device=device),
            1, 0)
    cfg = cfgs['feedforward']
    modules = (fm, fe, fg)
    on = int(device == 'cuda')      # a CPU rehearsal runs the plain versions: no launch

    def counted(fn):
        """``fn()``'s result and the K1 / K2 / K4 launches it made (counts
        set to 0 just before, read just after)."""
        for m in modules:
            m.launches = 0
        out = fn()
        return out, [m.launches for m in modules]

    def on_card(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    report = {}
    # a. serve --quantize int8
    cpu_model = port.load_model(cfg, ds, str(ck / 'feedforward'), device='cpu')[0]
    qcpu = port.quantized_feedforward_forward(cpu_model)
    layers = port.quantize_feedforward_params(cpu_model.layer_params())
    act = fm.ACTIVATIONS[cfg.activation]
    w_head = float(layers[-1].w_q.abs().max()) * float(layers[-1].s_w.max())
    x4096 = ds.gather(np.arange(4096)).inputs
    with torch.no_grad():
        h = torch.from_numpy(x4096).reshape(4096, -1)
        for layer in layers[:-1]:
            h = act(port.qdense(h, layer.w_q, layer.s_w, layer.b))
        head_step = float(h.abs().amax(-1).max()) / 127.0   # the head's largest input step
        want_q = {k: v.numpy() for k, v in qcpu(torch.from_numpy(x4096)).items()}
        f32 = fm.mlp_reference(torch.from_numpy(x4096).reshape(4096, -1),
                               cpu_model.layer_params(), cfg.activation, torch.float32)
        want_f32 = {k: v.numpy() for k, v in port.slice_output_heads(f32, 2, 1).items()}
    q_limit = INT8_STEPS * head_step * w_head
    (svc, server, url), launches = counted(lambda: _serve(port, [
        'serve', '--dataset-home', str(data), '--checkpoint-dir', str(ck), '--port', '0',
        '--device', device, '--quantize', 'int8', '--warmup']))
    try:
        s = _get(url + '/schema')
        _check(s['quantize'] == 'int8' and s['device'].startswith(device), f'/schema {s}')
        for m in modules:
            m.launches = 0
        errs, moved = {}, {}
        body1 = json.dumps({'inputs': x4096[:1].tolist()}).encode()
        body4096 = _b64_body(x4096)
        for b, body in ((1, body1), (4096, body4096)):
            got = _decode(_post(url + '/predict', body)['outputs'])
            errs[b] = _agree({k: v.tolist() for k, v in got.items()},
                             {k: v[:b] for k, v in want_q.items()},
                             f'int8 /predict B={b} vs the CPU int8 forward', atol=q_limit)
            moved[b] = sum(int((got[k] != want_q[k][:b]).sum()) for k in got)
            rng = {k: float(np.abs(v[:b]).max()) for k, v in want_f32.items()}
            worst = max(float(np.abs(got[k] - want_f32[k][:b]).max()) / max(rng[k], 1e-6)
                        for k in got)
            _check(worst <= INT8_F32_REL, f'int8 B={b}: {worst} of the f32 range')
            errs[f'f32 {b}'] = worst
        p50_b1 = _host_p50_ms(lambda: _post(url + '/predict', body1), 20)
        p50_b4096 = _host_p50_ms(lambda: _post(url + '/predict', body4096), 5)
        launches = [m.launches for m in modules] + launches
        _check(launches == [0] * 6, f'serve --quantize int8 launched K1/K2/K4 {launches}')
    finally:
        _stop(svc, server)
    report['serve_int8'] = dict(
        predict_p50_ms_b1=p50_b1, predict_p50_ms_b4096=p50_b4096,
        windows_per_sec_b4096=4096 / p50_b4096 * 1e3, max_abs_err_vs_cpu_int8=errs[4096],
        max_abs_err_vs_cpu_int8_b1=errs[1], limit_vs_cpu_int8=q_limit,
        elements_moved_vs_cpu_int8={str(b): v for b, v in moved.items()},
        rel_err_vs_f32={'1': errs['f32 1'], '4096': errs['f32 4096']})
    print(f'[inference] serve --quantize int8: /predict B=1 json p50 {p50_b1:.2f} ms, B=4096 '
          f'b64 p50 {p50_b4096:.1f} ms = {4096 / p50_b4096 * 1e3:.0f} windows/s; vs the CPU '
          f'int8 forward max abs err {errs[1]:.3g} (B=1) / {errs[4096]:.3g} (B=4096, '
          f'{moved[4096]} elements moved; limit {q_limit:.3g}), vs the f32 plain forward '
          f'{errs["f32 4096"]:.3g} of the range; no K1 launch ({card})', flush=True)

    # b. analyze --quantize int8 at B=1 and B=512, beside the unquantized command
    homes = {}
    for name, trials, length in (('b1', 1, 200), ('b512', 4, 512 + 51)):
        home = root / f'analyze_{name}'
        (home / 'train').mkdir(parents=True)
        (home / 'dev').mkdir()
        port.write_synthetic_subject(str(home / 'dev' / 'subject.b3d'), num_trials=trials,
                                     trial_length=length, seed=seed + 171)
        homes[name] = home
    analyzed = {}
    for name, batch in (('b1', 1), ('b512', 512)):
        for mode in ('int8', 'f32'):
            args = port.parser().parse_args([
                'analyze', '--dataset-home', str(homes[name]), '--checkpoint-dir', str(ck),
                '--no-wandb', '--device', device, '--batch-size', str(batch),
                *(['--quantize', 'int8'] if mode == 'int8' else [])])
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                result, launches = counted(lambda: port.analyze(args))  # noqa: B023
            dev = result['dev']
            forwards = -(-dev['windows'] // batch)
            _check(launches == ([0, 0, 0] if mode == 'int8' else [on * forwards, 0, 0]),
                   f'analyze {mode} B={batch}: launches {launches}')
            _check((mode == 'int8') == ('evaluating int8-quantized forward' in out.getvalue()),
                   f'analyze {mode}: output')
            analyzed[f'{mode} B={batch}'] = dict(
                windows=dev['windows'], seconds=dev['seconds'],
                windows_per_sec=dev['windows'] / dev['seconds'], summary=dev['summary'])
        q, f = analyzed[f'int8 B={batch}']['summary'], analyzed[f'f32 B={batch}']['summary']
        rel = abs(q['force_avg_err'] - f['force_avg_err']) / max(abs(f['force_avg_err']), 1e-30)
        _check(rel <= INT8_F32_REL, f'analyze B={batch}: int8 force error {rel} off the f32 one')
        analyzed[f'force_avg_err_rel B={batch}'] = rel
        print(f'[inference] analyze B={batch} ({analyzed[f"int8 B={batch}"]["windows"]} '
              f'windows): int8 {analyzed[f"int8 B={batch}"]["windows_per_sec"]:.1f} windows/s, '
              f'K1 {analyzed[f"f32 B={batch}"]["windows_per_sec"]:.1f} windows/s; force avg '
              f'err int8 {q["force_avg_err"]:.5g} vs {f["force_avg_err"]:.5g} ({rel:.3g} '
              f'relative), loss {q["loss"]:.5g} vs {f["loss"]:.5g} ({card})', flush=True)
    report['analyze_int8'] = analyzed

    # c. export through K1 / K2 / K4 (and the int8 forward), loaded back
    exported = {}
    for name, model_type, flags, module, per_call in (
            ('feedforward', 'feedforward', [], fm, 1),
            ('pallas', 'transformer', ['--model-type', 'transformer', '--attn-impl', 'pallas'],
             fe, ENC_FULL['layers']),
            ('groundlink', 'groundlink', ['--model-type', 'groundlink'], fg, 1),
            ('int8', 'feedforward', ['--quantize', 'int8'], None, 0)):
        path = root / f'{name}.pt2'
        args = port.parser().parse_args(['export', '--dataset-home', str(data),
                                         '--checkpoint-dir', str(ck), '--device', device,
                                         '--out', str(path), *flags])
        with contextlib.redirect_stdout(io.StringIO()):
            res = port.export(args)
        t0 = time.perf_counter()
        program = torch.export.load(str(path)).module()
        load_s = time.perf_counter() - t0
        model = port.load_model(cfgs[model_type], ds, str(ck / model_type), device=device)[0]
        eager = port.quantized_feedforward_forward(model) if name == 'int8' else model
        want_launches = [on * per_call if m is module else 0 for m in modules]
        for b in (1, 4096):
            x = on_card(ds.gather(np.arange(b)).inputs)
            with torch.no_grad():
                got, launches = counted(lambda: program(x))  # noqa: B023
                want = eager(x)
            _check(launches == want_launches,
                   f'export {name} B={b}: launches {launches}, want {want_launches}')
            _check(set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want),
                   f'export {name} B={b}: the loaded program != the eager forward')
        exported[name] = dict(export_seconds=res['seconds'], load_seconds=load_s,
                              artifact_bytes=res['sidecar']['artifact_bytes'],
                              launches_per_call=want_launches)
        print(f'[inference] export {name}: traced in {res["seconds"]:.2f} s, '
              f'{res["sidecar"]["artifact_bytes"]} bytes, loaded in {load_s:.2f} s; at B=1 '
              f'and 4096 K1/K2/K4 launches {want_launches} a call, bitwise the eager forward',
              flush=True)

    # the diffusion chain: --static-batch 2 --sample-steps 10 (the trace
    # unrolls every step), its seed at call time
    dflags = ['--model-type', 'diffusion', '--output-data-format', 'all_frames']
    dcfg = port.config_from_args(port.parser().parse_args(['train', *dflags]))
    dds = port.WindowDataset(str(data), window_size=50, stride=5, skip_loading_skeletons=True,
                             output_data_format='all_frames')
    port.save_checkpoint(str(ck / 'diffusion'), port.build_model_for_dataset(
        dcfg, dds, generator=torch.Generator().manual_seed(seed + 172), device=device), 1, 0)
    path = root / 'diffusion.pt2'
    args = port.parser().parse_args(['export', '--dataset-home', str(data), '--checkpoint-dir',
                                     str(ck), '--device', device, '--out', str(path), *dflags,
                                     '--static-batch', '2', '--sample-steps', '10'])
    with contextlib.redirect_stdout(io.StringIO()):
        res = port.export(args)
    program = torch.export.load(str(path)).module()
    model = port.load_model(dcfg, dds, str(ck / 'diffusion'), device=device)[0]
    chain = port.eval_forward(dcfg, model, str(ck / 'diffusion'), sample_steps=10)
    x = on_card(dds.gather(np.arange(2)).inputs)
    seed_t = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
    with torch.no_grad():
        a, b, c, want = (program(x, seed_t(7)), program(x, seed_t(7)), program(x, seed_t(8)),
                         chain(x, seed_t(7)))
    _check(all(torch.equal(a[k], b[k]) and torch.equal(a[k], want[k])
               and bool(torch.isfinite(a[k]).all()) for k in want),
           'exported diffusion chain: not bitwise the eager chain for one seed')
    _check(not all(torch.equal(a[k], c[k]) for k in a), 'exported chain: seeds 7 and 8 agree')
    exported['diffusion (static batch 2, 10 steps)'] = dict(
        export_seconds=res['seconds'], artifact_bytes=res['sidecar']['artifact_bytes'])
    print(f'[inference] export diffusion --static-batch 2 --sample-steps 10: traced in '
          f'{res["seconds"]:.2f} s, {res["sidecar"]["artifact_bytes"]} bytes; seed 7 twice '
          f'bitwise, bitwise the eager chain, seed 8 differs', flush=True)
    report['export'] = exported

    # d. one K1 call through the custom operator against the direct call
    us = _op_vs_direct_us(torch, fm, port.library, device,
                          torch.Generator().manual_seed(seed + 173))
    report['k1_call_us'] = us
    print(f'[inference] K1 at B=1, host us a call: direct {us["direct"]:.1f}, through '
          f'ib_torch::fused_mlp {us["op"]:.1f} ({card})', flush=True)

    # e. save-prediction-csv through K1 against --device cpu, the Predictor at 512
    subject = str(data / 'subject_0.b3d')
    rows, csv_launches = {}, None
    for dev in (device, 'cpu'):
        out = root / f'pred_{dev}.csv'
        argv = ['save-prediction-csv', '--file', subject, '--trial', '1', '--checkpoint-dir',
                str(ck), '--out', str(out), '--device', dev]
        with contextlib.redirect_stdout(io.StringIO()):
            _, launches = counted(lambda: port.main(argv))  # noqa: B023
        if dev == device:
            csv_launches = launches
        with open(out) as f:
            rows[dev] = list(csv.reader(f))
    got, want = (np.asarray(rows[d][1:], float) for d in (device, 'cpu'))
    _check(rows[device][0] == rows['cpu'][0] and got.shape == want.shape
           and np.array_equal(got[:, 0], want[:, 0]), 'save-prediction-csv: rows')
    n_rows = got.shape[0]
    _check(csv_launches == [on * -(-n_rows // 512), 0, 0],
           f'save-prediction-csv: launches {csv_launches} for {n_rows} windows')
    fds = port.WindowDataset(subject, window_size=50, stride=5, skip_loading_skeletons=True)
    predictors = {dev: port.Predictor(cfg, str(ck / 'feedforward'), fds, device=dev)
                  for dev in (device, 'cpu')}
    predictors[device].predict_trial(0, 0)
    t0 = time.perf_counter()
    pred, launches = counted(lambda: predictors[device].predict_trial(0, 0, batch_size=512))
    seconds = time.perf_counter() - t0
    n = pred.window_starts.size
    _check(launches == [on * -(-n // 512), 0, 0], f'Predictor: launches {launches} for {n}')
    # the CSV's trial through K1 and through the plain version: each body's
    # force share, and the rows where one lies within SHARE_TIE of the 0.3
    # rule (K1's ATOL on the forces may flip the rule there)
    shares = {}
    for dev, p in predictors.items():
        f = p.predict_trial(0, 1).outputs['groundContactForceInRootFrame'][:, -1, :]
        mags = np.linalg.norm(f.reshape(-1, 2, 3), axis=-1)
        shares[dev] = mags / (mags.sum(axis=1, keepdims=True) + 1e-9)
    near = (np.abs(shares[device] - 0.3) <= SHARE_TIE).any(1) | \
        (np.abs(shares['cpu'] - 0.3) <= SHARE_TIE).any(1)
    _check(near.size == n_rows and np.array_equal((shares[device] > 0.3)[~near],
                                                  (shares['cpu'] > 0.3)[~near]),
           'save-prediction-csv: the 0.3 rule decided otherwise away from a tie')
    # K1 against its plain version: ATOL on the CoPs and forces, so the arrow
    # tip (CoP + 0.001 F mass) within ATOL (1 + 0.001 mass); a row near a tie
    # on its CoPs only
    mass = fds.subjects[0].getMassKg()
    limit = np.tile([ATOL] * 3 + [ATOL * (1 + 1e-3 * mass)] * 3, 2) + 1e-6
    err = np.abs(got[:, 1:] - want[:, 1:])
    cops = np.tile([True] * 3 + [False] * 3, 2)
    _check((err[~near] <= limit).all() and (err[:, cops] <= limit[cops]).all(),
           f'save-prediction-csv: rows off the --device cpu rows by {err.max(axis=0)}')
    report['save_prediction_csv'] = dict(rows=n_rows, launches=csv_launches[0],
                                         rows_near_tie=int(near.sum()),
                                         max_abs_err=float(err[~near].max()))
    report['predictor'] = dict(windows=n, seconds=seconds, windows_per_sec_b512=n / seconds,
                               launches=launches[0])
    print(f'[inference] save-prediction-csv: {n_rows} rows, K1 {csv_launches[0]} launches, '
          f'against --device cpu max abs err {float(err[~near].max()):.3g} ({int(near.sum())} '
          f'rows with a force share within {SHARE_TIE} of the 0.3 rule, held on their CoPs); '
          f'Predictor at batch 512: {n} windows in {seconds * 1e3:.1f} ms = '
          f'{n / seconds:.0f} windows/s ({card})', flush=True)
    report['checkpoints'] = str(ck)     # phase 18 serves them again
    report['seconds'] = time.perf_counter() - t_phase
    return report


# 18. the viewer commands on the card against the same commands on the CPU.
# FK runs in float32 on both devices and both round it to 4 decimals, so a
# value may round to the neighbouring decimal; the predictions are held at
# each kernel's served-answer tolerance (K1 ATOL, K2 HEAD_REL x the output's
# largest value, K4 GL_REL x its output vector's), a frame with a force
# share within SHARE_TIE of the 0.3 rule on its CoPs only; a window whose
# loss lies within LOSS_REL of threshold_ratio x its trial's mean may be
# suspicious on one side only (the band's windows are left out of the
# comparison of review-file's rows and counted).
FK_ATOL = 1.5e-4
LOSS_REL = 2e-2
REVIEW_RATIO = 1.25         # random weights: 3 x the mean flags no window
VIEWER_TICKS = 200
TICK_INTERVAL_MS = 40.0     # viz/live.py: LiveViewerServer's tick_interval
VIEWER_MODELS = (           # name, model type, flags, K1 / K2 / K4, launches a forward
    ('feedforward', 'feedforward', [], 0, 1),
    ('pallas', 'transformer', ['--model-type', 'transformer', '--attn-impl', 'pallas'], 1,
     ENC_FULL['layers']),
    ('groundlink', 'groundlink', ['--model-type', 'groundlink'], 2, 1))
TETRA_OBJ = 'v 0 0 0\nv 0.1 0 0\nv 0 0.1 0\nv 0 0 0.1\nf 1 2 3\nf 1 2 4\nf 1 3 4\nf 2 3 4\n'


def _html_payload(path: Path) -> dict:
    """The frames a viewer HTML carries (``viz/viewer.py``'s template)."""
    return json.loads(path.read_text().split('const DATA = ', 1)[1].split(';\nconst cv', 1)[0])


def _pred_limits(name: str, outputs: dict) -> tuple:
    """(CoP, force) tolerance of a viewer's predictions, from the CPU
    Predictor's ``outputs`` of the trial."""
    key_c, key_f = ('groundContactCenterOfPressureInRootFrame',
                    'groundContactForceInRootFrame')
    if name == 'feedforward':
        return ATOL, ATOL
    if name == 'pallas':
        return tuple(HEAD_REL * float(np.abs(outputs[k]).max()) for k in (key_c, key_f))
    lim = GL_REL * max(float(np.abs(v).max()) for v in outputs.values())
    return lim, lim


def _fk_err(got: dict, want: dict, what: str) -> float:
    _check(set(got) == set(want) and bool(want), f'{what}: bodies {sorted(got)}')
    return max(float(np.abs(np.asarray(got[b][k]) - np.asarray(want[b][k])).max())
               for b in want for k in ('R', 'p'))


def _pred_errs(got: dict, want: dict) -> tuple:
    """Max abs difference of the predicted CoPs, of the forces, and which
    bodies' forces are zero on one side only."""
    gc, gf, wc, wf = (np.array([x[j] for x in p['pred_forces']])
                      for p, j in ((got, 0), (got, 1), (want, 0), (want, 1)))
    return (float(np.abs(gc - wc).max()), float(np.abs(gf - wf).max()),
            bool(((gf == 0) != (wf == 0)).any()))


def _hold_viewer_payload(got: dict, want: dict, limits: tuple, near: set, what: str) -> dict:
    """The card's viewer payload against the CPU's (see the constants
    above); returns the largest differences."""
    _check(got['dt'] == want['dt'] and len(got['frames']) == len(want['frames'])
           and bool(want.get('meshes')) and got.get('meshes') == want['meshes'],
           f'{what}: payload shape or meshes')
    worst = dict(fk=0.0, cop=0.0, force=0.0, predicted_frames=0)
    for i, (g, w) in enumerate(zip(got['frames'], want['frames'])):
        for k in ('joints', 'bones', 'label_forces', 'missing_grf', 'root_vel', 'root_history'):
            _check(g[k] == w[k], f'{what}: frame {i} {k}')
        worst['fk'] = max(worst['fk'], _fk_err(g['bodies'], w['bodies'], f'{what} frame {i}'))
        _check(('pred_forces' in g) == ('pred_forces' in w), f'{what}: frame {i} predicted')
        if 'pred_forces' in w:
            worst['predicted_frames'] += 1
            cop, force, flipped = _pred_errs(g, w)
            worst['cop'] = max(worst['cop'], cop)
            if i not in near:
                _check(not flipped, f'{what}: frame {i}: the 0.3 rule decided otherwise')
                worst['force'] = max(worst['force'], force)
    _check(worst['fk'] <= FK_ATOL and worst['cop'] <= limits[0] and worst['force'] <= limits[1],
           f'{what}: {worst} against FK {FK_ATOL}, predictions {limits}')
    return worst


def _review_rows(path: Path) -> list:
    with open(path) as f:
        rows = list(csv.reader(f))
    _check(rows[0] == ['trial', 'segment_start', 'segment_end', 'state', 'mean_loss'],
           f'{path.name}: header {rows[0]}')
    return [(int(r[0]), int(r[1]), int(r[2]), r[3], float(r[4])) for r in rows[1:]]


def _hold_review_rows(got: list, want: list, preds: dict, trials: int, what: str) -> dict:
    """review-file's rows on the card against the CPU's: which windows are
    suspicious, away from the ratio x mean band, and the mean losses of the
    segments both found."""
    near_windows = 0
    for trial in range(trials):
        card, cpu = (preds[side].predict_trial(0, trial) for side in ('card', 'cpu'))
        loss, cpu_loss = card.per_window_loss, cpu.per_window_loss
        _check(np.allclose(loss, cpu_loss, rtol=LOSS_REL, atol=1e-6),
               f'{what}: trial {trial} window losses off the CPU\'s')
        near = np.zeros(loss.size, bool)
        for pw in (loss, cpu_loss):
            near |= np.abs(pw - REVIEW_RATIO * pw.mean()) <= LOSS_REL * REVIEW_RATIO * pw.mean()
        near_windows += int(near.sum())
        flags = []
        for rows in (got, want):
            f = np.zeros(loss.size, bool)
            for t, start, end, _, _ in rows:
                if t == trial:
                    f |= (cpu.last_frame >= start) & (cpu.last_frame < end)
            flags.append(f[~near])
        _check(np.array_equal(*flags), f'{what}: trial {trial} suspicious windows differ')
    common = {r[:3] for r in got} & {r[:3] for r in want}
    by_key = [{r[:3]: r[4] for r in rows} for rows in (got, want)]
    worst = max([abs(by_key[0][k] - by_key[1][k]) / abs(by_key[1][k]) for k in common] or [0.0])
    _check(worst <= LOSS_REL and {r[3] for r in got} <= {'WIP'},
           f'{what}: segment mean losses {worst} relative')
    return dict(rows=len(got), cpu_rows=len(want), common_rows=len(common),
                windows_near_threshold=near_windows, max_rel_err_mean_loss=worst)


def _ws_frames(port_number: int, n: int, ws, timeout: float = 20.0) -> list:
    """A WebSocket client on the loopback port: the handshake, then the
    first ``n`` text messages (the init and frames)."""
    import socket
    c = socket.create_connection(('127.0.0.1', port_number), timeout=timeout)
    try:
        c.sendall(b'GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: '
                  b'Upgrade\r\nSec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n'
                  b'Sec-WebSocket-Version: 13\r\n\r\n')
        buf = b''
        while b'\r\n\r\n' not in buf:
            buf += c.recv(4096)
        head, buf = buf.split(b'\r\n\r\n', 1)
        _check(b' 101 ' in head.split(b'\r\n')[0]
               and ws.accept_key('dGhlIHNhbXBsZSBub25jZQ==').encode() in head,
               f'WebSocket handshake: {head[:80]!r}')
        msgs, deadline = [], time.time() + timeout
        while len(msgs) < n and time.time() < deadline:
            got, buf = ws.decode_frames(buf)
            msgs.extend(json.loads(p) for op, p in got if op == ws.OP_TEXT)
            if len(msgs) < n:
                buf += c.recv(65536)
        c.sendall(ws.encode_client_frame(b'', opcode=ws.OP_CLOSE))
    finally:
        c.close()
    _check(len(msgs) >= n, f'WebSocket: {len(msgs)} of {n} messages')
    return msgs[:n]


def phase_viewer(torch, port, fm, fe, fg, root, seed, card, data=None, ck=None,
                 device='cuda', trial_length=1100, ticks=VIEWER_TICKS):
    """18. The viewer commands at full width on seeded random weights (phase
    17's checkpoints ``ck`` where given): for feedforward (K1), the ``pallas``
    transformer (K2) and GroundLink (K4), ``visualize-file`` of a trial of
    ``data``'s subject 0 (else one written here) with a Geometry folder of
    small meshes, held against the same command with ``--device cpu``;
    ``ticks`` live ticks (``visualize``'s session: B=1 forward, the loss
    evaluator, FK) timed, the first five against the CPU session's; the
    ``visualize-file --live`` server answering a WebSocket client; and
    ``review-file`` against its rows from the CPU Predictor. ``device`` 'cpu'
    with shorter trials rehearses it (no launch counts)."""
    t_phase = time.perf_counter()
    root = root / 'viewer'
    root.mkdir()
    if data is None:
        data = root / 'data'
        data.mkdir()
        port.write_synthetic_subject(str(data / 'subject_0.b3d'), num_trials=2,
                                     trial_length=trial_length, seed=seed)
    subject = data / 'subject_0.b3d'
    geom = root / 'Geometry'
    geom.mkdir()
    for name in ('pelvis', 'femur', 'tibia', 'talus', 'calcn', 'toes', 'torso'):
        (geom / f'{name}.obj').write_text(TETRA_OBJ)
    ds = port.WindowDataset(str(subject), window_size=50, stride=5, skip_loading_skeletons=True)
    if ck is None:
        ck = root / 'ckpt'
        for _, model_type, flags, _, _ in VIEWER_MODELS:
            cfg = port.config_from_args(port.parser().parse_args(['train', *flags]))
            port.save_checkpoint(str(ck / model_type), port.build_model_for_dataset(
                cfg, ds, generator=torch.Generator().manual_seed(seed + 170), device=device),
                1, 0)
    trials = ds.subjects[0].getNumTrials()
    win = np.nonzero((ds.win_subject == 0) & (ds.win_trial == 0))[0]
    n_trial = {t: int(((ds.win_subject == 0) & (ds.win_trial == t)).sum()) for t in range(trials)}
    modules = (fm, fe, fg)
    on = int(device == 'cuda')      # a CPU rehearsal runs the plain versions: no launch
    sides = (('card', device), ('cpu', 'cpu'))

    def counted(fn):
        for m in modules:
            m.launches = 0
        out = fn()
        return out, [m.launches for m in modules]

    report = dict(frames=ds.subjects[0].getTrialLength(0), windows=n_trial[0],
                  trials=trials, ticks=ticks)
    for name, model_type, flags, mi, per_forward in VIEWER_MODELS:
        def launches_of(forwards):
            return [on * per_forward * forwards if i == mi else 0 for i in range(3)]  # noqa: B023

        cfg = port.config_from_args(port.parser().parse_args(['train', *flags]))
        preds = {side: port.Predictor(cfg, str(ck / model_type), ds, device=dev)
                 for side, dev in sides}
        cpu = preds['cpu']
        cpu.predict_trial = functools.lru_cache()(cpu.predict_trial)   # each trial once
        rec = {}
        # a. visualize-file: the static payload on the card and on the CPU
        payloads = {}
        for side, dev in sides:
            out = root / f'{name}_{side}.html'
            argv = ['visualize-file', '--file', str(subject), '--trial', '0', '--checkpoint-dir',
                    str(ck), '--geometry-folder', str(geom), '--out', str(out), '--device', dev,
                    *flags]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc, launches = counted(lambda: port.main(argv))  # noqa: B023
            rec[f'command_seconds_{side}'] = time.perf_counter() - t0
            _check(rc == 0, f'visualize-file {name} --device {dev}: rc {rc}')
            if side == 'card':
                forwards = -(-n_trial[0] // 512)
                _check(launches == launches_of(forwards),
                       f'visualize-file {name}: launches {launches} for {n_trial[0]} windows')
                rec['payload_launches'] = launches[mi]
            payloads[side] = _html_payload(out)
        t0 = time.perf_counter()
        port.build_viz_payload(ds, 0, 0, preds['card'], geometry_folder=str(geom))
        rec['build_payload_seconds'] = time.perf_counter() - t0
        shares = {}
        for side, p in preds.items():
            f = p.predict_trial(0, 0).outputs['groundContactForceInRootFrame'][:, -1, :]
            mags = np.linalg.norm(f.reshape(len(f), -1, 3), axis=-1)
            shares[side] = mags / (mags.sum(axis=1, keepdims=True) + 1e-9)
        near = ((np.abs(shares['card'] - 0.3) <= SHARE_TIE).any(1)
                | (np.abs(shares['cpu'] - 0.3) <= SHARE_TIE).any(1))
        near_frames = {int(fr) for fr in cpu.predict_trial(0, 0).last_frame[near]}
        limits = _pred_limits(name, cpu.predict_trial(0, 0).outputs)
        rec['payload_vs_cpu'] = _hold_viewer_payload(payloads['card'], payloads['cpu'], limits,
                                                     near_frames, f'visualize-file {name}')
        rec['payload_vs_cpu'].update(frames_near_tie=len(near_frames), limits=list(limits))

        # b. the live session of visualize: a B=1 forward, the evaluator and FK a tick
        sessions = {side: port.build_live_session(
            ds, preds[side], port.RegressionLossEvaluator('dev', port.loss_config_from(cfg)),
            window_indices=win, geometry_folder=str(geom))[0] for side, _ in sides}
        tick_ms, first = [], []
        with contextlib.redirect_stdout(io.StringIO()):
            for m in modules:
                m.launches = 0
            for _ in range(ticks):
                t0 = time.perf_counter()
                packet = sessions['card'].tick()
                tick_ms.append((time.perf_counter() - t0) * 1e3)
                if len(first) < 5:
                    first.append(packet)
            live_launches = [m.launches for m in modules]
            cpu_first = [sessions['cpu'].tick() for _ in range(5)]
        _check(live_launches == launches_of(ticks),
               f'live {name}: launches {live_launches} for {ticks} ticks')
        worst = dict(fk=0.0, cop=0.0, force=0.0, running_loss=0.0)
        for g, w in zip(first, cpu_first):
            for k in ('frame', 'joints', 'root_vel', 'root_history', 'label_forces', 'subject'):
                _check(g[k] == w[k], f'live {name}: tick {w["frame"]} {k}')
            worst['fk'] = max(worst['fk'], _fk_err(g['bodies'], w['bodies'], f'live {name}'))
            cop, force, _ = _pred_errs(g, w)
            worst['cop'], worst['force'] = max(worst['cop'], cop), max(worst['force'], force)
            loss, cpu_loss = (float(p['hud'].split(': ')[1]) for p in (g, w))
            worst['running_loss'] = max(worst['running_loss'],
                                        abs(loss - cpu_loss) / max(abs(cpu_loss), 1e-6))
        _check(worst['fk'] <= FK_ATOL and worst['cop'] <= limits[0] + 1e-5
               and worst['force'] <= limits[1] and worst['running_loss'] <= LOSS_REL + 1e-3,
               f'live {name}: {worst} against {limits}')
        ms = sorted(tick_ms[1:])         # the first tick compiles nothing but warms caches
        rec['live'] = dict(tick_ms_p50=ms[len(ms) // 2], tick_ms_p99=ms[int(0.99 * (len(ms) - 1))],
                           tick_ms_max=ms[-1], interval_ms=TICK_INTERVAL_MS,
                           launches=live_launches[mi], launches_per_tick=live_launches[mi] / ticks,
                           vs_cpu_first_5=worst)

        # c. visualize-file --live: the server, answered by a WebSocket client
        servers = []
        block = port.LiveViewerServer.block
        port.LiveViewerServer.block = lambda self: servers.append(self)  # noqa: B023
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                for m in modules:
                    m.launches = 0
                rc = port.main(['visualize-file', '--file', str(subject), '--trial', '0',
                                '--live', '--port', '0', '--checkpoint-dir', str(ck),
                                '--geometry-folder', str(geom), '--device', device, *flags])
        finally:
            port.LiveViewerServer.block = block
        _check(rc == 0 and len(servers) == 1, f'visualize-file --live {name}: rc {rc}')
        try:
            msgs = _ws_frames(servers[0].port, 6, port.ws)
        finally:
            servers[0].stop()
            time.sleep(0.1)              # the tick thread's last tick ends
        served = [m.launches for m in modules]
        frames = msgs[1:]
        _check(msgs[0]['type'] == 'init' and set(msgs[0]['meshes']) == set(payloads['cpu']['meshes'])
               and all(m['type'] == 'frame' and 'pred_forces' in m and m['bodies'] for m in frames)
               and [m['frame'] for m in frames] == list(range(frames[0]['frame'],
                                                              frames[0]['frame'] + len(frames))),
               f'visualize-file --live {name}: messages')
        _check(served[mi] >= on * per_forward * len(frames) and served[mi] % per_forward == 0
               and sum(served) == served[mi], f'visualize-file --live {name}: launches {served}')
        rec['server'] = dict(frames_received=len(frames), launches=served[mi])

        # d. review-file on the card against its rows from the CPU Predictor
        rows = {}
        for side, dev in sides:
            out = root / f'{name}_{side}.review.csv'
            with contextlib.redirect_stdout(io.StringIO()):
                if side == 'card':
                    rc, launches = counted(lambda: port.main([  # noqa: B023
                        'review-file', '--file', str(subject), '--checkpoint-dir', str(ck),
                        '--threshold-ratio', str(REVIEW_RATIO), '--out-csv', str(out),  # noqa: B023
                        '--device', dev, *flags]))  # noqa: B023
                    forwards = sum(-(-n // 512) for n in n_trial.values())
                    _check(rc == 0 and launches == launches_of(forwards),
                           f'review-file {name}: rc {rc}, launches {launches}')
                    rec['review_launches'] = launches[mi]
                else:
                    port.review_segments(cpu, ds, str(out), REVIEW_RATIO)
            rows[side] = _review_rows(out)
        _check(bool(rows['cpu']), f'review-file {name}: no suspicious segment on the CPU')
        rec['review'] = _hold_review_rows(rows['card'], rows['cpu'], preds, trials,
                                          f'review-file {name}')
        report[name] = rec
        live_ = rec['live']
        print(f'[viewer] {name}: visualize-file {n_trial[0]} windows, {rec["payload_launches"]} '
              f'launches, command {rec["command_seconds_card"]:.2f} s (CPU '
              f'{rec["command_seconds_cpu"]:.2f} s), payload {rec["build_payload_seconds"]:.3f} s '
              f'warm; vs CPU: FK {rec["payload_vs_cpu"]["fk"]:.2g}, CoP '
              f'{rec["payload_vs_cpu"]["cop"]:.3g}, force {rec["payload_vs_cpu"]["force"]:.3g} '
              f'(limits {limits[0]:.3g} / {limits[1]:.3g}; {len(near_frames)} frames near the '
              f'0.3 tie); live tick p50 {live_["tick_ms_p50"]:.2f} ms, p99 '
              f'{live_["tick_ms_p99"]:.2f} ms against the {TICK_INTERVAL_MS:.0f} ms interval, '
              f'{live_["launches_per_tick"]:g} launches a tick; server {len(frames)} frames; '
              f'review-file {len(rows["card"])} / {len(rows["cpu"])} segments '
              f'({rec["review"]["windows_near_threshold"]} windows near the '
              f'{REVIEW_RATIO} x mean threshold), {rec["review_launches"]} launches ({card})',
              flush=True)
    report['seconds'] = time.perf_counter() - t_phase
    return report


def _trace_kernels(path, names=ENC_KERNELS) -> dict:
    """The GPU kernels of a Chrome trace that ``train --profile`` wrote,
    counted by the first of ``names`` their name holds ('other' for the
    rest), as :func:`_traced` counts a trace in this process."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    counts = dict.fromkeys((*names, 'other'), 0)
    for e in events:
        if e.get('cat') == 'kernel':
            counts[next((n for n in names if n in e.get('name', '')), 'other')] += 1
    return counts


def _same_state(torch, a: Path, b: Path, what: str) -> int:
    """The checkpoints in ``a`` and ``b``: the same (epoch, batch) labels and
    every tensor of each one's model and optimizer state bitwise equal;
    returns how many checkpoints were compared."""
    from inferbiomechanics_tpu_torch.train.checkpoint import list_checkpoints
    fa, fb = list_checkpoints(str(a)), list_checkpoints(str(b))
    _check([f[:2] for f in fa] == [f[:2] for f in fb] and len(fa) > 0,
           f'{what}: checkpoints {[f[:2] for f in fa]} against {[f[:2] for f in fb]}')
    for (_, _, x), (_, _, y) in zip(fa, fb):
        pa, pb = (torch.load(p, weights_only=True) for p in (x, y))
        for part in ('model_state_dict', 'optimizer_state_dict'):
            ta, tb = (list(_leaves(p[part])) for p in (pa, pb))
            _check(len(ta) == len(tb) > 0 and all(
                torch.equal(u, v) if torch.is_tensor(u) else u == v for u, v in zip(ta, tb)),
                f'{what}: {part} of {os.path.basename(x)} differs')
    return len(fa)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _csv_rows(path: Path) -> list:
    with open(path, newline='') as f:
        return list(csv.reader(f))


SANITY_LINE = re.compile(r'^(\S+): mean=(\S+) var=(\S+) min=(\S+) max=(\S+)$', re.M)


def phase_cli_extras(torch, port, fm, fe, fg, root, seed, card, device='cuda', batch=64,
                     subjects=4, trial_length=600, ff_flags=(), pallas_flags=()):
    """19. The last lifted flags and the small commands at full width on the
    defaults (feedforward 1770->512->512->30, the ``pallas`` transformer
    d=256, GroundLink), on ``subjects`` synthetic train subjects and one dev
    subject: (a) ``pickle-data``, then feedforward ``train --use-pickled``
    and ``train`` from the ``.b3d`` files, same flags and seed, bitwise equal,
    K1 once a dev batch, each run's log (the JSONL fallback, wandb hidden)
    with its git hash, for phase 20's ``plot-training``; (b) ``train --model-type transformer --attn-impl pallas
    --profile`` for one epoch at B=64 beside the same run unprofiled (before
    and after it): bitwise equal, the trace read back holding K3 12 x steps
    and K2 4 x (steps + dev forwards), its bytes, what ``--profile`` added;
    (c) ``analyze --plot-errors`` of feedforward (K1) and GroundLink (K4):
    the PNGs, the CSV rows of the run without the flag, a launch a batch;
    (d) ``sanity-check``, its statistics against the same ones computed in
    float64 on ``device`` (within the print's rounding and float32 sums).
    ``device`` 'cpu' with ``*_flags`` narrowing the models rehearses it (no
    launch counts, no kernels in the trace)."""
    t_phase = time.perf_counter()
    on = device == 'cuda'
    root = root / 'cli_extras'
    home, small = root / 'data', root / 'small'
    for where, split, n, length, first in (
            (home, 'train', subjects, trial_length, 1900), (home, 'dev', 1, trial_length, 1950),
            (small, 'train', 1, 400, 1960), (small, 'dev', 1, 400, 1970)):
        (where / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            port.write_synthetic_subject(str(where / split / f'subject_{i}.b3d'), num_trials=2,
                                         trial_length=length, seed=seed + first + i)
    geom = root / 'Geometry'
    geom.mkdir()
    report = {}

    def command(argv, cwd=None):
        """``python -m inferbiomechanics_tpu_torch <argv>`` in this process:
        (stdout, seconds)."""
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.chdir(cwd or os.getcwd()), contextlib.redirect_stdout(out):
            rc = port.main(argv)
        _check(rc == 0, f'{argv[0]}: exit {rc}\n{out.getvalue()[-2000:]}')
        return out.getvalue(), time.perf_counter() - t0

    def dataset(path, **kw):
        return port.WindowDataset(str(path), window_size=50, stride=5,
                                  skip_loading_skeletons=True, **kw)

    # (a) pickle-data, then --use-pickled against the .b3d files
    _, pickle_s = command(['pickle-data', '--dataset-home', str(home)])
    blocks = sorted((home / 'train_pickled').glob('*.npz'))
    train_ds, dev_ds = dataset(home / 'train'), dataset(home / 'dev')
    dev_batches, steps = len(dev_ds) // batch, len(train_ds) // batch
    _check(len(blocks) == 1 and dev_batches >= 2 and steps >= 16,
           f'{len(blocks)} blocks, {steps} steps, {dev_batches} dev batches')
    base = ['train', '--dataset-home', str(home), '--device', device, '--epochs', '1',
            '--seed', str(seed), '--batch-size', str(batch), '--geometry-folder', str(geom)]
    ff = {}
    # the run log goes to the JSONL fallback (wandb hidden: no wandb process),
    # under each run's own working directory inside the phase's
    real = sys.modules.get('wandb', False)
    sys.modules['wandb'] = None
    try:
        for name, more in (('pickled', ['--use-pickled']), ('b3d', [])):
            fm.launches = 0
            (root / f'run_{name}').mkdir()
            out, seconds = command([*base, *ff_flags, '--checkpoint-dir',
                                    str(root / f'ff_{name}'), *more], cwd=root / f'run_{name}')
            ff[name] = dict(k1=fm.launches, seconds=seconds)
            _check('Training done: 1 epochs' in out, f'train {name}: {out[-1000:]}')
            _check(fm.launches == dev_batches * on,
                   f'train {name}: K1 {fm.launches} launches, want one a dev batch '
                   f'({dev_batches})')
    finally:
        if real is False:
            sys.modules.pop('wandb', None)
        else:
            sys.modules['wandb'] = real
    n_ckpt = _same_state(torch, root / 'ff_pickled' / 'feedforward',
                         root / 'ff_b3d' / 'feedforward', '--use-pickled against .b3d')
    run_logs = [sorted((root / f'run_{name}' / 'outputs' / 'logs').glob('metrics_*.jsonl'))
                for name in ('pickled', 'b3d')]
    _check([len(logs) for logs in run_logs] == [1, 1], f'run logs {run_logs}')
    run_logs = [logs[0] for logs in run_logs]
    records = [[json.loads(line) for line in p.read_text().splitlines()] for p in run_logs]
    configs = [r[0].get('_config') for r in records]
    logged = [rec for r in records for rec in r[1:]]
    # a run: its config first, then the dev report, the logged losses, the
    # train report
    _check(all(c is not None for c in configs)
           and [c['use_pickled'] for c in configs] == [True, False]
           and all('git_hash' in c and c['logger'] == 'jsonl' for c in configs)
           and sum(f'{s}/reports/Force Avg Err (N per kg)' in r for r in logged
                   for s in ('dev', 'train')) == 4
           and sum('batch' in r for r in logged) >= 2,
           f'run logs: {configs}, {[list(r)[:2] for r in logged]}')
    report['use_pickled'] = dict(
        pickle_seconds=pickle_s, block_bytes=sum(b.stat().st_size for b in blocks),
        windows=len(train_ds), dev_batches=dev_batches, checkpoints_bitwise=n_ckpt, runs=ff,
        logged_records=len(logged), run_logs=[str(p) for p in run_logs])
    print(f'[cli-extras] pickle-data {len(train_ds)} + {len(dev_ds)} windows in '
          f'{pickle_s:.2f} s ({report["use_pickled"]["block_bytes"]} bytes of blocks); feedforward '
          f'train --use-pickled {ff["pickled"]["seconds"]:.2f} s and from the .b3d files '
          f'{ff["b3d"]["seconds"]:.2f} s, B={batch}: {n_ckpt} checkpoint(s) bitwise equal '
          f'(parameters and optimizer state); K1 {ff["pickled"]["k1"]} / {ff["b3d"]["k1"]} '
          f'launches for {dev_batches} dev batches; run logs: {len(configs)} JSONL files, '
          f'each its config with the git hash first, {len(logged)} records ({card})',
          flush=True)

    # (b) a profiled pallas epoch against the same epoch unprofiled
    pallas = [*base, '--model-type', 'transformer', '--attn-impl', 'pallas', *pallas_flags,
              '--no-wandb']
    layers = port.config_from_args(port.parser().parse_args(pallas)).num_layers
    runs = {}
    for name, more in (('plain', []), ('profiled', ['--profile', '--profile-dir',
                                                     str(root / 'trace')]),
                       ('plain again', [])):
        fe.launches = fe.bwd_launches = 0
        captures = port.step_mod.captures
        t0 = time.perf_counter()
        result = port.run_training(port.parser().parse_args(
            [*pallas, '--checkpoint-dir', str(root / f'pallas_{name.split()[0]}_{len(runs)}'),
             *more]))
        seconds = time.perf_counter() - t0
        captures = port.step_mod.captures - captures
        called = (port.step_mod.GraphedStep.WARMUP_STEPS + 1) * captures
        runs[name] = dict(seconds=seconds, epoch_seconds=result.windows_seen
                          / result.windows_per_sec, windows_per_sec=result.windows_per_sec,
                          k2=fe.launches, k3=fe.bwd_launches, captures=captures)
        _check(result.windows_seen == steps * batch and (not on or (
            captures == 1 and fe.launches == layers * (called + dev_batches)
            and fe.bwd_launches == layers * fe.BWD_LAUNCHES_PER_LAYER * called)),
            f'pallas {name}: {result.windows_seen} windows, wrappers K2 {fe.launches} K3 '
            f'{fe.bwd_launches}, {captures} captures')
    n_ckpt = _same_state(torch, root / 'pallas_plain_0' / 'transformer',
                         root / 'pallas_profiled_1' / 'transformer', '--profile against plain')
    traces = sorted((root / 'trace').glob('rank0.*.pt.trace.json'))
    _check(len(traces) == 1, f'traces {traces}')
    trace_bytes = traces[0].stat().st_size
    kernels = _trace_kernels(traces[0])
    k3_shape = fe.plan_encoder_bwd(batch, 10, 256, 1024, 8).shape
    if on:
        _check_traced(kernels, layers, steps, dev_batches, k3_shape, 'train --profile trace')
    k2_traced = kernels['fused_encoder_kernel']
    k3_traced = sum(kernels[k] for k in ENC_KERNELS[1:])
    plain_s = (runs['plain']['epoch_seconds'] + runs['plain again']['epoch_seconds']) / 2
    added = runs['profiled']['epoch_seconds'] - plain_s
    wall_added = runs['profiled']['seconds'] - (runs['plain']['seconds']
                                                + runs['plain again']['seconds']) / 2
    report['profile'] = dict(steps=steps, dev_batches=dev_batches, runs=runs,
                             checkpoints_bitwise=n_ckpt, trace_bytes=trace_bytes,
                             trace_kernels=kernels, k3_shape=k3_shape,
                             epoch_seconds_added=added, command_seconds_added=wall_added)
    print(f'[cli-extras] train --profile, pallas B={batch}, one epoch of {steps} steps and '
          f'{dev_batches} dev batches ({card}): {n_ckpt} checkpoint(s) bitwise the unprofiled '
          f'run\'s; trace {trace_bytes} bytes, K2 {k2_traced} == {layers} x ({steps} + '
          f'{dev_batches}), K3 {k3_traced} == {layers} x {fe.BWD_LAUNCHES_PER_LAYER} x {steps} '
          f'({k3_shape} shape), {kernels["other"]} other kernels; epoch '
          f'{runs["profiled"]["epoch_seconds"]:.4f} s profiled against '
          f'{runs["plain"]["epoch_seconds"]:.4f} / {runs["plain again"]["epoch_seconds"]:.4f} s '
          f'(+{added:.4f} s); the command {runs["profiled"]["seconds"]:.2f} s against '
          f'{runs["plain"]["seconds"]:.2f} / {runs["plain again"]["seconds"]:.2f} s '
          f'(+{wall_added:.2f} s)', flush=True)

    # (c) analyze --plot-errors: the PNGs, the rows of the run without it
    small_dev, small_train = dataset(small / 'dev'), dataset(small / 'train')
    batches = sum(-(-len(d) // batch) for d in (small_dev, small_train))
    gcfg = port.config_from_args(port.parser().parse_args(['train', '--model-type',
                                                           'groundlink']))
    port.save_checkpoint(str(root / 'gl' / 'groundlink'), port.build_model_for_dataset(
        gcfg, small_dev, generator=torch.Generator().manual_seed(seed + 190), device=device),
        0, 0)
    analyzed = {}
    for name, module, flags, src in (
            ('feedforward (K1)', fm, list(ff_flags), root / 'ff_b3d' / 'feedforward'),
            ('groundlink (K4)', fg, ['--model-type', 'groundlink'], root / 'gl' / 'groundlink')):
        rows, launches = {}, {}
        for mode in ('plain', 'plot'):
            d = root / f'analyze_{mode}_{src.name}'
            shutil.copytree(src, d / src.name)
            extra = (['--plot-errors', '--plot-path-root', str(d / 'plots')]
                     if mode == 'plot' else [])
            module.launches = 0
            out, seconds = command(['analyze', '--dataset-home', str(small), '--checkpoint-dir',
                                    str(d), '--device', device, '--no-wandb', '--batch-size',
                                    str(batch), *flags, *extra])
            launches[mode] = module.launches
            rows[mode] = [_csv_rows(d / src.name / f'{s}_analysis.csv') for s in ('dev', 'train')]
            if mode == 'plot':
                pngs = sorted(p.name for p in (d / 'plots').iterdir())
                _check(pngs == ['dev_grferrorleft-y.png', 'train_grferrorleft-y.png']
                       and all((d / 'plots' / p).read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'
                               for p in pngs), f'analyze --plot-errors {name}: {pngs}')
        _check(rows['plot'] == rows['plain'] and len(rows['plot'][0]) == len(small_dev)
               and len(rows['plot'][1]) == len(small_train),
               f'analyze {name}: the rows with --plot-errors differ from those without')
        _check(launches['plot'] == launches['plain'] == batches * on,
               f'analyze {name}: launches {launches}, want one a batch ({batches})')
        analyzed[name] = dict(launches=launches, rows=len(small_dev) + len(small_train),
                              seconds=seconds)
    report['plot_errors'] = analyzed
    drawn_by = ('matplotlib' if importlib.util.find_spec('matplotlib')
                else 'utils/png_plot.py (no matplotlib here)')
    print(f'[cli-extras] analyze --plot-errors B={batch}, PNGs drawn by {drawn_by} ({card}): '
          f'feedforward K1 '
          f'{analyzed["feedforward (K1)"]["launches"]["plot"]} and GroundLink K4 '
          f'{analyzed["groundlink (K4)"]["launches"]["plot"]} launches for {batches} batches '
          f'(batch by batch, as without the flag in chunks), the PNGs of both splits, '
          f'{analyzed["feedforward (K1)"]["rows"]} CSV rows each equal to the run\'s without '
          f'the flag', flush=True)

    # (d) sanity-check against the same statistics in float64 on the device
    out, sanity_s = command(['sanity-check', '--dataset-home', str(home)])
    one = port.WindowDataset(str(home / 'train'), window_size=1, stride=1,
                             skip_loading_skeletons=True)
    printed = {m.group(1): [float(v) for v in m.groups()[1:]]
               for m in SANITY_LINE.finditer(out)}
    worst = 0.0
    for mat, offsets in ((one.features_all, one.in_offsets), (one.labels_all, one.lab_offsets)):
        cols = torch.from_numpy(mat).to(device, torch.float64)
        for key, (o, w) in offsets.items():
            c = cols[:, o:o + w]
            want = [float(c.mean()), float(c.var(correction=0)), float(c.min()),
                    float(c.max())]
            # the print rounds to 4 decimals; numpy sums in float32
            scale = float(c.abs().max())
            for got_v, want_v in zip(printed[key], want):
                err = abs(got_v - want_v)
                worst = max(worst, err)
                _check(err <= 5e-5 + 1e-5 * (abs(want_v) + scale),
                       f'sanity-check {key}: printed {printed[key]}, on the device {want}')
    _check(out.startswith(f'{len(one)} windows over {subjects} subjects')
           and len(printed) == len(one.in_offsets) + len(one.lab_offsets)
           and 'WARNING' not in out, f'sanity-check: {out[:500]}')
    report['sanity_check'] = dict(seconds=sanity_s, keys=len(printed), worst_abs_err=worst)
    print(f'[cli-extras] sanity-check {len(one)} windows, {len(printed)} keys in '
          f'{sanity_s:.2f} s: each statistic within 5e-5 + 1e-5 x (|value| + max |column|) '
          f'of float64 on {device} (worst {worst:.3g})', flush=True)
    report['seconds'] = time.perf_counter() - t_phase
    return report


PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'


def _png_decodes(path: Path) -> bool:
    """A PNG file whose chunks' CRCs hold and whose image data inflates to
    the rows its header promises (8-bit grey, RGB or RGBA)."""
    data = path.read_bytes()
    if data[:8] != PNG_SIGNATURE:
        return False
    at, idat, header = 8, b'', None
    while at + 12 <= len(data):
        n, kind = struct.unpack('>I4s', data[at:at + 8])
        body = data[at + 8:at + 8 + n]
        if struct.unpack('>I', data[at + 8 + n:at + 12 + n])[0] != zlib.crc32(kind + body):
            return False
        if kind == b'IHDR':
            header = struct.unpack('>IIBB', body[:10])
        elif kind == b'IDAT':
            idat += body
        at += 12 + n
    if header is None or header[2] != 8 or header[3] not in (0, 2, 6):
        return False
    w, h, _, color = header
    return len(zlib.decompress(idat)) == h * (w * {0: 1, 2: 3, 6: 4}[color] + 1)


def _legacy_job(job):
    """Phase 20, in a worker process: legacy subject ``seed`` written by the
    port's writer to ``path``, copied to ``ref`` and converted there by
    ``data/b3d_legacy.py::ensure_tpu_format``: the bytes ``convert-b3d`` must
    write. Returns the converted file's path."""
    path, ref, seed, trials, length = job
    from inferbiomechanics_tpu_torch.data.b3d_legacy import ensure_tpu_format
    from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_legacy_subject
    write_synthetic_legacy_subject(path, num_trials=trials, trial_length=length, seed=seed)
    shutil.copyfile(path, ref)
    return ensure_tpu_format(ref)


# 21. the options the port refused until now. A flax-tree model's outputs
# on the card against the same weights on the CPU: plain bf16 ops on both
# sides, which round at different places (FLAX_REL x max a head, the
# transformer suite's limit of two bf16 evaluations); the flax denoiser's eps
# likewise.
FLAX_REL = 3e-2


def phase_options(torch, port, fe, fg, diffusion, root, seed, card, data, ds, device='cuda',
                  batch=64, size_flags=()):
    """21. ``--attn-impl flax`` and ``--conv-impl banded`` at full width:

    - ``train --attn-impl flax`` (the transformer's flax tree, one epoch of
      B=``batch``; no K2 or K3: the plain bf16 forward, as in JAX), its
      checkpoint served with ``--fused-inference`` (the JAX warning: the
      plain forward; /predict at B=1 and 4096 against the same weights on
      the CPU, p50 of each) and scored by ``analyze``; a 50-step DDIM chain
      of the flax denoiser (random weights from the seed) at B=1, its eps
      against the CPU's, the fused sampler's JAX refusal;
    - both flax runs converted to the ``vpu`` tree and run through K2
      (:func:`phase_converted_flax`);
    - ``train --model-type groundlink --conv-impl banded``: the banded
      training forward, K4 once a dev batch in the dev eval; the checkpoint
      loaded by the banded and the direct conv models evaluates bitwise the
      same through K4.
    ``device`` 'cpu' rehearses it (no launch counts checked)."""
    t_phase = time.perf_counter()
    on_card = device == 'cuda'
    report = {'card': card}
    home = root / 'options_data'
    for split, length in (('train', 600), ('dev', 400)):
        (home / split).mkdir(parents=True)
        port.write_synthetic_subject(str(home / split / 'subject_0.b3d'), num_trials=1,
                                     trial_length=length,
                                     seed=seed + 2100 + (10 if split == 'dev' else 0))
    windows = lambda split: len(port.WindowDataset(  # noqa: E731
        str(home / split), window_size=50, stride=5, skip_loading_skeletons=True))
    steps, dev_b = windows('train') // batch, windows('dev') // batch
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def train(ck, *flags):
        fe.launches = fe.bwd_launches = fg.launches = 0
        t0 = time.perf_counter()
        result = port.run_training(port.parser().parse_args([
            'train', '--dataset-home', str(home), '--checkpoint-dir', str(ck), '--device',
            device, '--batch-size', str(batch), '--epochs', '1', '--seed', str(seed), *flags]))
        launches = dict(k2=fe.launches, k3=fe.bwd_launches, k4=fg.launches)
        _check(result.epochs_run == 1 and np.isfinite(
            float(np.mean(result.final_train_metrics['loss']))), f'train {flags}: {result}')
        return result, time.perf_counter() - t0, launches

    # 21a. the flax transformer: train, serve, analyze
    flax = ['--model-type', 'transformer', '--attn-impl', 'flax', *size_flags]
    result, train_s, launches = train(root / 'flax', *flax)
    _check(launches['k2'] == launches['k3'] == 0, f'train --attn-impl flax: {launches}')
    serve_argv = ['serve', '--dataset-home', str(data), '--checkpoint-dir', str(root / 'flax'),
                  '--port', '0', '--device', device, *flax, '--fused-inference']
    cfg = port.config_from_args(port.parser().parse_args(serve_argv))
    cpu_model, _, _ = port.load_model(cfg, ds, str(root / 'flax' / 'transformer'), device='cpu')
    fe.launches = 0
    svc, server, url = _serve(port, serve_argv)
    try:
        _check(_get(url + '/schema')['fused_inference'] is False,
               'serve --attn-impl flax --fused-inference: the plain forward, with the warning')
        errs, p50 = {}, {}
        for b in (1, 4096):
            x = ds.gather(np.arange(b)).inputs
            body = _b64_body(x)
            got = _decode(_post(url + '/predict', body)['outputs'])
            rows = min(b, 256)          # the CPU's forward on the first rows
            with torch.no_grad():
                want = {k: v.numpy() for k, v in cpu_model.eval()(
                    torch.from_numpy(np.ascontiguousarray(x[:rows], np.float32))).items()}
            errs[b] = _agree({k: v[:rows].tolist() for k, v in got.items()}, want,
                             f'/predict flax B={b}', rel=FLAX_REL)
            p50[b] = _host_p50_ms(lambda: _post(url + '/predict', body),  # noqa: B023
                                  20 if b == 1 else 10)
        _check(fe.launches == 0, f'serve --attn-impl flax: {fe.launches} K2 launches')
    finally:
        _stop(svc, server)
    analyzed = port.analyze(port.parser().parse_args([
        'analyze', '--dataset-home', str(home), '--checkpoint-dir', str(root / 'flax'),
        '--no-wandb', '--device', device, *flax]))
    dev = analyzed['dev']
    _check(dev['windows'] == windows('dev') and np.isfinite(
        list(dev['summary'].values())).all(), f'analyze --attn-impl flax: {dev}')
    report['flax_transformer'] = dict(
        train_seconds=train_s, steps=steps, batch=batch, train_launches=launches,
        final_train_loss=float(np.mean(result.final_train_metrics['loss'])),
        predict_rel_err_vs_cpu={str(b): e for b, e in errs.items()},
        predict_p50_ms={str(b): v for b, v in p50.items()}, analyze_windows=dev['windows'],
        analyze_seconds=dev.get('seconds'))
    print(f'[options] train --attn-impl flax, transformer full width B={batch}, {steps} steps '
          f'in {train_s:.1f} s, K2/K3 launches {launches} ({card}); serve --fused-inference '
          f'serves the plain forward (the JAX warning): /predict B=1 p50 {p50[1]:.2f} ms, '
          f'B=4096 p50 {p50[4096]:.1f} ms = {4096 / p50[4096] * 1e3:.0f} windows/s, answers '
          f'within {FLAX_REL} x max of the CPU\'s (max abs err {errs[1]:.3g} / '
          f'{errs[4096]:.3g}); analyze: {dev["windows"]} dev windows', flush=True)

    # 21a'. the flax denoiser: a 50-step chain at B=1
    dds = port.WindowDataset(str(home / 'dev'), window_size=50, stride=5,
                             output_data_format='all_frames', skip_loading_skeletons=True)
    dcfg = port.config_from_args(port.parser().parse_args([
        'serve', '--model-type', 'diffusion', '--attn-impl', 'flax', '--output-data-format',
        'all_frames', *size_flags]))
    net = port.build_model_for_dataset(dcfg, dds, generator=torch.Generator().manual_seed(seed),
                                       device=device).eval()
    cpu_net = port.build_model_for_dataset(dcfg, dds, device='cpu').eval()
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    try:
        diffusion.make_sampler(net, num_steps=50, fused_inference=True)
        refused = None
    except ValueError as e:
        refused = str(e)
    _check(refused is not None and 'consumes the vpu parameter tree' in refused,
           f'the flax denoiser\'s fused sampler: {refused}')
    cond = np.ascontiguousarray(dds.gather(np.arange(1)).inputs, np.float32)
    rng = np.random.default_rng(seed)
    x_t = rng.normal(size=(1, net.num_frames, net.target_channels)).astype(np.float32)
    t = np.array([500])
    with torch.no_grad():
        eps = net(torch.from_numpy(x_t).to(device), torch.from_numpy(t).to(device),
                  torch.from_numpy(cond).to(device)).cpu().numpy()
        eps_cpu = cpu_net(torch.from_numpy(x_t), torch.from_numpy(t),
                          torch.from_numpy(cond)).numpy()
    eps_rel = float(np.abs(eps - eps_cpu).max() / np.abs(eps_cpu).max())
    _check(eps_rel <= FLAX_REL, f'flax denoiser eps on the card vs the CPU: {eps_rel} x max')
    sampler = diffusion.make_sampler(net, num_steps=50)
    cond_d = torch.from_numpy(cond).to(device)
    fe.launches = 0

    def chain():
        out = sampler(net, cond_d, generator=torch.Generator(device=device).manual_seed(seed))
        sync()
        return out

    with torch.no_grad():
        out = chain()
        chain_ms = _host_p50_ms(chain, 5)
    _check(all(np.isfinite(v.cpu().numpy()).all() for v in out.values()) and fe.launches == 0,
           f'flax denoiser chain: finite outputs, no K2 ({fe.launches})')
    report['flax_denoiser'] = dict(eps_rel_vs_cpu=eps_rel, chain_b1_ms=chain_ms, steps=50,
                                   fused_refusal=refused)
    print(f'[options] the flax denoiser, full width, a 50-step chain at B=1 (plain bf16 '
          f'forward, no K2): {chain_ms:.1f} ms host p50 of 5; eps within {eps_rel:.4f} x max of '
          f'the CPU\'s; --fused-inference refused in the JAX words ({card})', flush=True)

    # 21c. both flax runs converted to the vpu tree, then through K2
    report['converted_from_flax'] = phase_converted_flax(
        torch, port, fe, diffusion, root, seed, card, data, ds, home, dds, cpu_model, net,
        cond, dict(p50=p50, chain_ms=chain_ms), device=device, size_flags=size_flags)

    # 21b. banded GroundLink: train, then its eval through K4
    gl = ['--model-type', 'groundlink']
    result, banded_s, launches = train(root / 'banded', *gl, '--conv-impl', 'banded')
    _check(not on_card or launches == dict(k2=0, k3=0, k4=dev_b),
           f'train --conv-impl banded: launches {launches}, want K4 {dev_b} (a dev batch)')
    x = torch.from_numpy(np.ascontiguousarray(ds.gather(np.arange(4096)).inputs,
                                              np.float32)).to(device)
    outs = {}
    for impl in ('banded', 'xla'):
        gcfg = port.config_from_args(port.parser().parse_args(
            ['serve', *gl, '--conv-impl', impl]))
        model, _, _ = port.load_model(gcfg, ds, str(root / 'banded' / 'groundlink'),
                                      device=device)
        fg.launches = 0
        with torch.no_grad():
            outs[impl] = model.eval()(x)
        _check(not on_card or fg.launches == 1, f'{impl} eval: {fg.launches} K4 launches')
    same = all(torch.equal(outs['banded'][k], outs['xla'][k]) for k in outs['xla'])
    _check(same, 'the banded and direct conv models\' K4 evals differ on the same weights')
    report['banded_groundlink'] = dict(train_seconds=banded_s, steps=steps, batch=batch,
                                       train_launches=launches, eval_bitwise_direct=same,
                                       final_train_loss=float(np.mean(
                                           result.final_train_metrics['loss'])))
    print(f'[options] train --model-type groundlink --conv-impl banded, B={batch}, {steps} '
          f'steps in {banded_s:.1f} s (the banded bf16 product in training), launches '
          f'{launches} (K4 once a dev batch); its checkpoint\'s eval through K4 at B=4096 '
          f'bitwise the direct conv model\'s on the same weights ({card})', flush=True)
    report['seconds'] = time.perf_counter() - t_phase
    print(f'[options] phase 21 took {report["seconds"]:.1f} s ({card})', flush=True)
    return report


def phase_converted_flax(torch, port, fe, diffusion, root, seed, card, data, ds, home, dds,
                         flax_cpu_model, flax_net, cond, flax_times, device='cuda',
                         size_flags=()):
    """21c. the port's ``scripts/convert_attn_checkpoint.py`` on phase 21's
    full-width flax runs, and what the converted runs serve, score and
    sample through K2:

    - the flax transformer's ``.torch.pt`` and a ``.ckpt`` of the same
      weights (``weights.jax_payload`` through ``utils/flax_msgpack.py``, as
      phase 13 writes one) converted ``--to vpu`` into directories without a
      sidecar give the same state dict; ``--to flax`` brings each back
      bitwise;
    - the converted run served by ``serve --attn-impl vpu --fused-inference``:
      /predict at B=1 and 4096 within FLAX_REL x max of the flax model on the
      CPU, K2 ``num_layers`` launches a forward by the wrapper and by name in
      a device-only trace, p50 at both batches beside the flax run's; scored
      by ``analyze --attn-impl vpu --fused-inference`` on two short trials
      (finite metrics; the vpu forward, no K2, as the JAX command scores a
      transformer);
    - the flax denoiser converted alike: a 50-step DDIM chain at B=1 through
      the fused sampler, ``50 x num_layers`` K2 launches by the wrapper and
      by name, each step's eps through K2 within FLAX_REL x max of the flax
      denoiser's on the same (x_t, t, cond), the chain's ms beside the flax
      chain's; ``analyze --fused-inference`` of it on the short trials, K2
      ``50 x num_layers`` a window by the wrapper and by name.
    ``device`` 'cpu' rehearses it (K2's plain version, which no wrapper
    counts; no trace)."""
    from inferbiomechanics_tpu_torch import weights
    from inferbiomechanics_tpu_torch.scripts import convert_attn_checkpoint as tool
    from inferbiomechanics_tpu_torch.train.checkpoint import (
        read_payload, resolve_checkpoint_path, save_checkpoint,
    )
    from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
    from inferbiomechanics_tpu_torch.utils import flax_msgpack
    t_part = time.perf_counter()
    on_card = device == 'cuda'
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def by_name(fn):
        """``fn()``, the wrapper's K2 count reset before it, and its K2
        launches by name in a device-only trace (None on the CPU)."""
        fe.launches = 0
        if not on_card:
            return fn(), None
        result, counts = _kernels_by_name(fn, ('fused_encoder_kernel',))
        return result, counts['fused_encoder_kernel']

    def convert(src, dst, to):
        _check(tool.main([str(src), str(dst), '--to', to, '--num-heads',
                          str(flax_cpu_model.num_heads)]) == 0 and dst.exists(),
               f'convert_attn_checkpoint {src} --to {to}')

    def same_state(a, b):
        return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)

    # the flax transformer's checkpoint, in both formats, there and back
    t0 = time.perf_counter()
    src = Path(resolve_checkpoint_path(str(root / 'flax' / 'transformer')))
    original = torch.load(src, map_location='cpu', weights_only=True)
    pt = root / 'converted' / 'transformer' / src.name
    convert(src, pt, 'vpu')
    convert_s = time.perf_counter() - t0
    jx = root / 'converted_ckpt' / 'flax.ckpt'
    jx.parent.mkdir(parents=True)
    jx.write_bytes(flax_msgpack.dumps(weights.jax_payload(
        flax_cpu_model, make_optimizer(flax_cpu_model.named_parameters(), 'rmsprop', 1e-4),
        original['epoch'], original['batch'], original.get('step', 0))))
    convert(jx, jx.with_name('vpu.ckpt'), 'vpu')
    converted = torch.load(pt, map_location='cpu', weights_only=True)
    _check(same_state(converted['model_state_dict'],
                      read_payload(str(jx.with_name('vpu.ckpt')))['model_state_dict'])
           and 'optimizer_state_dict' not in converted
           and 'opt_state' not in flax_msgpack.loads(jx.with_name('vpu.ckpt').read_bytes()),
           'the converted .torch.pt and .ckpt of the same weights differ')
    convert(pt, root / 'converted_back' / src.name, 'flax')
    convert(jx.with_name('vpu.ckpt'), jx.with_name('back.ckpt'), 'flax')
    back = torch.load(root / 'converted_back' / src.name, map_location='cpu',
                      weights_only=True)['model_state_dict']
    want_ckpt, got_ckpt = (list(_leaves(flax_msgpack.loads(p.read_bytes())['params']))
                           for p in (jx, jx.with_name('back.ckpt')))
    round_trip = same_state(back, original['model_state_dict']) and len(want_ckpt) == len(
        got_ckpt) and all(a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
                          for a, b in zip(got_ckpt, want_ckpt))
    _check(round_trip, 'convert_attn_checkpoint --to flax of the converted run: not bitwise '
                       'the flax original')

    # serve and analyze the converted run through K2
    layers = len(flax_cpu_model.blocks)
    vpu = ['--model-type', 'transformer', '--attn-impl', 'vpu', *size_flags, '--fused-inference']
    serve_argv = ['serve', '--dataset-home', str(data), '--checkpoint-dir',
                  str(root / 'converted'), '--port', '0', '--device', device, *vpu]
    svc, server, url = _serve(port, serve_argv)
    errs, p50, traced = {}, {}, {}
    try:
        _check(_get(url + '/schema')['fused_inference'] is True,
               'serve --attn-impl vpu --fused-inference of the converted run: not fused')
        for b in (1, 4096):
            x = ds.gather(np.arange(b)).inputs
            body = _b64_body(x)
            answer, traced[b] = by_name(lambda: _post(url + '/predict', body))  # noqa: B023
            _check(fe.launches == layers * on_card and traced[b] in (None, layers),
                   f'converted /predict B={b}: K2 {fe.launches} by the wrapper, {traced[b]} '
                   f'by name, want {layers}')
            got = _decode(answer['outputs'])
            rows = min(b, 256)          # the flax model on the CPU, on the first rows
            with torch.no_grad():
                want = {k: v.numpy() for k, v in flax_cpu_model.eval()(
                    torch.from_numpy(np.ascontiguousarray(x[:rows], np.float32))).items()}
            errs[b] = _agree({k: v[:rows].tolist() for k, v in got.items()}, want,
                             f'converted /predict B={b} vs the flax model', rel=FLAX_REL)
            p50[b] = _host_p50_ms(lambda: _post(url + '/predict', body),  # noqa: B023
                                  20 if b == 1 else 10)
    finally:
        _stop(svc, server)
    # analyze scores a vpu transformer through its plain forward, as the JAX
    # command does (--fused-inference moves diffusion chains only): finite
    # metrics and no K2; a split of two short trials
    small = root / 'converted_home'
    for split, s in (('train', 0), ('dev', 1)):
        (small / split).mkdir(parents=True)
        port.write_synthetic_subject(str(small / split / 'subject_0.b3d'), num_trials=1,
                                     trial_length=60, seed=seed + 2130 + s)

    def score(ck, *flags):
        """``analyze`` of ``ck`` on the short split: (windows, the wrapper's
        K2 launches, by name)."""
        analyzed, by_trace = by_name(lambda: port.analyze(port.parser().parse_args([
            'analyze', '--dataset-home', str(small), '--checkpoint-dir', str(ck),
            '--no-wandb', '--device', device, *flags])))
        _check(all(np.isfinite(list(r['summary'].values())).all() for r in analyzed.values()),
               f'analyze {flags}: {analyzed}')
        return sum(r['windows'] for r in analyzed.values()), fe.launches, by_trace

    windows, analyze_launches, analyze_traced = score(root / 'converted', *vpu)
    _check(analyze_launches == 0 and analyze_traced in (None, 0),
           f'analyze of the converted transformer: K2 {analyze_launches} by the wrapper, '
           f'{analyze_traced} by name; the vpu forward runs none')
    print(f'[options] convert_attn_checkpoint --to vpu of the flax transformer ({layers} '
          f'blocks; .torch.pt and .ckpt the same state dict, --to flax back bitwise; '
          f'{convert_s:.2f} s): serve --attn-impl vpu --fused-inference /predict B=1 p50 '
          f'{p50[1]:.2f} ms (flax run {flax_times["p50"][1]:.2f}), B=4096 p50 {p50[4096]:.1f} '
          f'ms (flax run {flax_times["p50"][4096]:.1f}), K2 {layers} a forward by the wrapper '
          f'and {traced[1]} / {traced[4096]} by name, within {FLAX_REL} x max of the flax '
          f'model (max abs err {errs[1]:.3g} / {errs[4096]:.3g}); analyze: {windows} windows, '
          f'finite, through the vpu forward (no K2, as in JAX) ({card})', flush=True)

    # the flax denoiser, converted, sampled through K2
    dcfg = port.config_from_args(port.parser().parse_args([
        'serve', '--model-type', 'diffusion', '--output-data-format', 'all_frames',
        *size_flags]))
    save_checkpoint(str(root / 'flax_denoiser'), flax_net, 0, 0)
    dsrc = Path(resolve_checkpoint_path(str(root / 'flax_denoiser')))
    convert(dsrc, root / 'converted_denoiser' / 'diffusion' / dsrc.name, 'vpu')
    net, _, _ = port.load_model(dcfg, dds, str(root / 'converted_denoiser' / 'diffusion'),
                                device=device)
    sampler = diffusion.make_sampler(net, num_steps=50, fused_inference=True)
    cond_d = torch.from_numpy(cond).to(device)

    def chain(trace=None):
        out = sampler(net, cond_d, generator=torch.Generator(device=device).manual_seed(seed),
                      trace=trace)
        sync()
        return out

    steps = []
    with torch.no_grad():
        out, chain_traced = by_name(lambda: chain(steps))
        chain_launches = fe.launches
        _check(chain_launches == 50 * layers * on_card
               and chain_traced in (None, chain_launches)
               and all(np.isfinite(v.cpu().numpy()).all() for v in out.values()),
               f'the converted denoiser\'s chain: K2 {chain_launches} by the wrapper, '
               f'{chain_traced} by name, want {50 * layers}; finite outputs')
        chain_ms = _host_p50_ms(chain, 5)
        eps_rel = 0.0
        for t, x_t in steps:     # teacher-forced: each step's (x_t, t, cond)
            tt = torch.full((1,), t, dtype=torch.int32, device=device)
            want = flax_net(x_t, tt, cond_d).float()
            got = diffusion.fused_denoiser_eps(net, x_t, tt, cond_d)
            eps_rel = max(eps_rel, float((got - want).abs().max() / want.abs().max()))
    _check(len(steps) == 50 and eps_rel <= FLAX_REL,
           f'the converted denoiser\'s eps through K2 vs the flax denoiser\'s: {eps_rel} x max')
    dwindows, d_launches, d_traced = score(
        root / 'converted_denoiser', '--model-type', 'diffusion', '--output-data-format',
        'all_frames', *size_flags, '--fused-inference')
    _check(d_launches == 50 * layers * dwindows * on_card and d_traced in (None, d_launches),
           f'analyze --fused-inference of the converted denoiser: {dwindows} windows, K2 '
           f'{d_launches} by the wrapper, {d_traced} by name, want {50 * layers} a window')
    print(f'[options] the converted flax denoiser, a 50-step chain at B=1 through K2: '
          f'{chain_ms:.1f} ms host p50 of 5 (the flax chain {flax_times["chain_ms"]:.1f} ms), '
          f'K2 {chain_launches} by the wrapper, {chain_traced} by name; each step\'s eps '
          f'within {eps_rel:.4f} x max of the flax denoiser\'s; analyze --fused-inference: '
          f'{dwindows} windows, K2 {d_launches} (by name {d_traced}) ({card})', flush=True)
    return dict(
        transformer=dict(blocks=layers, convert_seconds=convert_s, round_trip_bitwise=round_trip,
                         predict_max_abs_err_vs_flax={str(b): e for b, e in errs.items()},
                         predict_p50_ms={str(b): v for b, v in p50.items()},
                         flax_predict_p50_ms={str(b): v for b, v in flax_times['p50'].items()},
                         launches_per_forward=layers,
                         launches_traced={str(b): v for b, v in traced.items()},
                         analyze_windows=windows, analyze_launches=analyze_launches),
        denoiser=dict(chain_b1_ms=chain_ms, flax_chain_b1_ms=flax_times['chain_ms'],
                      launches=chain_launches, launches_traced=chain_traced,
                      eps_rel_vs_flax=eps_rel, analyze_windows=dwindows,
                      analyze_launches=d_launches, analyze_launches_traced=d_traced),
        seconds=time.perf_counter() - t_part)


def phase_last_commands(torch, port, fm, root, seed, card, data, logs=None, device='cuda',
                        subjects=4, trials=2, length=1500, transfer_mb=256):
    """20. The last four commands, each run in this process through
    ``__main__.main`` (a ``SystemExit`` read for its code; any nonzero code
    fails the phase): (a) ``doctor --json --transfer-mb 256 --dataset-home
    <data>``: healthy, the card's name and power limit ``nvidia-smi``'s, K1
    launched once at B=1 and once at B=4096 (the wrapper's count; and in a
    profiler trace of a second run, two ``fused_mlp_kernel`` launches of two
    instantiations) and held to ``mlp_reference``; (b) ``make-plots`` over ``data`` (phase 4's
    subjects) with every figure group: the files ``render_plots`` names for
    the cached statistics, each a PNG that decodes, written again by
    ``--use-cache``; (c) ``plot-training`` of a ``metrics_*.jsonl`` of
    ``logs`` (phase 19's two runs): its finals the last value of each key,
    and ``--compare`` of both; (d) ``convert-b3d`` of ``subjects`` legacy
    subjects of ``trials`` x ``length`` frames (written, and converted by
    ``ensure_tpu_format`` for reference, in worker processes while (b) and
    (c) run): each output byte for byte the reference, then ``--verify`` and
    ``--infer-schema`` clean. matplotlib, where installed, is hidden so that
    ``utils/png_plot.py`` draws, as on a machine without it. Without
    ``logs`` two short ``train`` runs write them. ``device`` 'cpu' rehearses
    it (``doctor --device cpu``, no launch count or trace)."""
    import concurrent.futures
    import multiprocessing
    import pickle
    from inferbiomechanics_tpu_torch.ops.tune import traced_kernels
    t_phase = time.perf_counter()
    on = device == 'cuda'
    root = root / 'last_commands'
    root.mkdir()
    report = {}

    def command(argv, what, cwd=None):
        """``python -m inferbiomechanics_tpu_torch <argv>`` in this process:
        (stdout, seconds); fails the phase on a nonzero exit."""
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.chdir(cwd or os.getcwd()), contextlib.redirect_stdout(out):
            try:
                rc = port.main(argv)
            except SystemExit as e:
                rc = e.code
        _check(rc == 0, f'{what}: exit {rc}\n{out.getvalue()[-3000:]}')
        return out.getvalue(), time.perf_counter() - t0

    def written(out):
        return [Path(line[len('wrote '):]).name for line in out.splitlines()
                if line.startswith('wrote ') and not line.startswith('wrote cache ')]

    # (a) doctor; on the card once more under a profiler trace (no dataset,
    # 1 MB copies), for its K1 kernels by name
    argv = ['doctor', '--json', '--transfer-mb', str(transfer_mb), '--dataset-home', str(data)]
    fm.launches = 0
    out, doctor_s = command(argv if on else [*argv, '--device', 'cpu'], 'doctor')
    launches = fm.launches
    doc = json.loads(next(line for line in out.splitlines() if line.startswith('{')))
    k1 = {k['batch']: k for k in doc['k1']}
    _check(doc['healthy'] and doc['degraded'] == [] and 'DOCTOR: healthy' in out
           and sorted(k1) == [1, 4096] and all(k['ok'] for k in k1.values())
           and doc['datasets'] and all(d['windows'] > 0 for d in doc['datasets'].values()),
           f'doctor: {out[-3000:]}')
    k1_traced = []
    if on:
        (out, _), kernels = traced_kernels(lambda: command(['doctor', '--transfer-mb', '1'],
                                                           'doctor (traced)'))
        k1_traced = [name for name, _ in kernels if 'fused_mlp_kernel' in name]
        _check(doc['device']['nvidia_smi'][0] == card
               and doc['device']['devices'][0]['name'] == card.split(',')[0].strip()
               and doc['device']['devices'][0]['capability'] == [9, 0],
               f'doctor: device {doc["device"]}, nvidia-smi says {card!r}')
        _check([k1[b]['kernel'] for b in (1, 4096)] == ['small', 'large']
               and launches == 2 and len(k1_traced) == 2 and len(set(k1_traced)) == 2,
               f'doctor: K1 {launches} launches by the wrapper, traced {k1_traced}')
    probes = doc['probes']
    report['doctor'] = dict(seconds=doctor_s, build=doc.get('build'), probes=probes,
                            k1=doc['k1'], k1_traced=k1_traced, toolchain=doc['toolchain'])
    pinned = probes['pinned_gbps']
    print(f'[last-commands] doctor --transfer-mb {transfer_mb}: healthy in {doctor_s:.2f} s; '
          f'{doc["device"]["nvidia_smi"]}; nvcc {doc["toolchain"]["version"]}; build '
          f'{(doc.get("build") or {}).get("status", "skipped")}; K1 B=1 '
          f'{k1[1]["us"]:.1f} us ({k1[1]["kernel"]}, max abs err {k1[1]["max_abs_err"]:.3g}), '
          f'B=4096 {k1[4096]["us"]:.1f} us ({k1[4096]["kernel"]}, max abs err '
          f'{k1[4096]["max_abs_err"]:.3g}), one call each (traced: {k1_traced}); '
          f'host->device pageable {probes["pageable_gbps"]:.2f} GB/s, pinned '
          f'{"not measured" if pinned is None else f"{pinned:.2f} GB/s"}; 512x512 bf16 '
          f'matmul {probes["step_ms"]:.3f} ms/step ({card})', flush=True)

    legacy, refs, converted = root / 'legacy', root / 'reference', root / 'converted'
    legacy.mkdir()
    refs.mkdir()
    jobs = [(str(legacy / f'subject_{i}.b3d'), str(refs / f'subject_{i}.b3d'), seed + 2000 + i,
             trials, length) for i in range(subjects)]
    hidden = importlib.util.find_spec('matplotlib') is not None
    real = sys.modules.get('matplotlib', False)
    sys.modules['matplotlib'] = None
    t_legacy = time.perf_counter()
    pool = concurrent.futures.ProcessPoolExecutor(
        subjects, mp_context=multiprocessing.get_context('spawn'))
    try:
        references = pool.map(_legacy_job, jobs)

        # (b) make-plots, every figure group, drawn by png_plot
        plots, cache = root / 'plots', root / 'plots.pkl'
        out, plots_s = command(['make-plots', '--data-path', str(data), '--out-dir', str(plots),
                                '--cache', str(cache)], 'make-plots')
        figures = written(out)
        with open(cache, 'rb') as f:
            stats = pickle.load(f)
        names = [Path(p).name for p in port.render_plots(stats, str(root / 'named'))]
        scatter = [n for n in names if n.startswith('scatter_')]
        _check(figures == names and len(scatter) == 26
               and all(_png_decodes(plots / n) for n in figures),
               f'make-plots wrote {figures}, render_plots names {names}')
        out, replay_s = command(['make-plots', '--use-cache', '--cache', str(cache),
                                 '--out-dir', str(root / 'replayed')], 'make-plots --use-cache')
        _check(written(out) == figures and f'loaded cache {cache}' in out
               and all(_png_decodes(root / 'replayed' / n) for n in figures),
               f'make-plots --use-cache wrote {written(out)}')
        report['make_plots'] = dict(seconds=plots_s, replay_seconds=replay_s,
                                    figures=len(figures), cache_bytes=cache.stat().st_size,
                                    subjects=stats['num_subjects'], trials=stats['num_trials'])
        print(f'[last-commands] make-plots over {stats["num_subjects"]} subjects, '
              f'{stats["num_trials"]} trials: {len(figures)} figures ({len(scatter)} scatter) '
              f'drawn by utils/png_plot.py{" (matplotlib hidden)" if hidden else ""}, each a '
              f'PNG that decodes, the names render_plots gives, in {plots_s:.2f} s; cache '
              f'{cache.stat().st_size} bytes; --use-cache the same files in {replay_s:.2f} s',
              flush=True)

        # (c) plot-training of the train runs' JSONL logs
        if logs is None:
            logs = _jsonl_runs(torch, port, root / 'runs', seed, device)
        out, curves_s = command(['plot-training', '--log-file', str(logs[0]), '--out',
                                 str(root / 'curves.png')], 'plot-training')
        finals = {k.strip(): float(v) for k, v in (line.rsplit('  final ', 1)
                                                    for line in out.splitlines()[1:])}
        last = {}
        for line in Path(logs[0]).read_text().splitlines()[1:]:
            for k, v in json.loads(line).items():
                if not isinstance(v, bool) and isinstance(v, (int, float)):
                    last[k] = v
        want = {k: float(f'{v:.6g}') for k, v in last.items() if k not in ('epoch', 'batch')}
        _check(finals == want and _png_decodes(root / 'curves.png'),
               f'plot-training finals {finals}, the file\'s last values {want}')
        out, compare_s = command(['plot-training', '--compare', *map(str, logs), '--out',
                                  str(root / 'compare.png')], 'plot-training --compare')
        _check(out.startswith(f'compared {len(logs)} runs') and _png_decodes(root / 'compare.png'),
               f'plot-training --compare: {out[-2000:]}')
        report['plot_training'] = dict(seconds=curves_s, compare_seconds=compare_s,
                                       series=len(finals))
        print(f'[last-commands] plot-training: {len(finals)} finals equal to the last value '
              f'of each key in {Path(logs[0]).name} ({curves_s:.2f} s); --compare of '
              f'{len(logs)} runs ({compare_s:.2f} s); PNGs that decode', flush=True)
        references = list(references)
    finally:
        pool.shutdown(cancel_futures=True)
        if real is False:
            sys.modules.pop('matplotlib', None)
        else:
            sys.modules['matplotlib'] = real
    legacy_s = time.perf_counter() - t_legacy

    # (d) convert-b3d, byte for byte ensure_tpu_format's files
    out, convert_s = command(['convert-b3d', str(legacy), '--out-dir', str(converted)],
                             'convert-b3d')
    _check(f'{subjects} converted, 0 skipped' in out, f'convert-b3d: {out[-2000:]}')
    for i, ref in enumerate(references):
        _check((converted / f'subject_{i}.b3d').read_bytes() == Path(ref).read_bytes(),
               f'convert-b3d: subject_{i} differs from ensure_tpu_format\'s file')
    in_mb = sum(p.stat().st_size for p in legacy.iterdir()) / 1e6
    out_mb = sum(p.stat().st_size for p in converted.iterdir()) / 1e6
    out, verify_s = command(['convert-b3d', str(legacy), '--verify'], 'convert-b3d --verify')
    _check(out.count(': OK (') == subjects and 'PROBLEM' not in out, f'--verify: {out[-2000:]}')
    out, infer_s = command(['convert-b3d', str(legacy), '--infer-schema'],
                           'convert-b3d --infer-schema')
    _check(out.count('CONSISTENT') == subjects and 'DISAGREEMENT' not in out,
           f'--infer-schema: {out[-2000:]}')
    report['convert_b3d'] = dict(seconds=convert_s, verify_seconds=verify_s,
                                 infer_seconds=infer_s, legacy_mb=in_mb, converted_mb=out_mb,
                                 subjects=subjects, frames=subjects * trials * length,
                                 written_and_referenced_seconds=legacy_s)
    print(f'[last-commands] convert-b3d {subjects} legacy subjects of {trials} x {length} '
          f'frames ({in_mb:.1f} MB -> {out_mb:.1f} MB): {convert_s:.2f} s, '
          f'{in_mb / convert_s:.1f} MB/s of legacy input, each file byte for byte '
          f'ensure_tpu_format\'s; --verify clean in {verify_s:.2f} s; --infer-schema '
          f'consistent in {infer_s:.2f} s', flush=True)
    report['seconds'] = time.perf_counter() - t_phase
    return report


# 22. the quality studies (inferbiomechanics_tpu_torch/scripts/): the port's
# parity_rmse for feedforward (2 epochs) and anchor_quality's pallas
# transformer (1 epoch) on the study split, each through its command-line
# entry in this process. Their digest is the study data's on record, every
# dev batch goes through K1 / K2 and every train step of the pallas model
# through K3 (named in a profiler trace, and counted by the wrappers alike),
# and each curve is finite and ends with its force and COM-acc errors below
# those of its initial weights.
QUALITY_KERNELS = ('fused_mlp_kernel', 'fused_encoder_kernel', 'encoder_bwd_tile_kernel',
                   'encoder_wgrad_kernel', 'encoder_bwd_reduce_kernel')


def _kernels_by_name(fn, names):
    """Run ``fn()`` under a trace of the device alone
    (``ops/tune.py::traced_kernels``) and return its result and its GPU
    kernels counted by the first of ``names`` their name holds ('other' for
    the rest)."""
    from inferbiomechanics_tpu_torch.ops.tune import traced_kernels
    result, kernels = traced_kernels(fn, host=False)
    counts = dict.fromkeys((*names, 'other'), 0)
    for name, _ in kernels:
        counts[next((n for n in names if n in name), 'other')] += 1
    return result, counts


def phase_quality(torch, root, seed, card, device='cuda'):
    """22. the quality studies on the study split (trial length 1500)."""
    from inferbiomechanics_tpu_torch.scripts import anchor_quality, parity_rmse as P
    from inferbiomechanics_tpu_torch.train.step import make_eval_step
    t_phase = time.perf_counter()
    want = json.loads((REPO / 'docs' / 'port_parity' / 'study_data.json').read_text())
    data = root / 'quality_study'
    report = {'card': card}
    for fmt in ('last_frame', 'all_frames'):
        digest = P.build_study_data(str(data), want['trial_length'], fmt)[7]
        _check(digest == want[fmt], f'study data {fmt}: sha256 {digest}, on record {want[fmt]}')
    runs = (('feedforward', P.main, ['--model', 'feedforward', '--epochs', '2'], 'last_frame',
             'vpu'),
            ('transformer', anchor_quality.main, ['--family', 'transformer', '--attn-impl',
                                                  'pallas', '--epochs', '1'], 'all_frames',
             'pallas'))
    for model_type, main, argv, fmt, attn in runs:
        out = root / f'quality_{model_type}.json'
        t0, before = time.perf_counter(), P.kernel_launches()
        rc, traced = _kernels_by_name(lambda: main(  # noqa: B023
            [*argv, '--seeds', str(seed), '--data', str(data), '--out', str(out),
             '--device', device]), QUALITY_KERNELS)
        seconds = time.perf_counter() - t0
        counted = P.launches_since(before)
        res = json.loads(out.read_text())
        run = res['runs'][str(seed)]
        _check(rc == 0 and res['data_sha256'] == want[fmt] and res['card'] == card,
               f'{model_type}: rc {rc}, sha256 {res["data_sha256"]}, card {res["card"]}')
        _check(run['launches'] == counted, f'{model_type}: run launches {run["launches"]}, '
                                           f'the wrappers counted {counted}')
        # the initial weights, scored as the run scores an epoch
        ds, _, _, y_tr, x_dev, lab_dev, _, _ = P.build_study_data(
            str(data), want['trial_length'], fmt)
        model = P.study_model(model_type, ds, attn_impl=attn,
                              generator=torch.Generator().manual_seed(seed), device=device)
        eval_step = make_eval_step(model, ds.lab_offsets, P.study_loss_config())
        yd = torch.zeros((P.DEV_BATCH, *y_tr.shape[1:]), device=device)
        init = P.dev_metrics(P.dev_predictions(
            lambda xb: eval_step(None, xb, yd[:xb.shape[0]])[0],  # noqa: B023
            P.to_device(x_dev, device)), lab_dev)
        curve = run['curve']
        # CoP is not held: an untrained model's near-zero CoPs score about
        # as well as a model one epoch in
        _check(all(np.isfinite(c[m]) for c in curve for m in P.METRICS)
               and all(curve[-1][m] < init[m] for m in ('force_avg_err', 'com_acc_avg_err')),
               f'{model_type}: curve {curve} from the initial weights\' {init}')
        steps = res['config']['n_train'] // P.BATCH * res['config']['epochs']
        evals = -(-res['config']['n_dev'] // P.DEV_BATCH) * res['config']['epochs']
        layers = ENC_FULL['layers'] if attn == 'pallas' else 0
        want_traced = {'fused_mlp_kernel': evals if model_type == 'feedforward' else 0,
                       'fused_encoder_kernel': layers * (steps + evals),
                       'encoder_bwd_tile_kernel': layers * steps,
                       'encoder_wgrad_kernel': layers * steps,
                       'encoder_bwd_reduce_kernel': layers * steps}
        _check(all(traced[k] == v for k, v in want_traced.items())
               and counted == {'K1': want_traced['fused_mlp_kernel'],
                               'K2': want_traced['fused_encoder_kernel'],
                               'K3': 3 * layers * steps, 'K4': 0},
               f'{model_type}: traced {traced}, counted {counted}, want {want_traced}')
        report[f'{model_type} {attn}'] = dict(
            seconds=seconds, run_seconds=run['seconds'], steps=steps, dev_batches=evals,
            traced=traced, launches=counted, init=init, curve=curve)
        print(f'[quality] {model_type} {attn}: {steps} steps, {evals} dev batches in '
              f'{seconds:.1f} s traced ({run["seconds"]:.1f} s the run); launches {counted}; '
              f'dev force {init["force_avg_err"]:.4f} at init -> '
              f'{curve[-1]["force_avg_err"]:.4f} ({card})', flush=True)
    report['seconds'] = time.perf_counter() - t_phase
    print(f'[quality] phase 22: {report["seconds"]:.1f} s ({card})', flush=True)
    return report


def _jsonl_runs(torch, port, root, seed, device):
    """Two short feedforward ``train`` runs (seeds ``seed`` and ``seed`` + 1)
    logging to the JSONL fallback, wandb hidden; their log files."""
    home = root / 'home'
    for split, first in (('train', 2100), ('dev', 2110)):
        (home / split).mkdir(parents=True)
        port.write_synthetic_subject(str(home / split / 'subject_0.b3d'), num_trials=2,
                                     trial_length=400, seed=seed + first)
    (root / 'Geometry').mkdir()
    real = sys.modules.get('wandb', False)
    sys.modules['wandb'] = None
    logs = []
    try:
        for i in range(2):
            cwd = root / f'run_{i}'
            cwd.mkdir()
            with contextlib.chdir(cwd), contextlib.redirect_stdout(io.StringIO()):
                rc = port.main(['train', '--dataset-home', str(home), '--checkpoint-dir',
                                str(cwd / 'ckpt'), '--device', device, '--epochs', '1',
                                '--seed', str(seed + i), '--batch-size', '64',
                                '--geometry-folder', str(root / 'Geometry')])
            _check(rc == 0, f'train run {i}: exit {rc}')
            logs += sorted((cwd / 'outputs' / 'logs').glob('metrics_*.jsonl'))
    finally:
        if real is False:
            sys.modules.pop('wandb', None)
        else:
            sys.modules['wandb'] = real
    _check(len(logs) == 2, f'run logs {logs}')
    return logs


def _dp_start_params(torch, port, job, ds, device):
    """The parameters :func:`_dp_steps` starts from (float64, by name)."""
    cfg = port.config_from_args(port.parser().parse_args(['train', *job['flags']]))
    model = port.build_model_for_dataset(
        cfg, ds, generator=torch.Generator().manual_seed(job['seed']), device=device)
    return {k: v.detach().double().cpu().numpy() for k, v in model.state_dict().items()}


def _steady_windows_per_sec(epochs_seen):
    """Streamed windows over the host ms of staging and training each
    segment, leaving out each epoch's first segment (which waits for its
    build, and in a run's first epoch for the step's capture)."""
    rows = [s for e in epochs_seen for s in e['stats'][1:]]
    ms = sum(s.stage_ms + s.train_ms for s in rows)
    return sum(s.windows for s in rows) / ms * 1e3 if ms > 0 else None


def _print_times(card, what, b, ms, dev, library, bound):
    fmt = lambda us: 'not measured' if us is None else f'{us:.1f} us'  # noqa: E731
    print(f'[times] {what} B={b}, CUDA events (median of 30, better of two '
          f'runs): kernel {ms["kernel"] * 1e3:.1f} us, plain (f32 reference) '
          f'{ms["plain"] * 1e3:.1f} us, {library} {ms["library"] * 1e3:.1f} us; '
          f'bound {bound[0] * 1e3:.2f} us by {bound[1]} ({card})', flush=True)
    print(f'[times] {what} B={b}, profiler device time per call: kernel '
          f'{fmt(dev["kernel"])}, plain {fmt(dev["plain"])}, {library} '
          f'{fmt(dev["library"])}', flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--only-phase', type=int, choices=[15, 16, 17, 18, 19, 20, 21, 22],
                    default=None,
                    help='build the kernels and run this phase alone (no result lines)')
    if sys.argv[1:2] == ['--rank-jobs']:         # a torchrun rank of phase 16
        return rank_jobs(sys.argv[2])
    args = ap.parse_args()
    t_smoke = time.perf_counter()
    if not (REPO / 'inferbiomechanics_tpu_torch').is_dir():
        print('chip_smoke: run from a checkout of the repo (no '
              'inferbiomechanics_tpu_torch/ beside this script)', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this run needs '
              'a GPU', file=sys.stderr)
        return 1

    # 1. the card
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    print(f'[card] torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}',
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions' f32 matmuls
    torch.backends.cudnn.allow_tf32 = False

    from inferbiomechanics_tpu_torch.__main__ import build_parser as main_parser
    from inferbiomechanics_tpu_torch.__main__ import main as port_main
    from inferbiomechanics_tpu_torch.cli.analyze_cmd import analyze
    from inferbiomechanics_tpu_torch.cli.make_plots_cmd import render_plots
    from inferbiomechanics_tpu_torch.cli.export_cmd import eval_forward, export
    from inferbiomechanics_tpu_torch.cli.serve_cmd import build_parser, start
    from inferbiomechanics_tpu_torch.cli.train_cmd import run_training
    from inferbiomechanics_tpu_torch.config import Config, config_from_args
    from inferbiomechanics_tpu_torch.data.dataset import WindowDataset, unpack
    from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
    from inferbiomechanics_tpu_torch.models import diffusion
    from inferbiomechanics_tpu_torch.models.common import slice_output_heads
    from inferbiomechanics_tpu_torch.models.transformer import fused_transformer_forward
    from inferbiomechanics_tpu_torch.ops import _build
    from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
    from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg
    from inferbiomechanics_tpu_torch.ops import fused_mlp as fm
    from inferbiomechanics_tpu_torch.ops import library
    from inferbiomechanics_tpu_torch.ops.quant import (
        qdense, quantize_feedforward_params, quantized_feedforward_forward,
    )
    from inferbiomechanics_tpu_torch.inference import Predictor
    from inferbiomechanics_tpu_torch.cli.review_file_cmd import review_segments
    from inferbiomechanics_tpu_torch.cli.visualize_file_cmd import build_viz_payload
    from inferbiomechanics_tpu_torch.loss.evaluator import RegressionLossEvaluator
    from inferbiomechanics_tpu_torch.viz import ws
    from inferbiomechanics_tpu_torch.viz.live import LiveViewerServer
    from inferbiomechanics_tpu_torch.viz.live_model import build_live_session
    from inferbiomechanics_tpu_torch.ops.tune import (
        library_encoder_layer, library_groundlink, random_groundlink_params,
    )
    from inferbiomechanics_tpu_torch.train import augment as augment_mod
    from inferbiomechanics_tpu_torch.train.augment import mirror_outputs, spec_from_dataset
    from inferbiomechanics_tpu_torch.loss.evaluator import loss_and_metrics
    from inferbiomechanics_tpu_torch.train.checkpoint import (
        load_latest_checkpoint, save_checkpoint,
    )
    from inferbiomechanics_tpu_torch.train import step as step_mod
    from inferbiomechanics_tpu_torch.train.device_data import (
        DeviceResidentData, make_device_chunked_step, make_device_diffusion_chunked_step,
        make_device_train_step,
    )
    from inferbiomechanics_tpu_torch.train.checkpoint import load_model
    from inferbiomechanics_tpu_torch.train.loop import (
        build_model_for_dataset, loss_config_from, per_step_generators,
    )
    from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
    from inferbiomechanics_tpu_torch.train.run_config import save_run_config
    from inferbiomechanics_tpu_torch.train.state import ParamEMA, create_train_state

    # the chunked step logs each capture of a train step, with its launches
    capture_log = logging.getLogger('inferbiomechanics_tpu_torch.train.step')
    capture_log.setLevel(logging.INFO)
    to_stdout = logging.StreamHandler(sys.stdout)
    to_stdout.setFormatter(logging.Formatter('[capture] %(message)s'))
    capture_log.addHandler(to_stdout)

    # the wall clock at each phase's end, for the last [smoke] line
    marks = [('start', t_smoke)]

    def mark(name):
        marks.append((name, time.perf_counter()))

    # 2. build
    info = _build.build()
    print(f'[build] K1, K2, K3 and K4 built with nvcc in {info["seconds"]:.2f} s', flush=True)
    for line in info['log'].splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling entry function' in line:
            print(f'[build] {line.strip()}', flush=True)

    if args.only_phase == 15:
        tmp = Path(tempfile.mkdtemp(prefix='ib_chip_smoke_'))
        try:
            port = SimpleNamespace(
                parser=main_parser, config_from_args=config_from_args,
                write_synthetic_subject=write_synthetic_subject, WindowDataset=WindowDataset,
                build_model_for_dataset=build_model_for_dataset,
                create_train_state=create_train_state, make_optimizer=make_optimizer,
                DeviceResidentData=DeviceResidentData,
                make_device_chunked_step=make_device_chunked_step,
                loss_config_from=loss_config_from, start=start, build_parser=build_parser,
                slice_output_heads=slice_output_heads)
            report = phase_data_parallel(torch, port, fm, fe, fg, step_mod, tmp, args.seed, card)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(report, default=str), flush=True)
        return 0
    def inference_port():
        return SimpleNamespace(
            parser=main_parser, main=port_main, config_from_args=config_from_args,
            write_synthetic_subject=write_synthetic_subject, WindowDataset=WindowDataset,
            build_model_for_dataset=build_model_for_dataset, save_checkpoint=save_checkpoint,
            load_model=load_model, slice_output_heads=slice_output_heads, analyze=analyze,
            quantized_feedforward_forward=quantized_feedforward_forward,
            quantize_feedforward_params=quantize_feedforward_params, qdense=qdense,
            export=export, eval_forward=eval_forward, library=library, Predictor=Predictor,
            start=start, build_parser=build_parser, build_viz_payload=build_viz_payload,
            build_live_session=build_live_session, review_segments=review_segments,
            LiveViewerServer=LiveViewerServer, ws=ws,
            RegressionLossEvaluator=RegressionLossEvaluator, loss_config_from=loss_config_from)

    if args.only_phase == 17:
        tmp = Path(tempfile.mkdtemp(prefix='ib_chip_smoke_'))
        try:
            report = phase_inference(torch, inference_port(), fm, fe, fg, tmp, args.seed, card)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(report, default=str), flush=True)
        return 0
    if args.only_phase == 18:
        tmp = Path(tempfile.mkdtemp(prefix='ib_chip_smoke_'))
        try:
            report = phase_viewer(torch, inference_port(), fm, fe, fg, tmp, args.seed, card)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(report, default=str), flush=True)
        return 0
    def extras_port():
        return SimpleNamespace(
            parser=main_parser, main=port_main, run_training=run_training,
            config_from_args=config_from_args, write_synthetic_subject=write_synthetic_subject,
            WindowDataset=WindowDataset, build_model_for_dataset=build_model_for_dataset,
            save_checkpoint=save_checkpoint, step_mod=step_mod)

    if args.only_phase == 19:
        tmp = Path(tempfile.mkdtemp(prefix='ib_chip_smoke_'))
        try:
            report = phase_cli_extras(torch, extras_port(), fm, fe, fg, tmp, args.seed, card)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(report, default=str), flush=True)
        return 0
    def last_port():
        return SimpleNamespace(main=port_main, render_plots=render_plots,
                               write_synthetic_subject=write_synthetic_subject)

    if args.only_phase == 20:
        tmp = Path(tempfile.mkdtemp(prefix='ib_chip_smoke_'))
        try:
            data = tmp / 'data'       # phase 4's subjects
            data.mkdir()
            for s in range(2):
                write_synthetic_subject(str(data / f'subject_{s}.b3d'), num_trials=2,
                                        trial_length=1100, seed=args.seed + s)
            report = phase_last_commands(torch, last_port(), fm, tmp, args.seed, card, data)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(report, default=str), flush=True)
        return 0
    def options_port():
        return SimpleNamespace(
            parser=main_parser, run_training=run_training, analyze=analyze,
            config_from_args=config_from_args, write_synthetic_subject=write_synthetic_subject,
            WindowDataset=WindowDataset, build_model_for_dataset=build_model_for_dataset,
            load_model=load_model, start=start, build_parser=build_parser)

    if args.only_phase == 21:
        tmp = Path(tempfile.mkdtemp(prefix='ib_chip_smoke_'))
        try:
            data = tmp / 'data'       # phase 4's subjects
            data.mkdir()
            for s in range(2):
                write_synthetic_subject(str(data / f'subject_{s}.b3d'), num_trials=2,
                                        trial_length=1100, seed=args.seed + s)
            ds = WindowDataset(str(data), window_size=50, stride=5, skip_loading_skeletons=True)
            report = phase_options(torch, options_port(), fe, fg, diffusion, tmp, args.seed,
                                   card, data, ds)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(report, default=str), flush=True)
        return 0
    if args.only_phase == 22:
        tmp = Path(tempfile.mkdtemp(prefix='ib_chip_smoke_'))
        try:
            report = phase_quality(torch, tmp, args.seed, card)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(report, default=str), flush=True)
        return 0
    if args.only_phase == 16:
        tmp = Path(tempfile.mkdtemp(prefix='ib_chip_smoke_'))
        try:
            port = SimpleNamespace(parser=main_parser, run_training=run_training,
                                   write_synthetic_subject=write_synthetic_subject,
                                   WindowDataset=WindowDataset)
            report = phase_model_parallel(torch, port, fm, fe, fg, tmp, args.seed, card)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(report, default=str), flush=True)
        return 0

    mark('1-2 build')
    # 3. kernels vs plain
    k1_err = phase_k1_vs_plain(torch, fm, args.seed)
    k2_err, k2_checked = phase_k2_vs_plain(torch, fe, args.seed)
    k4_err, k4_checked = phase_k4_vs_plain(torch, fg, random_groundlink_params, args.seed)
    k3_err, k3_checked = phase_k3_vs_plain(torch, fe, args.seed)
    mark('3 kernels vs plain')

    tmp = Path(tempfile.mkdtemp(prefix='ib_chip_smoke_'))
    try:
        data, ckpt_root = tmp / 'data', tmp / 'checkpoints'
        data.mkdir()
        for s in range(2):
            write_synthetic_subject(str(data / f'subject_{s}.b3d'), num_trials=2,
                                    trial_length=1100, seed=args.seed + s)
        cfg = Config()     # defaults: feedforward 512x512 sigmoid, window 50 / stride 5
        ds = WindowDataset(str(data), window_size=cfg.window_size,
                           stride=cfg.stride, skip_loading_skeletons=True)
        _check(len(ds) >= 4096, f'only {len(ds)} windows')
        live = {}          # the model whose weights the servers serve now

        def weights_for(config):
            def new_weights(seed: int, epoch: int):
                live['model'] = build_model_for_dataset(
                    config, ds, generator=torch.Generator().manual_seed(seed),
                    device='cuda').eval()
                save_checkpoint(str(ckpt_root / config.model_type), live['model'],
                                epoch, 0)
            return new_weights

        def to_card(x: np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()

        # 4. the feedforward slice
        def ff_plain(x: np.ndarray) -> dict:
            with torch.no_grad():
                out = fm.mlp_reference(to_card(x).reshape(len(x), -1),
                                       live['model'].layer_params(), cfg.activation)
                return {k: v.cpu().numpy() for k, v in slice_output_heads(out, 2, 1).items()}

        def ff_agree(outputs: dict, x: np.ndarray, what: str) -> float:
            return _agree(outputs, ff_plain(x), what, atol=ATOL)

        weights_for(cfg)(args.seed, 1)
        port = SimpleNamespace(
            build_parser=build_parser, start=start, WindowDataset=WindowDataset,
            parser=main_parser, run_training=run_training,
            config_from_args=config_from_args, unpack=unpack,
            write_synthetic_subject=write_synthetic_subject,
            loss_and_metrics=loss_and_metrics, loss_config_from=loss_config_from,
            build_model_for_dataset=build_model_for_dataset,
            DeviceResidentData=DeviceResidentData,
            load_latest_checkpoint=load_latest_checkpoint, analyze=analyze,
            save_checkpoint=save_checkpoint, save_run_config=save_run_config,
            make_device_chunked_step=make_device_chunked_step,
            make_device_diffusion_chunked_step=make_device_diffusion_chunked_step,
            ParamEMA=ParamEMA, create_train_state=create_train_state,
            make_optimizer=make_optimizer, per_step_generators=per_step_generators,
            load_model=load_model, slice_output_heads=slice_output_heads,
            fused_transformer_forward=fused_transformer_forward)
        k1_launches, ff_p50 = phase_service(
            port, 'feedforward', cfg, [], data, ckpt_root, ds, weights_for(cfg),
            ff_agree, fm, 1, args.seed)

        # 5. the transformer slice, through the fused encoder layer
        tcfg = Config()
        tcfg.model_type, tcfg.fused_inference = 'transformer', True
        _check((tcfg.d_model, tcfg.num_layers, tcfg.num_heads, tcfg.attn_impl)
               == (ENC_FULL['d'], ENC_FULL['layers'], ENC_FULL['heads'], 'vpu'),
               'transformer defaults moved')

        def tf_plain(x: np.ndarray) -> dict:
            with torch.no_grad():
                out = fused_transformer_forward(live['model'], to_card(x),
                                                use_kernel=False)
                return {k: v.cpu().numpy() for k, v in out.items()}

        def tf_agree(outputs: dict, x: np.ndarray, what: str) -> float:
            want = tf_plain(x)
            _check(len(want) == 7, f'{what}: {len(want)} heads')
            return _agree(outputs, want, what, rel=HEAD_REL)

        weights_for(tcfg)(args.seed, 1)
        k2_launches, tf_p50 = phase_service(
            port, 'transformer', tcfg, ['--model-type', 'transformer', '--fused-inference'],
            data, ckpt_root, ds, weights_for(tcfg), tf_agree, fe, ENC_FULL['layers'],
            args.seed)
        tmodel = live['model']

        # 5b. the GroundLink slice, through the fused GroundLink forward
        gcfg = Config()
        gcfg.model_type = 'groundlink'

        def gl_plain(x, model=None) -> dict:
            """The plain version on the card, as torch tensors by head."""
            model = live['model'] if model is None else model
            with torch.no_grad():
                out = fg.groundlink_reference(x, model.layer_params(),
                                              gcfg.output_data_format, GL_FULL['fc_depth'])
                return slice_output_heads(out, 2, out.shape[1])

        def gl_agree(outputs: dict, x: np.ndarray, what: str) -> float:
            want = {k: v.cpu().numpy() for k, v in gl_plain(to_card(x)).items()}
            return _agree(outputs, want, what, atol=_vector_limit(want))

        weights_for(gcfg)(args.seed, 1)
        packed = live['model'].packed()
        _check(packed.widths == (GL_FULL['c_in'], *GL_FULL['features'], 256, 256, 30)
               and packed.pwidths == (192, 128, 128, 256, 256, 256, 256, 32)
               and (packed.n_conv, packed.fc_depth, packed.taps) == (4, 3, 7),
               f'GroundLink defaults moved: {packed.widths}')
        k4_launches, gl_p50 = phase_service(
            port, 'groundlink', gcfg, ['--model-type', 'groundlink'], data, ckpt_root,
            ds, weights_for(gcfg), gl_agree, fg, 1, args.seed)

        # 5c. the serving extras
        members, dirs = [], []
        for i in range(3):
            members.append(build_model_for_dataset(
                cfg, ds, generator=torch.Generator().manual_seed(args.seed + 10 + i),
                device='cuda').eval())
            dirs.append(str(tmp / f'member_{i}'))
            save_checkpoint(dirs[-1], members[-1], i, 0)

        def plain_members(x: np.ndarray) -> list:
            with torch.no_grad():
                flat = to_card(x).reshape(len(x), -1)
                return [{k: v.cpu().numpy() for k, v in slice_output_heads(
                    fm.mlp_reference(flat, m.layer_params(), cfg.activation), 2, 1).items()}
                    for m in members]

        k1_ens_launches = phase_ensemble(port, data, dirs, ds, plain_members, fm)

        spec = spec_from_dataset(ds, lateral_axis=gcfg.mirror_lateral_axis)
        in_perm = torch.as_tensor(np.asarray(spec.in_perm, np.int64)).cuda()
        in_sign = torch.as_tensor(spec.in_sign).cuda()

        def gl_symmetrized(x: np.ndarray) -> dict:
            """(f(x) + unmirror(f(mirror(x)))) / 2 with f the plain version."""
            xt = to_card(x)
            o1 = gl_plain(xt)
            o2 = mirror_outputs(spec, ds.lab_offsets, gl_plain(xt[..., in_perm] * in_sign))
            return {k: ((o1[k] + o2[k]) * 0.5).cpu().numpy() for k in o1}

        k4_tta_launches = phase_tta_and_poller(
            port, data, ckpt_root, ds, gl_symmetrized, weights_for(gcfg), fg, args.seed)

        mark('4-5c serving')
        # 7 and 7b. training
        trained = phase_training(torch, port, fe, fg, step_mod, tmp, args.seed, card)
        mark('7 training')
        # 7d. the chunked step against step by step, resumed, kernels traced
        chunked = phase_chunked(torch, port, fe, step_mod, tmp, args.seed, card)
        mark('7d chunked')

        # 8. analyze on the checkpoints phase 7 wrote
        analyzed = phase_analyze(torch, port, fm, fe, fg, tmp, args.seed, card,
                                 member=tmp / 'member_0')
        mark('8 analyze')

        # 9. the diffusion denoiser: sampling, serve and analyze through K2
        diffused = phase_diffusion(torch, port, fe, fm, fg, diffusion, tmp, args.seed, card,
                                   data, ds)
        mark('9 diffusion')

        # 10. diffusion training, with the dev eval's chains through K2
        diffusion_trained = phase_diffusion_train(torch, port, fe, fm, fg, step_mod, diffusion,
                                                  tmp, args.seed, card, tmp / 'train_data')
        mark('10 diffusion training')

        # 11. batchnorm, dropout and augmentation in every tier of both loops
        regularised = phase_regularised(torch, port, fe, fm, step_mod, augment_mod, tmp,
                                        args.seed, card)
        mark('11 regularised')

        # 12. the analytical and physics path: skeleton FK and inverse
        # dynamics, analyze --model-type analytical, --compute-report
        physics = phase_physics(torch, port, fm, fg, step_mod, tmp, args.seed, card,
                                wide=tmp / 'analyze_wide')
        mark('12 physics')

        # 13. checkpoints across frameworks: JAX-format files served, scored
        # and resumed, the asynchronous writer, soups
        checkpoints = phase_checkpoints(torch, port, fm, fe, fg, step_mod, tmp, args.seed, card)
        mark('13 checkpoints')

        # 14. scale-out on one card: --device-data stream in both loops, and
        # the sweep command (a grid in one captured step, PBT, resume)
        scale_out = phase_scale_out(torch, port, fm, fe, fg, step_mod, tmp, args.seed, card)
        mark('14 scale-out')

        # 15. data parallelism over processes: world 1 on NCCL with the
        # all-reduce in the captured step, two ranks on the card, torchrun
        data_parallel = phase_data_parallel(torch, port, fm, fe, fg, step_mod, tmp, args.seed,
                                            card)
        mark('15 data parallel')

        # 16. model parallelism and sharded sweeps: train --model-parallel 2
        # on two ranks, sweep --shard-configs under torchrun, the 2-D layout
        model_parallel = phase_model_parallel(torch, port, fm, fe, fg, tmp, args.seed, card)
        mark('16 model parallel')

        # 17. inference and serving extras: int8 serve and analyze, export
        # through K1 / K2 / K4, save-prediction-csv and the Predictor
        inference = phase_inference(torch, inference_port(), fm, fe, fg, tmp, args.seed, card,
                                    data=data)
        mark('17 inference')

        # 18. the viewer commands: visualize-file's payload, the live viewer's
        # ticks and server, review-file, on phase 17's checkpoints
        viewer = phase_viewer(torch, inference_port(), fm, fe, fg, tmp, args.seed, card,
                              data=data, ck=Path(inference['checkpoints']))
        mark('18 viewer')

        # 19. the lifted flags and the small commands: pickle-data and
        # --use-pickled, --profile, analyze --plot-errors, sanity-check
        extras = phase_cli_extras(torch, extras_port(), fm, fe, fg, tmp, args.seed, card)
        mark('19 cli extras')

        # 20. the last four commands: doctor (K1 at both shapes), make-plots,
        # plot-training on phase 19's run logs, convert-b3d
        last = phase_last_commands(torch, last_port(), fm, tmp, args.seed, card, data,
                                   logs=extras['use_pickled']['run_logs'])
        mark('20 last commands')

        # 21. the options the port refused until now: --attn-impl flax in
        # the transformer and the denoiser, --conv-impl banded in GroundLink
        options = phase_options(torch, options_port(), fe, fg, diffusion, tmp, args.seed, card,
                                data, ds)
        mark('21 options')

        # 22. the quality studies: parity_rmse (feedforward, 2 epochs) and
        # anchor_quality (the pallas transformer, 1 epoch) on the study split
        quality = phase_quality(torch, tmp, args.seed, card)
        mark('22 quality studies')

        # 6, the part that needs the dataset: a whole train step
        steps = phase_step_times(torch, port, fe, ds, make_device_train_step,
                                 make_optimizer, create_train_state, card, args.seed)
        # the default --batch-size (64): K3's small shape on the main path
        default_batch = Config().batch_size
        steps[f'pallas B={default_batch}'] = phase_step_times(
            torch, port, fe, ds, make_device_train_step, make_optimizer, create_train_state,
            card, args.seed, batch=default_batch, attns=('pallas',),
            parts_alone=False)['pallas']
        k3_step_shape = fe.plan_encoder_bwd(
            default_batch, ENC_FULL['t'], ENC_FULL['d'], ENC_FULL['d'] * ENC_FULL['mlp_ratio'],
            ENC_FULL['heads']).shape
        by_shape = steps[f'pallas B={default_batch}']['launches']['k3_by_shape']
        _check(by_shape[k3_step_shape] > 0 and sum(by_shape.values()) == by_shape[k3_step_shape],
               f'train steps at B={default_batch}: K3 by shape {by_shape}, the plan picks '
               f'{k3_step_shape}')
        # the same steps in chunks of 64 (the default --device-chunk-steps)
        for b in (4096, default_batch):
            steps[f'pallas B={b} chunks of 64'] = phase_chunk_times(
                torch, port, fe, ds, card, args.seed, b)
        mark('6 train steps')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 6. times
    print(f'[times] card {card}', flush=True)
    gen = torch.Generator().manual_seed(args.seed)
    packed = fm.pack_mlp_params(_random_params(torch, FULL_DIMS, gen), 'cuda')
    layers16 = [(W, b.to(torch.bfloat16)) for W, b in packed.layers]
    act = fm.ACTIVATIONS['sigmoid']
    k1, k1_served = {}, {}
    for b in (1, 64, 512, 4096):
        k1_served[str(b)] = fm.plan_mlp(b, packed.pdims).kernel
        xt = torch.randn(b, FULL_DIMS[0], generator=gen).cuda()
        fns = {
            'kernel': lambda: fm.fused_mlp_forward(xt, packed, 'sigmoid'),  # noqa: B023
            'plain': lambda: fm.mlp_reference(xt, packed.layers, 'sigmoid'),  # noqa: B023
            'library': lambda: _bf16_chain(torch, xt, layers16, act),  # noqa: B023
        }
        err16 = float((fns['library']() - fns['plain']()).abs().max())
        print(f'[times] bf16 cuBLAS chain B={b}: max abs err vs plain '
              f'{err16:.3g} (speed baseline only)', flush=True)
        ms, dev = _time_three(torch, fns)
        k1[b] = dict(ms=ms, dev=dev, bound=k1_bound(b, FULL_DIMS))
        _print_times(card, f'K1 1770->512->512->30 sigmoid ({k1_served[str(b)]}-batch kernel)',
                     b, ms, dev, 'bf16 cuBLAS chain', k1[b]['bound'])

    t, d, heads = ENC_FULL['t'], ENC_FULL['d'], ENC_FULL['heads']
    m, n_layers = d * ENC_FULL['mlp_ratio'], ENC_FULL['layers']
    stack = [fe.pack_encoder_params(
        _random_encoder_params(torch, fe, gen, d, ENC_FULL['mlp_ratio']), 'cuda')
        for _ in range(n_layers)]
    lib_stack = [library_encoder_layer(p.params, d, heads, m) for p in stack]
    k2, k2_stack, fwd, k2_served = {}, {}, {}, {}

    def run_stack(x, layer_fn):
        for i in range(n_layers):
            x = layer_fn(i, x)
        return x

    with torch.no_grad():
        for b in (1, 4096):
            xt = torch.randn(b, t, d, generator=gen).cuda()
            k2_served[str(b)] = fe.plan_encoder(b, t, d, m, heads).shape
            fns = {
                'kernel': lambda: fe.fused_encoder_layer(xt, stack[0], heads),  # noqa: B023
                'plain': lambda: fe.encoder_layer_reference(xt, stack[0].params, heads),  # noqa: B023
                'library': lambda: lib_stack[0](xt.to(torch.bfloat16)).float(),  # noqa: B023
            }
            err16 = float((fns['library']() - fns['plain']()).abs().max())
            print(f'[times] nn.TransformerEncoderLayer bf16 B={b}: max abs err vs '
                  f'plain {err16:.3g} (speed baseline only)', flush=True)
            ms, dev = _time_three(torch, fns)
            k2[b] = dict(ms=ms, dev=dev, bound=k2_bound(b, t, d, m))
            _print_times(card, f'K2 one layer T=10 d=256 H=8 ({k2_served[str(b)]} shape)', b, ms, dev,
                         'nn.TransformerEncoderLayer bf16', k2[b]['bound'])
            fns = {
                'kernel': lambda: run_stack(  # noqa: B023
                    xt, lambda i, h: fe.fused_encoder_layer(h, stack[i], heads)),  # noqa: B023
                'plain': lambda: run_stack(  # noqa: B023
                    xt, lambda i, h: fe.encoder_layer_reference(h, stack[i].params, heads)),  # noqa: B023
                'library': lambda: run_stack(  # noqa: B023
                    xt.to(torch.bfloat16), lambda i, h: lib_stack[i](h)).float(),  # noqa: B023
            }
            ms, dev = _time_three(torch, fns)
            bound = k2_bound(b, t, d, m)
            k2_stack[b] = dict(ms=ms, dev=dev, bound=(n_layers * bound[0], bound[1]))
            _print_times(card, f'K2 x{n_layers}, the encoder stack', b, ms, dev,
                         f'nn.TransformerEncoderLayer bf16 x{n_layers}', k2_stack[b]['bound'])
            xin = torch.randn(b, t, 177, generator=gen).cuda()
            fwd[b] = {
                'kernel': _cuda_ms(torch, lambda: fused_transformer_forward(tmodel, xin)),  # noqa: B023
                'plain': _cuda_ms(torch, lambda: fused_transformer_forward(  # noqa: B023
                    tmodel, xin, use_kernel=False)),  # noqa: B023
                'vpu': _cuda_ms(torch, lambda: tmodel(xin)),  # noqa: B023
            }
            print(f'[times] transformer forward B={b} (projection, {n_layers} layers, '
                  f'final LN, 7 heads), CUDA events: fused through K2 '
                  f'{fwd[b]["kernel"] * 1e3:.1f} us, fused through the plain layer '
                  f'{fwd[b]["plain"] * 1e3:.1f} us, vpu forward (bf16 PyTorch ops) '
                  f'{fwd[b]["vpu"] * 1e3:.1f} us', flush=True)

    k3, k3_parts, k3_served, pack_ms = {}, {}, {}, None
    train_stack = [fe.pack_encoder_params(p.params, 'cuda', transposes=True) for p in stack]
    lib_params = list(lib_stack[0].parameters())
    for b in (1, 64, 4096):
        k3_served[str(b)] = fe.plan_encoder_bwd(b, t, d, m, heads).shape
        xt = torch.randn(b, t, d, generator=gen).cuda()
        gt = torch.randn(b, t, d, generator=gen).cuda()
        x16 = xt.to(torch.bfloat16).requires_grad_(True)
        g16 = gt.to(torch.bfloat16)
        fns = {
            'kernel': lambda: fe.fused_encoder_layer_bwd(xt, gt, train_stack[0], heads),  # noqa: B023
            'plain': lambda: fe.encoder_layer_bwd_reference(  # noqa: B023
                xt, gt, train_stack[0].params, heads),  # noqa: B023
            'library': lambda: torch.autograd.grad(  # noqa: B023
                lib_stack[0](x16), [x16, *lib_params], g16),  # noqa: B023
        }
        with torch.no_grad():
            ref_dx = fns['plain']()[0]
        err16 = float((fns['library']()[0].float() - ref_dx).abs().max())
        print(f'[times] autograd through nn.TransformerEncoderLayer bf16 B={b}: dx max abs '
              f'err vs plain {err16:.3g} on values up to {float(ref_dx.abs().max()):.3g} '
              f'(speed baseline only)', flush=True)
        ms, dev = _time_three(torch, fns)
        k3[b] = dict(ms=ms, dev=dev, bound=k3_bound(b, t, d, m))
        _print_times(card, f'K3 one layer backward ({fe.BWD_LAUNCHES_PER_LAYER} launches, '
                     f'recompute included; {k3_served[str(b)]} shape) T=10 d=256 H=8', b, ms,
                     dev, 'autograd fwd+bwd through nn.TransformerEncoderLayer bf16',
                     k3[b]['bound'])
        # the tile kernel of either shape, then the two launches after it
        parts = _device_us_by_name(torch, fns['kernel'], (
            'encoder_bwd_tile_kernel', 'encoder_wgrad_kernel', 'encoder_bwd_reduce_kernel'))
        k3_parts[str(b)] = parts
        print(f'[times] K3 B={b} ({k3_served[str(b)]} shape), profiler device time by launch: '
              + ', '.join(f'{k} {v:.1f} us' for k, v in parts.items())
              + f'; bound {k3[b]["bound"][0] * 1e3:.2f} us by {k3[b]["bound"][1]}, autograd '
              + ('not measured' if dev['library'] is None else f'{dev["library"]:.1f} us')
              + f' ({card})', flush=True)
    # the tile kernel's products: 40 d^2 operations a row (8 d^2 multiply-adds
    # of recompute, 12 d^2 against transposed weights)
    tile_us = k3_parts['4096']['encoder_bwd_tile_kernel']
    k3_tile = dict(tflops=40.0 * d * d * 4096 * t / tile_us / 1e6,
                   share_of_k3_bound=k3[4096]['bound'][0] * 1e3 / tile_us)
    print(f'[times] K3 tile kernel B=4096: {k3_tile["tflops"]:.1f} TFLOP/s on the tensor '
          f'cores ({40.0 * d * d * 4096 * t / 1e9:.1f} GFLOP), K3\'s bound is '
          f'{k3_tile["share_of_k3_bound"]:.3f} of its time', flush=True)
    with torch.no_grad():
        f32_params = [tuple(q.float() for q in p.params) for p in stack]
        pack_ms = _cuda_ms(torch, lambda: [fe.pack_encoder_params(q, 'cuda', transposes=True)
                                           for q in f32_params])
    print(f'[times] packing {n_layers} layers for a train step (bf16 cast, fragment order, '
          f'weights and transposes; torch ops), CUDA events: {pack_ms * 1e3:.1f} us',
          flush=True)

    k4, k4_served = {'last_frame': {}, 'all_frames': {}}, {}
    gl_tree = random_groundlink_params(gen, GL_FULL['c_in'], GL_FULL['features'],
                                       GL_FULL['fc_depth'])
    gl_packed = fg.pack_groundlink_params(gl_tree, 'cuda')
    gl_library = library_groundlink(gl_packed.params, GL_FULL['fc_depth'])
    with torch.no_grad():
        for fmt in k4:
            # all_frames at the ends only: the smoke's time limit
            for b in (1, 8, 64, 512, 4096) if fmt == 'last_frame' else (1, 4096):
                plan = fg.plan_groundlink(b, GL_FULL['t'], gl_packed.pwidths, gl_packed.n_conv,
                                          gl_packed.fc_depth, gl_packed.taps,
                                          fmt != 'all_frames')
                k4_served[f'{b} {fmt}'] = f'{plan.shape} ({plan.windows} windows a tile, ' \
                                          f'{plan.blocks(b)} blocks)'
                xt = torch.randn(b, GL_FULL['t'], GL_FULL['c_in'], generator=gen).cuda()
                fns = {
                    'kernel': lambda: fg.fused_groundlink_forward(xt, gl_packed, fmt),  # noqa: B023
                    'plain': lambda: fg.groundlink_reference(  # noqa: B023
                        xt, gl_packed.params, fmt, GL_FULL['fc_depth']),  # noqa: B023
                    'library': lambda: gl_library(xt, fmt),  # noqa: B023
                }
                ref = fns['plain']()
                err16 = float((fns['library']() - ref).abs().max())
                print(f'[times] bf16 conv1d/linear chain B={b} {fmt}: max abs err vs plain '
                      f'{err16:.3g} on outputs up to {float(ref.abs().max()):.3g} (speed '
                      f'baseline only)', flush=True)
                ms, dev = _time_three(torch, fns)
                k4[fmt][b] = dict(ms=ms, dev=dev, bound=k4_bound(b, fmt, **GL_FULL))
                _print_times(card, f'K4 177->128->128->256->256 k=7 T=10 fc 3 {fmt} '
                             f'({k4_served[f"{b} {fmt}"]})', b, ms,
                             dev, 'bf16 F.conv1d/F.linear chain', k4[fmt][b]['bound'])

    def entry(meta, launches, err, shape, times, **more):
        big, small = times[4096], times[1]
        return dict(
            meta, launches=launches, max_abs_err=err, shape=shape,
            ms=big['ms']['kernel'], plain_ms=big['ms']['plain'],
            bound_ms=big['bound'][0], bound_by=big['bound'][1],
            library_ms=big['ms']['library'],
            ms_b1=small['ms']['kernel'], plain_ms_b1=small['ms']['plain'],
            bound_ms_b1=small['bound'][0], bound_by_b1=small['bound'][1],
            library_ms_b1=small['ms']['library'],
            device_us={str(b): v['dev'] for b, v in times.items()}, card=card, **more)

    print(f'[smoke] wall time {time.perf_counter() - t_smoke:.1f} s, phase 12 '
          f'{physics["seconds"]:.1f} s, phase 13 {checkpoints["seconds"]:.1f} s, phase 14 '
          f'{scale_out["seconds"]:.1f} s, phase 15 {data_parallel["seconds"]:.1f} s, phase 16 '
          f'{model_parallel["seconds"]:.1f} s, phase 17 {inference["seconds"]:.1f} s, phase 18 '
          f'{viewer["seconds"]:.1f} s, phase 19 {extras["seconds"]:.1f} s, phase 20 '
          f'{last["seconds"]:.1f} s, phase 21 {options["seconds"]:.1f} s, phase 22 '
          f'{quality["seconds"]:.1f} s ({card})',
          flush=True)
    mark('6 times')
    print('[smoke] seconds by part: ' + ', '.join(
        f'{name} {t1 - t0:.1f}' for (_, t0), (name, t1) in zip(marks, marks[1:])), flush=True)
    print(card, flush=True)     # name, power limit: as nvidia-smi prints them
    print(json.dumps({'kernels': [
        entry(K1, k1_launches, k1_err, 'B=4096, 1770->512->512->30, sigmoid', k1,
              library='bf16 cuBLAS chain (3 addmm)', launches_per_forward=1,
              served_by=k1_served, small_batch_max=fm.SMALL_BATCH_MAX,
              ptxas=_ptxas_report(info['log'], 'fused_mlp_kernel'),
              predict_p50_ms={'1': ff_p50[0], '4096': ff_p50[1]},
              analyze=analyzed['feedforward (K1)'],
              diffusion_partial_proposal_launches={
                  'serve': diffused['extras']['partial 0.3']['k1'],
                  'analyze B=1': diffused['analyze']['partial_launches'][1]},
              compute_report_launches={
                  'analyze B=1': physics['feedforward (K1)']['launches'][0],
                  'train dev evals': physics['train']['k1_launches']},
              physics=physics,
              analyze_ensemble_launches=analyzed['extras']['ensemble_launches'][0],
              batchnorm=regularised, checkpoints=checkpoints, scale_out=scale_out,
              data_parallel=data_parallel, model_parallel=model_parallel,
              inference=dict(export=inference['export']['feedforward'],
                             k1_call_us=inference['k1_call_us'],
                             save_prediction_csv=inference['save_prediction_csv'],
                             predictor=inference['predictor'],
                             int8_no_kernel=dict(serve=inference['serve_int8'],
                                                 analyze=inference['analyze_int8'],
                                                 export=inference['export']['int8'])),
              viewer=dict(viewer['feedforward'], frames=viewer['frames'],
                          windows=viewer['windows']),
              use_pickled=extras['use_pickled'],
              plot_errors=extras['plot_errors']['feedforward (K1)'],
              sanity_check=extras['sanity_check'],
              quality_study_launches=quality['feedforward vpu']['launches']['K1']),
        entry(K2, k2_launches, k2_err, 'B=4096, T=10, d=256, H=8, mlp 1024', k2,
              library='nn.TransformerEncoderLayer bf16', launches_per_forward=n_layers,
              stack_ms={str(b): v['ms'] for b, v in k2_stack.items()},
              forward_ms={str(b): v for b, v in fwd.items()},
              predict_p50_ms={'1': tf_p50[0], '4096': tf_p50[1]},
              diffusion=dict(launches_per_chain=n_layers * 50,
                             launches={'serve': diffused['serve']['launches'],
                                       'analyze B=1': diffused['analyze']['k2_launches'],
                                       **{k: v['launches'] for k, v in
                                          diffused['chains'].items()},
                                       **{k: v['k2'] for k, v in diffused['extras'].items()
                                          if isinstance(v, dict)}},
                             chain_b1=diffused['chain_b1'],
                             predict_p50_ms=diffused['serve']['predict_p50_ms'],
                             windows_per_sec_b4096=diffused['serve']['windows_per_sec_b4096'],
                             analyze=diffused['analyze'],
                             train=diffusion_trained),
              train_launches=trained['k2_launches'],
              train_launches_traced=trained['k2_traced'],
              analyze=analyzed['transformer pallas (K2)'],
              small_batch_max=fe.SMALL_BATCH_MAX, served_by=k2_served,
              checked_shapes=k2_checked,
              ptxas=_ptxas_report(info['log'], 'fused_encoder_kernel'),
              inference=dict(export=inference['export']['pallas'],
                             diffusion_export_plain=inference['export'][
                                 'diffusion (static batch 2, 10 steps)']),
              viewer=dict(viewer['pallas'], frames=viewer['frames'], windows=viewer['windows']),
              profile=extras['profile'],
              # the paths that run no K2: the pipeline's stages and the flax tree
              quality_study_launches=quality['transformer pallas']['launches']['K2'],
              pipeline=model_parallel['train_pp2'],
              flax=dict(transformer=options['flax_transformer'],
                        denoiser=options['flax_denoiser']),
              # the flax runs converted to the vpu tree: through K2
              converted_from_flax=options['converted_from_flax']),
        entry(K3, trained['k3_launches'], k3_err,
              'B=4096, T=10, d=256, H=8, mlp 1024; max_abs_err relative to each '
              'tensor\'s max |plain|', k3,
              library='torch.autograd.grad through nn.TransformerEncoderLayer bf16, '
                      'forward and backward',
              launches_traced=trained['k3_traced'],
              launches_per_layer=fe.BWD_LAUNCHES_PER_LAYER,
              launches_per_train_step=n_layers * fe.BWD_LAUNCHES_PER_LAYER,
              shape_launches={'train': trained['k3_shape_launches'],
                              f'train steps B={default_batch}':
                                  steps[f'pallas B={default_batch}']['launches']['k3_by_shape']},
              bwd_small_batch_max=fe.BWD_SMALL_BATCH_MAX, served_by=k3_served,
              checked_shapes=k3_checked,
              device_us_by_launch=k3_parts, tile_kernel=k3_tile, pack_ms_per_step=pack_ms,
              ptxas=_ptxas_report(info['log'], 'fused_encoder_bwd_cu'),
              train=trained, train_step=steps, chunked=chunked,
              profile_trace_launches=sum(extras['profile']['trace_kernels'][k]
                                         for k in ENC_KERNELS[1:]),
              quality_study=quality['transformer pallas']),
        entry(K4, k4_launches, k4_err,
              'B=4096, T=10, 177->128->128->256->256, k=7, fc_depth 3, last_frame',
              k4['last_frame'],
              library='bf16 F.pad + F.conv1d + F.elu x4, F.linear x3',
              launches_per_forward=1,
              all_frames={str(b): dict(ms=v['ms'], device_us=v['dev'], bound_ms=v['bound'][0],
                                       bound_by=v['bound'][1])
                          for b, v in k4['all_frames'].items()},
              last_frame={str(b): dict(ms=v['ms'], bound_ms=v['bound'][0])
                          for b, v in k4['last_frame'].items()},
              served_by=k4_served, small_batch_max=fg.SMALL_BATCH_MAX,
              large_windows=fg.LARGE_WINDOWS,
              large_windows_all_frames=fg.LARGE_WINDOWS_ALL_FRAMES,
              large_blocks=fg.LARGE_BLOCKS,
              checked_shapes=k4_checked,
              ptxas=_ptxas_report(info['log'], 'fused_groundlink_kernel'),
              extras_launches={'tta_mirror (2 a forward)': k4_tta_launches,
                               'K1 in a 3-member ensemble (3 a forward)': k1_ens_launches},
              predict_p50_ms={'1': gl_p50[0], '4096': gl_p50[1]},
              train_dev_eval_launches=trained['groundlink']['k4_launches'],
              analyze=analyzed['groundlink (K4)'],
              analyze_tta_launches=analyzed['extras']['tta_launches'][2],
              compute_report_launches={
                  'analyze B=1': physics['groundlink (K4)']['launches'][1]},
              inference=dict(export=inference['export']['groundlink']),
              viewer=dict(viewer['groundlink'], frames=viewer['frames'],
                          windows=viewer['windows']),
              plot_errors=extras['plot_errors']['groundlink (K4)'],
              banded=options['banded_groundlink']),
    ]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
