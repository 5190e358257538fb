"""The training loop.

PyTorch counterpart of ``inferbiomechanics_tpu/train/loop.py``, for one
device. Per epoch: dev-set evaluation BEFORE the train epoch, then the
train epoch with the loss logged every ``log_every_batches`` and a
checkpoint every ``checkpoint_every_batches``, and resume from the newest
``epoch_{e}_batch_{b}`` checkpoint, inside its epoch when it was written
mid-epoch (the batch order is a function of the seed and the epoch alone,
so skipping the consumed prefix replays the exact remaining stream).

Two data tiers: the device-resident one (``train/device_data.py``: the
dataset lives on the device and a step gets a ``[B]`` index vector), and
the host loader (``data/loader.py``) for ``--device-data off`` or a
dataset above ``--device-data-max-bytes``.

Both tiers run K steps a dispatch (``--device-chunk-steps``, default 64,
and ``--host-chunk-steps``; a chunk is clamped to the epoch's length): the
K steps' inputs go up in one copy, each step replays the step captured as a
CUDA graph, and the chunk's metrics come back in one copy, one chunk late,
so that the host never waits for the device between chunks. A chunk of 1
dispatches each step eagerly. Loss logs and checkpoints fire once for each
chunk that crosses their cadence, labelled with its last batch.

SIGTERM asks for a checkpoint at the next step boundary (chunk boundary,
when chunked) and a clean exit; the same command then resumes from it.
"""

from __future__ import annotations

import itertools
import logging
import signal
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.loader import PrefetchLoader
from inferbiomechanics_tpu_torch.loss.evaluator import (
    LossConfig, RegressionLossEvaluator,
)
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.models.common import generator_masks
from inferbiomechanics_tpu_torch.train.checkpoint import (
    BEST_NAME, list_checkpoints, load_latest_checkpoint, prune_checkpoints,
    save_checkpoint, warm_start_from,
)
from inferbiomechanics_tpu_torch.train.device_data import (
    DeviceResidentData, make_device_chunked_step, make_device_eval_runner,
    make_device_train_step,
)
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer, wrap_freeze
from inferbiomechanics_tpu_torch.train.run_config import (
    check_resume_architecture, save_run_config, warn_on_architecture_mismatch,
)
from inferbiomechanics_tpu_torch.train.state import create_train_state, num_params
from inferbiomechanics_tpu_torch.train.step import (
    make_chunked_train_step, make_eval_step, make_train_step,
)

logger = logging.getLogger(__name__)


@dataclass
class TrainResult:
    epochs_run: int
    final_train_metrics: Dict[str, float]
    final_dev_metrics: Dict[str, float]
    windows_per_sec: float
    windows_seen: int = 0
    preempted: bool = False   # SIGTERM checkpoint-and-exit (see train())


def loss_config_from(config: Config) -> LossConfig:
    return LossConfig(
        predict_grf_components=tuple(config.predict_grf_components),
        predict_cop_components=tuple(config.predict_cop_components),
        predict_moment_components=tuple(config.predict_moment_components),
        predict_wrench_components=tuple(config.predict_wrench_components),
        aux_tau_weight=config.aux_tau_weight,
        aux_com_acc_weight=config.aux_com_acc_weight,
        aux_contact_weight=config.aux_contact_weight,
    )


def _reject_unported(config: Config) -> None:
    """Raise for every training option of the JAX package that the port
    does not have yet, by the flag's name."""
    unported = [
        ('--pipeline-parallel', config.pipeline_parallel > 1,
         'ROADMAP.md, not to port'),
        ('--model-parallel', config.model_parallel > 1,
         'ROADMAP.md Queue 1 item 8 (scale-out)'),
        ('--grad-allreduce-dtype bf16', config.grad_allreduce_dtype == 'bf16',
         'ROADMAP.md Queue 1 item 8 (scale-out)'),
        ('--augment-mirror', config.augment_mirror,
         'ROADMAP.md Queue 1 item 4 (the Augmenter)'),
        ('--augment-noise-std', config.augment_noise_std > 0,
         'ROADMAP.md Queue 1 item 4 (the Augmenter)'),
        ('--compute-report', config.compute_report,
         'ROADMAP.md Queue 1 item 7 (analytical and physics)'),
        ('--async-checkpoint', config.async_checkpoint,
         'ROADMAP.md Queue 1 item 2.6 (checkpoints)'),
        ('--profile', config.profile, 'ROADMAP.md Queue 1 item 9 (the rest of the CLI)'),
        ('--model-type diffusion', config.model_type == 'diffusion',
         'ROADMAP.md Queue 1 item 6b (diffusion training)'),
        (f'--device-data {config.device_data}',
         config.device_data in ('sharded', 'stream'),
         'ROADMAP.md Queue 1 item 8 (scale-out)'),
    ]
    for flag, asked, where in unported:
        if asked:
            raise NotImplementedError(f'{flag} is not yet ported ({where})')


def train(config: Config,
          train_ds: WindowDataset,
          dev_ds: Optional[WindowDataset] = None,
          metric_logger=None,
          max_batches_per_epoch: Optional[int] = None,
          device='cuda') -> TrainResult:
    """Run the whole training workflow on ``device`` (``cuda`` fails without
    a GPU; ``cpu`` runs the kernels' plain versions)."""
    from inferbiomechanics_tpu_torch.serve import resolve_device
    _reject_unported(config)
    device = resolve_device(device)
    if config.grad_accum_steps > 1 and config.batch_size % config.grad_accum_steps:
        raise ValueError(f'batch_size={config.batch_size} must split into '
                         f'--grad-accum-steps {config.grad_accum_steps} '
                         f'equal microbatches')

    stop_requested = {'flag': False}

    def _on_term(signum, frame):
        stop_requested['flag'] = True
        logger.warning('SIGTERM received: writing a checkpoint at the '
                       'next step boundary and exiting cleanly')

    old_handler = None
    try:
        old_handler = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass   # not the main thread (e.g. tests driving train() directly)

    model = build_model_for_dataset(
        config, train_ds, generator=torch.Generator().manual_seed(config.seed),
        device=device)
    lc = loss_config_from(config)
    optimizer = make_optimizer(model.named_parameters(), config.opt_type,
                               config.learning_rate,
                               lr_schedule=config.lr_schedule,
                               lr_decay_steps=config.lr_decay_steps,
                               lr_warmup_steps=config.lr_warmup_steps,
                               weight_decay=config.weight_decay,
                               grad_clip_norm=config.grad_clip_norm)
    if config.freeze_params:
        optimizer = wrap_freeze(optimizer, config.freeze_params)
    state = create_train_state(model, optimizer)
    # dropout masks from a generator of their own on the device, seeded from
    # --seed and the step count before every step (TrainState.reseed_dropout):
    # the masks of a step do not depend on where a run was resumed
    if hasattr(model, 'dropout_masks'):
        state.dropout_gen = torch.Generator(device=device)
        state.dropout_seed = config.seed
        model.dropout_masks = generator_masks(state.dropout_gen)
    logger.info('model %s: %d params on %s', config.model_type,
                num_params(state), device)

    # provenance sidecar; on resume, refuse or warn about architecture drift
    # against the PREVIOUS run's sidecar before this run's overwrites it
    if list_checkpoints(config.checkpoint_dir):
        check_resume_architecture(config, config.checkpoint_dir)
        warn_on_architecture_mismatch(config, config.checkpoint_dir, 'resume')
    save_run_config(config.checkpoint_dir, config)
    if config.init_from_checkpoint:
        # a warm start must not clobber an interrupted run's progress
        if list_checkpoints(config.checkpoint_dir):
            logger.warning('--init-from-checkpoint %s ignored: %s already '
                           'has resume checkpoints',
                           config.init_from_checkpoint, config.checkpoint_dir)
        else:
            warm_start_from(state, config.init_from_checkpoint)
            logger.info('warm start: params from %s (fresh optimizer)',
                        config.init_from_checkpoint)

    ckpt_epoch, ckpt_batch = load_latest_checkpoint(state, config.checkpoint_dir)
    if ckpt_batch > 0:
        # a mid-epoch checkpoint is written AFTER the step at ckpt_batch, so
        # its update is in the state already: resume at ckpt_batch + 1
        start_epoch, skip_batches = ckpt_epoch, ckpt_batch + 1
    else:
        start_epoch, skip_batches = ckpt_epoch + 1, 0

    # ---- the data tier ----
    dev_big_enough = dev_ds is not None and len(dev_ds) >= config.batch_size
    dev_resident = dev_big_enough and dev_ds.features_all is not None
    use_device_data = False
    if train_ds.features_all is not None:
        data_bytes = train_ds.features_all.nbytes + train_ds.labels_all.nbytes
        if dev_resident:
            data_bytes += dev_ds.features_all.nbytes + dev_ds.labels_all.nbytes
        use_device_data = (config.device_data == 'on' or
                           (config.device_data == 'auto' and
                            data_bytes < config.device_data_max_bytes))
    elif config.device_data == 'on':
        raise ValueError('--device-data on requires materialized features '
                         '(dataset was built with materialize_features=False)')
    # a chunk is clamped to the epoch's length: one larger would never fill
    steps_per_epoch = max(1, len(train_ds) // config.batch_size)
    device_step = device_eval = chunked_step = None
    chunk_k = 1
    if use_device_data:
        packed_est = DeviceResidentData.packed_bytes_estimate(train_ds)
        if dev_resident:
            packed_est += DeviceResidentData.packed_bytes_estimate(dev_ds)
        pack = (config.pack_windows == 'on' or
                (config.pack_windows == 'auto' and
                 data_bytes + packed_est < config.device_data_max_bytes))
        device_data = DeviceResidentData(train_ds, device, pack_windows=pack)
        device_step = make_device_train_step(model, device_data, lc,
                                             grad_accum=config.grad_accum_steps)
        chunk_k = min(max(1, config.device_chunk_steps), steps_per_epoch)
        if chunk_k > 1:
            chunked_step = make_device_chunked_step(model, device_data, lc,
                                                    grad_accum=config.grad_accum_steps)
        logger.info('device-resident data: %.0f MB on %s%s',
                    device_data.device_bytes / 1e6, device,
                    ' (windows packed)' if pack else '')
        if dev_resident:
            device_eval = make_device_eval_runner(
                model, DeviceResidentData(dev_ds, device, pack_windows=pack),
                lc, config.batch_size)
    train_step = make_train_step(model, train_ds.lab_offsets, lc,
                                 grad_accum=config.grad_accum_steps)
    eval_step = make_eval_step(model, train_ds.lab_offsets, lc)
    # --host-upload-dtype bf16: the inputs go up rounded to bf16 on the host
    upload_dtype = torch.bfloat16 if config.host_upload_dtype == 'bf16' else torch.float32
    if not use_device_data:
        chunk_k = min(max(1, config.host_chunk_steps), steps_per_epoch)
        if chunk_k > 1:
            chunked_step = make_chunked_train_step(
                model, train_ds.lab_offsets, lc, grad_accum=config.grad_accum_steps,
                input_dtype=upload_dtype, device=device)
    if chunked_step is not None:
        logger.info('chunked dispatch: %d steps a chunk', chunk_k)
    # a chunk takes its batches on the host and uploads them itself
    train_loader = PrefetchLoader(
        train_ds, config.batch_size,
        device='cpu' if chunked_step is not None else device,
        n_threads=config.data_loading_workers,
        input_dtype=torch.float32 if chunked_step is not None else upload_dtype)
    dev_loader = (PrefetchLoader(dev_ds, config.batch_size, device=device,
                                 shuffle=False) if dev_big_enough else None)

    train_eval = RegressionLossEvaluator('train', lc)
    dev_eval = RegressionLossEvaluator('dev', lc)
    windows_seen = 0
    compute_time = 0.0
    final_dev: Dict[str, float] = {}
    train_metrics: Dict[str, float] = {}
    epochs_run = 0
    best_dev_loss = float('inf')
    stale_evals = 0

    def write_checkpoint(epoch: int, batch: int, filename=None) -> None:
        save_checkpoint(config.checkpoint_dir, state, epoch, batch, filename=filename)
        if config.keep_checkpoints and not filename:
            prune_checkpoints(config.checkpoint_dir, config.keep_checkpoints)

    def run_dev_eval(epoch: int) -> bool:
        """Dev eval of the CURRENT state."""
        nonlocal final_dev
        if device_eval is not None:
            dev_eval(None, None, None, precomputed_metrics=device_eval(state))
        elif dev_loader is not None:
            for batch in dev_loader.epoch(seed=config.seed * 1_000_003 + epoch):
                _, metrics = eval_step(state, batch.inputs, batch.labels)
                dev_eval(None, None, None, precomputed_metrics=metrics)
        else:
            return False
        print(f'[epoch {epoch}] dev report:')
        final_dev = dev_eval.print_report()
        if metric_logger is not None and final_dev:
            metric_logger.log({'dev/loss': final_dev['loss'], 'epoch': epoch})
        return True

    def track_best(epoch: int) -> bool:
        """Best-checkpoint and early-stop bookkeeping; the dev eval at epoch
        e scores the state AFTER epoch e-1. True when training should stop."""
        nonlocal best_dev_loss, stale_evals
        if not (final_dev and (config.keep_best or config.early_stop_patience)):
            return False
        dev_loss = final_dev['loss']
        if dev_loss < best_dev_loss:
            best_dev_loss, stale_evals = dev_loss, 0
            if config.keep_best:
                write_checkpoint(epoch - 1, 0, filename=BEST_NAME)
                logger.info('new best dev loss %.6f -> %s', dev_loss, BEST_NAME)
            return False
        stale_evals += 1
        if config.early_stop_patience and stale_evals >= config.early_stop_patience:
            print(f'early stop: dev loss has not improved in '
                  f'{stale_evals} evals (best {best_dev_loss:.6f})')
            return True
        return False

    def log_loss(epoch: int, batch_idx: int, metrics) -> None:
        loss = float(metrics['loss'])      # waits for the device
        if metric_logger is not None:
            metric_logger.log({'train/loss': loss, 'epoch': epoch, 'batch': batch_idx})
        logger.info('epoch %d batch %d loss %.6f', epoch, batch_idx, loss)

    def crosses(first_idx: int, last_idx: int, every: int) -> bool:
        """True when batches first_idx .. last_idx cross a multiple of
        ``every`` (batch 0 never counts)."""
        return last_idx > 0 and last_idx // every > max(first_idx - 1, 0) // every

    def run_chunked_epoch(epoch: int, batch_iter):
        """The epoch's batches in chunks of ``chunk_k`` consecutive batch
        indices (the resume prefix and the batches past
        ``max_batches_per_epoch`` left out, so a chunk may be shorter).
        Returns (windows trained, preempted, the last step's metrics)."""
        windows, pending, last = 0, None, None

        def drain(p):
            """Account a dispatched chunk: its rows to the evaluator in step
            order, then its log and checkpoint cadences, once each for the
            chunk, labelled with its last batch. Reading the rows is the only
            wait for the device within an epoch."""
            nonlocal last
            first_idx, last_idx, chunk = p
            rows = chunk.rows()
            for row in rows:
                train_eval(None, None, None, precomputed_metrics=row)
            last = rows[-1]
            if first_idx == 0 or crosses(first_idx, last_idx, config.log_every_batches):
                log_loss(epoch, last_idx, last)
            if crosses(first_idx, last_idx, config.checkpoint_every_batches):
                write_checkpoint(epoch, last_idx)

        cap = max_batches_per_epoch
        it = iter(batch_iter)
        while True:
            raw = list(itertools.islice(it, chunk_k))
            if not raw:
                break
            hit_cap = cap is not None and raw[-1][0] >= cap - 1
            group = [g for g in raw if (cap is None or g[0] < cap)
                     and not (epoch == start_epoch and g[0] < skip_batches)]
            if not group:
                if hit_cap:
                    break
                continue
            first_idx, last_idx = group[0][0], group[-1][0]
            if pending is not None and crosses(pending[0], pending[1],
                                               config.checkpoint_every_batches):
                # the pending chunk writes a mid-epoch checkpoint: drain it
                # now, while the state is the one its batch label names
                drain(pending)
                pending = None
            if use_device_data:
                chunk = chunked_step(state, np.stack([b for _, b in group]))
            else:
                chunk = chunked_step(state, [b.inputs.numpy() for _, b in group],
                                     [b.labels.numpy() for _, b in group])
            # the metrics of the chunk before come back while this one runs
            if pending is not None:
                drain(pending)
            pending = (first_idx, last_idx, chunk)
            windows += len(group) * config.batch_size
            if stop_requested['flag'] and last_idx >= 1:
                drain(pending)
                write_checkpoint(epoch, last_idx)
                logger.info('preemption checkpoint written: epoch %d batch %d',
                            epoch, last_idx)
                return windows, True, last
            if hit_cap:
                break
        if pending is not None:
            drain(pending)
        return windows, False, last

    stopped_early = preempted = False
    for epoch in range(start_epoch, config.epochs):
        run_dev_eval(epoch)
        if track_best(epoch):
            stopped_early = True
            break

        t_epoch = time.time()
        if use_device_data:
            # numpy's generator on both sides: the port and the JAX package
            # see the same batches
            perm = np.random.default_rng(
                (config.seed, epoch)).permutation(len(train_ds))
            n_steps = perm.shape[0] // config.batch_size
            batches = (perm[k * config.batch_size:(k + 1) * config.batch_size]
                       for k in range(n_steps))
            if chunked_step is None:
                batches = (torch.from_numpy(b).to(device, non_blocking=True)
                           for b in batches)
            batch_iter = enumerate(batches)
        else:
            batch_iter = enumerate(train_loader.epoch(
                seed=config.seed * 1_000_003 + epoch))
        # windows_per_sec: the epoch's wall clock, closed by reading back
        # the LAST step's loss (the device runs behind the host)
        t_compute = time.time()
        last_metrics = None
        if chunked_step is not None:
            windows, preempted, last_metrics = run_chunked_epoch(epoch, batch_iter)
            windows_seen += windows
        else:
            for batch_idx, batch in batch_iter:
                if max_batches_per_epoch is not None and batch_idx >= max_batches_per_epoch:
                    break
                if epoch == start_epoch and batch_idx < skip_batches:
                    continue   # mid-epoch resume: prefix already consumed
                if use_device_data:
                    metrics = device_step(state, batch)
                else:
                    metrics = train_step(state, batch.inputs, batch.labels)
                train_eval(None, None, None, precomputed_metrics=metrics)
                last_metrics = metrics
                # only at batch_idx >= 1: a batch-0 mid-epoch checkpoint looks
                # like an end-of-epoch one to the resume logic
                if stop_requested['flag'] and batch_idx >= 1:
                    write_checkpoint(epoch, batch_idx)
                    logger.info('preemption checkpoint written: epoch %d batch %d',
                                epoch, batch_idx)
                    preempted = True
                    windows_seen += config.batch_size
                    break
                if batch_idx % config.log_every_batches == 0:
                    log_loss(epoch, batch_idx, metrics)
                if batch_idx > 0 and batch_idx % config.checkpoint_every_batches == 0:
                    write_checkpoint(epoch, batch_idx)
                windows_seen += config.batch_size
        if last_metrics is not None:
            float(last_metrics['loss'])     # synchronises with the device
            compute_time += time.time() - t_compute
        if preempted:
            break
        epochs_run += 1
        print(f'[epoch {epoch}] train report ({time.time() - t_epoch:.1f}s):')
        train_metrics = train_eval.print_report()
        write_checkpoint(epoch, 0)

    # the loop evaluates BEFORE each epoch, so without this the last epoch's
    # state would never be scored and could not become the best checkpoint
    if ((config.keep_best or config.early_stop_patience)
            and not stopped_early and epochs_run > 0
            and run_dev_eval(config.epochs)):
        track_best(config.epochs)
    if old_handler is not None:
        signal.signal(signal.SIGTERM, old_handler)
    if preempted:
        print('training preempted (SIGTERM): checkpoint written, resume '
              'with the same command')
    wps = windows_seen / compute_time if compute_time > 0 else 0.0
    return TrainResult(epochs_run=epochs_run,
                       final_train_metrics=train_metrics if epochs_run else {},
                       final_dev_metrics=final_dev,
                       windows_per_sec=wps,
                       windows_seen=windows_seen,
                       preempted=preempted)
