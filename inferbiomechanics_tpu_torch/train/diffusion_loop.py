"""The diffusion denoiser's training loop.

PyTorch counterpart of ``inferbiomechanics_tpu/train/diffusion_loop.py``:
the regression loop's epoch structure (``train/loop.py``: dev eval before
each epoch, checkpoints at their cadence and after each epoch, SIGTERM,
``--keep-best``, ``--early-stop-patience``, ``--init-from-checkpoint``, the
device-resident and host-loader tiers in chunks of captured steps, and
``--device-data stream``, an epoch a call, ``train/streaming_data.py``), with
the eps-prediction step (``models/diffusion.py::make_diffusion_train_step``)
and a dev evaluation that SAMPLES the model: a 50-step DDIM chain of the
current parameters a dev batch, scored by the ``RegressionLossEvaluator``,
so that a diffusion run reports the schema of every other model. With
``--fused-inference`` the chain's denoiser calls run the fused encoder
layer kernel (K2), one launch a layer and step.

``--augment-mirror`` / ``--augment-noise-std`` augment each step's
conditioning and labels as in the regression loop (``train/augment.py``);
the dev chains see the windows as they are.

``--ema-decay`` keeps an exponential moving average of the parameters on
the train state (``train/state.py::ParamEMA``), updated after every update
inside the step, and so inside a captured step's graph. It rides in every
checkpoint as ``ema_params``, which ``serve --use-ema`` and ``analyze
--use-ema`` read, and is seeded from the resumed checkpoint's, else from
the warm-start source's, else from the parameters.

Data parallelism over processes follows the regression loop
(``train/loop.py``: the ranks laid out on ``make_mesh(model_parallel=
--model-parallel)``, the state and its EMA replicated, the batch over the
``data`` axis; the sharded tier through
``train/sharded_data.py::make_sharded_diffusion_epoch_runner``, with the
EMA); the gradients are mean-reduced in float32 (the JAX package's
diffusion loop reads no ``--grad-allreduce-dtype``), and the dev chains
score each rank's shard of the dev batches.

Resume is epoch-granular, as in the JAX package: a run resumes at the epoch
after its newest checkpoint's, so a mid-epoch (or SIGTERM) checkpoint keeps
the parameters, the optimizer and the EMA, but the rest of its epoch is not
replayed. A step's draws come from the state's generator reseeded from
``--seed`` and the step count, so a resumed run draws what the uninterrupted
one drew.

``--profile`` traces the first epoch, its dev chains included, into
``--profile-dir`` (``train/profiling.py``).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import torch

from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset, unpack
from inferbiomechanics_tpu_torch.data.loader import PrefetchLoader
from inferbiomechanics_tpu_torch.loss.evaluator import RegressionLossEvaluator
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.models.diffusion import (
    DDPMSchedule, make_diffusion_train_step, make_sampler,
)
from inferbiomechanics_tpu_torch.parallel import dist
from inferbiomechanics_tpu_torch.train.checkpoint import (
    load_ema_params, load_latest_checkpoint, resolve_checkpoint_path,
)
from inferbiomechanics_tpu_torch.train.device_data import (
    make_device_diffusion_chunked_step, make_device_diffusion_train_step,
)
from inferbiomechanics_tpu_torch.train.loop import (
    BestTracker, CheckpointWriter, SigtermStop, TrainResult, check_tier_options,
    check_data_parallel, chunk_steps, epoch_batches, loss_config_from, make_dispatch,
    optimizer_for, per_step_generators, prepare_checkpoint_dir, resident_train_data,
    run_chunks, run_streamed_epoch, sharded_tier, train_loader, upload_dtype,
)
from inferbiomechanics_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
from inferbiomechanics_tpu_torch.train.sharded_data import make_sharded_diffusion_epoch_runner
from inferbiomechanics_tpu_torch.train.profiling import FirstEpochTrace
from inferbiomechanics_tpu_torch.train.state import ParamEMA, create_train_state, num_params
from inferbiomechanics_tpu_torch.train.step import ChunkedStep
from inferbiomechanics_tpu_torch.train.streaming_data import (
    StreamingPlan, make_streaming_diffusion_epoch,
)

logger = logging.getLogger(__name__)

EVAL_SAMPLE_STEPS = 50   # DDIM steps for dev-set sampling


def train_diffusion(config: Config,
                    train_ds: WindowDataset,
                    dev_ds: Optional[WindowDataset] = None,
                    metric_logger=None,
                    max_batches_per_epoch: Optional[int] = None,
                    device='cuda') -> TrainResult:
    """Train the diffusion denoiser on ``device`` (``cuda`` fails without a
    GPU; ``cpu`` runs the kernels' plain versions). ``final_train_metrics``
    is ``{'eps_mse': the last step's loss}``."""
    from inferbiomechanics_tpu_torch.serve import resolve_device
    # --compute-report and --pipeline-parallel are not read here, as the JAX
    # package's diffusion loop reads neither
    check_tier_options(config)
    if config.output_data_format != 'all_frames':
        raise ValueError('diffusion training requires --output-data-format '
                         'all_frames (the denoiser models whole windows)')
    device = resolve_device(device)
    layout = make_mesh(model_parallel=config.model_parallel)    # as the JAX loop's
    n_dp, dp_group = layout.size(DATA_AXIS), layout.group(DATA_AXIS)
    dp_shard = (layout.coord(DATA_AXIS), n_dp)
    if check_data_parallel(config, n_dp) is not None:
        logger.warning('--grad-allreduce-dtype bf16: the diffusion loop reduces its '
                       'gradients in float32 (the JAX package\'s diffusion loop reads '
                       'no --grad-allreduce-dtype)')

    stop = SigtermStop()
    model = build_model_for_dataset(
        config, train_ds, generator=torch.Generator().manual_seed(config.seed), device=device)
    # on the training device: a captured step reads its constants there
    sched = DDPMSchedule(config.diffusion_timesteps, device=device)
    state = create_train_state(model, optimizer_for(config, model))
    # a step's timesteps, noise and keep mask come from a generator on the
    # device, reseeded from --seed and the step count before every step; the
    # augmentation (mirrored / noised conditioning, mirrored labels) from a
    # generator of its own, so that it moves none of them
    state.dropout_gen = torch.Generator(device=device)
    augment = per_step_generators(config, state, train_ds, device, dp_group)
    dist.attach(state, model, None, augment, dp_group)
    logger.info('diffusion model: %d params on %s', num_params(state), device)
    warm_started = prepare_checkpoint_dir(config, state)
    ckpt_epoch, _ = load_latest_checkpoint(state, config.checkpoint_dir)
    start_epoch = ckpt_epoch + 1
    if config.ema_decay:
        path = resolve_checkpoint_path(config.checkpoint_dir)
        if path is None and warm_started:
            path = config.init_from_checkpoint
        state.ema = ParamEMA(model, config.ema_decay,
                             init=load_ema_params(path, like=model) if path else None)

    # ---- the data tier ----
    device_data, _ = resident_train_data(config, train_ds, device)
    on_device = device_data is not None
    chunk_k = chunk_steps(config, train_ds, on_device, group=dp_group)
    chunked_step = dispatch = None
    streaming = None
    if max_batches_per_epoch is None and len(train_ds) >= config.batch_size:
        streaming = sharded_tier(config, train_ds, device, on_device, lambda sdata, k: (
            make_sharded_diffusion_epoch_runner(model, sdata, sched, config.batch_size,
                                                chunk_steps=k, cond_dropout=config.cond_dropout,
                                                augment=augment)), layout)
    if streaming is not None:
        logger.info('diffusion sharded data: %d shards', n_dp)
    elif config.device_data == 'stream':
        plan = StreamingPlan(train_ds, config.device_data_max_bytes)
        streaming = make_streaming_diffusion_epoch(
            model, train_ds, plan, sched, config.batch_size, device,
            chunk_steps=max(1, config.device_chunk_steps), cond_dropout=config.cond_dropout,
            augment=augment)
        logger.info('diffusion streaming data: %d segments of %d rows',
                    len(plan.segments), plan.rows_pad)
    elif on_device:
        step = make_device_diffusion_train_step(model, device_data, sched, config.cond_dropout,
                                                augment=augment)
        if chunk_k > 1:
            chunked_step = make_device_diffusion_chunked_step(model, device_data, sched,
                                                              config.cond_dropout,
                                                              augment=augment)
    else:
        step = make_diffusion_train_step(model, train_ds.lab_offsets, sched, config.cond_dropout,
                                         augment=augment)
        if chunk_k > 1:
            chunked_step = ChunkedStep(step, (upload_dtype(config), torch.float32), device)
    if streaming is None:
        if chunked_step is not None:
            logger.info('chunked dispatch: %d steps a chunk', chunk_k)
        loader = train_loader(config, train_ds, device, chunked_step is not None, dp_shard)
        dispatch = make_dispatch(state, step, chunked_step, on_device, device)
    sampler = make_sampler(model, sched, num_steps=EVAL_SAMPLE_STEPS,
                           fused_inference=config.fused_inference)
    dev_loader = (PrefetchLoader(dev_ds, config.batch_size, device=device, shuffle=False,
                                 shard_index=dp_shard[0], num_shards=n_dp)
                  if dev_ds is not None and len(dev_ds) // n_dp >= config.batch_size
                  else None)
    dev_eval = RegressionLossEvaluator('dev', loss_config_from(config),
                                       wandb_logger=metric_logger)

    windows_seen, compute_time = 0, 0.0
    final_dev: Dict[str, float] = {}
    last_loss = float('nan')
    epochs_run = 0
    write_checkpoint = CheckpointWriter(config, state)
    best = BestTracker(config, write_checkpoint)

    def run_dev_eval(epoch: int) -> bool:
        """Sample the CURRENT parameters on each dev batch and score it."""
        nonlocal final_dev
        if dev_loader is None:
            return False
        model.eval()    # the fused chain packs the weights once, until the next train()
        for batch in dev_loader.epoch(seed=config.seed * 1_000_003 + epoch):
            gen = torch.Generator(device=device).manual_seed(
                config.seed * 1_000_003 + 777 + epoch)
            outputs = sampler(model, batch.inputs, gen)
            with torch.no_grad():
                metrics = dev_eval.compute_metrics(outputs, unpack(batch.labels, dev_ds.lab_offsets))
            dev_eval(None, None, None,
                     precomputed_metrics=dist.mean_over_ranks(metrics, dp_group))
        print(f'[epoch {epoch}] dev report (sampled, {EVAL_SAMPLE_STEPS} steps):')
        final_dev = dev_eval.print_report(log_to_wandb=metric_logger is not None)
        return True

    def log_loss(epoch: int, batch_idx: int, metrics) -> None:
        loss = float(metrics['loss'])      # waits for the device
        if metric_logger is not None:
            metric_logger.log({'train/diffusion_loss': loss, 'epoch': epoch, 'batch': batch_idx})
        logger.info('epoch %d batch %d eps-mse %.6f', epoch, batch_idx, loss)

    stopped_early = preempted = False
    # --profile: the first epoch, its dev evaluation included
    trace = FirstEpochTrace(config.profile, config.profile_dir, device)
    try:
        for epoch in range(start_epoch, config.epochs):
            run_dev_eval(epoch)
            if best.track(epoch, final_dev):
                stopped_early = True
                break
            if streaming is not None:
                metrics, seconds, n, preempted = run_streamed_epoch(
                    streaming, state, config, train_ds, epoch, metric_logger=metric_logger,
                    metric_key='train/diffusion_loss', write_checkpoint=write_checkpoint, stop=stop)
                if metrics:
                    last_loss = float(metrics['loss'])
                compute_time += seconds
                windows_seen += n
                epochs_run += 1
                trace.close()
                print(f'[epoch {epoch}] eps-mse {last_loss:.6f}')
                if preempted:
                    break
                continue
            # windows_per_sec: the epoch's wall clock, closed by reading back
            # the LAST step's loss (the device runs behind the host)
            t_compute = time.time()
            n, stopped_at, last = run_chunks(
                dispatch, epoch_batches(config, train_ds, loader, epoch, on_device, shard=dp_shard),
                chunk_k,
                skip=0, cap=max_batches_per_epoch, log_every=config.log_every_batches,
                checkpoint_every=config.checkpoint_every_batches, account=lambda row: None,
                log=lambda idx, row: log_loss(epoch, idx, row),              # noqa: B023
                checkpoint=lambda idx: write_checkpoint(epoch, idx),         # noqa: B023
                stop=lambda: dist.any_rank(stop.requested))
            windows_seen += n * config.batch_size
            if last is not None:
                last_loss = float(last['loss'])
                compute_time += time.time() - t_compute
            epochs_run += 1
            trace.close()
            print(f'[epoch {epoch}] eps-mse {last_loss:.6f}')
            # a SIGTERM checkpoint is this epoch's too: resume is epoch-granular
            write_checkpoint(epoch, 0)
            if stopped_at is not None:
                preempted = True
                break
    finally:
        trace.close()      # also after no epoch, a SIGTERM or an exception

    # score the FINAL state too (the loop evaluates before each epoch only)
    if ((config.keep_best or config.early_stop_patience)
            and not stopped_early and epochs_run > 0
            and run_dev_eval(config.epochs)):
        best.track(config.epochs, final_dev)
    write_checkpoint.wait()      # the last checkpoint is on disk
    stop.restore()
    if preempted:
        print('training preempted (SIGTERM): checkpoint written, resume '
              'with the same command')
    wps = windows_seen / compute_time if compute_time > 0 else 0.0
    return TrainResult(epochs_run=epochs_run,
                       final_train_metrics={'eps_mse': last_loss},
                       final_dev_metrics=final_dev,
                       windows_per_sec=wps,
                       windows_seen=windows_seen,
                       preempted=preempted)
