"""The training loop.

PyTorch counterpart of ``inferbiomechanics_tpu/train/loop.py``. Per epoch: dev-set evaluation BEFORE the train epoch, then the
train epoch with the loss logged every ``log_every_batches`` and a
checkpoint every ``checkpoint_every_batches``, and resume from the newest
``epoch_{e}_batch_{b}`` checkpoint, inside its epoch when it was written
mid-epoch (the batch order is a function of the seed and the epoch alone,
so skipping the consumed prefix replays the exact remaining stream).

Three data tiers: the device-resident one (``train/device_data.py``: the
dataset lives on the device and a step gets a ``[B]`` index vector), the
host loader (``data/loader.py``) for ``--device-data off`` or a dataset
above ``--device-data-max-bytes``, and ``--device-data stream``
(``train/streaming_data.py``): segments of trials under
``--device-data-max-bytes`` copied one at a time into one device buffer.
The streaming tier logs, checkpoints and honours SIGTERM once an epoch, as
the JAX package's does.

Both tiers run K steps a dispatch (``--device-chunk-steps``, default 64,
and ``--host-chunk-steps``; a chunk is clamped to the epoch's length): the
K steps' inputs go up in one copy, each step replays the step captured as a
CUDA graph, and the chunk's metrics come back in one copy, one chunk late,
so that the host never waits for the device between chunks. A chunk of 1
dispatches each step eagerly. Loss logs and checkpoints fire once for each
chunk that crosses their cadence, labelled with its last batch.

SIGTERM asks for a checkpoint at the next step boundary (chunk boundary,
when chunked) and a clean exit; the same command then resumes from it.
``--async-checkpoint`` writes every checkpoint through
``train/checkpoint.py::AsyncCheckpointer``: the step waits for the snapshot
on the host only, and the loop waits for the last write before it returns.

``--compute-report`` adds the inverse-dynamics joint-torque report to the
dev evaluation (``loss/tau_report.py``): the dev batches then come from the
host loader through the eval step, never the device-resident dev eval, and
the evaluator scores their outputs against each subject's skeleton.

``--augment-mirror`` / ``--augment-noise-std`` augment every tier's train
step (``train/augment.py::Augmenter``, built by ``augmenter_from_config``),
on the device, before the forward; dev evaluation never augments. The
dropout masks and the augmentation's draws come from two generators on the
device that the state reseeds from ``--seed`` and the step count before
every step (:func:`per_step_generators`).

Data parallelism over processes (``parallel/dist.py``; the ``train``
command starts it under ``IB_MULTIHOST``): one rank a device, laid out as
the JAX loop lays its devices out, on ``make_mesh(model_parallel=
--model-parallel)`` (``parallel/mesh.py``): (data, model) of shape
(n / mp, mp). The state is replicated on every rank, as the JAX loop
replicates it, and the batch is split over the ``data`` axis only, so the mp
ranks of a ``data`` row hold the same parameters and see the same rows;
``--model-parallel`` lowers the data-parallel degree to n / mp. The host
tier loads the ``data`` coordinate's shard of the epoch's order and the
device-resident tier its slice of the epoch's permutation, B windows a
rank (a global batch of n_dp x B), with the table on every rank's device;
``--device-data sharded`` (and ``auto`` when only the ``data`` ranks' memory
together holds the dataset) splits the trials over the ``data`` axis
(``train/sharded_data.py``), B / n_dp windows a rank. Every step
mean-reduces its gradients over its ``data`` group before the update
(``--grad-allreduce-dtype bf16``: in bf16; no collective when the group is
one rank), BatchNorm statistics and the Augmenter's noise scale are the
global batch's, and the per-step draws are the global batch's with the
rank's rows kept. Dev evaluation splits over the ``data`` axis and averages
its metrics. Only rank 0 writes checkpoints and the sidecar; every rank
reads them on resume; a SIGTERM to any rank stops every rank at the same
step boundary. The device-resident tier runs step by step at world size > 1
(the JAX package's policy, which counts processes), and so does every tier
whose collectives cannot be captured in a CUDA graph (gloo over two ranks
or more).

``--pipeline-parallel S`` (> 1; the transformer on the host loader tier,
step by step, with the JAX loop's refusals, :func:`check_pipeline_options`)
lays the ranks out on ``make_pipeline_mesh`` ((data, pipe) of (n / S, S))
and trains through ``parallel/pipeline.py``: each rank runs its stage's
blocks on ``--pipeline-microbatches`` microbatches (0: 2 S) of its ``data``
coordinate's batch. Every rank holds the canonical state and trains its
stage's part of it; the other stages' blocks are gathered before a dev
evaluation (once a state) and, with their optimizer moments, before every
checkpoint, so checkpoints stay canonical and resume restructures them back.

``--profile`` traces the first epoch, its dev evaluation included, into
``--profile-dir`` (``train/profiling.py``). A ``metric_logger`` (the
``train`` command's ``MetricLogger``) gets the logged losses and the train
and dev reports under the JAX package's keys.

The tiers, the chunked epoch (:func:`run_chunks`), SIGTERM, the best
checkpoint and the checkpoint directory's set-up are shared with the
diffusion loop (``train/diffusion_loop.py``).
"""

from __future__ import annotations

import itertools
import logging
import signal
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset, unpack
from inferbiomechanics_tpu_torch.data.loader import PrefetchLoader
from inferbiomechanics_tpu_torch.loss.evaluator import (
    LossConfig, RegressionLossEvaluator,
)
from inferbiomechanics_tpu_torch.loss.tau_report import make_tau_report_fn
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.models.common import generator_masks
from inferbiomechanics_tpu_torch.parallel import dist
from inferbiomechanics_tpu_torch.parallel.mesh import (
    DATA_AXIS, Layout, make_mesh, make_pipeline_mesh,
)
from inferbiomechanics_tpu_torch.parallel.pipeline import (
    PALLAS_REFUSAL, StagePlan, canonical_trainstate_from_pipeline, make_pipeline_train_step,
    pipeline_trainstate_from_canonical,
)
from inferbiomechanics_tpu_torch.train.augment import augmenter_from_config
from inferbiomechanics_tpu_torch.train.checkpoint import (
    BEST_NAME, AsyncCheckpointer, list_checkpoints, load_latest_checkpoint,
    prune_checkpoints, save_checkpoint, warm_start_from,
)
from inferbiomechanics_tpu_torch.train.device_data import (
    DeviceResidentData, make_device_chunked_step, make_device_eval_runner,
    make_device_train_step,
)
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer, wrap_freeze
from inferbiomechanics_tpu_torch.train.profiling import FirstEpochTrace
from inferbiomechanics_tpu_torch.train.run_config import (
    check_resume_architecture, save_run_config, warn_on_architecture_mismatch,
)
from inferbiomechanics_tpu_torch.train.state import create_train_state, num_params
from inferbiomechanics_tpu_torch.train.step import (
    make_chunked_train_step, make_eval_step, make_train_step,
)
from inferbiomechanics_tpu_torch.train.sharded_data import (
    ShardedDeviceData, make_sharded_epoch_runner,
)
from inferbiomechanics_tpu_torch.train.streaming_data import (
    StreamingPlan, host_seed_for, make_streaming_epoch,
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


def per_step_generators(config: Config, state, train_ds: WindowDataset, device,
                        group: Optional[dist.Group] = None):
    """The state's per-step generators on ``device``, seeded from
    ``--seed`` and the step count before every step
    (``TrainState.reseed_generators``), so that a step's draws do not depend
    on where a run was resumed: the dropout masks' (for a model with dropout
    sites) and, with ``--augment-*``, the augmentation's. Under data
    parallelism over ``group`` (the ``data`` axis; None: the world) the
    draws are the global batch's, of which the rank keeps its rows. Returns
    the Augmenter (``augmenter_from_config``; None when augmentation is
    off)."""
    model = state.model
    state.dropout_seed = config.seed
    state.draw_shard = dist.draw_shard(group)
    if hasattr(model, 'dropout_masks'):
        state.dropout_gen = torch.Generator(device=device)
        model.dropout_masks = generator_masks(state.dropout_gen, state.draw_shard)
    augmenter = augmenter_from_config(config, train_ds, logger, device=device)
    if augmenter is not None:
        state.aug_gen = torch.Generator(device=device)
    return augmenter


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


def check_tier_options(config: Config) -> None:
    """The JAX package's refusals of the data tiers' options, with its
    words (the three training loops share them)."""
    if config.device_data in ('sharded', 'stream') and config.grad_accum_steps > 1:
        raise ValueError('--grad-accum-steps applies to the host and '
                         'device-resident tiers; the sharded/streaming '
                         'tiers run fixed whole-batch epoch programs')
    if config.grad_allreduce_dtype == 'bf16':
        if config.batchnorm:
            raise ValueError('--grad-allreduce-dtype bf16 does not support '
                             'batchnorm models (running stats would need '
                             'their own cross-shard reduction)')
        if config.device_data == 'stream':
            raise ValueError('--grad-allreduce-dtype bf16 applies to the '
                             'host, device-resident, and sharded tiers; '
                             'the streaming tier runs fixed whole-batch '
                             'segment programs')


def check_pipeline_options(config: Config) -> None:
    """The JAX train loop's refusals of ``--pipeline-parallel`` (> 1), word
    for word and in its order (``inferbiomechanics_tpu/train/loop.py``):
    the transformer only, on the host loader tier, without
    ``--model-parallel``, grad accumulation, the bf16 all-reduce, dropout or
    the ``pallas`` tree."""
    if config.model_type != 'transformer':
        raise ValueError('--pipeline-parallel requires the transformer '
                         f'(got {config.model_type})')
    if config.model_parallel > 1:
        raise ValueError('--pipeline-parallel and --model-parallel are '
                         'mutually exclusive mesh layouts')
    if config.device_data in ('on', 'sharded', 'stream'):
        raise ValueError('--pipeline-parallel runs the host loader '
                         'tier; use --device-data auto or off')
    if config.grad_accum_steps > 1:
        raise ValueError('--pipeline-parallel already microbatches '
                         'the step; --grad-accum-steps must be 1')
    if config.grad_allreduce_dtype == 'bf16':
        raise ValueError('--grad-allreduce-dtype bf16 is not supported '
                         'with --pipeline-parallel')
    if config.dropout and config.dropout_prob:
        raise ValueError('--pipeline-parallel requires dropout off '
                         '(stages run without per-layer RNG plumbing)')
    if config.attn_impl == 'pallas':
        raise ValueError(PALLAS_REFUSAL)


class SigtermStop:
    """SIGTERM asks for a checkpoint at the next step boundary (chunk
    boundary, when chunked) and a clean exit: :attr:`requested` turns True.
    Installed from the main thread only (tests drive the loops from
    others); :meth:`restore` puts the previous handler back."""

    def __init__(self):
        self.requested = False
        self._old = None
        try:
            self._old = signal.signal(signal.SIGTERM, self._on_term)
        except ValueError:
            pass   # not the main thread

    def _on_term(self, signum, frame):
        self.requested = True
        logger.warning('SIGTERM received: writing a checkpoint at the '
                       'next step boundary and exiting cleanly')

    def restore(self) -> None:
        if self._old is not None:
            signal.signal(signal.SIGTERM, self._old)


class BestTracker:
    """``--keep-best`` and ``--early-stop-patience``: ``track(epoch, dev)``
    after the dev eval at ``epoch``, which scores the state AFTER epoch
    ``epoch - 1``; writes the best checkpoint through ``write_checkpoint``
    and returns True when training should stop."""

    def __init__(self, config: Config, write_checkpoint):
        self.config, self.write_checkpoint = config, write_checkpoint
        self.best, self.stale = float('inf'), 0

    def track(self, epoch: int, final_dev: Dict[str, float]) -> bool:
        config = self.config
        if not (final_dev and (config.keep_best or config.early_stop_patience)):
            return False
        dev_loss = final_dev['loss']
        if dev_loss < self.best:
            self.best, self.stale = dev_loss, 0
            if config.keep_best:
                self.write_checkpoint(epoch - 1, 0, filename=BEST_NAME)
                logger.info('new best dev loss %.6f -> %s', dev_loss, BEST_NAME)
            return False
        self.stale += 1
        if config.early_stop_patience and self.stale >= config.early_stop_patience:
            print(f'early stop: dev loss has not improved in '
                  f'{self.stale} evals (best {self.best:.6f})')
            return True
        return False


def optimizer_for(config: Config, model):
    """The optimizer the flags name over ``model``'s parameters
    (``--freeze-params`` applied)."""
    optimizer = make_optimizer(model.named_parameters(), config.opt_type,
                               config.learning_rate,
                               lr_schedule=config.lr_schedule,
                               lr_decay_steps=config.lr_decay_steps,
                               lr_warmup_steps=config.lr_warmup_steps,
                               weight_decay=config.weight_decay,
                               grad_clip_norm=config.grad_clip_norm)
    if config.freeze_params:
        optimizer = wrap_freeze(optimizer, config.freeze_params)
    return optimizer


def check_data_parallel(config: Config, n_dp: int) -> Optional[torch.dtype]:
    """The JAX package's checks of the batch against the data-parallel size
    ``n_dp`` (the layout's ``data`` axis), with its words; returns the
    gradient all-reduce's reduced dtype (bf16 for ``--grad-allreduce-dtype
    bf16``, None for float32; ignored, as in the JAX package, with a single
    data shard)."""
    if config.batch_size % n_dp != 0:
        raise ValueError(f'batch_size={config.batch_size} not divisible by '
                         f'data-parallel size {n_dp}')
    if config.grad_accum_steps > 1:
        micro = config.batch_size // config.grad_accum_steps
        if config.batch_size % config.grad_accum_steps:
            raise ValueError(f'batch_size={config.batch_size} must split into '
                             f'--grad-accum-steps {config.grad_accum_steps} '
                             f'equal microbatches')
        if micro % n_dp:
            raise ValueError(
                f'batch_size={config.batch_size} must split into '
                f'--grad-accum-steps {config.grad_accum_steps} microbatches '
                f'each divisible by data-parallel size {n_dp}')
    if config.grad_allreduce_dtype != 'bf16':
        return None
    if n_dp == 1:
        logger.info('--grad-allreduce-dtype bf16: single data shard, '
                    'no cross-device reduction to reduce — ignored')
        return None
    return torch.bfloat16


def prepare_checkpoint_dir(config: Config, state) -> bool:
    """The provenance sidecar (on resume, refuse or warn about architecture
    drift against the PREVIOUS run's sidecar before this run's overwrites
    it; every rank reads, rank 0 writes), then ``--init-from-checkpoint``,
    which must not clobber an interrupted run's progress. Returns True when
    the state was warm started."""
    if list_checkpoints(config.checkpoint_dir):
        check_resume_architecture(config, config.checkpoint_dir)
        warn_on_architecture_mismatch(config, config.checkpoint_dir, 'resume')
    dist.barrier()      # every rank has read the previous run's sidecar
    if dist.is_main():
        save_run_config(config.checkpoint_dir, config)
    if not config.init_from_checkpoint:
        return False
    if list_checkpoints(config.checkpoint_dir):
        logger.warning('--init-from-checkpoint %s ignored: %s already '
                       'has resume checkpoints',
                       config.init_from_checkpoint, config.checkpoint_dir)
        return False
    warm_start_from(state, config.init_from_checkpoint)
    logger.info('warm start: params from %s (fresh optimizer)',
                config.init_from_checkpoint)
    return True


class CheckpointWriter:
    """``write(epoch, batch, filename=None)``: ``prepare()`` on every rank
    when given, then the state (with its EMA, when
    it keeps one) to ``config.checkpoint_dir``, then the oldest epoch
    checkpoints beyond ``--keep-checkpoints`` pruned (named files are
    not). With ``--async-checkpoint`` through an ``AsyncCheckpointer``: the
    call returns once the snapshot is on the host, and :meth:`wait`, which
    the loops call before they return (a SIGTERM exit too), blocks until
    the last write is on disk. Under data parallelism only rank 0 writes
    (every rank holds the same state)."""

    def __init__(self, config: Config, state, prepare: Optional[Callable[[], None]] = None):
        self.config, self.state, self.prepare = config, state, prepare
        self.writes = dist.is_main()
        self.writer = AsyncCheckpointer() if config.async_checkpoint and self.writes else None

    def __call__(self, epoch: int, batch: int, filename=None) -> None:
        if self.prepare is not None:     # on every rank (a pipeline's gather)
            self.prepare()
        if not self.writes:
            return
        config = self.config
        keep = 0 if filename else config.keep_checkpoints
        if self.writer is not None:
            self.writer.save(config.checkpoint_dir, self.state, epoch, batch,
                             filename=filename, prune_keep=keep)
            return
        save_checkpoint(config.checkpoint_dir, self.state, epoch, batch, filename=filename)
        if keep:
            prune_checkpoints(config.checkpoint_dir, keep)

    def wait(self) -> None:
        if self.writer is not None:
            self.writer.wait()


def resident_train_data(config: Config, train_ds: WindowDataset, device,
                        dev_ds: Optional[WindowDataset] = None):
    """The device-resident tier's choice: ``(DeviceResidentData of the train
    split, pack_windows)`` when ``--device-data`` and the size (``dev_ds``'s
    too, when it is to be resident beside it) allow, else ``(None,
    False)``: the host loader."""
    if train_ds.features_all is None:
        if config.device_data == 'on':
            raise ValueError('--device-data on requires materialized features '
                             '(dataset was built with materialize_features=False)')
        return None, False
    splits = [train_ds] + ([dev_ds] if dev_ds is not None else [])
    data_bytes = sum(d.features_all.nbytes + d.labels_all.nbytes for d in splits)
    if not (config.device_data == 'on' or (config.device_data == 'auto' and
                                           data_bytes < config.device_data_max_bytes)):
        return None, False
    packed_est = sum(DeviceResidentData.packed_bytes_estimate(d) for d in splits)
    pack = (config.pack_windows == 'on' or
            (config.pack_windows == 'auto' and
             data_bytes + packed_est < config.device_data_max_bytes))
    data = DeviceResidentData(train_ds, device, pack_windows=pack)
    logger.info('device-resident data: %.0f MB on %s%s', data.device_bytes / 1e6,
                device, ' (windows packed)' if pack else '')
    return data, pack


def sharded_wanted(config: Config, train_ds: WindowDataset, on_device: bool,
                   n: int) -> bool:
    """``--device-data sharded``, or ``auto`` when the dataset missed one
    device's budget but fits the budgets of the ``n`` ranks of the ``data``
    axis together (the JAX rule; the bytes of a lazy dataset from its
    metadata: rows x C_in float32)."""
    if config.device_data == 'sharded':
        return True
    if config.device_data != 'auto' or on_device or n == 1 or config.grad_accum_steps > 1:
        return False
    if train_ds.features_all is not None:
        data_bytes = train_ds.features_all.nbytes + train_ds.labels_all.nbytes
    else:
        data_bytes = (train_ds.labels_all.shape[0] * train_ds.num_input_channels * 4
                      + train_ds.labels_all.nbytes)
    return data_bytes < config.device_data_max_bytes * n


def sharded_tier(config: Config, train_ds: WindowDataset, device, on_device: bool,
                 build: Callable, layout: Layout):
    """The sharded tier's epoch when :func:`sharded_wanted`: the shard of
    the rank's ``data`` coordinate on ``device`` (``train/sharded_data.py``)
    and ``build(sdata, chunk_steps)``; None otherwise, or when ``auto``
    cannot shard (logged; the host loader then). Its steps run in chunks of
    ``--device-chunk-steps`` where their collectives can be captured."""
    n_dp, group = layout.size(DATA_AXIS), layout.group(DATA_AXIS)
    if not sharded_wanted(config, train_ds, on_device, n_dp):
        return None
    try:
        sdata = ShardedDeviceData(train_ds, layout.coord(DATA_AXIS), n_dp, device)
        epoch = build(sdata, max(1, config.device_chunk_steps) if dist.can_capture(group) else 1)
    except (ValueError, NotImplementedError) as e:
        if config.device_data == 'sharded':
            raise
        logger.warning('sharded device data unavailable (%s); '
                       'falling back to the host loader', e)
        return None
    logger.info('sharded device data: %d shards, %.0f MB on %s', sdata.num_shards,
                sdata.device_bytes / 1e6, device)
    return epoch


def chunk_steps(config: Config, train_ds: WindowDataset, on_device: bool,
                lowp: Optional[torch.dtype] = None, group: Optional[dist.Group] = None) -> int:
    """Steps a dispatch (``--device-chunk-steps`` or ``--host-chunk-steps``),
    clamped to the epoch length over the processes: a larger chunk would
    never fill. One (step by step) on the device-resident tier at world size
    > 1 or with the bf16 all-reduce (the JAX package's policy, which counts
    processes), and on every tier whose collectives over ``group`` (the
    ``data`` axis) cannot be captured in a CUDA graph (gloo). Host chunks
    and the bf16 all-reduce refuse each other, in the JAX package's
    words."""
    asked = config.device_chunk_steps if on_device else config.host_chunk_steps
    k = min(max(1, asked), max(1, len(train_ds) // dist.world_size() // config.batch_size))
    if lowp is not None and not on_device and k > 1:
        raise ValueError('--host-chunk-steps > 1 does not compose with '
                         '--grad-allreduce-dtype (the explicit-psum '
                         'shard_map step); use one or the other')
    if (on_device and (dist.world_size() > 1 or lowp is not None)) or not dist.can_capture(group):
        return 1
    return k


def upload_dtype(config: Config) -> torch.dtype:
    """The host tier's input dtype on the way to the device: bf16 with
    ``--host-upload-dtype bf16`` (rounded on the host; the models round
    their inputs to bf16 anyway), else float32."""
    return torch.bfloat16 if config.host_upload_dtype == 'bf16' else torch.float32


def train_loader(config: Config, train_ds: WindowDataset, device, chunked: bool,
                 shard: Tuple[int, int] = (0, 1)) -> PrefetchLoader:
    """The host tier's loader of shard ``shard`` = (index, count) of the
    epoch's order (the ``data`` coordinate and size; (0, 1): all of it): a
    chunk takes its batches on the host in float32 and uploads them itself;
    an eager step gets them on ``device`` in :func:`upload_dtype`."""
    return PrefetchLoader(train_ds, config.batch_size,
                          device='cpu' if chunked else device,
                          n_threads=config.data_loading_workers,
                          input_dtype=torch.float32 if chunked else upload_dtype(config),
                          shard_index=shard[0], num_shards=shard[1])


def epoch_batches(config: Config, train_ds: WindowDataset, loader: PrefetchLoader,
                  epoch: int, on_device: bool, pad_to_batch: bool = False,
                  shard: Tuple[int, int] = (0, 1)):
    """The epoch's (index, batch) pairs: on the device tier, window index
    vectors from numpy's generator seeded (seed, epoch) (the JAX package's
    regression loop draws the same batches); else the loader's batches.
    ``pad_to_batch`` is the JAX sweep's rule on the device tier: at least one
    step, a split shorter than a batch repeated to fill it (``np.resize``).
    Under data parallelism (``shard`` = (the ``data`` coordinate, the
    ``data`` size)) the permutation is truncated to a multiple of the size
    and the rank takes every size-th window from its coordinate on (equal
    step counts on every rank; the replicas of a ``data`` row the same rows,
    as the mesh's ``P('data')`` gives them), and the loader its shard."""
    if not on_device:
        return enumerate(loader.epoch(seed=config.seed * 1_000_003 + epoch))
    perm = np.random.default_rng((config.seed, epoch)).permutation(len(train_ds))
    index, n = shard
    if n > 1:
        perm = perm[:(perm.shape[0] // n) * n][index::n]
    b = config.batch_size
    if pad_to_batch:
        return enumerate(np.resize(perm[k * b:(k + 1) * b], b)
                         for k in range(max(1, perm.shape[0] // b)))
    return enumerate(perm[k * b:(k + 1) * b] for k in range(perm.shape[0] // b))


def run_streamed_epoch(streaming, state, config: Config, train_ds: WindowDataset,
                       epoch: int, *, metric_logger, metric_key: str, write_checkpoint,
                       stop: SigtermStop):
    """One epoch of the streaming or the sharded tier under their
    epoch-granular policy, for both loops: the epoch (its host seed from
    ``--seed`` and ``epoch``), its mean loss logged under ``metric_key``, one
    checkpoint, and SIGTERM (on any rank) honoured after it. Returns (the epoch's mean metrics, its seconds, the
    windows it counts as the JAX package counts them, True when SIGTERM
    asked to stop)."""
    t0 = time.time()
    metrics = streaming(state, host_seed_for(config.seed, epoch))
    seconds = time.time() - t0
    if metrics and metric_logger is not None:
        metric_logger.log({metric_key: float(metrics['loss']), 'epoch': epoch})
    write_checkpoint(epoch, 0)
    windows = (len(train_ds) // config.batch_size) * config.batch_size
    return metrics, seconds, windows, dist.any_rank(stop.requested)


class ReadyMetrics:
    """An eager step's metrics, as a chunk of one step."""

    def __init__(self, metrics):
        self.metrics = metrics

    def rows(self):
        return [self.metrics]


def make_dispatch(state, step, chunked_step, on_device: bool, device):
    """``dispatch(group) -> chunk`` for :func:`run_chunks`: a group of
    (index, batch) pairs through ``chunked_step`` (window index vectors on
    the device tier, host batches on the host tier), or, without one, a
    group of one batch through the eager ``step``."""

    def dispatch(group):
        if chunked_step is not None:
            if on_device:
                return chunked_step(state, np.stack([b for _, b in group]))
            return chunked_step(state, [b.inputs.numpy() for _, b in group],
                                [b.labels.numpy() for _, b in group])
        (_, b), = group
        if on_device:
            return ReadyMetrics(step(state, torch.from_numpy(b).to(device, non_blocking=True)))
        return ReadyMetrics(step(state, b.inputs, b.labels))

    return dispatch


def crosses(first_idx: int, last_idx: int, every: int) -> bool:
    """True when batches first_idx .. last_idx cross a multiple of
    ``every`` (batch 0 never counts)."""
    return last_idx > 0 and last_idx // every > max(first_idx - 1, 0) // every


def run_chunks(dispatch, batch_iter, chunk_k: int, *, skip: int, cap: Optional[int],
               log_every: int, checkpoint_every: int, account, log, checkpoint, stop):
    """Train an epoch's (index, batch) pairs in chunks of ``chunk_k``
    consecutive batch indices, each through ``dispatch(group)`` (the indices
    below ``skip``, a resumed epoch's consumed prefix, and from ``cap`` on,
    ``max_batches_per_epoch``, left out, so a chunk may be shorter).

    A chunk is accounted one chunk late, while the next one runs: its rows
    to ``account(row)`` in step order, then its cadences, once each for the
    chunk and labelled with its last batch: ``log(last_idx, last_row)``
    (also for the epoch's first chunk) and ``checkpoint(last_idx)``. A chunk
    that writes a checkpoint is accounted before the next one goes out, while
    the state is the one its label names. Reading the rows is the only wait
    for the device within an epoch. ``stop()`` True ends the epoch after the
    chunk that reached batch 1 or later.

    Returns (batches trained, the last batch index when ``stop()`` ended the
    epoch else None, the last step's metrics)."""
    count, pending, last = 0, None, None

    def drain(p):
        nonlocal last
        first_idx, last_idx, chunk = p
        rows = chunk.rows()
        for row in rows:
            account(row)
        last = rows[-1]
        if first_idx == 0 or crosses(first_idx, last_idx, log_every):
            log(last_idx, last)
        if crosses(first_idx, last_idx, checkpoint_every):
            checkpoint(last_idx)

    it = iter(batch_iter)
    while True:
        raw = list(itertools.islice(it, chunk_k))
        if not raw:
            break
        hit_cap = cap is not None and raw[-1][0] >= cap - 1
        group = [g for g in raw if (cap is None or g[0] < cap) and g[0] >= skip]
        if not group:
            if hit_cap:
                break
            continue
        first_idx, last_idx = group[0][0], group[-1][0]
        if pending is not None and crosses(pending[0], pending[1], checkpoint_every):
            drain(pending)
            pending = None
        chunk = dispatch(group)
        if pending is not None:
            drain(pending)
        pending = (first_idx, last_idx, chunk)
        count += len(group)
        if stop() and last_idx >= 1:
            drain(pending)
            return count, last_idx, last
        if hit_cap:
            break
    if pending is not None:
        drain(pending)
    return count, None, last


def train(config: Config,
          train_ds: WindowDataset,
          dev_ds: Optional[WindowDataset] = None,
          metric_logger=None,
          max_batches_per_epoch: Optional[int] = None,
          device='cuda') -> TrainResult:
    """Run the whole training workflow on ``device`` (``cuda`` fails without
    a GPU; ``cpu`` runs the kernels' plain versions). The diffusion
    denoiser trains through ``train/diffusion_loop.py::train_diffusion``."""
    from inferbiomechanics_tpu_torch.serve import resolve_device
    pp = max(1, int(config.pipeline_parallel))
    if pp > 1:
        check_pipeline_options(config)
    check_tier_options(config)
    if config.model_type == 'diffusion':
        raise ValueError('--model-type diffusion trains through '
                         'train/diffusion_loop.py::train_diffusion')
    device = resolve_device(device)
    # the JAX refusals of a world --model-parallel or --pipeline-parallel does
    # not divide (one process: 1)
    layout = (make_pipeline_mesh(pipe=pp) if pp > 1
              else make_mesh(model_parallel=config.model_parallel))
    n_dp, dp_group = layout.size(DATA_AXIS), layout.group(DATA_AXIS)
    dp_shard = (layout.coord(DATA_AXIS), n_dp)
    lowp = check_data_parallel(config, n_dp)

    stop = SigtermStop()
    model = build_model_for_dataset(
        config, train_ds, generator=torch.Generator().manual_seed(config.seed),
        device=device)
    lc = loss_config_from(config)
    state = create_train_state(model, optimizer_for(config, model))
    # on-device augmentation in every tier's train step; dev eval never augments
    augment = per_step_generators(config, state, train_ds, device, dp_group)
    dist.attach(state, model, lowp, augment, dp_group)
    logger.info('model %s: %d params on %s', config.model_type,
                num_params(state), device)
    prepare_checkpoint_dir(config, state)

    ckpt_epoch, ckpt_batch = load_latest_checkpoint(state, config.checkpoint_dir)
    stages = None
    if pp > 1:
        # the canonical state (fresh or resumed) becomes this rank's stage;
        # checkpoints stay canonical (the writer gathers the stages first)
        stages = StagePlan(layout, model.num_layers)
        pipeline_trainstate_from_canonical(state, stages)
    if ckpt_batch > 0:
        # a mid-epoch checkpoint is written AFTER the step at ckpt_batch, so
        # its update is in the state already: resume at ckpt_batch + 1
        start_epoch, skip_batches = ckpt_epoch, ckpt_batch + 1
    else:
        start_epoch, skip_batches = ckpt_epoch + 1, 0

    # ---- the data tier ----
    # every rank evaluates whole batches of its data shard of the dev split
    dev_big_enough = dev_ds is not None and len(dev_ds) // n_dp >= config.batch_size
    # the torque report needs each dev batch's inputs, outputs and subjects
    # the pipeline runs the host loader tier, step by step
    dev_resident = (dev_big_enough and dev_ds.features_all is not None
                    and not config.compute_report and stages is None)
    device_data, pack = (resident_train_data(config, train_ds, device,
                                             dev_ds if dev_resident else None)
                         if stages is None else (None, False))
    on_device = device_data is not None
    chunk_k, chunked_step, device_eval, dispatch, streaming = 1, None, None, None, None
    if stages is not None:
        num_micro = config.pipeline_microbatches or 2 * pp
        step = make_pipeline_train_step(model, train_ds.lab_offsets, lc, stages,
                                        num_microbatches=num_micro, augment=augment)
        logger.info('pipeline parallelism: %d stages x %d layers, dp=%d, '
                    '%d microbatches/step', pp, model.num_layers // pp, n_dp, num_micro)
    else:
        streaming = sharded_tier(config, train_ds, device, on_device, lambda sdata, k: (
            make_sharded_epoch_runner(model, sdata, lc, config.batch_size, chunk_steps=k,
                                      augment=augment)), layout)
    if streaming is None and stages is None:
        chunk_k = chunk_steps(config, train_ds, on_device, lowp, dp_group)
        if config.device_data == 'stream':
            plan = StreamingPlan(train_ds, config.device_data_max_bytes)
            streaming = make_streaming_epoch(model, train_ds, plan, lc, config.batch_size, device,
                                             chunk_steps=max(1, config.device_chunk_steps),
                                             augment=augment)
            logger.info('streaming data: %d segments of %d rows', len(plan.segments),
                        plan.rows_pad)
        elif on_device:
            step = make_device_train_step(model, device_data, lc,
                                          grad_accum=config.grad_accum_steps, augment=augment)
            if chunk_k > 1:
                chunked_step = make_device_chunked_step(model, device_data, lc,
                                                        grad_accum=config.grad_accum_steps,
                                                        augment=augment)
            if dev_resident:
                device_eval = make_device_eval_runner(
                    model, DeviceResidentData(dev_ds, device, pack_windows=pack),
                    lc, config.batch_size, shard=dist.draw_shard(dp_group))
        else:
            step = make_train_step(model, train_ds.lab_offsets, lc,
                                   grad_accum=config.grad_accum_steps, augment=augment)
            if chunk_k > 1:
                chunked_step = make_chunked_train_step(
                    model, train_ds.lab_offsets, lc, grad_accum=config.grad_accum_steps,
                    input_dtype=upload_dtype(config), device=device, augment=augment)
    if streaming is None:
        if chunked_step is not None:
            logger.info('chunked dispatch: %d steps a chunk', chunk_k)
        loader = train_loader(config, train_ds, device, chunked_step is not None, dp_shard)
        dispatch = make_dispatch(state, step, chunked_step, on_device, device)
    eval_step = make_eval_step(model, train_ds.lab_offsets, lc)
    dev_loader = (PrefetchLoader(dev_ds, config.batch_size, device=device, shuffle=False,
                                 shard_index=dp_shard[0], num_shards=n_dp)
                  if dev_big_enough else None)

    tau_fn = (make_tau_report_fn(dev_ds, device)
              if config.compute_report and dev_ds is not None else None)
    train_eval = RegressionLossEvaluator('train', lc, wandb_logger=metric_logger)
    dev_eval = RegressionLossEvaluator('dev', lc, tau_fn=tau_fn, wandb_logger=metric_logger)
    windows_seen = 0
    compute_time = 0.0
    final_dev: Dict[str, float] = {}
    train_metrics: Dict[str, float] = {}
    epochs_run = 0

    # a pipeline's dev eval reads the canonical parameters, gathered once a
    # state; its checkpoints the canonical state, moments too
    gathered_at = [None]

    def gather_params() -> None:
        if stages is not None and gathered_at[0] != state.step:
            canonical_trainstate_from_pipeline(state, stages, optimizer=False)
            gathered_at[0] = state.step

    write_checkpoint = CheckpointWriter(config, state, prepare=None if stages is None else (
        lambda: canonical_trainstate_from_pipeline(state, stages)))
    best = BestTracker(config, write_checkpoint)

    def run_dev_eval(epoch: int) -> bool:
        """Dev eval of the CURRENT state."""
        nonlocal final_dev
        if device_eval is not None:
            dev_eval(None, None, None,
                     precomputed_metrics=dist.mean_over_ranks(device_eval(state), dp_group))
        elif dev_loader is not None:
            gather_params()
            for batch in dev_loader.epoch(seed=config.seed * 1_000_003 + epoch):
                outputs, metrics = eval_step(state, batch.inputs, batch.labels)
                dev_eval(batch.inputs, outputs, unpack(batch.labels, dev_ds.lab_offsets),
                         batch.subject_indices, compute_report=config.compute_report,
                         precomputed_metrics=dist.mean_over_ranks(metrics, dp_group))
        else:
            return False
        print(f'[epoch {epoch}] dev report:')
        final_dev = dev_eval.print_report(log_to_wandb=metric_logger is not None)
        return True

    def log_loss(epoch: int, batch_idx: int, metrics) -> None:
        loss = float(metrics['loss'])      # waits for the device
        if metric_logger is not None:
            metric_logger.log({'train/loss': loss, 'epoch': epoch, 'batch': batch_idx})
        logger.info('epoch %d batch %d loss %.6f', epoch, batch_idx, loss)

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
                    metric_key='train/loss', write_checkpoint=write_checkpoint, stop=stop)
                if metrics:
                    train_eval(None, None, None, precomputed_metrics=metrics)
                compute_time += seconds
                windows_seen += n
                epochs_run += 1
                trace.close()
                print(f'[epoch {epoch}] train report ({seconds:.1f}s):')
                train_metrics = train_eval.print_report(log_to_wandb=metric_logger is not None)
                if preempted:
                    break
                continue
            t_epoch = time.time()
            # windows_per_sec: the epoch's wall clock, closed by reading back
            # the LAST step's loss (the device runs behind the host)
            t_compute = time.time()
            n, stopped_at, last_metrics = run_chunks(
                dispatch,
                epoch_batches(config, train_ds, loader, epoch, on_device, shard=dp_shard),
                chunk_k,
                skip=skip_batches if epoch == start_epoch else 0, cap=max_batches_per_epoch,
                log_every=config.log_every_batches,
                checkpoint_every=config.checkpoint_every_batches,
                account=lambda row: train_eval(None, None, None, precomputed_metrics=row),
                log=lambda idx, row: log_loss(epoch, idx, row),              # noqa: B023
                checkpoint=lambda idx: write_checkpoint(epoch, idx),         # noqa: B023
                stop=lambda: dist.any_rank(stop.requested))
            windows_seen += n * config.batch_size
            if last_metrics is not None:
                float(last_metrics['loss'])     # synchronises with the device
                compute_time += time.time() - t_compute
            if stopped_at is not None:
                write_checkpoint(epoch, stopped_at)
                logger.info('preemption checkpoint written: epoch %d batch %d',
                            epoch, stopped_at)
                preempted = True
                break
            epochs_run += 1
            trace.close()
            print(f'[epoch {epoch}] train report ({time.time() - t_epoch:.1f}s):')
            train_metrics = train_eval.print_report(log_to_wandb=metric_logger is not None)
            write_checkpoint(epoch, 0)
    finally:
        trace.close()      # also after no epoch, a SIGTERM or an exception

    # the loop evaluates BEFORE each epoch, so without this the last epoch's
    # state would never be scored and could not become the best checkpoint
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
                       final_train_metrics=train_metrics if epochs_run else {},
                       final_dev_metrics=final_dev,
                       windows_per_sec=wps,
                       windows_seen=windows_seen,
                       preempted=preempted)
