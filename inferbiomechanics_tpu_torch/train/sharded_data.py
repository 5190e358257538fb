"""Sharded device data: device memory scales with the ranks.

PyTorch counterpart of ``inferbiomechanics_tpu/train/sharded_data.py``
(``--device-data sharded``, and ``auto`` when the dataset fits the ranks'
memory together but not one device's). The trials are split over the
``data`` axis of the run's layout (``parallel/mesh.py``; every rank of a
plain data-parallel run) by longest-processing-time balancing
(:func:`partition_trials`, the JAX function, so shard row counts differ by
at most one trial); the rank at ``data`` coordinate r holds only shard r's
rows on its device (:class:`ShardedDeviceData`; the ranks that share it,
the replicas of a ``model`` axis or a sweep's ``config`` rows, hold the
same), featurized on demand when the dataset was opened with
``--no-materialize-features``, so that host memory scales with the ranks
too. Every step each rank draws ``batch_size / n_dp`` windows
uniformly from its own window table and gathers them on its device (the
reference's DistributedSampler semantics): the global batch is
``batch_size``, and only the gradient all-reduce crosses ranks.

An epoch is ``num_windows // batch_size`` steps, the same count on every
rank (a collective every step). Its selections come from a host generator
seeded by the epoch's host seed and the shard (the JAX package draws them
on the device from its ``jax.random`` key, which the port cannot
reproduce); the tests feed the JAX package's own selections through the
``sel`` seam of :class:`ShardedEpoch`. The steps run as the device tier's
do: in chunks of captured steps where the step's collectives can be
captured (``parallel/dist.py::can_capture``), else one eager step at a
time. Logging, checkpoints and SIGTERM are once an epoch, as for the JAX
package's sharded tier.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.loss.evaluator import LossConfig
from inferbiomechanics_tpu_torch.models.diffusion import DDPMSchedule, TrainDraws
from inferbiomechanics_tpu_torch.train.augment import AugmentDraws, Augmenter
from inferbiomechanics_tpu_torch.train.device_data import (
    SegmentBuffer, make_device_chunked_step, make_device_diffusion_chunked_step,
    make_device_diffusion_train_step, make_device_train_step,
)
from inferbiomechanics_tpu_torch.train.streaming_data import segment_trainer


def partition_trials(ds: WindowDataset, n_shards: int) -> List[List[int]]:
    """Greedy LPT assignment of trials to shards, balanced by row count.

    Every shard must end up with at least one window; raises otherwise
    (use the replicated tier for datasets with fewer trials than
    shards)."""
    n_trials = int(ds.trial_row_offset.shape[0])
    if n_trials < n_shards:
        raise ValueError(f'{n_trials} trials < {n_shards} shards; use the '
                         f'replicated device-data tier')
    # labels_all is materialized in every dataset mode: the row counts stay
    # metadata-only under materialize_features=False
    trial_ends = np.append(ds.trial_row_offset[1:], ds.labels_all.shape[0])
    rows = trial_ends - ds.trial_row_offset                     # [n_trials]
    order = np.argsort(rows)[::-1]                              # LPT
    loads = np.zeros(n_shards, np.int64)
    shards: List[List[int]] = [[] for _ in range(n_shards)]
    for ti in order:
        s = int(np.argmin(loads))
        shards[s].append(int(ti))
        loads[s] += int(rows[ti])
    for s, trials in enumerate(shards):
        if not any(np.any(ds.win_ft == ti) for ti in trials):
            raise ValueError(f'shard {s} has no windows; dataset too small '
                             f'for {n_shards} shards')
    return shards


class ShardedDeviceData:
    """Shard ``rank`` of ``world`` on ``device`` (the ``data`` coordinate
    and size of the run's layout): its trials' rows (bf16
    features, float32 labels) in a :class:`SegmentBuffer`, and its window
    table (segment-local window starts, in the JAX package's order).
    :meth:`gather` takes shard-local window ids. The window tables of all
    shards are kept on the host (``win_global`` [world, win_pad]: each local
    window's index in the dataset; ``win_count``)."""

    def __init__(self, ds: WindowDataset, rank: int, world: int, device):
        shards = partition_trials(ds, world)
        trial_ends = np.append(ds.trial_row_offset[1:], ds.labels_all.shape[0])
        rows_per_trial = trial_ends - ds.trial_row_offset
        bases, gids = [], []
        for trials in shards:
            row_off, b, g = 0, [], []
            for ti in trials:
                mask = ds.win_ft == ti
                b.append(ds.win_start[mask].astype(np.int64) + row_off)
                g.append(np.nonzero(mask)[0])
                row_off += int(rows_per_trial[ti])
            bases.append(np.concatenate(b))
            gids.append(np.concatenate(g))
        self.win_count = np.asarray([b.shape[0] for b in bases], np.int64)
        self.win_global = np.zeros((world, int(self.win_count.max())), np.int64)
        for s in range(world):
            self.win_global[s, :self.win_count[s]] = gids[s]
        self.rank, self.num_shards = rank, world
        self.num_windows = int(self.win_count.sum())
        self.trials = shards[rank]
        n_rows = int(sum(rows_per_trial[ti] for ti in self.trials))
        feats = np.zeros((n_rows, ds.num_input_channels), np.float32)
        labs = np.zeros((n_rows, ds.num_label_channels), np.float32)
        row_off = 0
        for ti in self.trials:
            lo, hi = int(ds.trial_row_offset[ti]), int(trial_ends[ti])
            feats[row_off:row_off + hi - lo] = (ds.features_all[lo:hi]
                                                if ds.features_all is not None
                                                else ds.featurize_trial_features(ti))
            labs[row_off:row_off + hi - lo] = ds.labels_all[lo:hi]
            row_off += hi - lo
        self.buffer = SegmentBuffer(ds, n_rows, device)
        self.buffer.load(feats, labs)
        self.device = self.buffer.device
        self.win_base = torch.from_numpy(bases[rank]).to(self.device)
        self.lab_offsets = ds.lab_offsets
        self.output_data_format = ds.output_data_format
        self.device_bytes = n_rows * (ds.num_input_channels * 2 + ds.num_label_channels * 4) \
            + bases[rank].nbytes

    @property
    def local_windows(self) -> int:
        return int(self.win_count[self.rank])

    def gather(self, sel: torch.Tensor):
        """[b] shard-local window ids (on the device) -> (inputs [b, T, C_in]
        bf16, labels [b, F, C_lab] f32), the JAX ``_local_gather``."""
        return self.buffer.gather(self.win_base[sel])


def gather_by_local_indices(sdata: ShardedDeviceData, sel: np.ndarray):
    """This rank's ``(inputs, labels)`` of explicit shard-local window ids
    ``sel`` [b] (the JAX function of the name gathers every shard's)."""
    return sdata.gather(torch.as_tensor(np.asarray(sel, np.int64), device=sdata.device))


class ShardedEpoch:
    """``epoch(state, host_seed, sel=None) -> mean_metrics``: one epoch of
    ``n_steps`` steps on this rank's shard, each on ``batch_size / n_dp``
    windows drawn uniformly (with replacement) from the shard's table: from
    a host generator seeded by (``host_seed``, the shard), or ``sel``
    [n_steps, b_local] when given. ``train(state, sel)`` trains the steps
    and returns their metric rows (:meth:`rows`); the epoch's metrics are
    their mean (each row already the global batch's, after the
    all-reduce)."""

    def __init__(self, sdata: ShardedDeviceData, batch_size: int, train: Callable,
                 steps_per_call: int = 0):
        if batch_size % sdata.num_shards:
            raise ValueError(f'batch_size {batch_size} not divisible by '
                             f'{sdata.num_shards} shards')
        self.n_steps = steps_per_call or sdata.num_windows // batch_size
        if self.n_steps == 0:
            raise ValueError(f'dataset has {sdata.num_windows} windows < '
                             f'batch_size {batch_size}')
        self.sdata, self.batch_size, self.train = sdata, batch_size, train
        self.b_local = batch_size // sdata.num_shards

    def selections(self, host_seed: int) -> np.ndarray:
        rng = np.random.default_rng((int(host_seed), self.sdata.rank))
        return rng.integers(0, self.sdata.local_windows, (self.n_steps, self.b_local))

    def rows(self, state, host_seed: int, sel: Optional[np.ndarray] = None
             ) -> List[Dict[str, np.ndarray]]:
        """The epoch's steps; their metric rows."""
        sel = self.selections(host_seed) if sel is None else np.asarray(sel, np.int64)
        if sel.shape != (self.n_steps, self.b_local):
            raise ValueError(f'selections of shape {sel.shape}, want '
                             f'{(self.n_steps, self.b_local)}')
        return self.train(state, sel)

    def __call__(self, state, host_seed: int, sel: Optional[np.ndarray] = None
                 ) -> Dict[str, np.ndarray]:
        rows = self.rows(state, host_seed, sel)
        return {key: np.mean(np.stack([r[key] for r in rows]), axis=0) for key in rows[0]}


def make_sharded_epoch_runner(model, sdata: ShardedDeviceData, loss_config: LossConfig,
                              batch_size: int, chunk_steps: int = 1,
                              steps_per_call: int = 0,
                              augment: Optional[Augmenter] = None,
                              aug_draws: Optional[AugmentDraws] = None) -> ShardedEpoch:
    """The regression step on the rank's shard (the device tier's step on
    the shard's gather): ``epoch(state, host_seed[, sel]) -> mean_metrics``.
    ``chunk_steps`` > 1 replays the step captured once."""
    step = make_device_train_step(model, sdata, loss_config, augment=augment,
                                  aug_draws=aug_draws)
    chunked = (make_device_chunked_step(model, sdata, loss_config, augment=augment,
                                        aug_draws=aug_draws)
               if chunk_steps > 1 else None)
    return ShardedEpoch(sdata, batch_size,
                        segment_trainer(step, chunked, chunk_steps, sdata.device),
                        steps_per_call)


def make_sharded_diffusion_epoch_runner(model, sdata: ShardedDeviceData,
                                        schedule: DDPMSchedule, batch_size: int,
                                        chunk_steps: int = 1, steps_per_call: int = 0,
                                        cond_dropout: float = 0.0,
                                        draws: Optional[TrainDraws] = None,
                                        augment: Optional[Augmenter] = None,
                                        aug_draws: Optional[AugmentDraws] = None
                                        ) -> ShardedEpoch:
    """Sharded diffusion training: the eps-prediction step
    (``device_data.make_device_diffusion_train_step``) on the rank's shard;
    the state's EMA, when it keeps one, is updated after every update
    (inside the captured step). ``epoch(state, host_seed[, sel]) ->
    {'loss'}``."""
    if sdata.output_data_format != 'all_frames':
        raise ValueError('diffusion requires all_frames labels')
    step = make_device_diffusion_train_step(model, sdata, schedule, cond_dropout, draws,
                                            augment, aug_draws)
    chunked = (make_device_diffusion_chunked_step(model, sdata, schedule, cond_dropout,
                                                  draws, augment, aug_draws)
               if chunk_steps > 1 else None)
    return ShardedEpoch(sdata, batch_size,
                        segment_trainer(step, chunked, chunk_steps, sdata.device),
                        steps_per_call)


__all__ = ['ShardedDeviceData', 'ShardedEpoch', 'gather_by_local_indices',
           'make_sharded_diffusion_epoch_runner', 'make_sharded_epoch_runner',
           'partition_trials']
