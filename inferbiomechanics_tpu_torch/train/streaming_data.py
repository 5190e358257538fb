"""Streaming device data: training when the dataset exceeds device memory.

PyTorch counterpart of ``inferbiomechanics_tpu/train/streaming_data.py``
(``--device-data stream``). Trials are packed into segments that fit a
memory budget (:class:`StreamingPlan`); each epoch visits the segments in a
shuffled order, copies one segment's rows into one preallocated device
buffer (``train/device_data.py::SegmentBuffer``) and trains that segment's
shuffled windows, in chunks of ``--device-chunk-steps`` replays of the
captured step. Segments are padded to one row count and the buffer is never
reallocated, so one captured step serves every segment: the counterpart of
the JAX package's one compiled program for every segment. Shuffling is
hierarchical: segments globally, windows within a segment.

Segments are built one at a time, the next on a host thread while the
current one trains, so host memory holds two segments, not the dataset;
with a ``materialize_features=False`` dataset the tier is out of core:
each segment's trials are featurized on demand
(``WindowDataset.featurize_trial_features``).

The epoch's host generator is seeded by an integer (``host_seed``): the JAX
package derives it from its ``jax.random`` key, which the port cannot
reproduce, so the port derives its own from numpy (:func:`host_seed_for`)
and the tests pass the JAX package's integer.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

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


@dataclass
class Segment:
    """Metadata only: rows materialize via ``StreamingPlan.segment_arrays``."""
    trials: List[int]             # flat-trial ids packed into this segment
    win_base: np.ndarray          # [W_seg] window starts, segment-local rows
    n_rows: int                   # un-padded row count


class StreamingPlan:
    """Pack trials into equal-row segments under ``hbm_budget_bytes``.

    The budget counts float32 bytes for features and labels, although the
    features go to the device in bf16 (the JAX package's rule, which sets
    the segment count). Planning is metadata only (row counts from
    ``labels_all``, which every dataset mode materializes); feature bytes
    are touched only when ``segment_arrays`` materializes a segment.
    """

    def __init__(self, ds: WindowDataset, hbm_budget_bytes: int):
        bytes_per_row = (ds.num_input_channels + ds.num_label_channels) * 4
        budget_rows = max(1, hbm_budget_bytes // bytes_per_row)
        n_trials = ds.trial_row_offset.shape[0]
        trial_ends = np.append(ds.trial_row_offset[1:], ds.labels_all.shape[0])

        self.ds = ds
        self._trial_ends = trial_ends
        self.segments: List[Segment] = []
        cur_trials: List[int] = []
        cur_rows = 0

        def flush():
            nonlocal cur_trials, cur_rows
            if not cur_trials:
                return
            base_chunks = []
            row_off = 0
            for ti in cur_trials:
                lo, hi = int(ds.trial_row_offset[ti]), int(trial_ends[ti])
                mask = ds.win_ft == ti
                base_chunks.append(ds.win_start[mask].astype(np.int64) + row_off)
                row_off += hi - lo
            self.segments.append(Segment(
                trials=cur_trials,
                win_base=(np.concatenate(base_chunks) if base_chunks else
                          np.zeros(0, np.int64)),
                n_rows=row_off))
            cur_trials, cur_rows = [], 0

        for ti in range(n_trials):
            rows = int(trial_ends[ti]) - int(ds.trial_row_offset[ti])
            if rows > budget_rows:
                raise ValueError(
                    f'trial {ti} has {rows} rows > segment budget {budget_rows}; '
                    f'raise hbm_budget_bytes')
            if cur_rows + rows > budget_rows:
                flush()
            cur_trials.append(ti)
            cur_rows += rows
        flush()

        # one padded row count: one device buffer and one captured step
        self.rows_pad = max((s.n_rows for s in self.segments), default=0)

    def segment_arrays(self, si: int) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize segment ``si``: ([rows_pad, C_in] f32 features,
        [rows_pad, C_lab] labels), zero-padded. Features come from the
        materialized matrix when present, else per trial on demand."""
        ds = self.ds
        seg = self.segments[si]
        feats = np.zeros((self.rows_pad, ds.num_input_channels), np.float32)
        labs = np.zeros((self.rows_pad, ds.num_label_channels), np.float32)
        row_off = 0
        for ti in seg.trials:
            lo, hi = int(ds.trial_row_offset[ti]), int(self._trial_ends[ti])
            n = hi - lo
            if ds.features_all is not None:
                feats[row_off:row_off + n] = ds.features_all[lo:hi]
            else:
                feats[row_off:row_off + n] = ds.featurize_trial_features(ti)
            labs[row_off:row_off + n] = ds.labels_all[lo:hi]
            row_off += n
        return feats, labs


def host_seed_for(seed: int, epoch: int) -> int:
    """The port's host seed of an epoch, from ``(seed, epoch)``."""
    return int(np.random.default_rng((seed, epoch)).integers(0, 2**31 - 1))


@dataclass
class SegmentStats:
    """One trained segment: its index, windows trained, steps, the host ms
    to build it (in the prefetch thread) and to stage it (bf16 into pinned
    memory), the device ms of its copy (CUDA events; host ms on the CPU),
    and the ms from its first dispatch to its last step's metrics on the
    host."""
    segment: int
    windows: int
    steps: int
    build_ms: float
    stage_ms: float
    upload_ms: Optional[float]
    train_ms: float


class StreamingEpoch:
    """``epoch(state, host_seed) -> mean_metrics``: one streamed epoch.

    Visits the plan's segments in an order shuffled by ``host_seed`` and
    skips a segment with fewer than ``batch_size`` windows. Each segment's
    window starts are permuted and truncated to whole batches; its rows are
    copied into ``buffer`` in place (features rounded to bf16 on the host),
    after the last replay that reads the previous segment, on the same
    stream. ``train(state, idx)`` trains its steps and returns their metric
    rows. The epoch's metrics are the mean of the per-segment means. While a
    segment trains, the next one is built on one host thread.

    :attr:`stats` holds the last epoch's :class:`SegmentStats`, in visiting
    order."""

    def __init__(self, plan: StreamingPlan, buffer: SegmentBuffer, batch_size: int,
                 train: Callable):
        self.plan, self.buffer, self.batch_size = plan, buffer, batch_size
        self.train = train
        self.stats: List[SegmentStats] = []

    def _build(self, si: int):
        t0 = time.perf_counter()
        feats, labs = self.plan.segment_arrays(si)
        return feats, labs, (time.perf_counter() - t0) * 1e3

    def __call__(self, state, host_seed: int) -> Dict[str, np.ndarray]:
        plan, b = self.plan, self.batch_size
        host_rng = np.random.default_rng(int(host_seed))
        order = [int(si) for si in host_rng.permutation(len(plan.segments))
                 if plan.segments[si].win_base.shape[0] >= b]
        means: List[Dict[str, np.ndarray]] = []
        pending_stats = []
        self.stats = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(self._build, order[0]) if order else None
            for k, si in enumerate(order):
                feats, labs, build_ms = pending.result()
                pending = (pool.submit(self._build, order[k + 1])
                           if k + 1 < len(order) else None)
                idx = host_rng.permutation(plan.segments[si].win_base)
                n_steps = idx.shape[0] // b
                idx = idx[:n_steps * b].reshape(n_steps, b)
                stage_ms, upload = self.buffer.load(feats, labs)
                t0 = time.perf_counter()
                rows = self.train(state, idx)
                train_ms = (time.perf_counter() - t0) * 1e3
                means.append({key: np.mean(np.stack([r[key] for r in rows]), axis=0)
                              for key in rows[0]})
                pending_stats.append((si, n_steps, build_ms, stage_ms, upload, train_ms))
        for si, n_steps, build_ms, stage_ms, upload, train_ms in pending_stats:
            self.stats.append(SegmentStats(si, n_steps * b, n_steps, build_ms, stage_ms,
                                           upload(), train_ms))
        if not means:
            return {}
        return {key: np.mean(np.stack([m[key] for m in means]), axis=0) for key in means[0]}


def metrics_on_host(row: Dict) -> Dict[str, np.ndarray]:
    """A step's metrics as host arrays (an eager step's are device tensors)."""
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in row.items()}


def segment_trainer(step: Callable, chunked_step, chunk_steps: int, device) -> Callable:
    """``train(state, idx [n, B]) -> per-step metric rows``: a segment's
    steps in chunks of ``chunk_steps`` through ``chunked_step`` (the last,
    partial chunk replays the same graph, step by step), or one eager
    ``step`` at a time when ``chunked_step`` is None; bitwise either way."""
    from inferbiomechanics_tpu_torch.train.loop import make_dispatch, run_chunks

    def train(state, idx: np.ndarray):
        rows: List[Dict[str, np.ndarray]] = []
        dispatch = make_dispatch(state, step, chunked_step, True, device)
        k = chunk_steps if chunked_step is not None else 1
        never = 1 << 62
        run_chunks(dispatch, enumerate(idx), k, skip=0, cap=None, log_every=never,
                   checkpoint_every=never, account=lambda row: rows.append(metrics_on_host(row)),
                   log=lambda i, r: None, checkpoint=lambda i: None, stop=lambda: False)
        return rows

    return train


def refuse_several_processes() -> None:
    """The JAX package's refusal of the streaming tier under several
    processes, with its words."""
    from inferbiomechanics_tpu_torch.parallel import dist
    if dist.world_size() > 1:
        raise ValueError(
            '--device-data stream is single-controller SPMD: the '
            'per-process segment materialization has no cross-process '
            'plan; on a multi-host pod use --device-data sharded')


def make_streaming_epoch(model, ds: WindowDataset, plan: StreamingPlan,
                         loss_config: LossConfig, batch_size: int, device,
                         chunk_steps: int = 1,
                         augment: Optional[Augmenter] = None,
                         aug_draws: Optional[AugmentDraws] = None) -> StreamingEpoch:
    """The regression step over streamed segments: ``epoch(state,
    host_seed) -> mean_metrics``. The gather is ``start + arange(frames) *
    stride``; labels are read at ``(frames - 1) * stride`` for
    ``last_frame`` and on every frame for ``all_frames``. ``chunk_steps``
    > 1 replays the step captured once for every segment. Refused under
    several processes (:func:`refuse_several_processes`)."""
    refuse_several_processes()
    buffer = SegmentBuffer(ds, plan.rows_pad, device)
    step = make_device_train_step(model, buffer, loss_config, augment=augment,
                                  aug_draws=aug_draws)
    chunked = (make_device_chunked_step(model, buffer, loss_config, augment=augment,
                                        aug_draws=aug_draws)
               if chunk_steps > 1 else None)
    return StreamingEpoch(plan, buffer, batch_size,
                          segment_trainer(step, chunked, chunk_steps, buffer.device))


def make_streaming_diffusion_epoch(model, ds: WindowDataset, plan: StreamingPlan,
                                   schedule: DDPMSchedule, batch_size: int, device,
                                   chunk_steps: int = 1, cond_dropout: float = 0.0,
                                   draws: Optional[TrainDraws] = None,
                                   augment: Optional[Augmenter] = None,
                                   aug_draws: Optional[AugmentDraws] = None
                                   ) -> StreamingEpoch:
    """Out-of-core diffusion training: the eps-prediction step
    (``device_data.make_device_diffusion_train_step``) over streamed
    segments; the state's EMA, when it keeps one, is updated after every
    update (inside the captured step). ``epoch(state, host_seed) ->
    {'loss'}``, the mean of the per-segment means."""
    if ds.output_data_format != 'all_frames':
        raise ValueError('diffusion requires all_frames labels')
    refuse_several_processes()
    buffer = SegmentBuffer(ds, plan.rows_pad, device)
    step = make_device_diffusion_train_step(model, buffer, schedule, cond_dropout, draws,
                                            augment, aug_draws)
    chunked = (make_device_diffusion_chunked_step(model, buffer, schedule, cond_dropout,
                                                  draws, augment, aug_draws)
               if chunk_steps > 1 else None)
    return StreamingEpoch(plan, buffer, batch_size,
                          segment_trainer(step, chunked, chunk_steps, buffer.device))


def streaming_windows_per_epoch(plan: StreamingPlan, batch_size: int) -> int:
    """Windows one streamed epoch trains: whole batches of each segment
    with at least one."""
    return sum((s.win_base.shape[0] // batch_size) * batch_size for s in plan.segments)


__all__ = ['Segment', 'SegmentStats', 'StreamingEpoch', 'StreamingPlan', 'host_seed_for',
           'make_streaming_diffusion_epoch', 'make_streaming_epoch', 'refuse_several_processes',
           'segment_trainer', 'streaming_windows_per_epoch']
