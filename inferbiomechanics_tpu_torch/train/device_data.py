"""Device-resident data path: window assembly on the device.

PyTorch counterpart of ``inferbiomechanics_tpu/train/device_data.py``. When
the packed feature and label matrices fit in device memory (45 MB per 64k
frames at 177 channels) the whole dataset is copied there once and every
training batch is gathered on the device: per step the host sends one
``[B]`` index vector, and a chunk of K steps one ``[K, B]`` upload
(``make_device_chunked_step``; for the diffusion denoiser
``make_device_diffusion_train_step`` and ``make_device_diffusion_chunked_step``,
the counterpart of the JAX package's ``make_device_diffusion_epoch_runner``).
Larger datasets take the host loader (``data/loader.py``), or, with
``--device-data stream``, a :class:`SegmentBuffer` that holds one segment
of trials at a time (``train/streaming_data.py``).

The tiled benchmark variant is not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from inferbiomechanics_tpu_torch.data.dataset import WindowDataset, unpack
from inferbiomechanics_tpu_torch.loss.evaluator import LossConfig, loss_and_metrics
from inferbiomechanics_tpu_torch.models.diffusion import (
    DDPMSchedule, DiffusionDenoiser, TrainDraws, diffusion_grads,
)
from inferbiomechanics_tpu_torch.train.augment import AugmentDraws, Augmenter, maybe_augment
from inferbiomechanics_tpu_torch.train.state import TrainState
from inferbiomechanics_tpu_torch.train.step import (
    ChunkedStep, Metrics, accumulate_grads, as_train_step, aug_draws_of,
)


def _to_bf16(a: np.ndarray) -> torch.Tensor:
    """float32 numpy -> bf16 tensor, rounded to nearest even on the host."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


class DeviceResidentData:
    """The dataset's packed arrays and window table, resident on a device."""

    def __init__(self, ds: WindowDataset, device, pack_windows: bool = False):
        """Features are rounded to bf16 on the host before the copy (half
        the memory and gather bandwidth; the models compute in bf16 anyway);
        labels stay float32 (the loss runs in f32).

        ``pack_windows=True`` also builds, on the device, a window-major
        copy of the features ``[num_windows, T * C_in]`` (and of the labels
        in ``all_frames`` mode): a batch is then one gather of B contiguous
        rows instead of B * T scattered ones, at about window / stride times
        the frame-major memory.
        """
        self.device = torch.device(device)
        feat = _to_bf16(ds.features_all)
        lab = torch.from_numpy(np.ascontiguousarray(ds.labels_all, np.float32))
        self.upload_bytes = feat.numel() * 2 + lab.numel() * 4
        self.features_all = feat.to(self.device)
        self.labels_all = lab.to(self.device)
        base = np.asarray(ds.trial_row_offset[ds.win_ft] + ds.win_start, np.int64)
        self.win_base = torch.from_numpy(base).to(self.device)
        self.num_windows = int(base.shape[0])
        self.window_size = ds.window_size
        self.stride = ds.stride
        self.num_model_frames = ds.num_model_frames
        self.output_data_format = ds.output_data_format
        self.lab_offsets = ds.lab_offsets
        self.features_packed = None
        self.labels_packed = None
        self.device_bytes = self.upload_bytes + base.nbytes
        self._offs = (torch.arange(self.num_model_frames, device=self.device)
                      * self.stride)
        if pack_windows:
            self._pack_windows()

    def _pack_windows(self) -> None:
        rows = self.win_base[:, None] + self._offs[None, :]

        def pack(mat: torch.Tensor) -> torch.Tensor:
            return mat[rows].reshape(rows.shape[0], -1)      # [N, T * C]

        self.features_packed = pack(self.features_all)
        self.device_bytes += self.features_packed.numel() * 2
        if self.output_data_format == 'all_frames':
            self.labels_packed = pack(self.labels_all)
            self.device_bytes += self.labels_packed.numel() * 4

    @staticmethod
    def packed_bytes_estimate(ds: WindowDataset) -> int:
        """Device memory that ``pack_windows=True`` adds for this dataset."""
        n_windows = int(ds.win_start.shape[0])
        per_window = ds.num_model_frames * int(ds.features_all.shape[1]) * 2
        if ds.output_data_format == 'all_frames':
            per_window += ds.num_model_frames * int(ds.labels_all.shape[1]) * 4
        return n_windows * per_window

    def gather(self, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B] window indices (on the device) -> (inputs [B, T, C_in] bf16,
        labels [B, F, C_lab] f32); exactly ``num_model_frames`` frames a
        window."""
        base = self.win_base[idx]
        rows = base[:, None] + self._offs[None, :]
        if self.features_packed is not None:
            inputs = self.features_packed[idx].reshape(
                idx.shape[0], self.num_model_frames, -1)
        else:
            inputs = self.features_all[rows]
        if self.output_data_format == 'all_frames':
            if self.labels_packed is not None:
                labels = self.labels_packed[idx].reshape(
                    idx.shape[0], self.num_model_frames, -1)
            else:
                labels = self.labels_all[rows]
        else:
            last = base + (self.num_model_frames - 1) * self.stride
            labels = self.labels_all[last[:, None]]
        return inputs, labels


class SegmentBuffer:
    """One segment of trials on the device, for ``--device-data stream``:
    ``rows_pad`` rows of bf16 features and float32 labels, allocated once.

    :meth:`load` copies a segment into it in place, so the addresses a
    captured step baked in stay valid for every segment: one capture
    serves the whole run. The copy is issued on the current stream, behind
    every replay already launched there that reads the previous segment,
    from one pinned staging buffer, which is overwritten only once the
    previous copy out of it has finished. :meth:`gather` takes segment-local
    window starts and behaves as :meth:`DeviceResidentData.gather` does on
    the window starts of its table."""

    def __init__(self, ds: WindowDataset, rows_pad: int, device):
        self.device = torch.device(device)
        pin = self.device.type == 'cuda'
        c_in, c_lab = ds.num_input_channels, ds.num_label_channels
        self.features = torch.zeros((rows_pad, c_in), dtype=torch.bfloat16, device=self.device)
        self.labels = torch.zeros((rows_pad, c_lab), dtype=torch.float32, device=self.device)
        self._stage_features = torch.empty((rows_pad, c_in), dtype=torch.bfloat16, pin_memory=pin)
        self._stage_labels = torch.empty((rows_pad, c_lab), dtype=torch.float32, pin_memory=pin)
        self._copied: Optional[torch.cuda.Event] = None
        self.stride = ds.stride
        self.num_model_frames = ds.num_model_frames
        self.output_data_format = ds.output_data_format
        self.lab_offsets = ds.lab_offsets
        self._offs = torch.arange(self.num_model_frames, device=self.device) * self.stride

    def load(self, features: np.ndarray, labels: np.ndarray):
        """Copy one segment ([rows_pad, C_in] and [rows_pad, C_lab] float32
        host arrays) into the buffer; the features are rounded to bf16 on
        the host, so the copy moves bf16 bytes. Returns (host ms to stage,
        ``upload_ms()``: the copy's device ms, read once it has finished;
        host ms on the CPU)."""
        t0 = time.perf_counter()
        if self._copied is not None:
            self._copied.synchronize()       # the staging buffer is free again
        self._stage_features.copy_(torch.from_numpy(features))   # rounds to bf16
        self._stage_labels.copy_(torch.from_numpy(labels))
        stage_ms = (time.perf_counter() - t0) * 1e3
        if self.device.type != 'cuda':
            t0 = time.perf_counter()
            self.features.copy_(self._stage_features)
            self.labels.copy_(self._stage_labels)
            ms = (time.perf_counter() - t0) * 1e3
            return stage_ms, lambda: ms
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        self.features.copy_(self._stage_features, non_blocking=True)
        self.labels.copy_(self._stage_labels, non_blocking=True)
        end.record()
        self._copied = end

        def upload_ms() -> float:
            end.synchronize()
            return start.elapsed_time(end)

        return stage_ms, upload_ms

    def gather(self, starts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B] window starts (segment-local rows, on the device) ->
        (inputs [B, T, C_in] bf16, labels [B, F, C_lab] f32)."""
        rows = starts[:, None] + self._offs[None, :]
        inputs = self.features[rows]
        if self.output_data_format == 'all_frames':
            labels = self.labels[rows]
        else:
            last = starts + (self.num_model_frames - 1) * self.stride
            labels = self.labels[last[:, None]]
        return inputs, labels


def make_device_train_step(model, data: DeviceResidentData,
                           loss_config: LossConfig,
                           grad_accum: int = 1,
                           augment: Optional[Augmenter] = None,
                           aug_draws: Optional[AugmentDraws] = None) -> Callable:
    """``step(state, idx) -> metrics``: the gather is part of the step, and
    with ``grad_accum > 1`` each microbatch gathers its own rows, so neither
    the full batch nor its activations are ever held at once. ``augment``
    mirrors and noises each gathered (micro)batch, its bf16 features as the
    JAX package's device tier does."""

    def grads(state: TrainState, idx: torch.Tensor) -> Metrics:
        model.train()
        draws = aug_draws_of(state, aug_draws)

        def loss_for(rows: slice):
            inputs, labels = maybe_augment(augment, *data.gather(idx[rows]), draws)
            return loss_and_metrics(model(inputs), unpack(labels, data.lab_offsets),
                                    loss_config)

        return accumulate_grads(state, grad_accum, idx.shape[0], loss_for)

    return as_train_step(grads)


def make_device_chunked_step(model, data: DeviceResidentData,
                             loss_config: LossConfig,
                             grad_accum: int = 1,
                             augment: Optional[Augmenter] = None,
                             aug_draws: Optional[AugmentDraws] = None) -> ChunkedStep:
    """Chunked device-tier dispatch: ``chunk(state, idx [K, B]) ->
    ChunkMetrics``, with ``idx`` the K steps' window indices on the host.

    A per-step dispatch pays ~200 launches and an index upload a step; here
    the K index vectors go up in one copy and each step is one replay of the
    step captured as a CUDA graph (``train/step.py::GraphedStep``), with
    numerics bitwise those of K :func:`make_device_train_step` calls (the
    same step body, the same dropout masks). Chunks of any length replay the
    same graph: the epoch's remainder and a resumed epoch's first batches
    too. On the CPU the K steps run eagerly."""
    step = make_device_train_step(model, data, loss_config, grad_accum=grad_accum,
                                  augment=augment, aug_draws=aug_draws)
    return ChunkedStep(step, (torch.int64,), data.device)


def make_device_diffusion_train_step(model: DiffusionDenoiser, data: DeviceResidentData,
                                     schedule: DDPMSchedule, cond_dropout: float = 0.0,
                                     draws: Optional[TrainDraws] = None,
                                     augment: Optional[Augmenter] = None,
                                     aug_draws: Optional[AugmentDraws] = None) -> Callable:
    """``step(state, idx) -> {'loss'}``: the diffusion denoiser's
    eps-prediction step (``models/diffusion.py::diffusion_grads``) on the
    windows ``idx`` gathered on the device; bitwise the host step on the
    same windows when it is not augmented (the denoiser rounds its
    conditioning to bf16 itself; an augmented step noises the gathered bf16
    features, as the JAX package's device tier does)."""
    if data.output_data_format != 'all_frames':
        raise ValueError('diffusion requires all_frames labels')
    grads = diffusion_grads(model, schedule, data.lab_offsets, cond_dropout, draws,
                            augment, aug_draws)
    return as_train_step(lambda state, idx: grads(state, *data.gather(idx)))


def make_device_diffusion_chunked_step(model: DiffusionDenoiser, data: DeviceResidentData,
                                       schedule: DDPMSchedule, cond_dropout: float = 0.0,
                                       draws: Optional[TrainDraws] = None,
                                       augment: Optional[Augmenter] = None,
                                       aug_draws: Optional[AugmentDraws] = None
                                       ) -> ChunkedStep:
    """``chunk(state, idx [K, B]) -> ChunkMetrics``: K of
    :func:`make_device_diffusion_train_step`'s steps, replayed from one
    captured step on a CUDA device (the draws from the state's generators,
    which the graph registers; the EMA update inside the graph), bitwise K
    step-by-step calls."""
    step = make_device_diffusion_train_step(model, data, schedule, cond_dropout, draws,
                                            augment, aug_draws)
    return ChunkedStep(step, (torch.int64,), data.device)


def make_device_eval_runner(model, data: DeviceResidentData,
                            loss_config: LossConfig, batch_size: int,
                            shard: Optional[Tuple[int, int]] = None) -> Callable:
    """``run_eval(state) -> mean_metrics``: the whole eval split in order,
    metrics averaged over the batches as the evaluator averages them. Under
    data parallelism (``shard`` = (rank, world size), ``batch_size`` a
    multiple of the world size) each batch of ``batch_size`` windows is
    split over the ranks and this rank evaluates its contiguous slice; the
    mean over the ranks of the result (``parallel/dist.py::mean_over_ranks``)
    is the global batches' mean."""
    n_steps = data.num_windows // batch_size
    if n_steps == 0:
        raise ValueError(f'eval split has {data.num_windows} windows < '
                         f'batch_size {batch_size}')
    idx_all = torch.arange(n_steps * batch_size, device=data.device).reshape(
        n_steps, batch_size)
    if shard is not None:
        r, n = shard
        b = batch_size // n
        idx_all = idx_all[:, r * b:(r + 1) * b]

    @torch.no_grad()
    def run_eval(state: TrainState) -> Metrics:
        model.eval()
        history = []
        for idx in idx_all:
            inputs, labels = data.gather(idx)
            history.append(loss_and_metrics(
                model(inputs), unpack(labels, data.lab_offsets), loss_config)[1])
        return {k: torch.stack([m[k] for m in history]).mean(0) for k in history[0]}

    return run_eval
