"""Batch-inference service on PyTorch.

PyTorch counterpart of ``inferbiomechanics_tpu/serve.py``'s
``InferenceService``. It plugs into the JAX package's shared HTTP layer
(``serve`` and its handler, the dynamic batcher), which needs only the
duck-typed surface below, and serves ``/health``, ``/schema``,
``/metrics``, ``/predict`` (JSON and b64), ``/predict_file`` and
``/reload``.

Differences from the JAX service:

- one device, named by the caller (``device='cuda'`` or ``'cpu'``); a
  missing GPU raises, nothing falls back to the CPU;
- no power-of-two batch padding: PyTorch runs eagerly and nothing
  recompiles per shape; ``max_batch`` still bounds a request;
- ensembles, ``quantize``, ``tta_mirror``, ``use_ema``, diffusion and
  ``--fused-inference`` raise "not yet ported" (ROADMAP.md Queue 1);
- no checkpoint polling: ``POST /reload`` swaps to a newer checkpoint.

Device work is serialized under one lock, as in the JAX service.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from inferbiomechanics_tpu_torch.shared import (
    Config, DynamicBatcher, WindowDataset, serve,
)
from inferbiomechanics_tpu_torch.train.checkpoint import (
    list_checkpoints, load_checkpoint_file, load_latest_checkpoint,
)
from inferbiomechanics_tpu_torch.train.loop import build_model_for_dataset

logger = logging.getLogger(__name__)

__all__ = ['InferenceService', 'resolve_device', 'serve']

_SERVING_SLICE = 'ROADMAP.md Queue 1 item 4 (inference and serving extras)'


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names a GPU that is not
    there."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f'device {device!r} requested but '
                               f'torch.cuda.is_available() is False')
    elif dev.type != 'cpu':
        raise ValueError(f'device must be cuda or cpu, got {device!r}')
    return dev


def _reject_unported(config: Config, **options) -> None:
    if config.model_type == 'diffusion':
        raise ValueError('diffusion serving is not yet ported '
                         '(ROADMAP.md Queue 1 item 6)')
    if getattr(config, 'fused_inference', False):
        raise ValueError('--fused-inference is not yet ported (ROADMAP.md '
                         'Queue 1 item 5, transformer and kernel K2)')
    for name, value in options.items():
        if value:
            raise ValueError(f'{name} is not yet ported ({_SERVING_SLICE})')


def _sidecar_run_config(checkpoint_dir: str) -> Optional[dict]:
    """The checkpoint dir's run_config.json, or None if absent or unreadable
    (it is provenance only)."""
    path = os.path.join(checkpoint_dir, 'run_config.json')
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        logger.warning('run-config sidecar unreadable for /schema: %s', e)
        return None


class InferenceService:
    """Checkpointed model + lock-serialized batch forward on one device."""

    def __init__(self, config: Config, checkpoint_dir: str,
                 dataset: WindowDataset, max_batch: int = 4096,
                 batch_wait_ms: float = 0.0, *, device='cuda',
                 ensemble: Optional[list] = None,
                 quantize: Optional[str] = None,
                 use_ema: bool = False,
                 tta_mirror: bool = False,
                 diffusion_samples: int = 1,
                 diffusion_partial: Optional[float] = None,
                 init_checkpoint: Optional[str] = None):
        _reject_unported(config, ensemble=ensemble,
                         quantize=quantize not in (None, 'none'),
                         use_ema=use_ema, tta_mirror=tta_mirror,
                         diffusion_samples=diffusion_samples != 1,
                         diffusion_partial=diffusion_partial is not None,
                         init_checkpoint=init_checkpoint)
        if config.model_type == 'analytical':
            raise ValueError('serve supports learned models; the analytical '
                             'baseline needs per-subject skeletons')
        if len(dataset) == 0:
            raise ValueError('schema dataset has no complete windows '
                             '(no .b3d files, or every trial is shorter '
                             'than --history-len); point --dataset-home at '
                             'data the model was built for')
        self.device = resolve_device(device)
        self.config = config
        self.ds = dataset
        self.max_batch = int(max_batch)
        self.members: list = []     # read by /health; ensembles are not ported
        self._checkpoint_dir = checkpoint_dir
        self.model, self.epoch, self.batch = self._load(checkpoint_dir)
        if self.epoch < 0:
            logger.warning('no checkpoint found in %s — serving an '
                           'UNTRAINED model', checkpoint_dir)
        self._lock = threading.Lock()
        self.batcher = (DynamicBatcher(self, batch_wait_ms)
                        if batch_wait_ms > 0 else None)
        self._stats_lock = threading.Lock()
        self.stats = {'requests': 0, 'rows': 0, 'errors': 0,
                      'device_forwards': 0}
        self._latencies_ms: list = []
        # predict_file's LRU cache of opened subject files
        self._file_ds: 'OrderedDict[str, WindowDataset]' = OrderedDict()
        self._file_ds_lock = threading.Lock()
        self._file_ds_cap = 4

    def _load(self, path: Optional[str] = None, *, checkpoint_file=None):
        """A fresh eval-mode model on the device, loaded from the newest
        checkpoint in ``path`` or from ``checkpoint_file``."""
        model = build_model_for_dataset(
            self.config, self.ds,
            generator=torch.Generator().manual_seed(0), device=self.device)
        if checkpoint_file is not None:
            epoch, batch = load_checkpoint_file(model, checkpoint_file)
        else:
            epoch, batch = load_latest_checkpoint(model, path)
        model.eval()
        model.packed()
        return model, epoch, batch

    def close(self) -> None:
        """Stop the dynamic batcher, if running."""
        if self.batcher is not None:
            self.batcher.close()

    def reload(self) -> dict:
        """Swap to the newest checkpoint in the checkpoint dir (``POST
        /reload``); a no-op when it is already being served. In-flight
        forwards finish on the old weights."""
        ckpts = list_checkpoints(self._checkpoint_dir)
        if not ckpts or (ckpts[-1][0], ckpts[-1][1]) == (self.epoch,
                                                         self.batch):
            return {'reloaded': False, 'epoch': self.epoch,
                    'batch': self.batch}
        model, epoch, batch = self._load(checkpoint_file=ckpts[-1][2])
        with self._lock:
            self.model, self.epoch, self.batch = model, epoch, batch
        logger.info('reloaded checkpoint epoch %d batch %d', epoch, batch)
        return {'reloaded': True, 'epoch': epoch, 'batch': batch}

    def warmup(self) -> None:
        """One forward at B=1 and at ``max_batch`` (``--warmup``): builds
        the kernels and sets up the device before the first request."""
        t0 = time.perf_counter()
        shape = (self.ds.num_model_frames, self.ds.num_input_channels)
        for bsz in sorted({1, self.max_batch}):
            self.predict_packed(np.zeros((bsz,) + shape, np.float32))
        logger.info('warmup done in %.1fs', time.perf_counter() - t0)

    def record_request(self, rows: int, dt_ms: float, error: bool) -> None:
        with self._stats_lock:
            self.stats['requests'] += 1
            self.stats['rows'] += rows
            self.stats['errors'] += int(error)
            self._latencies_ms.append(dt_ms)
            if len(self._latencies_ms) > 4096:
                del self._latencies_ms[:2048]

    def metrics(self) -> dict:
        """``GET /metrics``: the counters and request latency percentiles."""
        with self._stats_lock:
            lat = sorted(self._latencies_ms)
            out = dict(self.stats)
        if lat:
            pick = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]  # noqa: E731
            out['latency_ms'] = {'p50': round(pick(0.50), 2),
                                 'p90': round(pick(0.90), 2),
                                 'p99': round(pick(0.99), 2),
                                 'max': round(lat[-1], 2)}
        return out

    def predict(self, x: np.ndarray, with_spread: bool = False):
        """Request-facing entry: through the dynamic batcher when enabled.
        The shape is checked first, so that a bad request fails alone and
        not inside a coalesced group."""
        if self.batcher is not None:
            self._validate(x)
            return self.batcher.predict(x, with_spread)
        return self.predict_packed(x, with_spread)

    def _validate(self, x: np.ndarray) -> None:
        ds = self.ds
        if x.ndim != 3 or x.shape[1] != ds.num_model_frames \
                or x.shape[2] != ds.num_input_channels:
            raise ValueError(
                f'inputs must be [B, {ds.num_model_frames}, '
                f'{ds.num_input_channels}] (got {list(x.shape)}); '
                f'GET /schema describes the channel layout')
        if x.shape[0] == 0:
            raise ValueError('empty batch')
        if x.shape[0] > self.max_batch:
            raise ValueError(f'batch {x.shape[0]} exceeds max_batch '
                             f'{self.max_batch}; split the request')

    def predict_packed(self, x: np.ndarray, with_spread: bool = False):
        """[B, T, C_in] float32 -> output dict, each [B, out_frames, C].

        With ``with_spread=True`` returns ``(outputs, None)``: the spread is
        an ensemble's, and ensembles are not ported."""
        self._validate(x)
        with self._stats_lock:
            self.stats['device_forwards'] += 1
        with self._lock:
            xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            with torch.inference_mode():
                out = self.model(xt.to(self.device))
                out = {k: v.cpu().numpy() for k, v in out.items()}
        return (out, None) if with_spread else out

    def _file_dataset(self, path: str) -> WindowDataset:
        """``path`` opened as a WindowDataset, from a small LRU cache."""
        with self._file_ds_lock:
            ds = self._file_ds.get(path)
            if ds is not None:
                self._file_ds.move_to_end(path)
                return ds
        ds = WindowDataset(path, window_size=self.config.window_size,
                           stride=self.config.stride,
                           output_data_format=self.config.output_data_format,
                           skip_loading_skeletons=True,
                           materialize_features=False)
        with self._file_ds_lock:
            self._file_ds[path] = ds
            while len(self._file_ds) > self._file_ds_cap:
                self._file_ds.popitem(last=False)
        return ds

    def predict_file(self, path: str, trial: int,
                     max_windows: Optional[int] = None) -> dict:
        """``POST /predict_file``: every window of one trial of a subject
        file the server can read, in forwards of at most ``max_batch``."""
        ds = self._file_dataset(path)
        if ds.num_input_channels != self.ds.num_input_channels:
            raise ValueError(
                f'{path}: {ds.num_input_channels} input channels, model '
                f'expects {self.ds.num_input_channels}')
        idx = np.nonzero((ds.win_subject == 0) & (ds.win_trial == int(trial)))[0]
        if idx.size == 0:
            raise ValueError(f'{path}: no complete windows in trial {trial}')
        if max_windows:
            idx = idx[:int(max_windows)]
        outs = [self.predict_packed(np.asarray(
                    ds.gather(idx[i:i + self.max_batch]).inputs))
                for i in range(0, idx.size, self.max_batch)]
        starts = ds.win_start[idx]
        return {'window_starts': starts,
                'last_frame': starts + (ds.num_model_frames - 1) * ds.stride,
                'outputs': {k: np.concatenate([o[k] for o in outs])
                            for k in outs[0]}}

    def schema(self) -> dict:
        ds = self.ds
        return {
            'model_type': self.config.model_type,
            'checkpoint': {'epoch': self.epoch, 'batch': self.batch},
            'ensemble': None,
            'diffusion_sample_steps': None,
            'diffusion_samples': None,
            'fused_inference': False,
            'quantize': None,
            'use_ema': False,
            'mesh_devices': 1,
            'device': str(self.device),
            'window_size': ds.window_size,
            'stride': ds.stride,
            'num_model_frames': ds.num_model_frames,
            'num_dofs': ds.num_dofs,
            'contact_bodies': list(ds.contact_bodies),
            'num_input_channels': ds.num_input_channels,
            'input_layout': [{'key': k, 'width': w} for k, w in ds.in_layout],
            'label_layout': [{'key': k, 'width': w} for k, w in ds.lab_layout],
            'output_data_format': self.config.output_data_format,
            'max_batch': self.max_batch,
            'dynamic_batching': (None if self.batcher is None else
                                 {'wait_ms': self.batcher.wait_s * 1e3,
                                  'forwards': self.batcher.forwards}),
            'run_config': _sidecar_run_config(self._checkpoint_dir),
        }
