"""Batch-inference service on PyTorch.

PyTorch counterpart of ``inferbiomechanics_tpu/serve.py``: the
``InferenceService``, the dynamic batcher and the stdlib HTTP layer
(``serve`` and its handler, the payload codecs). It serves ``/health``,
``/schema``, ``/metrics``, ``/predict`` (JSON and b64), ``/predict_file``
and ``/reload`` for the feedforward model, GroundLink, the transformer and
the diffusion denoiser. The feedforward and GroundLink eval forwards run
through their fused kernels (``ops/fused_mlp.py``, ``ops/fused_groundlink.py``);
with ``--fused-inference`` a ``vpu`` transformer runs every encoder layer
through the fused kernel (``ops/fused_encoder.py``), and so does every step
of a diffusion chain. ``ensemble`` serves the mean of several checkpoints
(and, on request, their spread), ``tta_mirror`` averages each prediction with
the un-mirrored prediction of the mirrored window, ``use_ema`` serves a
checkpoint's EMA weights, ``quantize='int8'`` serves a feedforward model
through int8 weights and activations (``ops/quant.py``; weights quantized
once at load, no K1), and ``start_reload_poller`` swaps to newer
checkpoints as they land.

A diffusion ``/predict`` is a DDIM chain of ``sample_steps`` denoiser calls
conditioned on the request's windows (``models/diffusion.py::make_sampler``),
drawn from a generator seeded 0 at each request, as the JAX service uses
``PRNGKey(0)``; ``diffusion_samples`` K > 1 stacks K chains into one batch
of K x B rows (one launch a layer and step) and returns their mean, and on
request their spread; ``diffusion_partial`` starts the chains from an
``init_checkpoint`` model's proposal, part way down the schedule.

Differences from the JAX service:

- one device, named by the caller (``device='cuda'`` or ``'cpu'``); a
  missing GPU raises, nothing falls back to the CPU;
- no power-of-two batch padding: PyTorch runs eagerly and nothing
  recompiles per shape; ``max_batch`` still bounds a request;
- an ensemble runs its members one after another, each through its own
  kernel launch (a loop where the JAX service has one ``vmap``);
- a diffusion chain runs eagerly, step by step (one ``lax.scan`` program in
  the JAX service), and its draws are torch's, not ``jax.random``'s;
- ``--fused-inference`` on a denoiser whose ``d_model`` the encoder layer
  kernel does not take raises (the JAX service runs it).

Device work is serialized under one lock, as in the JAX service.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np
import torch

from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.models import diffusion
from inferbiomechanics_tpu_torch.models.transformer import (
    TransformerRegressor, fused_transformer_forward,
)
from inferbiomechanics_tpu_torch.ops.quant import quantized_feedforward_forward
from inferbiomechanics_tpu_torch.train.augment import spec_from_dataset, tta_average
from inferbiomechanics_tpu_torch.train.checkpoint import list_checkpoints, load_model

logger = logging.getLogger(__name__)

__all__ = ['DynamicBatcher', 'InferenceService', 'resolve_device', 'serve']


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


class DynamicBatcher:
    """Coalesce concurrent /predict requests into one device forward.

    Each handler thread enqueues its rows and blocks on an event; a
    single batcher thread drains the queue (waiting ``wait_ms`` after
    the first arrival so concurrent requests can pile in, the classic
    serving trade of a little latency for a lot of throughput), runs ONE
    forward for up to ``max_batch`` rows, and scatters the row
    slices back to the waiting requests, so N small clients cost about one
    forward instead of N.
    """

    def __init__(self, service: 'InferenceService', wait_ms: float):
        self.service = service
        self.wait_s = max(0.0, wait_ms) / 1e3
        self._cv = threading.Condition()
        self._queue: list = []
        self._closed = False
        self.forwards = 0           # instrumentation (tests/telemetry)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='ib-serve-batcher')
        self._thread.start()

    def predict(self, x: np.ndarray, with_spread: bool):
        item = {'x': x, 'spread': with_spread, 'ev': threading.Event()}
        with self._cv:
            if self._closed or not self._thread.is_alive():
                raise RuntimeError('dynamic batcher is shut down')
            self._queue.append(item)
            self._cv.notify()
        # bounded wait + liveness recheck: if the batcher thread dies the
        # request must error out, not hang the HTTP handler forever
        while not item['ev'].wait(timeout=5.0):
            if not self._thread.is_alive():
                raise RuntimeError('dynamic batcher thread died; '
                                   'request abandoned')
        if 'err' in item:
            raise item['err']
        return item['out']

    def close(self):
        with self._cv:
            self._closed = True
            # fail any queued-but-unserved requests instead of leaving
            # their handler threads blocked
            for it in self._queue:
                it['err'] = RuntimeError('dynamic batcher shut down')
                it['ev'].set()
            self._queue.clear()
            self._cv.notify()

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
            if self.wait_s:
                time.sleep(self.wait_s)     # let concurrent requests pile in
            with self._cv:
                group: list = []
                rows = 0
                while self._queue and rows + self._queue[0]['x'].shape[0] \
                        <= self.service.max_batch:
                    item = self._queue.pop(0)
                    group.append(item)
                    rows += item['x'].shape[0]
                if not group and self._queue:
                    # single oversized request: let predict_packed raise
                    group = [self._queue.pop(0)]
            if not group:
                continue
            try:
                x = np.concatenate([it['x'] for it in group]) \
                    if len(group) > 1 else group[0]['x']
                want_spread = any(it['spread'] for it in group)
                if want_spread:
                    out, spread = self.service.predict_packed(
                        x, with_spread=True)
                else:
                    out, spread = self.service.predict_packed(x), None
                self.forwards += 1
                off = 0
                for it in group:
                    n = it['x'].shape[0]
                    o = {k: v[off:off + n] for k, v in out.items()}
                    s = ({k: v[off:off + n] for k, v in spread.items()}
                         if spread is not None else None)
                    it['out'] = (o, s) if it['spread'] else o
                    off += n
            except Exception as e:   # propagate to every waiting request
                for it in group:
                    it['err'] = e
            finally:
                for it in group:
                    it['ev'].set()


class InferenceService:
    """Checkpointed model + lock-serialized batch forward on one device."""

    def __init__(self, config: Config, checkpoint_dir: str,
                 dataset: WindowDataset, max_batch: int = 4096,
                 batch_wait_ms: float = 0.0, *, device='cuda',
                 ensemble: Optional[list] = None,
                 sample_steps: int = 50,
                 quantize: Optional[str] = None,
                 use_ema: bool = False,
                 tta_mirror: bool = False,
                 diffusion_samples: int = 1,
                 diffusion_partial: Optional[float] = None,
                 init_checkpoint: Optional[str] = None,
                 checkpoint_file: Optional[str] = None):
        """``checkpoint_file``: serve this file (the port's or the JAX
        package's) instead of the newest checkpoint in ``checkpoint_dir``.
        ``ensemble``: optional list of checkpoint dirs or checkpoint files
        (e.g. the per-seed checkpoints of a sweep). Every member runs its own
        forward per request, and /predict returns the ensemble mean plus (on
        request) the across-member std as an uncertainty estimate.
        ``tta_mirror``: mirror test-time augmentation, two forwards per
        model and request. ``use_ema``: serve the checkpoint's EMA weights.
        ``sample_steps``, ``diffusion_samples``, ``diffusion_partial`` and
        ``init_checkpoint``: a diffusion model's chains (see the module's
        docstring). ``quantize='int8'``: a single feedforward checkpoint
        through int8 weights and activations; no reload."""
        quantize = quantize if quantize not in (None, 'none') else None
        self.is_diffusion = config.model_type == 'diffusion'
        self._check_options(config, ensemble, quantize, use_ema, tta_mirror,
                            diffusion_samples, diffusion_partial, init_checkpoint)
        if checkpoint_file and ensemble:
            raise ValueError('--checkpoint-file serves one checkpoint; an ensemble '
                             'names its members in --ensemble')
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
        self.sample_steps = int(sample_steps)
        self.diffusion_samples = int(diffusion_samples)
        self.use_ema = bool(use_ema)
        self.quantize = quantize
        self.members: list = []     # [{path, epoch, batch}] of an ensemble
        self._member_models: list = []
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_file = checkpoint_file
        self._use_fused = self._fused_inference(bool(ensemble))
        if ensemble:
            for spec in ensemble:
                model, e, b = self._load_member(spec)
                self._member_models.append(model)
                self.members.append({'path': spec, 'epoch': e, 'batch': b})
            self.model = self._member_models[0]
            self.epoch, self.batch = max((m['epoch'], m['batch'])
                                         for m in self.members)
        elif checkpoint_file:
            self.model, self.epoch, self.batch = self._load(checkpoint_file=checkpoint_file)
        else:
            self.model, self.epoch, self.batch = self._load(checkpoint_dir)
            if self.epoch < 0:
                logger.warning('no checkpoint found in %s — serving an '
                               'UNTRAINED model', checkpoint_dir)
        self.tta_mirror = bool(tta_mirror)
        # a diffusion chain's proposal is loaded once: a reload swaps the
        # denoiser only
        self._forward = (diffusion.make_chain_forward(
            config, dataset, self.model,
            os.path.dirname(os.path.abspath(checkpoint_file)) if checkpoint_file
            else checkpoint_dir, num_steps=self.sample_steps,
            seed=0, samples=self.diffusion_samples, partial=diffusion_partial,
            init_checkpoint=init_checkpoint, fused_inference=self._use_fused,
            device=self.device) if self.is_diffusion else self._make_forward())
        self._lock = threading.Lock()
        self._poller: Optional[threading.Thread] = None
        self._poller_stop = threading.Event()
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

    @staticmethod
    def _check_options(config, ensemble, quantize, use_ema, tta_mirror,
                       diffusion_samples, diffusion_partial, init_checkpoint) -> None:
        """The JAX service's refusals of option combinations, in its words."""
        is_diffusion = config.model_type == 'diffusion'
        if diffusion_samples < 1:
            raise ValueError('--diffusion-samples must be >= 1')
        if diffusion_samples > 1 and not is_diffusion:
            raise ValueError('--diffusion-samples applies to '
                             '--model-type diffusion')
        if diffusion_partial is not None and not is_diffusion:
            raise ValueError('--diffusion-partial applies to '
                             '--model-type diffusion')
        if init_checkpoint and diffusion_partial is None:
            raise ValueError('--init-checkpoint only does something with '
                             '--diffusion-partial (it seeds the truncated '
                             'DDIM chains)')
        if is_diffusion:
            if ensemble:
                raise ValueError('ensembles are not supported for diffusion '
                                 'serving (each member would run a full '
                                 'sampling chain); soup the checkpoints '
                                 'instead (python -m inferbiomechanics_tpu_torch '
                                 'convert-checkpoint --soup)')
            if config.output_data_format != 'all_frames':
                raise ValueError('serve --model-type diffusion requires '
                                 '--output-data-format all_frames '
                                 '(like diffusion training/analyze)')
        if use_ema and ensemble:
            raise ValueError('--use-ema serves a single checkpoint, '
                             'not an ensemble')
        if quantize and quantize != 'int8':
            raise ValueError(f'unknown --quantize {quantize!r}; '
                             f'expected int8')
        if quantize and (is_diffusion or ensemble):
            raise ValueError('--quantize int8 serves a single '
                             'feedforward checkpoint (not diffusion '
                             'or ensembles)')
        if quantize and config.model_type != 'feedforward':
            raise ValueError('--quantize int8 currently supports the '
                             'feedforward family only')
        if tta_mirror and (is_diffusion or quantize):
            raise ValueError('--tta-mirror serves the learned-model '
                             'paths (single model or ensemble; not '
                             'diffusion or int8)')

    def _load(self, path: Optional[str] = None, *, checkpoint_file=None):
        """A fresh eval-mode model on the device, loaded from the newest
        checkpoint in ``path`` or from ``checkpoint_file``; with ``use_ema``
        its weights are then the checkpoint's EMA weights."""
        model, epoch, batch = load_model(self.config, self.ds, path,
                                         checkpoint_file=checkpoint_file,
                                         use_ema=self.use_ema, device=self.device)
        if self.quantize:       # the int8 forward runs no kernel
            return model, epoch, batch
        # the kernels' weights, laid out once per load
        if self._use_fused or not isinstance(
                model, (TransformerRegressor, diffusion.DiffusionDenoiser)):
            model.packed()
        elif model.attn_impl == 'pallas':
            model.packed_layers(False)
        return model, epoch, batch

    def _load_member(self, spec: str):
        """One ensemble member from a checkpoint dir (its newest checkpoint)
        or a checkpoint file."""
        if os.path.isdir(spec):
            model, epoch, batch = self._load(spec)
            if epoch < 0:
                raise ValueError(f'ensemble member {spec!r}: no '
                                 f'checkpoints found')
            return model, epoch, batch
        if not os.path.exists(spec):
            raise FileNotFoundError(f'ensemble member {spec!r}')
        return self._load(checkpoint_file=spec)

    def _make_forward(self) -> Callable:
        """``forward(model, x)`` -> output dict of tensors: the model's eval
        forward (through its fused kernel where it has one), symmetrized
        when ``tta_mirror`` is on; with ``quantize``, the int8 forward of
        the weights loaded now, quantized here once."""
        if self.quantize:
            qfwd = quantized_feedforward_forward(self.model)
            return lambda model, x: qfwd(x)
        if self._use_fused:
            forward = fused_transformer_forward
        else:
            def forward(model, x):
                return model(x)
        if self.tta_mirror:
            # (f(x) + unmirror(f(mirror(x)))) / 2, per model: an ensemble's
            # members are symmetrized before the across-member mean and std
            spec = spec_from_dataset(
                self.ds, lateral_axis=self.config.mirror_lateral_axis)
            forward = tta_average(spec, self.ds.lab_offsets, forward)
        return forward

    def _fused_inference(self, ensemble: bool) -> bool:
        """Whether forwards go through the fused encoder layer kernel:
        asked for with ``--fused-inference``, and honoured for a single
        ``vpu`` transformer whose width the kernel takes, and for a
        diffusion denoiser (whose sampler refuses a width the kernel does
        not take)."""
        config = self.config
        if not config.fused_inference:
            return False
        if self.is_diffusion:
            return True
        if ensemble:
            logger.warning('--fused-inference ignored for ensembles '
                           '(the fused kernel path is single-model)')
            return False
        if not (config.model_type == 'transformer'
                and config.attn_impl == 'vpu' and config.d_model % 128 == 0):
            logger.warning('--fused-inference ignored: needs a vpu '
                           'transformer with d_model %% 128 == 0')
            return False
        return True

    def close(self) -> None:
        """Stop the reload poller and the dynamic batcher, if running."""
        self._poller_stop.set()
        if self._poller is not None:
            self._poller.join(timeout=30)
        if self.batcher is not None:
            self.batcher.close()

    def reload(self) -> dict:
        """Swap to the newest checkpoint in the checkpoint dir (``POST
        /reload``); a no-op when it is already being served. In-flight
        forwards finish on the old weights."""
        if self.members or self._checkpoint_file:
            raise ValueError('reload serves a single checkpoint dir; '
                             'restart the server to change an ensemble or '
                             'a --checkpoint-file')
        if self.quantize:
            raise ValueError('reload is not supported with --quantize '
                             '(weights are baked into the compiled '
                             'program); restart the server')
        ckpts = list_checkpoints(self._checkpoint_dir)
        if not ckpts or (ckpts[-1][0], ckpts[-1][1]) == (self.epoch,
                                                         self.batch):
            return {'reloaded': False, 'epoch': self.epoch,
                    'batch': self.batch}
        # the parameters and the EMA weights from the same file
        model, epoch, batch = self._load(checkpoint_file=ckpts[-1][2])
        with self._lock:
            self.model, self.epoch, self.batch = model, epoch, batch
        logger.info('reloaded checkpoint epoch %d batch %d', epoch, batch)
        return {'reloaded': True, 'epoch': epoch, 'batch': batch}

    def start_reload_poller(self, poll_sec: float) -> None:
        """Background thread: poll the checkpoint dir every ``poll_sec``
        seconds and swap when a newer checkpoint lands
        (``--reload-poll-sec``): train in one process, serve the freshest
        weights in another. Errors are logged, never fatal. ``close()``
        stops it."""
        if poll_sec <= 0:
            return
        if self.quantize:
            raise ValueError('--reload-poll-sec cannot work here: reload '
                             'is unsupported for --quantize services')
        if self.members or self._checkpoint_file:
            raise ValueError('--reload-poll-sec cannot work here: reload '
                             'is unsupported for ensembles and --checkpoint-file')

        def loop():
            while not self._poller_stop.wait(poll_sec):
                try:
                    r = self.reload()
                    if r.get('reloaded'):
                        logger.info('reload poller: now serving epoch %d '
                                    'batch %d', r['epoch'], r['batch'])
                except Exception as e:    # keep polling; the next file may load
                    logger.warning('reload poller: %s', e, exc_info=True)

        self._poller = threading.Thread(target=loop, daemon=True,
                                        name='ib-serve-reload-poller')
        self._poller.start()

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

        With ``with_spread=True`` returns ``(outputs, spread)`` where spread
        holds the across-ensemble (or across-sample, with
        ``diffusion_samples`` > 1) std per output channel (``None`` for a
        single-model service)."""
        self._validate(x)
        spread = None
        with self._stats_lock:
            self.stats['device_forwards'] += 1
        with self._lock:
            xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            with torch.inference_mode():
                xt = xt.to(self.device)
                if self.diffusion_samples > 1:
                    out, spread = self._forward(self.model, xt)
                    spread = {k: v.cpu().numpy() for k, v in spread.items()}
                elif self._member_models:
                    outs = [self._forward(m, xt) for m in self._member_models]
                    stacked = {k: torch.stack([o[k].float() for o in outs])
                               for k in outs[0]}
                    out = {k: v.mean(0) for k, v in stacked.items()}
                    # population std, as jnp.std
                    spread = {k: v.std(0, unbiased=False).cpu().numpy()
                              for k, v in stacked.items()}
                else:
                    out = self._forward(self.model, xt)
                out = {k: v.cpu().numpy() for k, v in out.items()}
        return (out, spread) if with_spread else out

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
            'ensemble': ({'size': len(self.members), 'members': self.members}
                         if self.members else None),
            'diffusion_sample_steps': self.sample_steps if self.is_diffusion else None,
            'diffusion_samples': self.diffusion_samples if self.is_diffusion else None,
            'fused_inference': self._use_fused,
            'quantize': self.quantize,
            'use_ema': self.use_ema,
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


# -----------------------------------------------------------------------------
# HTTP layer
# -----------------------------------------------------------------------------

def _decode_inputs(payload: dict) -> np.ndarray:
    if 'inputs_b64' in payload:
        shape = payload.get('shape')
        if not (isinstance(shape, list) and len(shape) == 3):
            raise ValueError('inputs_b64 requires "shape": [B, T, C]')
        raw = base64.b64decode(payload['inputs_b64'])
        x = np.frombuffer(raw, dtype='<f4')
        if x.size != int(np.prod(shape)):
            raise ValueError(f'inputs_b64 carries {x.size} floats, '
                             f'shape {shape} needs {int(np.prod(shape))}')
        return x.reshape(shape).astype(np.float32)
    if 'inputs' in payload:
        return np.asarray(payload['inputs'], np.float32)
    raise ValueError('request needs "inputs" or "inputs_b64"')


def _encode_outputs(outputs: Dict[str, np.ndarray], encoding: str) -> dict:
    if encoding == 'b64':
        return {k: {'b64': base64.b64encode(
                        np.ascontiguousarray(v, '<f4').tobytes()).decode(),
                    'shape': list(v.shape)}
                for k, v in outputs.items()}
    return {k: np.asarray(v, np.float32).tolist() for k, v in outputs.items()}


def make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # route through logging, not stderr
            logger.info('%s %s', self.address_string(), fmt % args)

        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/health':
                self._send(200, {'status': 'ok',
                                 'model': service.config.model_type,
                                 'epoch': service.epoch,
                                 'batch': service.batch,
                                 'ensemble_size': len(service.members)})
            elif self.path == '/schema':
                self._send(200, service.schema())
            elif self.path == '/metrics':
                self._send(200, service.metrics())
            else:
                self._send(404, {'error': f'unknown path {self.path}'})

        def do_POST(self):
            t_start = time.time()
            rows = 0
            ok = False
            try:
                n = int(self.headers.get('Content-Length', 0))
                payload = json.loads(self.rfile.read(n) or b'{}')
            except (ValueError, json.JSONDecodeError) as e:
                service.record_request(0, (time.time() - t_start) * 1e3,
                                       error=True)
                return self._send(400, {'error': f'bad JSON: {e}'})
            encoding = payload.get('encoding', 'json')
            try:
                if self.path == '/predict':
                    x = _decode_inputs(payload)
                    rows = int(x.shape[0])
                    want_spread = bool(payload.get('spread'))
                    if want_spread:
                        out, spread = service.predict(x, with_spread=True)
                    else:
                        out, spread = service.predict(x), None
                    resp = {'outputs': _encode_outputs(out, encoding),
                            'batch': rows}
                    if want_spread:
                        # across-ensemble std per channel; all-zeros has no
                        # meaning for a single model, so null there
                        resp['spread'] = (_encode_outputs(spread, encoding)
                                          if spread is not None else None)
                    ok = True
                    self._send(200, resp)
                elif self.path == '/reload':
                    resp = service.reload()
                    ok = True
                    self._send(200, resp)
                elif self.path == '/predict_file':
                    if 'file' not in payload:
                        raise ValueError('request needs "file"')
                    res = service.predict_file(
                        payload['file'], payload.get('trial', 0),
                        payload.get('max_windows'))
                    rows = len(res['window_starts'])
                    ok = True
                    self._send(200, {
                        'window_starts': res['window_starts'].tolist(),
                        'last_frame': res['last_frame'].tolist(),
                        'outputs': _encode_outputs(res['outputs'], encoding)})
                else:
                    self._send(404, {'error': f'unknown path {self.path}'})
            except ValueError as e:
                self._send(400, {'error': str(e)})
            except FileNotFoundError as e:
                self._send(404, {'error': str(e)})
            except Exception as e:   # pragma: no cover — last-resort guard
                logger.exception('predict failed')
                self._send(500, {'error': f'{type(e).__name__}: {e}'})
            finally:
                service.record_request(rows, (time.time() - t_start) * 1e3,
                                       error=not ok)

    return Handler


def serve(service: InferenceService, host: str = '127.0.0.1',
          port: int = 8090) -> ThreadingHTTPServer:
    """Build (and return) the HTTP server; caller runs serve_forever()."""
    server = ThreadingHTTPServer((host, port), make_handler(service))
    logger.info('serving %s on http://%s:%d (max_batch=%d)',
                service.config.model_type, host, server.server_address[1],
                service.max_batch)
    return server
