"""Checkpoint save / restore.

PyTorch counterpart of every public name of
``inferbiomechanics_tpu/train/checkpoint.py``: ``save_checkpoint``,
``AsyncCheckpointer``, ``list_checkpoints``, ``load_latest_checkpoint``,
``load_checkpoint_file``, ``warm_start_from``, ``load_ema_params``,
``resolve_checkpoint_path``, ``require_ema_params``, ``soup_checkpoints`` and
``prune_checkpoints``; ``load_model`` builds a model for a config and loads
it. A checkpoint is ``torch.save`` of

    {epoch, batch, model_state_dict,                      always
     optimizer_state_dict, opt_type, step}                from a TrainState
     ema_params}                                          when given one

written atomically; the loader restores the newest by (epoch, batch) and
returns ``(-1, 0)`` when there is none. ``ema_params`` is an exponential
moving average of the parameters, a state dict of the model's keys, under
the JAX package's key name; ``load_model(..., use_ema=True)`` serves it
for ``--use-ema``. Every function takes either a bare model (serving:
parameters only) or a ``TrainState`` (training: the optimizer's state and
the step count too), and reads the port's payloads with
``weights_only=True``. An ``optimizer_state_dict`` whose parameter group
carries ``param_names`` (``convert-checkpoint`` writes one) is matched to
the optimizer by name.

The loader also reads the JAX package's flax-msgpack checkpoints, told
apart by their first bytes (a ``torch.save`` zip starts ``PK\\x03\\x04``, a
flax payload with a msgpack map; ``utils/flax_msgpack.py`` reads it without
flax): parameters, batch statistics and step through ``weights.py``'s
mapping of the model's family, the optimizer's state when its layout is
the one the training optimizer keeps (otherwise the JAX loader's warning,
and the optimizer starts fresh), the recorded epoch and batch, and
``ema_params``. Such a file is read where it is named (``--checkpoint-file``,
``--ensemble`` members, ``--init-checkpoint``, ``--init-from-checkpoint``);
a whole JAX run directory is carried over by ``convert-checkpoint``.

Files are named ``epoch_{e}_batch_{b}.torch.pt``. The JAX package's
pattern (``epoch_E_batch_B.{ckpt,msgpack,pt}``) does not match that name,
so neither package mistakes the other's files for its own and a run
directory never mixes the two formats; ``train`` and ``serve`` given a
directory that holds only the JAX package's files warn once, naming
``convert-checkpoint``, and start fresh. Named files (``best.torch.pt``)
are model artifacts that the newest-checkpoint scan ignores.

``AsyncCheckpointer`` (``--async-checkpoint``) copies the state into pinned
host buffers on the caller's thread and serialises, commits and prunes on a
worker; ``soup_checkpoints`` averages the parameters of checkpoints of one
architecture (a model soup).
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import threading
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.train.run_config import RUN_CONFIG_NAME, load_run_config
from inferbiomechanics_tpu_torch.train.state import TrainState
from inferbiomechanics_tpu_torch.utils import flax_msgpack

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r'epoch_(\d+)_batch_(\d+)\.torch\.pt$')
BEST_NAME = 'best.torch.pt'

ModelOrState = Union[nn.Module, TrainState]


def checkpoint_name(epoch: int, batch: int) -> str:
    return f'epoch_{epoch}_batch_{batch}.torch.pt'


def _model_of(target: ModelOrState) -> nn.Module:
    return target.model if isinstance(target, TrainState) else target


# the JAX package's epoch checkpoints (not its reference .pt pattern)
_JAX_CKPT_RE = re.compile(r'epoch_(\d+)_batch_(\d+)\.(?:ckpt|msgpack)$')
ZIP_MAGIC = b'PK\x03\x04'     # a torch.save file
# state-dict entries that are running statistics, not parameters: a soup
# takes them from its newest member, as the JAX soup takes batch_stats
_BUFFER_SUFFIXES = ('.running_mean', '.running_var')

Copy = Callable[[tuple, torch.Tensor], torch.Tensor]


def _fresh_copy(key: tuple, t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype)
    out.copy_(t.detach())
    return out


def _snapshot(target: ModelOrState, epoch: int, batch: int,
              ema_params: Optional[Mapping[str, torch.Tensor]], copy: Copy) -> Dict:
    """Everything a checkpoint stores, each tensor on the host through
    ``copy(key, tensor)``."""
    payload = {'epoch': int(epoch), 'batch': int(batch),
               'model_state_dict': {k: copy(('model', k), v) for k, v in
                                    _model_of(target).state_dict().items()}}
    if isinstance(target, TrainState):
        opt = target.optimizer.state_dict()
        opt['state'] = {i: {k: copy(('opt', i, k), v) for k, v in st.items()}
                        for i, st in opt['state'].items()}
        payload.update(optimizer_state_dict=opt,
                       opt_type=target.optimizer.opt_type, step=int(target.step))
        if ema_params is None and target.ema is not None:
            ema_params = target.ema.state_dict()
    if ema_params is not None:
        payload['ema_params'] = {k: copy(('ema', k), v) for k, v in ema_params.items()}
    return payload


def _write_payload(payload: Dict, path: str) -> str:
    """Serialise ``payload`` to ``path`` atomically: a crash never leaves a
    torn checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + '.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(checkpoint_dir: str, target: ModelOrState,
                    epoch: int, batch: int,
                    filename: Optional[str] = None,
                    ema_params: Optional[Mapping[str, torch.Tensor]] = None) -> str:
    """Write ``target`` (a model, or a TrainState with its optimizer, step
    and EMA), and ``ema_params`` when given; returns the path. ``filename``
    overrides the ``epoch_{e}_batch_{b}.torch.pt`` name."""
    path = os.path.join(checkpoint_dir, filename or checkpoint_name(epoch, batch))
    return _write_payload(_snapshot(target, epoch, batch, ema_params, _fresh_copy), path)


class AsyncCheckpointer:
    """Checkpoint writes that overlap training (``--async-checkpoint``).

    Only the snapshot runs on the caller's thread: every tensor is copied
    (``non_blocking``, on the current stream) into pinned host buffers
    kept across saves, and the caller waits on an event recorded after the
    copies, so the snapshot is whole on the host before the next step (a
    captured step's replay updates the parameters and the optimizer's state
    in place) is launched. Serialisation, the atomic rename and pruning
    (``prune_keep``, ``--keep-checkpoints``, after the commit) run on a
    worker thread. One write is in flight at a time: ``save`` first joins
    the previous one, so checkpoints land in order and the buffers are free
    again. ``wait()`` drains it; a failed write re-raises there, once.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._buffers: Dict[tuple, torch.Tensor] = {}
        self.last_path: Optional[str] = None

    def _copy(self, key: tuple, t: torch.Tensor) -> torch.Tensor:
        buf = self._buffers.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            self._buffers[key] = buf
        buf.copy_(t.detach(), non_blocking=t.is_cuda)
        return buf

    def snapshot(self, target: ModelOrState, epoch: int, batch: int,
                 ema_params: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
        """The payload in the pinned buffers, once the copies have landed."""
        payload = _snapshot(target, epoch, batch, ema_params, self._copy)
        devices = {p.device for p in _model_of(target).parameters() if p.is_cuda}
        for device in devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            event.synchronize()
        return payload

    def save(self, checkpoint_dir: str, target: ModelOrState, epoch: int, batch: int,
             filename: Optional[str] = None,
             ema_params: Optional[Mapping[str, torch.Tensor]] = None,
             prune_keep: int = 0) -> None:
        self.wait()    # in order, buffers free; surfaces a prior write's error
        path = os.path.join(checkpoint_dir, filename or checkpoint_name(epoch, batch))
        payload = self.snapshot(target, epoch, batch, ema_params)

        def work():
            try:
                self.last_path = _write_payload(payload, path)
                if prune_keep:
                    prune_checkpoints(checkpoint_dir, prune_keep)
            except BaseException as e:     # surfaced by the next wait()
                self._exc = e

        self._thread = threading.Thread(target=work, name='ib-async-ckpt', daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight (if any) commits; re-raise its
        error here if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def list_checkpoints(checkpoint_dir: str) -> List[Tuple[int, int, str]]:
    """All checkpoints in dir as sorted [(epoch, batch, path)]."""
    if not os.path.isdir(checkpoint_dir):
        return []
    out = []
    for f in os.listdir(checkpoint_dir):
        m = _CKPT_RE.match(f)
        if m:
            out.append((int(m.group(1)), int(m.group(2)),
                        os.path.join(checkpoint_dir, f)))
    out.sort()
    return out


def checkpoint_format(path: str) -> str:
    """'torch' for a ``torch.save`` file (the port's, a reference one), 'jax'
    for the JAX package's flax msgpack, told apart by the first bytes."""
    with open(path, 'rb') as f:
        head = f.read(4)
    if head == ZIP_MAGIC:
        return 'torch'
    if flax_msgpack.is_msgpack_map(head):
        return 'jax'
    raise ValueError(f'checkpoint {path}: neither a torch.save file nor a JAX package '
                     f'(flax msgpack) checkpoint; first bytes {head!r}')


def read_checkpoint(path: str) -> Tuple[str, Dict]:
    """``(checkpoint_format(path), payload)``: the ``torch.save`` payload, or
    the JAX package's tree as flax's ``msgpack_restore`` gives it."""
    kind = checkpoint_format(path)
    if kind == 'torch':
        return kind, torch.load(path, map_location='cpu', weights_only=True)
    with open(path, 'rb') as f:
        return kind, flax_msgpack.loads(f.read())


def read_payload(path: str, prefer=()) -> Dict:
    """The port's payload of ``path`` in either format (a JAX checkpoint
    through ``weights.torch_payload_from_jax``; ``prefer``, optimizer
    types to read its state as first)."""
    kind, payload = read_checkpoint(path)
    return weights.torch_payload_from_jax(payload, prefer) if kind == 'jax' else payload


def convert_jax_checkpoint(path: str, out_dir: str, prefer=()) -> str:
    """Write one of the JAX package's checkpoints into ``out_dir`` in the
    port's format (``epoch_{e}_batch_{b}.ckpt`` -> ``.torch.pt``, another
    name by its stem), with its optimizer state, step, epoch, batch and EMA,
    and copy the ``run_config.json`` beside it (whose ``opt_type`` is read
    before ``prefer``) beside the output. Returns the written path."""
    sidecar = load_run_config(path) or {}
    if sidecar.get('opt_type'):
        prefer = (sidecar['opt_type'], *prefer)
    payload = read_payload(path, prefer)
    if 'optimizer_state_dict' not in payload:
        logger.warning('%s: its opt_state is the state of none of the optimizers; '
                       'the parameters are converted, the optimizer starts fresh', path)
    base = os.path.basename(path)
    m = _JAX_CKPT_RE.fullmatch(base)
    name = (checkpoint_name(int(m.group(1)), int(m.group(2))) if m
            else os.path.splitext(base)[0] + '.torch.pt')
    out = _write_payload(payload, os.path.join(out_dir, name))
    side = os.path.join(os.path.dirname(os.path.abspath(path)), RUN_CONFIG_NAME)
    if os.path.exists(side):
        shutil.copyfile(side, os.path.join(out_dir, RUN_CONFIG_NAME))
    return out


def _mismatch(path: str, e: Exception) -> str:
    return (f'checkpoint {path}: parameters do not match the model being '
            f'built, most commonly a transformer checkpoint written with a '
            f'different --attn-impl, or different --hidden-dims / --d-model / '
            f'--num-layers. Original error: {e}')


def _in_order(opt_sd: Dict, names: List[str]) -> Dict:
    """An optimizer state dict whose group names its parameters
    (``param_names``), renumbered in the order of ``names``."""
    group = opt_sd['param_groups'][0]
    saved = group.get('param_names')
    if saved is None:
        return opt_sd
    if sorted(saved) != sorted(names):
        raise ValueError(f'optimizer state for {sorted(set(saved) ^ set(names))[:5]} '
                         f'does not match the parameters')
    pos = {n: i for i, n in enumerate(saved)}
    group = {k: v for k, v in group.items() if k != 'param_names'}
    group['params'] = list(range(len(names)))
    return {'state': {i: opt_sd['state'][pos[n]] for i, n in enumerate(names)
                      if pos[n] in opt_sd['state']},
            'param_groups': [group]}


def _load_jax(target: ModelOrState, raw: Dict, path: str, use_ema: bool) -> Tuple[int, int]:
    """The JAX loader's restore (``inferbiomechanics_tpu/train/checkpoint.py
    ::load_checkpoint_file``) into the port's model or TrainState."""
    model = _model_of(target)
    family = weights.model_family(model)
    try:
        model.load_state_dict(weights.state_dict_from_jax(
            family, raw['params'], raw.get('batch_stats') or None))
    except (ValueError, KeyError, TypeError, RuntimeError) as e:
        raise ValueError(_mismatch(path, e)) from e
    if use_ema:
        model.load_state_dict(_required_ema(_jax_ema(raw, family), path))
    if isinstance(target, TrainState):
        target.step = int(np.asarray(raw['step']))
        opt = target.optimizer
        try:
            opt.load_state_dict(weights.optimizer_state_from_jax(
                family, raw['opt_state'], weights.optimizer_layout(opt),
                dict(zip(opt.names, opt.param_groups[0]['params']))))
        except (ValueError, KeyError) as e:
            logger.warning('checkpoint %s: optimizer state not restored (%s); '
                           'parameters restored, optimizer starts fresh', path, e)
    return int(np.asarray(raw.get('epoch', -1))), int(np.asarray(raw.get('batch', 0)))


def _jax_ema(raw: Dict, family: str) -> Optional[Dict[str, torch.Tensor]]:
    return weights.params_from_jax(family, raw['ema_params']) if 'ema_params' in raw else None


def load_checkpoint_file(target: ModelOrState, path: str, *,
                         use_ema: bool = False) -> Tuple[int, int]:
    """Load one checkpoint file, the port's or the JAX package's, into
    ``target``; returns (epoch, batch). A TrainState also gets the
    optimizer's state and the step count back when the file holds them and
    was written by the same kind of optimizer; otherwise the optimizer
    starts fresh, with a warning. ``use_ema`` then puts the file's EMA
    parameters in the model (``require_ema_params``'s error when it carries
    none)."""
    kind, payload = read_checkpoint(path)
    if kind == 'jax':
        return _load_jax(target, payload, path, use_ema)
    try:
        _model_of(target).load_state_dict(payload['model_state_dict'])
    except RuntimeError as e:
        raise ValueError(_mismatch(path, e)) from e
    if use_ema:
        _model_of(target).load_state_dict(_required_ema(payload.get('ema_params'), path))
    if isinstance(target, TrainState):
        if payload.get('opt_type') == target.optimizer.opt_type:
            target.optimizer.load_state_dict(
                _in_order(payload['optimizer_state_dict'], target.optimizer.names))
            target.step = int(payload['step'])
        else:
            logger.warning(
                'checkpoint %s: optimizer state not restored (written by %s, '
                'training with %s); parameters restored, optimizer starts '
                'fresh', path, payload.get('opt_type', 'no optimizer'),
                target.optimizer.opt_type)
    return int(payload['epoch']), int(payload['batch'])


def load_latest_checkpoint(target: ModelOrState,
                           checkpoint_dir: str) -> Tuple[int, int]:
    """Load the newest checkpoint into ``target``; returns (epoch, batch),
    or (-1, 0) if there is none."""
    path = _newest_or_warn(checkpoint_dir)
    return (-1, 0) if path is None else load_checkpoint_file(target, path)


_warned_dirs: set = set()


def _newest_or_warn(checkpoint_dir: str) -> Optional[str]:
    """:func:`resolve_checkpoint_path`; when the directory holds none of the
    port's checkpoints but the JAX package's, one warning (a directory) that
    names ``convert-checkpoint``."""
    path = resolve_checkpoint_path(checkpoint_dir)
    if path is None and os.path.isdir(checkpoint_dir) and checkpoint_dir not in _warned_dirs:
        found = sorted(f for f in os.listdir(checkpoint_dir) if _JAX_CKPT_RE.match(f))
        if found:
            _warned_dirs.add(checkpoint_dir)
            logger.warning(
                '%s holds %d checkpoint(s) of the JAX package (%s) and none of the '
                'port\'s, which are read from epoch_E_batch_B.torch.pt: starting '
                'fresh. To carry the run over: python -m inferbiomechanics_tpu_torch '
                'convert-checkpoint %s --out-dir DIR (a single .ckpt file loads as '
                'it is, named by --checkpoint-file or --init-from-checkpoint)',
                checkpoint_dir, len(found), found[-1], checkpoint_dir)
    return path


def warm_start_from(state: TrainState, path: str) -> None:
    """Transfer-learning init (``--init-from-checkpoint``): only the
    parameters of ``path``, keeping the fresh optimizer and step count."""
    load_checkpoint_file(state.model, path)


def load_ema_params(path: str, like: Optional[nn.Module] = None
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """The checkpoint's EMA parameters (a state dict), or ``None`` when it
    carries none. With ``like``, a model, they must have its parameters'
    names and shapes (else ``ValueError``)."""
    kind, payload = read_checkpoint(path)
    if kind == 'jax':
        ema = _jax_ema(payload, weights.model_family(like) if like is not None
                       else weights.tree_family(payload['params']))
    else:
        ema = payload.get('ema_params')
    if ema is None or like is None:
        return ema
    want = dict(like.named_parameters())
    wrong = sorted(k for k in set(want) | set(ema)
                   if k not in want or k not in ema or ema[k].shape != want[k].shape)
    if wrong:
        raise ValueError(f'checkpoint {path}: ema_params do not match the model being '
                         f'built at {wrong[:5]}')
    return ema


def resolve_checkpoint_path(checkpoint_dir: str) -> Optional[str]:
    """Path of the newest epoch_* checkpoint, or None."""
    ckpts = list_checkpoints(checkpoint_dir)
    return ckpts[-1][2] if ckpts else None


class MissingEMAError(ValueError):
    """``--use-ema`` on a checkpoint that carries no EMA parameters."""


def _required_ema(ema: Optional[Dict[str, torch.Tensor]],
                  checkpoint_path: Optional[str]) -> Dict[str, torch.Tensor]:
    if ema is None:
        raise MissingEMAError(f'--use-ema: checkpoint {checkpoint_path} carries '
                              f'no ema_params (train with --ema-decay)')
    return ema


def require_ema_params(checkpoint_path: Optional[str]) -> Dict[str, torch.Tensor]:
    """The EMA parameters of ``checkpoint_path`` (a file, from
    ``resolve_checkpoint_path`` or a --checkpoint-file); raises
    ``MissingEMAError`` (a ValueError) with the JAX package's --use-ema
    guidance when the checkpoint is missing or carries none."""
    return _required_ema(load_ema_params(checkpoint_path) if checkpoint_path else None,
                         checkpoint_path)


def load_model(config, dataset, checkpoint_dir: Optional[str] = None, *,
               checkpoint_file: Optional[str] = None, use_ema: bool = False,
               device=None) -> Tuple[nn.Module, int, int]:
    """A fresh eval-mode model for ``config`` sized to ``dataset`` on
    ``device`` (init drawn from seed 0), loaded from ``checkpoint_file`` or
    else from the newest checkpoint in ``checkpoint_dir``; with ``use_ema``
    its weights are the checkpoint's EMA weights. Returns (model, epoch,
    batch); (model, -1, 0) with the fresh weights when there is no
    checkpoint."""
    model = build_model_for_dataset(config, dataset,
                                    generator=torch.Generator().manual_seed(0), device=device)
    path = checkpoint_file or (_newest_or_warn(checkpoint_dir) if checkpoint_dir else None)
    if path is None:
        if use_ema:
            _required_ema(None, None)
        return model.eval(), -1, 0
    epoch, batch = load_checkpoint_file(model, path, use_ema=use_ema)
    return model.eval(), epoch, batch


def _is_buffer(name: str) -> bool:
    return name.endswith(_BUFFER_SUFFIXES)


def soup_checkpoints(paths, out_path: str) -> str:
    """Uniform parameter average of checkpoints of one architecture (a
    "model soup": one checkpoint that serves at one model's cost, where
    ``serve --ensemble`` keeps K models and averages their predictions).
    Members are the port's files or the JAX package's. Parameters are
    averaged in float64 and cast back; the running statistics, optimizer
    state, step and EMA are the newest member's by (epoch, batch), as the
    JAX soup keeps the newest member's payload and replaces its params.
    Raises for fewer than 2 paths and when the parameter names or shapes
    disagree. Written atomically in the port's format; returns
    ``out_path``."""
    if len(paths) < 2:
        raise ValueError('soup needs at least 2 checkpoints')
    payloads = [read_payload(p) for p in paths]
    sds = [pl['model_state_dict'] for pl in payloads]
    for p, sd in zip(paths[1:], sds[1:]):
        if set(sd) != set(sds[0]):
            raise ValueError(f'{p}: parameter tree structure differs from {paths[0]} '
                             f'(at {sorted(set(sd) ^ set(sds[0]))[:4]}) — not the same '
                             f'architecture')
        for k, v in sd.items():
            if v.shape != sds[0][k].shape:
                raise ValueError(f'{p}: shape mismatch {tuple(v.shape)} vs '
                                 f'{tuple(sds[0][k].shape)} at {k}')
    n = len(sds)
    newest = max(range(n), key=lambda i: (int(payloads[i].get('epoch', -1)),
                                          int(payloads[i].get('batch', 0))))
    out = dict(payloads[newest])
    out['model_state_dict'] = {
        k: v if _is_buffer(k) else torch.from_numpy(
            np.sum([sd[k].double().numpy() for sd in sds], axis=0) / n).to(v.dtype)
        for k, v in sds[newest].items()}
    return _write_payload(out, out_path)


def prune_checkpoints(checkpoint_dir: str, keep: int) -> List[str]:
    """Delete all but the newest ``keep`` epoch_* checkpoints; named files
    (the best checkpoint) are never touched. Returns the removed paths."""
    if keep <= 0:
        return []
    removed = []
    for _e, _b, path in list_checkpoints(checkpoint_dir)[:-keep]:
        os.remove(path)
        removed.append(path)
    return removed
