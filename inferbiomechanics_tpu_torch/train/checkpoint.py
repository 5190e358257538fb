"""Checkpoint save / restore.

PyTorch counterpart of ``inferbiomechanics_tpu/train/checkpoint.py``:
``save_checkpoint``, ``list_checkpoints``, ``load_latest_checkpoint``,
``load_checkpoint_file``, ``warm_start_from`` and ``prune_checkpoints``;
``load_model`` builds a model for a config and loads it.
A checkpoint is ``torch.save`` of

    {epoch, batch, model_state_dict,                      always
     optimizer_state_dict, opt_type, step}                from a TrainState
     ema_params}                                          when given one

written atomically; the loader restores the newest by (epoch, batch) and
returns ``(-1, 0)`` when there is none. ``ema_params`` is an exponential
moving average of the parameters, a state dict of the model's keys, under
the JAX package's key name; ``load_model(..., use_ema=True)`` serves it
for ``--use-ema``, and ``load_ema_params``, ``resolve_checkpoint_path`` and
``require_ema_params`` are the JAX package's readers. Every function takes either a bare
model (serving: parameters only) or a ``TrainState`` (training: the
optimizer's state and the step count too), and reads both payloads with
``weights_only=True``.

Files are named ``epoch_{e}_batch_{b}.torch.pt``. The JAX package's
pattern (``epoch_E_batch_B.{ckpt,msgpack,pt}``) does not match that name,
so neither package mistakes the other's files for its own. Named files
(``best.torch.pt``) are model artifacts that the newest-checkpoint scan
ignores. Reading the JAX package's flax-msgpack ``.ckpt`` files, the
asynchronous writer and checkpoint soups are not ported yet. Diffusion
training (``train/diffusion_loop.py``, ``--ema-decay``) writes the EMA.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r'epoch_(\d+)_batch_(\d+)\.torch\.pt$')
BEST_NAME = 'best.torch.pt'

ModelOrState = Union[nn.Module, TrainState]


def checkpoint_name(epoch: int, batch: int) -> str:
    return f'epoch_{epoch}_batch_{batch}.torch.pt'


def _model_of(target: ModelOrState) -> nn.Module:
    return target.model if isinstance(target, TrainState) else target


def save_checkpoint(checkpoint_dir: str, target: ModelOrState,
                    epoch: int, batch: int,
                    filename: Optional[str] = None,
                    ema_params: Optional[Mapping[str, torch.Tensor]] = None) -> str:
    """Write ``target`` (a model, or a TrainState with its optimizer, step
    and EMA), and ``ema_params`` when given; returns the path. ``filename``
    overrides the ``epoch_{e}_batch_{b}.torch.pt`` name."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, filename or checkpoint_name(epoch, batch))
    payload = {'epoch': int(epoch), 'batch': int(batch),
               'model_state_dict': {k: v.detach().cpu() for k, v in
                                    _model_of(target).state_dict().items()}}
    if isinstance(target, TrainState):
        opt = target.optimizer.state_dict()
        opt['state'] = {i: {k: v.detach().cpu() for k, v in st.items()}
                        for i, st in opt['state'].items()}
        payload.update(optimizer_state_dict=opt,
                       opt_type=target.optimizer.opt_type, step=int(target.step))
        if ema_params is None and target.ema is not None:
            ema_params = target.ema.state_dict()
    if ema_params is not None:
        payload['ema_params'] = {k: v.detach().cpu() for k, v in ema_params.items()}
    tmp = path + '.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint
    return path


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


def load_checkpoint_file(target: ModelOrState, path: str, *,
                         use_ema: bool = False) -> Tuple[int, int]:
    """Load one checkpoint file into ``target``; returns (epoch, batch). A
    TrainState also gets the optimizer's state and the step back when the
    file holds them and was written by the same kind of optimizer;
    otherwise the optimizer starts fresh, with a warning. ``use_ema`` then
    puts the file's EMA parameters in the model (``require_ema_params``'s
    error when it carries none)."""
    payload = torch.load(path, map_location='cpu', weights_only=True)
    try:
        _model_of(target).load_state_dict(payload['model_state_dict'])
    except RuntimeError as e:
        raise ValueError(
            f'checkpoint {path}: parameters do not match the model being '
            f'built, most commonly a transformer checkpoint written with a '
            f'different --attn-impl, or different --hidden-dims / --d-model / '
            f'--num-layers. Original error: {e}') from e
    if use_ema:
        _model_of(target).load_state_dict(_required_ema(payload.get('ema_params'), path))
    if isinstance(target, TrainState):
        if payload.get('opt_type') == target.optimizer.opt_type:
            target.optimizer.load_state_dict(payload['optimizer_state_dict'])
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
    path = resolve_checkpoint_path(checkpoint_dir)
    return (-1, 0) if path is None else load_checkpoint_file(target, path)


def warm_start_from(state: TrainState, path: str) -> None:
    """Transfer-learning init (``--init-from-checkpoint``): only the
    parameters of ``path``, keeping the fresh optimizer and step count."""
    load_checkpoint_file(state.model, path)


def load_ema_params(path: str, like: Optional[nn.Module] = None
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """The checkpoint's EMA parameters (a state dict), or ``None`` when it
    carries none. With ``like``, a model, they must have its parameters'
    names and shapes (else ``ValueError``)."""
    payload = torch.load(path, map_location='cpu', weights_only=True)
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
    path = checkpoint_file or (resolve_checkpoint_path(checkpoint_dir)
                               if checkpoint_dir else None)
    if path is None:
        if use_ema:
            _required_ema(None, None)
        return model.eval(), -1, 0
    epoch, batch = load_checkpoint_file(model, path, use_ema=use_ema)
    return model.eval(), epoch, batch


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
