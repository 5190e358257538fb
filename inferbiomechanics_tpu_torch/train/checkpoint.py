"""Checkpoint save / restore, the subset serving needs.

PyTorch counterpart of ``inferbiomechanics_tpu/train/checkpoint.py``:
``save_checkpoint``, ``list_checkpoints`` and ``load_latest_checkpoint``.
A checkpoint is ``torch.save`` of ``{epoch, batch, model_state_dict}``,
written atomically, and the loader restores the newest by (epoch, batch),
returning ``(-1, 0)`` when there is none.

Files are named ``epoch_{e}_batch_{b}.torch.pt``. The JAX package's
pattern (``epoch_E_batch_B.{ckpt,msgpack,pt}``) does not match that name,
so neither package mistakes the other's files for its own. Reading the
JAX package's flax-msgpack ``.ckpt`` files is not ported yet.
"""

from __future__ import annotations

import os
import re
from typing import List, Tuple

import torch
from torch import nn

_CKPT_RE = re.compile(r'epoch_(\d+)_batch_(\d+)\.torch\.pt$')


def checkpoint_name(epoch: int, batch: int) -> str:
    return f'epoch_{epoch}_batch_{batch}.torch.pt'


def save_checkpoint(checkpoint_dir: str, model: nn.Module,
                    epoch: int, batch: int) -> str:
    """Write ``model``'s parameters; returns the path."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, checkpoint_name(epoch, batch))
    payload = {'epoch': int(epoch), 'batch': int(batch),
               'model_state_dict': {k: v.detach().cpu()
                                    for k, v in model.state_dict().items()}}
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


def load_checkpoint_file(model: nn.Module, path: str) -> Tuple[int, int]:
    """Load one checkpoint file into ``model``; returns (epoch, batch)."""
    payload = torch.load(path, map_location='cpu', weights_only=True)
    model.load_state_dict(payload['model_state_dict'])
    return int(payload['epoch']), int(payload['batch'])


def load_latest_checkpoint(model: nn.Module,
                           checkpoint_dir: str) -> Tuple[int, int]:
    """Load the newest checkpoint into ``model``; returns (epoch, batch),
    or (-1, 0) if there is none."""
    ckpts = list_checkpoints(checkpoint_dir)
    if not ckpts:
        return -1, 0
    return load_checkpoint_file(model, ckpts[-1][2])
