"""``train`` subcommand.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/train_cmd.py``, on the
port's one flag schema (``config.py::add_config_flags``): train and dev
datasets under ``--dataset-home``, the model factory, resume, the epoch
loop (``--model-type diffusion``: the diffusion loop), checkpoints under
``<checkpoint-dir>/<model-type>/``; the subjects' skeletons are read only
for ``--compute-report``. ``--device``
names the torch device: ``cuda`` (the default; fails without a GPU) or
``cpu``. Metrics go to the log only (no wandb).

``IB_MULTIHOST`` set (the JAX command's multi-host switch) trains data
parallel over the processes ``torchrun`` starts, one rank a device:
``parallel/dist.py::start_from_env`` joins the process group from
torchrun's environment (NCCL for ``--device cuda``, rank r on
``cuda:LOCAL_RANK``; gloo for ``--device cpu``; ``IB_MULTIHOST=gloo`` or
``=nccl`` names the backend, e.g. gloo for ranks that share one GPU)::

    IB_MULTIHOST=1 torchrun --nproc-per-node 4 -m inferbiomechanics_tpu_torch train ...

``--model-parallel mp`` lays the ranks out as the JAX loop lays its devices
out, (data, model) of shape (n / mp, mp), with the state replicated: the mp
ranks of a ``data`` row train on the same rows, and the data-parallel
degree falls to n / mp (``train/loop.py``)::

    IB_MULTIHOST=1 torchrun --nproc-per-node 4 -m inferbiomechanics_tpu_torch train \
        ... --model-parallel 2
"""

from __future__ import annotations

import argparse
import logging
import os

from inferbiomechanics_tpu_torch.config import add_config_flags, config_from_args
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.parallel import dist
from inferbiomechanics_tpu_torch.train.diffusion_loop import train_diffusion
from inferbiomechanics_tpu_torch.train.loop import TrainResult, train

logger = logging.getLogger(__name__)


def register_subcommand(sub) -> None:
    p = sub.add_parser('train', conflict_handler='resolve',
                       help='Train a model on the AddBiomechanics dataset')
    add_config_flags(p)
    p.add_argument('--device', type=str, default='cuda',
                   help='torch device to train on: cuda (default; fails '
                        'without a GPU) or cpu')
    p.add_argument('--use-pickled', action='store_true', help='not yet ported')


def run_training(args: argparse.Namespace) -> TrainResult:
    """Train as the parsed ``train`` arguments say; returns the loop's result."""
    if args.use_pickled:
        raise NotImplementedError('--use-pickled is not yet ported '
                                  '(ROADMAP.md Queue 1 item 9, the rest of the CLI)')
    config = config_from_args(args)
    config.checkpoint_dir = os.path.join(os.path.abspath(config.checkpoint_dir),
                                         config.model_type)

    def split(name: str) -> WindowDataset:
        return WindowDataset(
            os.path.join(config.dataset_home, name),
            window_size=config.window_size, stride=config.stride,
            output_data_format=config.output_data_format,
            testing_with_short_dataset=config.short,
            trial_filter=config.trial_filter,
            skip_loading_skeletons=not config.compute_report,
            materialize_features=config.materialize_features)

    with dist.process_group_from_env(args.device) as device:
        train_ds = split('train')
        dev_ds = split('dev') if os.path.isdir(os.path.join(config.dataset_home, 'dev')) else None
        if config.model_type == 'diffusion':
            return train_diffusion(config, train_ds, dev_ds, device=device)
        return train(config, train_ds, dev_ds, device=device)


def run(args: argparse.Namespace) -> int:
    if args.model_type == 'analytical':
        print('The analytical baseline has no trainable parameters; '
              'use `analyze` to evaluate it.')
        return 0
    result = run_training(args)
    print(f'Training done: {result.epochs_run} epochs, '
          f'{result.windows_per_sec:,.0f} windows/sec')
    return 0
