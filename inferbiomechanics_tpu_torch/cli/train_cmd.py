"""``train`` subcommand.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/train_cmd.py``, on the
port's one flag schema (``config.py::add_config_flags``): train and dev
datasets under ``--dataset-home``, the model factory, resume, the epoch
loop (``--model-type diffusion``: the diffusion loop), checkpoints under
``<checkpoint-dir>/<model-type>/``; the subjects' skeletons are read only
for ``--compute-report``. ``--device``
names the torch device: ``cuda`` (the default; fails without a GPU) or
``cpu``. ``--use-pickled`` trains on the ``.npz`` blocks of ``pickle-data``
(``{train,dev}_pickled/``; no dev split without ``dev_pickled/``), with the
window size and stride the blocks were written with.

The command logs its run as the JAX command does: a warning when the
working tree has uncommitted changes, ``--geometry-folder`` resolved through
``utils/geometry.py::ensure_geometry``, and the train and dev reports through
``utils/wandb_compat.py::MetricLogger`` (wandb offline, else JSONL under
``outputs/logs``; off with ``--no-wandb``), whose config holds the flags and
the git hash.

``IB_MULTIHOST`` set (the JAX command's multi-host switch) trains data
parallel over the processes ``torchrun`` starts, one rank a device (rank 0
alone logs the run):
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
from inferbiomechanics_tpu_torch.data.pickled import PickledDataset
from inferbiomechanics_tpu_torch.parallel import dist
from inferbiomechanics_tpu_torch.serve import resolve_device
from inferbiomechanics_tpu_torch.train.diffusion_loop import train_diffusion
from inferbiomechanics_tpu_torch.train.loop import TrainResult, train
from inferbiomechanics_tpu_torch.utils.geometry import ensure_geometry
from inferbiomechanics_tpu_torch.utils.gitinfo import get_git_hash, has_uncommitted_changes
from inferbiomechanics_tpu_torch.utils.wandb_compat import MetricLogger

logger = logging.getLogger(__name__)


def register_subcommand(sub) -> None:
    p = sub.add_parser('train', conflict_handler='resolve',
                       help='Train a model on the AddBiomechanics dataset')
    add_config_flags(p)
    p.add_argument('--device', type=str, default='cuda',
                   help='torch device to train on: cuda (default; fails '
                        'without a GPU) or cpu')
    p.add_argument('--use-pickled', action='store_true',
                   help='Load pre-materialized {split}_pickled/ blocks (pickle-data '
                        'output) instead of featurizing .b3d files')


def datasets(config, args: argparse.Namespace):
    """The train split and the dev split (None when it is missing): the
    ``.npz`` blocks of ``pickle-data`` with ``--use-pickled`` (``config``
    then takes their window size and stride), else the ``.b3d`` files."""
    if args.use_pickled:
        train_ds = PickledDataset(os.path.join(config.dataset_home, 'train_pickled'))
        try:
            dev_ds = PickledDataset(os.path.join(config.dataset_home, 'dev_pickled'))
        except FileNotFoundError:
            dev_ds = None
        config.window_size, config.stride = train_ds.window_size, train_ds.stride
        return train_ds, dev_ds

    def split(name: str) -> WindowDataset:
        return WindowDataset(
            os.path.join(config.dataset_home, name),
            window_size=config.window_size, stride=config.stride,
            output_data_format=config.output_data_format,
            testing_with_short_dataset=config.short,
            trial_filter=config.trial_filter,
            skip_loading_skeletons=not config.compute_report,
            materialize_features=config.materialize_features)

    dev = os.path.isdir(os.path.join(config.dataset_home, 'dev'))
    return split('train'), split('dev') if dev else None


def run_training(args: argparse.Namespace, log_run: bool = False) -> TrainResult:
    """Train as the parsed ``train`` arguments say; returns the loop's
    result. ``log_run`` (the command's own run) also does what the JAX
    command does around training: the uncommitted-changes warning, the
    geometry folder and the run's ``MetricLogger`` (rank 0's alone under
    data parallelism), finished after training."""
    config = config_from_args(args)
    config.checkpoint_dir = os.path.join(os.path.abspath(config.checkpoint_dir),
                                         config.model_type)
    with dist.process_group_from_env(args.device) as device:
        device = resolve_device(device)     # no GPU: refused before anything else
        metric_logger = None
        if log_run:
            if has_uncommitted_changes():
                logger.warning('ALERT: You have uncommitted changes — runs may '
                               'not be reproducible from the recorded git hash.')
            config.geometry_folder = ensure_geometry(config.geometry_folder)
            metric_logger = MetricLogger(
                config={**vars(args), 'git_hash': get_git_hash()},
                group=os.environ.get('WANDB_RUN_GROUP'),
                enabled=not config.no_wandb and dist.is_main())
        train_ds, dev_ds = datasets(config, args)
        loop = train_diffusion if config.model_type == 'diffusion' else train
        result = loop(config, train_ds, dev_ds, metric_logger=metric_logger, device=device)
        if metric_logger is not None:
            metric_logger.finish()
        return result


def run(args: argparse.Namespace) -> int:
    if args.model_type == 'analytical':
        print('The analytical baseline has no trainable parameters; '
              'use `analyze` to evaluate it.')
        return 0
    result = run_training(args, log_run=True)
    print(f'Training done: {result.epochs_run} epochs, '
          f'{result.windows_per_sec:,.0f} windows/sec')
    return 0
