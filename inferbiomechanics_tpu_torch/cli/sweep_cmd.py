"""``sweep`` subcommand: an lr x seed grid trained together, per model shape.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/sweep_cmd.py`` with its
flags. The reference sweeps as nested bash loops, one sbatch training job
a (hidden_size, learning_rate) point (reference
``src/slurm/slurm_loop.sh:13-22``). Here the lr x seed grid of each model
shape trains together, one captured step for all its configs
(``train/sweep.py``); shape-changing axes (``--hidden-dims-grid``) run one
after the other. ``--pbt-every N`` turns the grid into population-based
training. ``--device`` names the torch device: ``cuda`` (the default;
fails without a GPU) or ``cpu``.

The JAX sweep spreads over the local devices of one process; the port
spreads over ranks, one a device, started by ``torchrun`` with
``IB_MULTIHOST`` set (``parallel/dist.py::process_group_from_env``, as for
``train``): ``--shard-configs`` gives each rank its block of the grid,
``--device-data sharded`` splits the trials over the ranks, and both
together lay the ranks out as (config, data) (``train/sweep.py``). Rank 0
writes ``sweep_results.json``::

    IB_MULTIHOST=1 torchrun --nproc-per-node 4 -m inferbiomechanics_tpu_torch sweep \
        --dataset-home D --checkpoint-dir C --lrs 1e-4 3e-4 --seeds 0 1 \
        --shard-configs [--device-data sharded]

Writes ``<checkpoint-dir>/sweep/<model-type>/<shape>/lr{lr}_seed{seed}/``
(each config's final and best checkpoints and its ``run_config.json``) and
``<checkpoint-dir>/sweep/<model-type>/sweep_results.json``, prints the
winner, and logs through ``utils/wandb_compat.py``.

    python -m inferbiomechanics_tpu_torch sweep --dataset-home D --checkpoint-dir C \\
        --lrs 1e-4 3e-4 1e-3 --seeds 0 1 --epochs 4 [--pbt-every 1] [--device-data stream]
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os

from inferbiomechanics_tpu_torch.config import add_config_flags, config_from_args
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.parallel import dist

logger = logging.getLogger(__name__)


def register_subcommand(sub) -> None:
    p = sub.add_parser('sweep', conflict_handler='resolve',
                       help='Train a hyperparameter grid together '
                            '(lr x seed in one captured step; hidden dims in sequence)')
    add_config_flags(p)
    p.add_argument('--lrs', type=float, nargs='+', default=None,
                   help='learning-rate axis (default: the single --learning-rate value)')
    p.add_argument('--seeds', type=int, nargs='+', default=None,
                   help='init/dropout seed axis (default: the single --seed value)')
    p.add_argument('--hidden-dims-grid', type=str, nargs='+', default=None, metavar='DIMS',
                   help='optional model-shape axis, each spec a comma-separated '
                        'hidden-dims list (e.g. "512,512" "256,256"); shapes train '
                        'one after the other, the lr x seed grid together inside each')
    p.add_argument('--shard-configs', action='store_true',
                   help='shard the config axis across the ranks (each owns K/n configs, '
                        'no per-step collective); with --device-data sharded, a 2-D '
                        '(config, data) layout')
    p.add_argument('--max-batches-per-epoch', type=int, default=None,
                   help='clamp epochs for smoke runs')
    p.add_argument('--pbt-every', type=int, default=0,
                   help="population-based training: every N dev evals the worst "
                        "quartile of configs copies the best quartile's weights and "
                        "adopts its lr x0.8/x1.25 (0 = plain grid)")
    p.add_argument('--device', type=str, default='cuda',
                   help='torch device to train on: cuda (default; fails without a GPU) or cpu')


def _split(config, name: str) -> WindowDataset:
    return WindowDataset(
        os.path.join(config.dataset_home, name),
        window_size=config.window_size, stride=config.stride,
        output_data_format=config.output_data_format,
        testing_with_short_dataset=config.short,
        trial_filter=config.trial_filter,
        skip_loading_skeletons=True,
        materialize_features=config.materialize_features)


def run(args: argparse.Namespace) -> int:
    config = config_from_args(args)
    if config.model_type == 'analytical':
        print('The analytical baseline has no trainable parameters; nothing to sweep.')
        return 0
    with dist.process_group_from_env(args.device) as device:
        return _sweep(args, config, device)


def _sweep(args: argparse.Namespace, config, device) -> int:
    from inferbiomechanics_tpu_torch.train.sweep import run_sweep
    from inferbiomechanics_tpu_torch.utils.wandb_compat import MetricLogger

    ml = MetricLogger(config=vars(args), group=os.environ.get('WANDB_RUN_GROUP'),
                      enabled=not config.no_wandb)
    lrs = args.lrs or [config.learning_rate]
    seeds = args.seeds if args.seeds is not None else [config.seed]
    shapes = args.hidden_dims_grid or [None]
    root = os.path.join(os.path.abspath(config.checkpoint_dir), 'sweep', config.model_type)

    train_ds = _split(config, 'train')
    try:
        dev_ds = _split(config, 'dev')
    except (FileNotFoundError, ValueError):
        dev_ds = None

    all_points, all_events, best = [], [], None
    for spec in shapes:
        if spec is not None:
            config.hidden_dims = [int(x) for x in spec.split(',') if x]
        shape_tag = ('hid' + 'x'.join(map(str, config.hidden_dims))
                     if spec is not None else 'base')
        config.checkpoint_dir = os.path.join(root, shape_tag)
        result = run_sweep(config, train_ds, dev_ds, lrs, seeds,
                           max_batches_per_epoch=args.max_batches_per_epoch,
                           shard_configs=args.shard_configs, pbt_every=args.pbt_every,
                           metric_logger=ml,
                           metric_prefix=f'{shape_tag}/' if len(shapes) > 1 else '',
                           device=device)
        if result.pbt_events:
            all_events.extend({**e, 'hidden_dims': list(config.hidden_dims)}
                              for e in result.pbt_events)
            print(f'[sweep] {len(result.pbt_events)} PBT exploit/explore events '
                  f'(see sweep_results.json)')
        for p in result.points:
            row = {**vars(p), 'hidden_dims': list(config.hidden_dims)}
            all_points.append(row)
            score = (row['best_dev_loss'] if row.get('best_dev_loss') is not None
                     else row['final_train_loss'])
            if score is not None and (best is None or score < best[0]):
                best = (score, row)
        b = result.best
        lr_moved = (b.final_learning_rate is not None
                    and not math.isclose(b.final_learning_rate, b.learning_rate, rel_tol=1e-6))
        lr_tag = (f'slot lr={b.learning_rate:g} (PBT final {b.final_learning_rate:g})'
                  if lr_moved else f'lr={b.learning_rate:g}')
        print(f'[sweep {shape_tag}] {len(result.points)} configs, '
              f'{result.windows_per_sec:,.0f} windows/sec aggregate; '
              f'best: {lr_tag} seed={b.seed}')

    out = os.path.join(root, 'sweep_results.json')
    if dist.is_main():
        os.makedirs(root, exist_ok=True)
        with open(out, 'w') as f:
            json.dump({'points': all_points, 'best': best[1] if best else None,
                       'pbt_events': all_events}, f, indent=2)
    if best:
        b = best[1]
        flr = b.get('final_learning_rate')
        pbt_tag = (f' (PBT final lr {flr:g})'
                   if flr is not None and not math.isclose(flr, b['learning_rate'],
                                                           rel_tol=1e-6) else '')
        print(f'sweep winner: lr={b["learning_rate"]:g}{pbt_tag} '
              f'seed={b["seed"]} hidden_dims={b["hidden_dims"]} '
              f'loss={best[0]:.6f}\nresults -> {out}')
    ml.finish()
    return 0
