"""``create-splits`` subcommand: the train and dev splits of a processed
dataset.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/create_splits_cmd.py``
(os and shutil only), with its flags: walk ``{data}/processed`` for non-empty
``.b3d`` files, group them by dataset name (the third-from-last path
segment), copy each as ``{dataset}_{file}``, the first two sorted files of
each dataset to ``dev`` and the rest to ``train``; a dataset of fewer than 3
files goes to ``train`` whole. A host-side command: it takes no
``--device``.

    python -m inferbiomechanics_tpu_torch create-splits --data-path D
"""

from __future__ import annotations

import argparse
import os
import shutil
from collections import defaultdict


def register_subcommand(sub) -> None:
    p = sub.add_parser('create-splits', help='Create train/dev splits of the dataset')
    p.add_argument('--data-path', '--data-folder', dest='data_path', type=str,
                   default='../data',
                   help='Root that contains processed/ and will receive train/ and '
                        'dev/ (ref flag: --data-folder).')


def run(args: argparse.Namespace) -> int:
    data_path = os.path.abspath(args.data_path)
    processed = os.path.join(data_path, 'processed')
    train_dir = os.path.join(data_path, 'train')
    dev_dir = os.path.join(data_path, 'dev')
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(dev_dir, exist_ok=True)

    by_dataset = defaultdict(list)
    for root, _dirs, files in os.walk(processed):
        for f in files:
            path = os.path.join(root, f)
            if f.endswith('.b3d') and os.path.getsize(path) > 0:
                parts = path.split(os.sep)
                dataset = parts[-3] if len(parts) >= 3 else 'default'
                by_dataset[dataset].append(path)

    for dataset, paths in sorted(by_dataset.items()):
        paths = sorted(paths)
        dev_paths = paths[:2] if len(paths) >= 3 else []    # fewer than 3: all to train
        for path in paths:
            target_dir = dev_dir if path in dev_paths else train_dir
            new_name = f'{dataset}_{os.path.basename(path)}'
            shutil.copyfile(path, os.path.join(target_dir, new_name))
            print(f'{os.path.basename(target_dir)} <- {new_name}')
    return 0
