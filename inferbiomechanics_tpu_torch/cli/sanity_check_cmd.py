"""``sanity-check`` subcommand: per-key statistics of the train split.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/sanity_check_cmd.py``, on
the port's ``WindowDataset``, with its flags and its text: a window_size = 1
pass over the train split, then for each input and label key the mean,
variance, minimum and maximum of its packed columns (numpy, float32, as the
JAX command computes them) and a warning for a key that holds non-finite
values. A host-side command: it runs no model and takes no ``--device``.

    python -m inferbiomechanics_tpu_torch sanity-check --dataset-home D
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from inferbiomechanics_tpu_torch.data.dataset import WindowDataset


def register_subcommand(sub) -> None:
    p = sub.add_parser('sanity-check', help='Print per-key data statistics for the train split')
    p.add_argument('--dataset-home', type=str, default='../data')
    p.add_argument('--geometry-folder', type=str, default='')
    p.add_argument('--short', action='store_true')


def report(name: str, mat: np.ndarray, offsets) -> None:
    print(f'--- {name} ---')
    for key, (o, w) in offsets.items():
        cols = mat[:, o:o + w]
        print(f'{key}: mean={cols.mean():.4f} var={cols.var():.4f} '
              f'min={cols.min():.4f} max={cols.max():.4f}')
        if not np.isfinite(cols).all():
            print(f'  WARNING: {key} contains non-finite values!')


def run(args: argparse.Namespace) -> int:
    ds = WindowDataset(os.path.join(args.dataset_home, 'train'), window_size=1, stride=1,
                       testing_with_short_dataset=args.short, skip_loading_skeletons=True)
    print(f'{len(ds)} windows over {len(ds.subject_paths)} subjects')
    report('inputs', ds.features_all, ds.in_offsets)
    report('labels', ds.labels_all, ds.lab_offsets)
    return 0
