"""``pickle-data`` subcommand: every window of the train and dev splits,
featurized once, into ``.npz`` blocks that ``train --use-pickled`` reads.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/pickle_data_cmd.py``, with
its flags and its block format: for each split under ``--dataset-home``,
``{split}_pickled/{split}_{i}.npz`` holds the window table of windows
``i * BLOCK`` on (``win_ft``, ``win_subject``, ``win_trial``, ``win_start``),
the trial row offsets, ``window_size``, ``stride`` and the layout metadata
(``num_dofs``, ``root_history_len``, ``num_contact_bodies``,
``output_data_format``); block 0 alone also holds the packed feature and
label matrices. The JAX package reads the blocks this command writes, and
the port's ``data/pickled.py::PickledDataset`` reads the JAX command's. A
host-side command: it runs no model and takes no ``--device``.

    python -m inferbiomechanics_tpu_torch pickle-data --dataset-home D
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from inferbiomechanics_tpu_torch.data.dataset import WindowDataset

BLOCK = 100_000


def register_subcommand(sub) -> None:
    p = sub.add_parser('pickle-data', help='Materialize featurized windows to .npz blocks')
    p.add_argument('--dataset-home', type=str, default='../data')
    p.add_argument('--history-len', type=int, default=50)
    p.add_argument('--stride', type=int, default=5)
    p.add_argument('--geometry-folder', type=str, default='')


def run(args: argparse.Namespace) -> int:
    for split in ('train', 'dev'):
        src = os.path.join(args.dataset_home, split)
        if not os.path.isdir(src):
            print(f'{split}: {src} missing, skipping')
            continue
        ds = WindowDataset(src, window_size=args.history_len, stride=args.stride,
                           skip_loading_skeletons=True)
        out_dir = os.path.join(args.dataset_home, f'{split}_pickled')
        os.makedirs(out_dir, exist_ok=True)
        n = len(ds)
        for block_i, start in enumerate(range(0, max(n, 1), BLOCK)):
            idx = np.arange(start, min(start + BLOCK, n))
            path = os.path.join(out_dir, f'{split}_{block_i}.npz')
            arrays = dict(
                trial_row_offset=ds.trial_row_offset,
                win_ft=ds.win_ft[idx], win_subject=ds.win_subject[idx],
                win_trial=ds.win_trial[idx], win_start=ds.win_start[idx],
                window_size=args.history_len, stride=args.stride,
                num_dofs=ds.num_dofs, root_history_len=ds.root_history_len,
                num_contact_bodies=len(ds.contact_bodies),
                output_data_format=ds.output_data_format)
            if block_i == 0:
                # the packed matrices go in block 0 only; later blocks carry
                # just their slice of the window table
                arrays['features_all'] = ds.features_all
                arrays['labels_all'] = ds.labels_all
            np.savez_compressed(path, **arrays)
            print(f'wrote {path} ({idx.size} windows)')
    return 0
