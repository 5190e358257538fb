"""Pre-materialized dataset blocks.

Capability parity: reference ``src/data/PickledDataset.py`` — load
windows from blocks written by the ``pickle-data`` command (§2.14),
skipping all header/featurization work. Blocks are ``.npz`` files
holding the packed feature/label matrices plus the window table (see
cli/pickle_data_cmd.py), so a loaded PickledDataset serves batches
through the same ``gather``/``batches`` interface as WindowDataset.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from inferbiomechanics_tpu_torch.data.dataset import (
    WindowDataset, _offsets, input_layout, label_layout,
)


class PickledDataset:
    """Load `{split}_{i}.npz` blocks from a `*_pickled` directory."""

    def __init__(self, pickled_dir: str, num_dofs: Optional[int] = None,
                 root_history_len: Optional[int] = None,
                 num_contact_bodies: Optional[int] = None):
        """Layout metadata (num_dofs / root_history_len /
        num_contact_bodies) is ADOPTED from the blocks when stored by the
        writer; explicit arguments only override (and are validated
        against) stored values. Blocks from the pre-metadata layout fall
        back to the rajagopal_no_arms defaults (23/10/2)."""
        # numeric block order: lexicographic sort would put block 10
        # before block 2 and scramble the window table
        def _block_key(p):
            stem = os.path.splitext(os.path.basename(p))[0]
            head, _, idx = stem.rpartition('_')
            return (head, int(idx)) if idx.isdigit() else (stem, -1)

        paths = sorted(glob.glob(os.path.join(pickled_dir, '*.npz')),
                       key=_block_key)
        if not paths:
            raise FileNotFoundError(f'no .npz blocks in {pickled_dir}')
        feats, labs, fts, subs, trs, starts = [], [], [], [], [], []
        self.window_size = None
        self.stride = None
        trial_offsets = []
        for p in paths:
            z = np.load(p)
            if self.window_size is None:
                self.window_size = int(z['window_size'])
                self.stride = int(z['stride'])
                # the packed matrices live in block 0 only (blocks written
                # by an older layout may repeat them; extra copies ignored)
                feats.append(z['features_all'])
                labs.append(z['labels_all'])
                trial_offsets = z['trial_row_offset']
                # layout metadata: adopt the writer's stored values; an
                # explicit caller argument must agree (a mismatched
                # expectation would silently mis-slice label columns)
                if 'num_dofs' in z.files:
                    for key, requested in (
                            ('num_dofs', num_dofs),
                            ('root_history_len', root_history_len),
                            ('num_contact_bodies', num_contact_bodies)):
                        got = int(z[key])
                        if requested is not None and got != requested:
                            raise ValueError(
                                f'{p}: stored {key}={got} does not match '
                                f'requested {key}={requested}')
                    num_dofs = int(z['num_dofs'])
                    root_history_len = int(z['root_history_len'])
                    num_contact_bodies = int(z['num_contact_bodies'])
                    self.output_data_format = str(z['output_data_format'])
            fts.append(z['win_ft'])
            subs.append(z['win_subject'])
            trs.append(z['win_trial'])
            starts.append(z['win_start'])
        self.features_all = np.concatenate(feats)
        self.labels_all = np.concatenate(labs)
        self.trial_row_offset = np.asarray(trial_offsets, np.int64)
        self.win_ft = np.concatenate(fts)
        self.win_subject = np.concatenate(subs)
        self.win_trial = np.concatenate(trs)
        self.win_start = np.concatenate(starts)

        # pre-metadata blocks: fall back to the rajagopal_no_arms defaults
        self.num_dofs = num_dofs = 23 if num_dofs is None else num_dofs
        self.root_history_len = root_history_len = \
            10 if root_history_len is None else root_history_len
        self.num_contact_bodies = num_contact_bodies = \
            2 if num_contact_bodies is None else num_contact_bodies
        self.in_layout = input_layout(num_dofs, root_history_len)
        self.lab_layout = label_layout(num_dofs, num_contact_bodies)
        self.in_offsets = _offsets(self.in_layout)
        self.lab_offsets = _offsets(self.lab_layout)
        self.num_input_channels = self.features_all.shape[1]
        self.num_label_channels = self.labels_all.shape[1]
        self.num_model_frames = self.window_size // self.stride
        self.output_data_format = getattr(self, 'output_data_format', 'last_frame')
        self.num_output_frames = 1
        self.subjects: List = []
        self.subject_paths: List[str] = []
        self.contact_bodies = ['calcn_r', 'calcn_l'][:num_contact_bodies]
        self.skeletons: List = []

    # reuse WindowDataset's gather/batches/unpack implementations
    __len__ = WindowDataset.__len__
    gather = WindowDataset.gather
    batches = WindowDataset.batches
    unpack_inputs = WindowDataset.unpack_inputs
    unpack_labels = WindowDataset.unpack_labels
