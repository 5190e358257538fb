"""``save-prediction-csv`` subcommand: a trial's predicted forces as CSV rows.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/save_prediction_csv_cmd.py``,
with its flags: every window of ``--trial`` of the subject ``--file`` goes
through the model's eval forward (``inference.py::Predictor``: K1, K2 or K4),
and each window's last frame becomes a row ``t, cop, cop + 0.001 F mass`` a
contact body in Blender's coordinates (the fixed rotation
[[1,0,0],[0,0,-1],[0,1,0]]), a body's force zeroed where its share of the
force is not above 0.3. ``--device`` defaults to ``cuda`` and fails without
a GPU; ``--device cpu`` runs the kernels' plain versions.

    python -m inferbiomechanics_tpu_torch save-prediction-csv --file S.b3d \
        --checkpoint-dir C [--trial 0] [--out predicted_forces.csv] [--tta-mirror]
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from inferbiomechanics_tpu_torch.config import add_config_flags, config_from_args
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.inference import Predictor
from inferbiomechanics_tpu_torch.train.run_config import (
    add_run_config_flag, use_run_config_if_requested,
)

# world -> Blender coordinate rotation
BLENDER_ROT = np.array([[1.0, 0.0, 0.0],
                        [0.0, 0.0, -1.0],
                        [0.0, 1.0, 0.0]])


def register_subcommand(sub) -> None:
    p = sub.add_parser('save-prediction-csv', conflict_handler='resolve',
                       help='Export per-frame predicted forces to CSV')
    p.add_argument('--file', type=str, required=True)
    p.add_argument('--trial', type=int, default=0)
    p.add_argument('--out', type=str, default='predicted_forces.csv')
    p.add_argument('--tta-mirror', action='store_true',
                   help='Mirror test-time augmentation: average each prediction '
                        'with the un-mirrored prediction of the sagittally '
                        'mirrored window')
    add_config_flags(p)
    add_run_config_flag(p)
    p.add_argument('--device', type=str, default='cuda',
                   help='torch device to predict on: cuda (default; fails '
                        'without a GPU) or cpu')


def run(args: argparse.Namespace) -> int:
    config = use_run_config_if_requested(config_from_args(args), args)
    ds = WindowDataset(args.file, window_size=config.window_size, stride=config.stride,
                       skip_loading_skeletons=True)
    checkpoint_dir = os.path.join(os.path.abspath(config.checkpoint_dir), config.model_type)
    predictor = Predictor(config, checkpoint_dir, ds, tta_mirror=args.tta_mirror,
                          device=args.device)
    pred = predictor.predict_trial(0, args.trial)
    if pred is None:
        print(f'trial {args.trial}: no valid windows')
        return 0
    forces, cops = predictor.predict_forces_at_frames(pred)
    mass = ds.subjects[0].getMassKg()
    nb = forces.shape[-1] // 3
    forces = forces.reshape(-1, nb, 3)
    cops = cops.reshape(-1, nb, 3)

    with open(args.out, 'w', newline='') as f:
        writer = csv.writer(f)
        header = ['t']
        for b in range(nb):
            header += [f'cop{b}_{a}' for a in 'xyz']
            header += [f'cop_plus_f{b}_{a}' for a in 'xyz']
        writer.writerow(header)
        for i, frame in enumerate(pred.last_frame):
            row = [int(frame)]
            for b in range(nb):
                cop_bl = BLENDER_ROT @ cops[i, b]
                # arrow tip: CoP + 0.001 * F * mass
                tip_bl = BLENDER_ROT @ (cops[i, b] + 0.001 * forces[i, b] * mass)
                row += [f'{v:.6f}' for v in cop_bl]
                row += [f'{v:.6f}' for v in tip_bl]
            writer.writerow(row)
    print(f'wrote {args.out} ({pred.last_frame.size} rows)')
    return 0
