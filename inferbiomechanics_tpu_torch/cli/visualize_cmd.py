"""``visualize`` subcommand: model predictions on the dev split in the viewer.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/visualize_cmd.py``, with
its flags: the reference's dev-split viewer (port 8888). The DEFAULT is the
live viewer (``viz/live_model.py``): a B=1 forward of the latest checkpoint a
tick through ``inference.py::Predictor`` (K1, K2 or K4), the loss evaluator
accumulated and reported every 100 frames and on 'r'. ``--static``, ``--out``
or ``--serve`` export one subject's trial as a self-contained HTML snapshot
instead (``visualize_file_cmd.build_viz_payload``). ``--device`` defaults to
``cuda`` and fails without a GPU; ``--device cpu`` runs the kernels' plain
versions.

    python -m inferbiomechanics_tpu_torch visualize --dataset-home D \
        --checkpoint-dir C [--static [--subject 0] [--trial 0] [--out F] [--serve]]
"""

from __future__ import annotations

import argparse
import os

from inferbiomechanics_tpu_torch.cli.visualize_file_cmd import (
    add_device_flag, build_viz_payload, make_predictor,
)
from inferbiomechanics_tpu_torch.config import add_config_flags, config_from_args
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.loss.evaluator import RegressionLossEvaluator
from inferbiomechanics_tpu_torch.serve import resolve_device
from inferbiomechanics_tpu_torch.train.loop import loss_config_from
from inferbiomechanics_tpu_torch.train.run_config import (
    add_run_config_flag, use_run_config_if_requested,
)
from inferbiomechanics_tpu_torch.utils.geometry import ensure_geometry
from inferbiomechanics_tpu_torch.viz.live_model import serve_live
from inferbiomechanics_tpu_torch.viz.viewer import export_html, serve_file


def register_subcommand(sub) -> None:
    p = sub.add_parser('visualize', conflict_handler='resolve',
                       help='Visualize model predictions on the dev split')
    p.add_argument('--subject', type=int, default=0)
    p.add_argument('--trial', type=int, default=0)
    p.add_argument('--out', type=str, default=None,
                   help='Static-export output path (implies --static); default '
                        'outputs/visualize.html')
    p.add_argument('--serve', action='store_true',
                   help='With --static: serve the exported HTML (implies --static)')
    p.add_argument('--static', action='store_true',
                   help='Export a batched HTML snapshot instead of serving the live viewer')
    p.add_argument('--live', action='store_true',
                   help=argparse.SUPPRESS)  # legacy: live is now the default
    p.add_argument('--tta-mirror', action='store_true',
                   help='Mirror test-time augmentation: average each prediction with the '
                        'un-mirrored prediction of the sagittally mirrored window')
    p.add_argument('--port', type=int, default=8888)
    p.add_argument('--host', type=str, default='127.0.0.1',
                   help='Bind address (default loopback; use 0.0.0.0 to allow remote access)')
    add_config_flags(p)
    add_run_config_flag(p)
    add_device_flag(p, 'predict and pose')


def run(args: argparse.Namespace) -> int:
    config = use_run_config_if_requested(config_from_args(args), args)
    device = resolve_device(args.device)
    ds = WindowDataset(os.path.join(config.dataset_home, 'dev'),
                       window_size=config.window_size, stride=config.stride,
                       testing_with_short_dataset=config.short,
                       skip_loading_skeletons=True)
    predictor = None
    if config.model_type != 'analytical':
        predictor = make_predictor(config, ds, args.tta_mirror, device)
    geometry = ensure_geometry(config.geometry_folder)
    # --out / --serve only make sense for the static export; honor them
    # rather than silently dropping them in the live default
    static = args.static or args.serve or args.out is not None
    if not static:
        # the interactive viewer is the default, matching the reference
        # (visualize.py:123-130 IS the live GUI)
        evaluator = (RegressionLossEvaluator('dev', loss_config_from(config))
                     if predictor else None)
        serve_live(ds, predictor, evaluator, geometry_folder=geometry,
                   title='dev split (live)', port=args.port, host=args.host, device=device)
        return 0
    payload = build_viz_payload(ds, args.subject, args.trial, predictor,
                                geometry_folder=geometry, device=device)
    out = args.out or 'outputs/visualize.html'
    path = export_html(out, payload, title=f'dev subject {args.subject} trial {args.trial}')
    print(f'wrote viewer: {path}')
    if args.serve:
        serve_file(path, args.port, host=args.host)
    return 0
