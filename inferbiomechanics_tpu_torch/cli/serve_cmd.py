"""``serve`` subcommand: the batch-inference HTTP server on PyTorch.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/serve_cmd.py``, with
the same flag schema (``add_config_flags``) plus the serve flags. It builds
its own parser: the JAX command's ``register_subcommand`` imports the JAX
training package. ``--device`` defaults to ``cuda`` and fails when there is
no GPU; ``--device cpu`` serves on the CPU.

    python -m inferbiomechanics_tpu_torch serve --dataset-home D --checkpoint-dir C
    python -m inferbiomechanics_tpu_torch serve ... --model-type groundlink
    python -m inferbiomechanics_tpu_torch serve ... --model-type transformer --fused-inference
    python -m inferbiomechanics_tpu_torch serve ... --ensemble C1 C2 C3 --tta-mirror
    python -m inferbiomechanics_tpu_torch serve ... --quantize int8
    python -m inferbiomechanics_tpu_torch serve ... --model-type diffusion \
        --output-data-format all_frames --fused-inference [--diffusion-samples 4]
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

from inferbiomechanics_tpu_torch.config import add_config_flags, config_from_args
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.serve import InferenceService, serve
from inferbiomechanics_tpu_torch.train.run_config import (
    add_run_config_flag, use_run_config_if_requested,
)


def build_parser() -> argparse.ArgumentParser:
    """A parser with the ``serve`` subcommand alone."""
    parser = argparse.ArgumentParser(prog='python -m inferbiomechanics_tpu_torch')
    register_subcommand(parser.add_subparsers(dest='command', required=True))
    return parser


def register_subcommand(sub) -> None:
    p = sub.add_parser('serve', conflict_handler='resolve',
                       help='Serve checkpoint predictions over HTTP')
    add_config_flags(p)
    p.add_argument('--device', type=str, default='cuda',
                   help='torch device to serve on: cuda (default; fails '
                        'without a GPU) or cpu')
    add_run_config_flag(p)
    p.add_argument('--port', type=int, default=8090)
    p.add_argument('--host', type=str, default='127.0.0.1',
                   help='Bind address; 0.0.0.0 exposes the server to the '
                        'network')
    p.add_argument('--max-batch', type=int, default=4096,
                   help='Largest accepted /predict batch')
    p.add_argument('--batch-wait-ms', type=float, default=0.0,
                   help='Dynamic batching: wait this long after a /predict '
                        'arrives so concurrent requests coalesce into one '
                        'device forward (0 = off)')
    p.add_argument('--warmup', action='store_true',
                   help='Run one forward at B=1 and at --max-batch before '
                        'accepting requests')
    p.add_argument('--reload-poll-sec', type=float, default=0.0,
                   help='Poll the checkpoint dir every N seconds and swap to '
                        'newer checkpoints automatically (0 = off; POST '
                        '/reload always works)')
    p.add_argument('--tta-mirror', action='store_true',
                   help='Mirror test-time augmentation: each prediction is '
                        'averaged with the un-mirrored prediction of the '
                        'sagittally mirrored window (one extra forward per '
                        'model and request)')
    p.add_argument('--ensemble', type=str, nargs='+', default=None,
                   metavar='CKPT',
                   help='Serve the mean of several checkpoints (dirs or '
                        'checkpoint files, e.g. a seed sweep\'s per-config '
                        'checkpoints), one forward per member; /predict can '
                        'also return the across-member std ("spread": true)')
    p.add_argument('--checkpoint-file', type=str, default=None,
                   help='Serve this checkpoint file (the port\'s .torch.pt or the JAX '
                        'package\'s .ckpt) instead of the newest in '
                        '--checkpoint-dir/<model-type>')
    p.add_argument('--sample-steps', type=int, default=50,
                   help='DDIM sampling steps per request (--model-type diffusion)')
    p.add_argument('--use-ema', action='store_true',
                   help='Serve the checkpoint\'s EMA parameters (written by '
                        'training with --ema-decay)')
    p.add_argument('--diffusion-samples', type=int, default=1,
                   help='Diffusion: K sampling chains per request, stacked into '
                        'one batch; /predict returns their mean and, with '
                        '"spread": true, their std')
    p.add_argument('--diffusion-partial', type=float, default=None,
                   help='Diffusion: partial denoising; each chain starts at this '
                        'fraction of the schedule from the --init-checkpoint '
                        'model\'s all-frames proposal')
    p.add_argument('--init-checkpoint', type=str, default=None,
                   help='Checkpoint dir of the all-frames proposal model for '
                        '--diffusion-partial')
    p.add_argument('--quantize', type=str, default=None, choices=['int8'],
                   help='Serve through int8 weights and activations '
                        '(feedforward family; ops/quant.py): weights '
                        'quantized once at load, int32 sums; no reload')


def start(args: argparse.Namespace):
    """Build the service and its HTTP server from parsed ``serve`` args;
    returns ``(service, server)``. The caller runs ``serve_forever``."""
    config = use_run_config_if_requested(config_from_args(args), args)
    checkpoint_dir = os.path.join(os.path.abspath(config.checkpoint_dir),
                                  config.model_type)
    # schema source: dev split if present, else the dataset root
    data_dir = os.path.join(config.dataset_home, 'dev')
    if not os.path.isdir(data_dir):
        data_dir = config.dataset_home
    ds = WindowDataset(data_dir, window_size=config.window_size,
                       stride=config.stride,
                       output_data_format=config.output_data_format,
                       testing_with_short_dataset=config.short,
                       skip_loading_skeletons=True,
                       materialize_features=False)
    service = InferenceService(config, checkpoint_dir, ds,
                               max_batch=args.max_batch,
                               batch_wait_ms=args.batch_wait_ms,
                               device=args.device,
                               ensemble=args.ensemble,
                               sample_steps=args.sample_steps,
                               quantize=args.quantize,
                               use_ema=args.use_ema,
                               tta_mirror=args.tta_mirror,
                               diffusion_samples=args.diffusion_samples,
                               diffusion_partial=args.diffusion_partial,
                               init_checkpoint=args.init_checkpoint,
                               checkpoint_file=args.checkpoint_file)
    if args.warmup:
        service.warmup()
    service.start_reload_poller(args.reload_poll_sec)
    return service, serve(service, host=args.host, port=args.port)


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(name)s: %(message)s')
    return run(build_parser().parse_args(argv))


def run(args: argparse.Namespace) -> int:
    service, server = start(args)
    tag = (f'{len(service.members)}-member ensemble' if service.members else
           f'epoch {service.epoch}, batch {service.batch}')
    print(f'serving {service.config.model_type} ({tag}) on {service.device} at '
          f'http://{args.host}:{server.server_address[1]} — Ctrl-C stops',
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
    return 0
