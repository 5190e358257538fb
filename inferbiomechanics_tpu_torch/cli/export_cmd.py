"""``export`` subcommand: a checkpointed model as a ``torch.export`` program.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/export_cmd.py``, with its
flags and refusals. ``torch.export`` traces the model's eval forward, its
weights baked in as constants and its batch dimension symbolic (unless
``--static-batch``), into a program that ``torch.export.save`` writes and
``torch.export.load`` reads back without the model code, its config or its
checkpoint machinery. A sidecar ``<out>.json`` records the input schema and
the provenance, with ``torch_version`` and ``artifact_bytes`` where the JAX
command writes ``jax_version`` and ``stablehlo_bytes``.

What a program runs:

- feedforward: K1, one launch a call (a batchnorm model's BatchNorms folded
  into the packed weights);
- the ``pallas`` transformer: K2, one launch a layer;
- GroundLink: K4, one launch a call;
- the ``vpu`` transformer: its plain forward, as the JAX command runs
  ``model.apply`` (``--fused-inference`` is not used);
- ``--quantize int8`` (feedforward): the int8 forward of ``ops/quant.py``,
  its weights int8 constants, no kernel;
- diffusion: the DDIM chain of ``--sample-steps`` steps of the plain
  denoiser (no fused path, as in the JAX command), unrolled, with its noise
  from ``models/diffusion.py::seeded_noise`` of a seed given at call time as a
  second argument (an int32 scalar tensor).

The kernels are the operators of ``ops/library.py``, so a consumer imports
that module before loading (the sidecar names it in ``requires_import``). A
program holds tensors on the device it was exported on: ``--device``
(``cuda`` by default, failing without a GPU; ``cpu`` for tests).

    python -m inferbiomechanics_tpu_torch export --dataset-home D --checkpoint-dir C --out model.pt2
    # consumer side:
    #   import torch, inferbiomechanics_tpu_torch.ops.library   # registers ib_torch::*
    #   outputs = torch.export.load('model.pt2').module()(windows)   # [B, T, C_in] float32
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable

import torch
from torch import nn

from inferbiomechanics_tpu_torch.config import add_config_flags, config_from_args
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.models import diffusion
from inferbiomechanics_tpu_torch.ops.quant import quantized_feedforward_forward
from inferbiomechanics_tpu_torch.serve import resolve_device
from inferbiomechanics_tpu_torch.train.checkpoint import load_model
from inferbiomechanics_tpu_torch.train.run_config import (
    add_run_config_flag, use_run_config_if_requested, warn_on_architecture_mismatch,
)

# the module that registers the operators a program may hold
REQUIRES_IMPORT = 'inferbiomechanics_tpu_torch.ops.library'
# the batch the symbolic dimension is traced at: torch.export specialises 0 and 1
_TRACE_BATCH = 2


def register_subcommand(sub) -> None:
    p = sub.add_parser('export', conflict_handler='resolve',
                       help='Write a checkpointed model as a torch.export program '
                            '(symbolic batch dim)')
    add_config_flags(p)
    add_run_config_flag(p)
    p.add_argument('--device', type=str, default='cuda',
                   help='torch device to export on, which the program\'s tensors '
                        'live on: cuda (default; fails without a GPU) or cpu')
    p.add_argument('--out', type=str, required=True,
                   help='Output program path (sidecar schema JSON written next to it)')
    p.add_argument('--checkpoint-file', type=str, default=None,
                   help='Export this checkpoint file instead of the newest epoch_* one')
    p.add_argument('--static-batch', type=int, default=None,
                   help='Freeze the batch dimension instead of exporting it symbolic')
    p.add_argument('--sample-steps', type=int, default=50,
                   help='Diffusion: DDIM steps unrolled into the exported chain')
    p.add_argument('--quantize', type=str, default=None, choices=['int8'],
                   help='Export the int8-quantized forward (feedforward family; '
                        'ops/quant.py): weights saved as int8 constants')


class _Program(nn.Module):
    """``fn`` as a module with no parameters of its own, so that the program
    holds as constants the tensors ``fn`` reads, and only those."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def eval_forward(config, model, checkpoint_dir: str, *, sample_steps: int = 50,
                 quantize=None) -> Callable:
    """The function ``export`` traces for ``model`` (loaded, on its device):
    ``fn(x)`` (``fn(x, seed)`` for diffusion) -> outputs dict. The kernels'
    weights are packed here, so that the trace finds them made."""
    if config.model_type == 'diffusion':
        sampler = diffusion.make_sampler(
            model, diffusion.DDPMSchedule(config.diffusion_timesteps), num_steps=sample_steps,
            guidance_scale=config.guidance_scale,
            target_space=diffusion.checkpoint_target_space(checkpoint_dir))
        return lambda x, seed: sampler(model, x, noise=diffusion.seeded_noise(seed))
    if quantize:
        return quantized_feedforward_forward(model)
    if config.model_type != 'transformer':
        model.packed()                      # K1, K4
    elif model.attn_impl == 'pallas':
        model.packed_layers(False)          # K2
    return lambda x: model(x)


def export(args: argparse.Namespace) -> dict:
    """Run ``export`` as the parsed arguments say; returns the program
    (``torch.export.ExportedProgram``), the sidecar and the seconds the
    trace took."""
    config = use_run_config_if_requested(config_from_args(args), args)
    if config.model_type == 'analytical':
        raise SystemExit('export supports learned models; the '
                         'analytical baseline carries per-subject '
                         'skeleton state')
    is_diffusion = config.model_type == 'diffusion'
    if is_diffusion and config.output_data_format != 'all_frames':
        raise SystemExit('export --model-type diffusion requires '
                         '--output-data-format all_frames')
    if args.quantize and config.model_type != 'feedforward':
        raise SystemExit('export --quantize int8 supports the '
                         'feedforward family only')
    device = resolve_device(args.device)
    data_dir = os.path.join(config.dataset_home, 'dev')
    if not os.path.isdir(data_dir):
        data_dir = config.dataset_home
    ds = WindowDataset(data_dir, window_size=config.window_size, stride=config.stride,
                       output_data_format=config.output_data_format,
                       skip_loading_skeletons=True, materialize_features=False)
    checkpoint_dir = os.path.join(os.path.abspath(config.checkpoint_dir), config.model_type)
    warn_on_architecture_mismatch(config, checkpoint_dir, 'export')
    model, epoch, batch = load_model(config, ds, checkpoint_dir,
                                     checkpoint_file=args.checkpoint_file, device=device)
    if epoch < 0:
        print(f'WARNING: no checkpoint in {checkpoint_dir}; '
              f'exporting an untrained model')
    fn = eval_forward(config, model, checkpoint_dir, sample_steps=args.sample_steps,
                      quantize=args.quantize)

    frames, channels = ds.num_model_frames, ds.num_input_channels
    x = torch.zeros((args.static_batch or _TRACE_BATCH, frames, channels), device=device)
    dims = ({} if args.static_batch else {0: torch.export.Dim('b')},)
    inputs = (x,)
    if is_diffusion:
        inputs += (torch.zeros((), dtype=torch.int32, device=device),)
        dims += (None,)
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(_Program(fn), inputs, dynamic_shapes=(dims,),
                                         strict=False)
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.export.save(program, args.out)
    n_bytes = os.path.getsize(args.out)
    sidecar = {
        'model_type': config.model_type,
        'checkpoint': {'epoch': epoch, 'batch': batch},
        'input': {'shape': ['b' if not args.static_batch else args.static_batch,
                            frames, channels],
                  'dtype': 'float32',
                  'layout': [{'key': k, 'width': w} for k, w in ds.in_layout]},
        'output_data_format': config.output_data_format,
        'diffusion_sample_steps': args.sample_steps if is_diffusion else None,
        'extra_inputs': ([{'name': 'seed', 'shape': [], 'dtype': 'int32'}]
                         if is_diffusion else []),
        'quantize': args.quantize,
        'torch_version': torch.__version__,
        'artifact_bytes': n_bytes,
        'requires_import': REQUIRES_IMPORT,
        'device': str(device),
    }
    with open(args.out + '.json', 'w') as f:
        json.dump(sidecar, f, indent=2)
    print(f'exported {config.model_type} (epoch {epoch}) -> {args.out} '
          f'({n_bytes / 1e6:.2f} MB torch.export program, '
          f'{"symbolic" if not args.static_batch else args.static_batch} '
          f'batch) + {args.out}.json')
    return {'program': program, 'sidecar': sidecar, 'seconds': seconds}


def run(args: argparse.Namespace) -> int:
    export(args)
    return 0
