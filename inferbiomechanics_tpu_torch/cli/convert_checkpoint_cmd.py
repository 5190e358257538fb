"""``convert-checkpoint`` subcommand: other frameworks' checkpoints into the
port's format, the port's back into the reference's, and model soups.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/convert_checkpoint_cmd.py``
with its flags. Sources:

- reference ``.pt`` files (``torch_compat.py``: feedforward and GroundLink),
  with the fresh state of ``--opt-type`` embedded, as the JAX command does;
- the JAX package's ``.ckpt`` files (flax msgpack), with their optimizer
  state, step, epoch, batch and EMA (``train/checkpoint.py
  ::convert_jax_checkpoint``), and the ``run_config.json`` beside them
  copied beside the output: the port's way to take over a run of the
  framework before it, as the JAX command takes over the reference's.

The output lands under ``--out-dir`` as ``epoch_{e}_batch_{b}.torch.pt``, so
``train``, ``serve`` and ``analyze`` with ``--checkpoint-dir`` one level up
(``<checkpoint-dir>/<model-type>/``) resume or load from it unchanged.
``--to-torch`` writes the port's (or the JAX package's) checkpoints as
reference ``.pt`` files; ``--soup OUT`` averages the parameters of
checkpoints of one architecture into one checkpoint. Directories name every
checkpoint in them.

    python -m inferbiomechanics_tpu_torch convert-checkpoint RUN/feedforward --out-dir C/feedforward
    python -m inferbiomechanics_tpu_torch convert-checkpoint C/feedforward --to-torch --out-dir REF
    python -m inferbiomechanics_tpu_torch convert-checkpoint C1/x.torch.pt C2/y.torch.pt --soup soup.torch.pt
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List

from inferbiomechanics_tpu_torch.train.checkpoint import (
    checkpoint_format, convert_jax_checkpoint, soup_checkpoints,
)
from inferbiomechanics_tpu_torch.torch_compat import (
    convert_torch_checkpoint, export_torch_checkpoint,
)


def register_subcommand(sub) -> None:
    p = sub.add_parser(
        'convert-checkpoint',
        help='Convert reference .pt and JAX package .ckpt checkpoints into the '
             'port\'s format (or back, or into a soup)')
    p.add_argument('paths', nargs='+',
                   help='checkpoint files or directories holding them')
    p.add_argument('--out-dir', type=str, default=None,
                   help='Destination checkpoint dir (point --checkpoint-dir/'
                        '<model-type> here later); required except with --soup')
    p.add_argument('--opt-type', type=str, default='rmsprop',
                   help='Optimizer whose fresh state a reference .pt gets (its torch '
                        'optimizer state is not portable); for a .ckpt whose state '
                        'fits more than one type (adam and adamax keep the same), '
                        'the type read after its run_config.json\'s')
    p.add_argument('--learning-rate', type=float, default=1e-4)
    p.add_argument('--to-torch', action='store_true',
                   help='Reverse direction: write the port\'s .torch.pt (or .ckpt) '
                        'files as reference-format .pt files')
    p.add_argument('--dropout', action='store_true',
                   help='--to-torch only: the reference model was built with '
                        '--dropout (shifts its Sequential layer indices)')
    p.add_argument('--soup', type=str, default=None, metavar='OUT',
                   help='Merge the given checkpoints (one architecture) into ONE '
                        'checkpoint by uniform parameter averaging (a "model '
                        'soup": ensemble-flavored accuracy at single-model '
                        'serving cost)')


def _files(paths, reverse: bool) -> List[str]:
    """The checkpoint files ``paths`` name: for a directory, the port's
    and the JAX package's files in it (``reverse``: --to-torch and --soup),
    else the reference's ``.pt`` files and the JAX package's."""
    files = []
    for p in paths:
        if not os.path.isdir(p):
            files.append(p)
            continue
        found = glob.glob(os.path.join(p, '*.ckpt'))
        pts = glob.glob(os.path.join(p, '*.pt'))
        found += [f for f in pts if f.endswith('.torch.pt') == reverse]
        files.extend(sorted(found))
    return files


def run(args: argparse.Namespace) -> int:
    reverse = bool(args.to_torch or args.soup)
    files = _files(args.paths, reverse)
    if not files:
        print('no checkpoints found')
        return 0
    if args.soup:
        out = soup_checkpoints(files, args.soup)
        print(f'souped {len(files)} checkpoints -> {out}')
        return 0
    if not args.out_dir:
        print('convert-checkpoint: --out-dir is required (except with --soup)',
              file=sys.stderr)
        return 2
    for f in files:
        if args.to_torch:
            out = export_torch_checkpoint(f, args.out_dir, dropout=args.dropout)
        elif checkpoint_format(f) == 'jax':
            out = convert_jax_checkpoint(f, args.out_dir, prefer=(args.opt_type,))
        else:
            out = convert_torch_checkpoint(f, args.out_dir, opt_type=args.opt_type,
                                           learning_rate=args.learning_rate)
        print(f'{f} -> {out}')
    return 0
