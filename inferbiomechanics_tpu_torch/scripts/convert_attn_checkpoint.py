"""Convert transformer/diffusion checkpoints between attention impls.

The port's counterpart of the JAX package's
``scripts/convert_attn_checkpoint.py``: ``attn_impl='flax'``
(``MultiHeadDotProductAttention_0``) and ``'vpu'`` (``ShortWindowAttention_0``)
are numerically equivalent parameterizations of the same layer, but their
parameter trees differ:

    flax:  EncoderBlock_i/MultiHeadDotProductAttention_0/{query,key,value}
           /kernel [d, H, dh] (+bias [H, dh]), /out/kernel [H, dh, d]
    vpu:   EncoderBlock_i/ShortWindowAttention_0/qkv/kernel [d, 3d]
           (q|k|v blocks, each ordered (H, dh)), /proj/kernel [d, d]

This converts a checkpoint written with one impl into the other, so that a
flax run serves, scores and samples through the fused encoder layer (K2)
with ``--attn-impl vpu``:

    python -m inferbiomechanics_tpu_torch.scripts.convert_attn_checkpoint IN OUT --to vpu

It reads either format, told apart by the first bytes
(``train/checkpoint.py::checkpoint_format``):

- the JAX package's flax-msgpack ``.ckpt`` (``utils/flax_msgpack.py``, no
  flax): every ``EncoderBlock_*`` of ``params`` converted, ``opt_state``
  dropped, everything else (step, epoch, batch, ``ema_params``) written back
  as it was, with the keys sorted as flax's writer sorts them: the output is
  the JAX script's, byte for byte;
- the port's ``.torch.pt``: ``model_state_dict`` through the same mapping on
  the JAX tree (``weights.params_to_jax``, then back with
  ``weights.params_from_jax`` of the other family),
  ``optimizer_state_dict`` and ``opt_type`` dropped, epoch, batch, step and
  ``ema_params`` kept.

As in the JAX tool, the EMA stays in the layout it was found in (the
port's ``--use-ema`` loaders refuse such a file by name), the
``run_config.json`` beside the input is not touched, ``pallas`` trees
(``enc{i}_*``) are left alone, and no device is used.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.train.checkpoint import _write_payload, read_checkpoint
from inferbiomechanics_tpu_torch.utils import flax_msgpack


def flax_attn_to_vpu(blk: dict) -> dict:
    """Replace MultiHeadDotProductAttention_0 with ShortWindowAttention_0."""
    mha = blk.pop('MultiHeadDotProductAttention_0')
    q, k, v, out = (mha[n] for n in ('query', 'key', 'value', 'out'))
    d = q['kernel'].shape[0]

    def fold(p):   # [d, H, dh] -> [d, d]
        return np.asarray(p['kernel']).reshape(d, d)

    qkv_kernel = np.concatenate([fold(q), fold(k), fold(v)], axis=1)
    qkv_bias = np.concatenate([np.asarray(p['bias']).reshape(d)
                               for p in (q, k, v)])
    blk['ShortWindowAttention_0'] = {
        'qkv': {'kernel': qkv_kernel, 'bias': qkv_bias},
        'proj': {'kernel': np.asarray(out['kernel']).reshape(d, d),
                 'bias': np.asarray(out['bias'])},
    }
    return blk


def vpu_attn_to_flax(blk: dict, num_heads: int) -> dict:
    """Replace ShortWindowAttention_0 with MultiHeadDotProductAttention_0."""
    swa = blk.pop('ShortWindowAttention_0')
    kern = np.asarray(swa['qkv']['kernel'])
    bias = np.asarray(swa['qkv']['bias'])
    d = kern.shape[0]
    dh = d // num_heads

    def unfold(mat, b):   # [d, d] -> {kernel [d,H,dh], bias [H,dh]}
        return {'kernel': mat.reshape(d, num_heads, dh),
                'bias': b.reshape(num_heads, dh)}

    blk['MultiHeadDotProductAttention_0'] = {
        'query': unfold(kern[:, :d], bias[:d]),
        'key': unfold(kern[:, d:2 * d], bias[d:2 * d]),
        'value': unfold(kern[:, 2 * d:], bias[2 * d:]),
        'out': {'kernel': np.asarray(swa['proj']['kernel']).reshape(
                    num_heads, dh, d),
                'bias': np.asarray(swa['proj']['bias'])},
    }
    return blk


def convert_params(params: dict, to: str, num_heads: int,
                   _converted: Optional[List[str]] = None) -> dict:
    """Convert every EncoderBlock_* in a checkpoint parameter tree.
    `_converted`, if given, is a list receiving the converted block names."""
    out = dict(params)
    for key, blk in params.items():
        if not key.startswith('EncoderBlock_'):
            continue
        blk = dict(blk)
        if to == 'vpu' and 'MultiHeadDotProductAttention_0' in blk:
            out[key] = flax_attn_to_vpu(blk)
        elif to == 'flax' and 'ShortWindowAttention_0' in blk:
            d = np.asarray(blk['ShortWindowAttention_0']['qkv']['kernel']).shape[0]
            if d % num_heads != 0:
                raise SystemExit(
                    f'{key}: d_model {d} not divisible by --num-heads '
                    f'{num_heads}')
            out[key] = vpu_attn_to_flax(blk, num_heads)
        else:
            continue
        if _converted is not None:
            _converted.append(key)
    return out


def _nothing_to_convert(path: str, to: str) -> SystemExit:
    return SystemExit(
        f'no EncoderBlock attention parameters to convert to '
        f'{to!r} — is {path} already in that format? '
        f'(nothing written)')


def convert_file(input_path: str, output_path: str, to: str, num_heads: int = 8) -> int:
    """Convert ``input_path`` (either format) into ``output_path`` in the
    same format; returns the number of blocks converted. Raises
    ``SystemExit``, writing nothing, when there is nothing to convert."""
    kind, raw = read_checkpoint(input_path)
    converted: List[str] = []
    if kind == 'jax':
        raw['params'] = convert_params(raw['params'], to, num_heads, _converted=converted)
        if not converted:
            raise _nothing_to_convert(input_path, to)
        # NOTE: --num-heads must match the TRAINING config for --to flax; any
        # divisor of d_model reshapes cleanly, but a wrong value changes the
        # per-head softmax grouping silently.
        # optimizer moments have the old tree shape; drop them (the loader
        # restarts the optimizer on mismatch anyway, this makes it explicit)
        raw.pop('opt_state', None)
        os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
        with open(output_path, 'wb') as f:     # keys sorted, as flax's writer sorts them
            f.write(flax_msgpack.dumps(weights._sorted_tree(raw)))
        return len(converted)
    sd = raw['model_state_dict']
    tree = convert_params(weights.params_to_jax(weights.state_dict_family(sd), sd), to,
                          num_heads, _converted=converted)
    if not converted:
        raise _nothing_to_convert(input_path, to)
    raw['model_state_dict'] = weights.params_from_jax(weights.tree_family(tree), tree)
    raw.pop('optimizer_state_dict', None)
    raw.pop('opt_type', None)
    _write_payload(raw, output_path)
    return len(converted)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('input')
    ap.add_argument('output')
    ap.add_argument('--to', choices=['vpu', 'flax'], required=True)
    ap.add_argument('--num-heads', type=int, default=8,
                    help='needed for --to flax (dh = d_model / num_heads)')
    args = ap.parse_args(argv)
    n = convert_file(args.input, args.output, args.to, args.num_heads)
    print(f'wrote {args.output} ({args.to} attention, {n} blocks converted)')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
