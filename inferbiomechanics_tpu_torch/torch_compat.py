"""Convert reference PyTorch checkpoints into the port's format, and back.

The port's own copy of ``inferbiomechanics_tpu/torch_compat.py``, with the
port's state dicts as its targets. The reference saves
``torch.save({'epoch', 'model_state_dict', 'optimizer_state_dict'})`` as
``epoch_{e}_batch_{b}.pt``; the port writes ``epoch_{e}_batch_{b}.torch.pt``
(``train/checkpoint.py``). The two trainable reference models convert:

- the feedforward model's ``net.{i}`` Linears (a Sequential of, per layer,
  ``[Dropout?][BatchNorm?] Linear [activation]``), keyed by their order,
  become the port's ``layers.{j}``. Both store ``weight [out, in]``, so
  nothing is transposed; the reference's output head is grouped by
  component across frames (``x[:, 0:6F]`` the CoPs of every frame, then
  the forces, ...) where the port's is frame-major, so the last layer's
  output rows are permuted (:func:`output_permutation`). Reference
  BatchNorm checkpoints are refused.
- GroundLink's ``cnn.{3j+1}`` Conv1d and ``fc.{3j+2}`` Linear layers become
  ``convs.{j}``, ``fcs.{j}`` and, for the last (biasless) one, ``head``, in
  the same layouts; its head is frame-major on both sides.

The reverse direction (``export_*``, ``convert-checkpoint --to-torch``)
writes the port's checkpoints (or the JAX package's) as reference-format
``.pt`` files that the reference's own loader reads.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from inferbiomechanics_tpu_torch.train.checkpoint import _write_payload, read_payload
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
from inferbiomechanics_tpu_torch.train.run_config import save_partial_run_config

# reference head blocks: (flat-vector start multiplier, per-frame width)
# x[:, start*F : (start+width)*F].reshape(B, F, width)
_REF_HEAD_BLOCKS: List[Tuple[int, int]] = [
    (0, 6),     # groundContactCenterOfPressureInRootFrame
    (6, 6),     # groundContactForceInRootFrame
    (12, 6),    # groundContactTorqueInRootFrame
    (18, 12),   # groundContactWrenchesInRootFrame
]
_PER_FRAME = 30     # 2 contact bodies x (3*3 + 6)
_REF_NAME_RE = re.compile(r'epoch_(\d+)_batch_(\d+)\.pt$')


def output_permutation(num_output_frames: int) -> np.ndarray:
    """``perm`` with ``ours_flat[o] = ref_flat[perm[o]]``.

    ref:  block b starts at ``start_b * F``; within it index ``f*w_b + c``.
    ours: frame-major, ``f * 30 + start_b + c``.
    """
    F = num_output_frames
    perm = np.empty(_PER_FRAME * F, np.int64)
    for start, width in _REF_HEAD_BLOCKS:
        for f in range(F):
            for c in range(width):
                perm[f * _PER_FRAME + start + c] = start * F + f * width + c
    return perm


def _strip_ddp(sd: Dict) -> Dict[str, torch.Tensor]:
    return {re.sub(r'^module\.', '', k): torch.as_tensor(np.asarray(v)) if
            not isinstance(v, torch.Tensor) else v for k, v in sd.items()}


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).contiguous().clone()


def convert_state_dict(state_dict: Dict, num_output_frames: int) -> Dict[str, torch.Tensor]:
    """Reference ``net.{i}.weight/bias`` Linears -> the port's feedforward
    ``layers.{j}`` (head rows permuted to frame-major)."""
    sd = _strip_ddp(state_dict)
    blocked = [k for k in sd if '.running_mean' in k or '.running_var' in k]
    if blocked:
        raise ValueError(
            f'checkpoint carries BatchNorm state ({blocked[:2]}...); '
            'batchnorm checkpoints are not convertible — retrain with '
            '--batchnorm here')
    lin = sorted(int(m.group(1)) for k, v in sd.items()
                 if (m := re.match(r'net\.(\d+)\.weight$', k)) and v.ndim == 2)
    if not lin:
        raise ValueError('no net.{i}.weight Linear layers found — is this '
                         'a reference FeedForwardBaseline checkpoint?')
    out: Dict[str, torch.Tensor] = {}
    perm = torch.from_numpy(output_permutation(num_output_frames))
    for j, i in enumerate(lin):
        w, b = _f32(sd[f'net.{i}.weight']), _f32(sd[f'net.{i}.bias'])
        if j == len(lin) - 1:
            if w.shape[0] != perm.numel():
                raise ValueError(
                    f'final layer emits {w.shape[0]} outputs, expected '
                    f'{perm.numel()} (= 30 x {num_output_frames} output '
                    f'frames / 2 contact bodies)')
            w, b = w[perm].contiguous(), b[perm].contiguous()
        out[f'layers.{j}.weight'], out[f'layers.{j}.bias'] = w, b
    return out


def convert_groundlink_state_dict(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """Reference GroundLink ``cnn.{i}``/``fc.{i}`` -> the port's ``convs.{j}``,
    ``fcs.{j}`` and ``head`` (the same layouts)."""
    sd = _strip_ddp(state_dict)
    convs = sorted(int(m.group(1)) for k in sd if (m := re.match(r'cnn\.(\d+)\.weight$', k)))
    fcs = sorted(int(m.group(1)) for k in sd if (m := re.match(r'fc\.(\d+)\.weight$', k)))
    if not convs or not fcs:
        raise ValueError('no cnn.{i}/fc.{i} layers found — is this a '
                         'reference Groundlink checkpoint?')
    out: Dict[str, torch.Tensor] = {}
    for j, i in enumerate(convs):
        out[f'convs.{j}.weight'] = _f32(sd[f'cnn.{i}.weight'])
        out[f'convs.{j}.bias'] = _f32(sd[f'cnn.{i}.bias'])
    for j, i in enumerate(fcs):
        last = j == len(fcs) - 1
        if (f'fc.{i}.bias' in sd) == last:
            raise ValueError('every fc Linear but the last (the head) has a bias')
        prefix = 'head' if last else f'fcs.{j}'
        out[f'{prefix}.weight'] = _f32(sd[f'fc.{i}.weight'])
        if not last:
            out[f'{prefix}.bias'] = _f32(sd[f'fc.{i}.bias'])
    return out


def fresh_optimizer_state(named: Dict[str, torch.Tensor], opt_type: str,
                          learning_rate: float) -> Dict:
    """The port's ``opt_type`` optimizer's state before its first update
    over the parameters ``named``, keyed by name (``param_names``)."""
    params = [(n, torch.nn.Parameter(t.clone())) for n, t in named.items()]
    opt = make_optimizer(params, opt_type, learning_rate)
    opt._state_lists([p for _, p in params])      # the rule's initial values
    sd = opt.state_dict()
    sd['param_groups'][0]['param_names'] = list(opt.names)
    return sd


def convert_torch_checkpoint(pt_path: str, out_dir: str, opt_type: str = 'rmsprop',
                             learning_rate: float = 1e-4) -> str:
    """Convert one reference ``.pt`` into ``out_dir`` under the port's name
    (``epoch_{e}_batch_{b}.torch.pt``, or the stem: ``best.pt`` ->
    ``best.torch.pt``); returns the written path. The reference's optimizer
    state is not converted: a fresh ``opt_type`` state is embedded, as a
    warm restart, which ``train --opt-type`` of the same type resumes. A
    partial ``run_config.json`` records what the state dict reveals."""
    base = os.path.basename(pt_path)
    m = _REF_NAME_RE.search(base)
    if m:
        epoch, batch = int(m.group(1)), int(m.group(2))
        name = f'epoch_{epoch}_batch_{batch}.torch.pt'
    else:
        # keep the stem: mapping every other name to epoch_0_batch_0 would
        # overwrite earlier conversions in the same --out-dir
        epoch, batch = -1, 0
        name = os.path.splitext(base)[0] + '.torch.pt'
    blob = torch.load(pt_path, map_location='cpu', weights_only=True)
    sd = _strip_ddp(blob.get('model_state_dict', blob))
    if any(k.startswith('cnn.') for k in sd):
        model_sd = convert_groundlink_state_dict(sd)
        fields = {'model_type': 'groundlink'}
    else:
        widths = [v.shape[0] for k, v in sd.items()
                  if re.match(r'net\.\d+\.weight$', k) and v.ndim == 2]
        frames = widths[-1] // _PER_FRAME if widths else 1
        model_sd = convert_state_dict(sd, frames)
        fields = {'model_type': 'feedforward', 'hidden_dims': [int(w) for w in widths[:-1]],
                  'batchnorm': False}
        if frames > 1:
            # width 1 is ambiguous (last_frame, or all_frames with window ==
            # stride): only the unambiguous case is recorded
            fields['output_data_format'] = 'all_frames'
    out = _write_payload({'epoch': epoch, 'batch': batch, 'model_state_dict': model_sd,
                          'optimizer_state_dict': fresh_optimizer_state(
                              model_sd, opt_type, learning_rate),
                          'opt_type': opt_type, 'step': 0},
                         os.path.join(out_dir, name))
    save_partial_run_config(out_dir, fields)
    return out


# ---- the reverse direction: the port's checkpoints -> reference .pt ----

def _linear_index(j: int, dropout: bool, batchnorm: bool) -> int:
    """Sequential index of the j-th Linear in the reference feedforward
    ``net``: per layer ``[Dropout?][BatchNorm?] Linear [act if not last]``."""
    block = int(dropout) + int(batchnorm) + 2
    return j * block + int(dropout) + int(batchnorm)


def export_state_dict(state_dict: Dict[str, torch.Tensor], num_output_frames: int,
                      dropout: bool = False, batchnorm: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """The port's feedforward state dict -> reference ``net.{i}.weight/bias``
    (the inverse of :func:`convert_state_dict`)."""
    if batchnorm or any(k.startswith('norms.') for k in state_dict):
        raise ValueError('batchnorm models are not exportable (the port\'s flax-exact '
                         'BatchNorm has no reference torch-BatchNorm layout here)')
    layers = sorted(int(m.group(1)) for k in state_dict
                    if (m := re.fullmatch(r'layers\.(\d+)\.weight', k)))
    if not layers or layers != list(range(len(layers))):
        raise ValueError(f'expected layers.0..n, got {sorted(state_dict)[:6]} — is this '
                         f'a feedforward checkpoint?')
    inv = torch.from_numpy(np.argsort(output_permutation(num_output_frames)))
    out: Dict[str, torch.Tensor] = {}
    for j in layers:
        w, b = _f32(state_dict[f'layers.{j}.weight']), _f32(state_dict[f'layers.{j}.bias'])
        if j == layers[-1]:
            if w.shape[0] != inv.numel():
                raise ValueError(
                    f'final layer emits {w.shape[0]} outputs, expected '
                    f'{inv.numel()} (= 30 x {num_output_frames} output frames '
                    f'/ 2 contact bodies)')
            w, b = w[inv].contiguous(), b[inv].contiguous()
        i = _linear_index(j, dropout, batchnorm)
        out[f'net.{i}.weight'], out[f'net.{i}.bias'] = w, b
    return out


def export_groundlink_state_dict(state_dict: Dict[str, torch.Tensor]
                                 ) -> Dict[str, torch.Tensor]:
    """The port's GroundLink state dict -> reference ``cnn.{i}``/``fc.{i}``:
    Conv1d at ``cnn.{3j+1}`` (``[Dropout, Conv1d, ELU]`` blocks), Linear at
    ``fc.{3j+2}`` (after a parameter-free Transpose, ``[Dropout, Linear,
    ELU]`` blocks), the last without a bias."""
    convs = sorted(int(m.group(1)) for k in state_dict
                   if (m := re.fullmatch(r'convs\.(\d+)\.weight', k)))
    fcs = sorted(int(m.group(1)) for k in state_dict
                 if (m := re.fullmatch(r'fcs\.(\d+)\.weight', k)))
    if not convs or 'head.weight' not in state_dict:
        raise ValueError(f'expected convs.*/fcs.*/head, got {sorted(state_dict)[:6]} — '
                         f'is this a GroundLink checkpoint?')
    out: Dict[str, torch.Tensor] = {}
    for j in convs:
        out[f'cnn.{3 * j + 1}.weight'] = _f32(state_dict[f'convs.{j}.weight'])
        out[f'cnn.{3 * j + 1}.bias'] = _f32(state_dict[f'convs.{j}.bias'])
    for j in fcs:
        out[f'fc.{3 * j + 2}.weight'] = _f32(state_dict[f'fcs.{j}.weight'])
        out[f'fc.{3 * j + 2}.bias'] = _f32(state_dict[f'fcs.{j}.bias'])
    out[f'fc.{3 * len(fcs) + 2}.weight'] = _f32(state_dict['head.weight'])
    return out


def export_torch_checkpoint(ckpt_path: str, out_dir: str, dropout: bool = False,
                            batchnorm: bool = False) -> str:
    """Write one of the port's checkpoints (or the JAX package's) as a
    reference-format ``torch.save`` file (``{'epoch', 'model_state_dict'}``,
    bare key names) named from the source's stem (``best.torch.pt`` ->
    ``best.pt``); same-named sources from two directories are told apart by
    the directory's name. The optimizer's state is not exported. Returns
    the written path."""
    payload = read_payload(ckpt_path)
    sd = payload['model_state_dict']
    if any(k.startswith('convs.') for k in sd):
        out_sd = export_groundlink_state_dict(sd)
    elif any(k.startswith('layers.') for k in sd):
        last = max(int(m.group(1)) for k in sd
                   if (m := re.fullmatch(r'layers\.(\d+)\.weight', k)))
        width = sd[f'layers.{last}.weight'].shape[0]
        if width % _PER_FRAME:
            raise ValueError(f'final layer width {width} is not a multiple of '
                             f'{_PER_FRAME} — not a 2-contact-body feedforward head')
        out_sd = export_state_dict(sd, width // _PER_FRAME, dropout=dropout,
                                   batchnorm=batchnorm)
    else:
        raise ValueError(f'unrecognized state dict ({sorted(sd)[:4]}...): only '
                         f'feedforward and GroundLink export to the reference format')
    base = os.path.basename(ckpt_path)
    stem = base[:-len('.torch.pt')] if base.endswith('.torch.pt') else os.path.splitext(base)[0]
    name = stem + '.pt'
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, name)
    if os.path.exists(out):
        parent = os.path.basename(os.path.dirname(os.path.abspath(ckpt_path)))
        out = os.path.join(out_dir, f'{parent}_{name}' if parent else f'dup_{name}')
        if os.path.exists(out):
            raise ValueError(f'output {out} already exists — exports from '
                             f'{ckpt_path} would overwrite it')
    torch.save({'epoch': max(int(payload.get('epoch', 0)), 0), 'model_state_dict': out_sd}, out)
    return out
