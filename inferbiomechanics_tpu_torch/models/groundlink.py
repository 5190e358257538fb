"""GroundLink temporal-CNN regressor.

PyTorch counterpart of ``inferbiomechanics_tpu/models/groundlink.py``: a 1-D
temporal conv stack (channels [C_in, 128, 128, 256, 256], kernel 7,
replicate padding, ELU) followed by an MLP head per frame (``fc_depth`` 3:
two hidden layers with ELU, then a bias-free head) emitting the 4 contact
output groups; ``last_frame`` runs the head on the final frame only.

- Parameters live in ``nn.Conv1d`` (``convs.{i}``, weight ``[C_out, C_in,
  k]``) and ``nn.Linear`` (``fcs.{j}``, and ``head`` without a bias).
- Init as the JAX module: xavier with gain sqrt(2) for the convs and the
  hidden layers, drawn like flax's ``variance_scaling(2.0, 'fan_avg',
  'truncated_normal')`` from a normal truncated at two standard deviations
  and rescaled to the variance 2 / fan_avg, with zero biases; torch's own
  Linear init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), for the head. The
  variances match the JAX module's; the draws cannot match across
  frameworks. They come from the ``generator`` the caller passes, on the
  CPU, so a seed gives the same weights on every device.
- The eval forward runs the fused GroundLink kernel
  (``ops/fused_groundlink.py``) on weights packed once per ``eval()`` or
  load. The training forward is plain PyTorch under autograd, computed as
  the flax module computes it: bf16 operands, replicate ``F.pad`` and
  ``F.conv1d``, bias added after the product, ELU, with dropout where the
  flax model has it: ``cnn_dropout`` before each conv, ``fc_dropout`` before
  each hidden Dense and before the head, scaled by 1 / (1 - p). Its keep
  masks come from ``dropout_masks`` (``models.common.generator_masks`` of a
  generator the train loop seeds; torch's default generator when it is
  None). Eval ignores dropout.
- ``conv_impl`` picks the training forward's conv lowering, as in the JAX
  package; both share one parameter tree, so either loads the other's
  checkpoints. ``'xla'`` (the default) is the direct conv above;
  ``'banded'`` computes each k-tap conv over the T frames as one bf16
  product ``[B, T C_in] @ W_big [T C_in, T C_out]``, ``W_big`` built in
  bf16 from the conv kernel with :func:`band_selector` (replicate padding
  folds into the band edges), plus the bias tiled T times. The eval forward
  is K4 for both.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from inferbiomechanics_tpu_torch.data.dataset import input_layout
from inferbiomechanics_tpu_torch.models.common import (
    MaskSource, ModelInput, dropout, generator_masks, output_head_size, pack_inputs,
    slice_output_heads,
)
from inferbiomechanics_tpu_torch.ops.fused_groundlink import (
    PackedGroundlink, fused_groundlink_forward, pack_groundlink_params,
)

# the flax module's compute dtype
_COMPUTE = torch.bfloat16
CONV_IMPLS = ('xla', 'banded')
# a unit normal truncated at +-2 has this standard deviation (flax divides by
# it so that the truncated draw keeps the variance asked for)
_TRUNC_STD = 0.87962566103423978


def band_selector(T: int, k: int) -> np.ndarray:
    """[k, T, T] 0/1 constant (the JAX package's ``_band_selector``):
    S[d, t, u] == 1 iff output frame u's d-th tap reads input frame t under
    replicate padding, i.e. t == clip(u + d - k//2, 0, T-1)."""
    half = k // 2
    S = np.zeros((k, T, T), np.float32)
    u = np.arange(T)
    for d in range(k):
        S[d, np.clip(u + d - half, 0, T - 1), u] = 1.0
    return S


# band_selector's constants on a device, by (T, k, device)
_SELECTORS: Dict[tuple, torch.Tensor] = {}


def banded_conv(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The JAX ``BandedConv`` in bf16: ``h`` [B, T, C_in] -> [B, T, C_out]
    through one product with the block-banded ``W_big[(t, ci), (u, co)] =
    sum_d S[d, t, u] kernel[d, ci, co]`` (``weight`` is ``nn.Conv1d``'s
    ``[C_out, C_in, k]``)."""
    b, t, c_in = h.shape
    c_out, _, k = weight.shape
    key = (t, k, h.device)
    if key not in _SELECTORS:     # made by an eager step, before any capture
        _SELECTORS[key] = torch.from_numpy(band_selector(t, k)).to(h.device, _COMPUTE)
    sel = _SELECTORS[key]
    kernel = weight.permute(2, 1, 0).to(_COMPUTE)                   # [k, C_in, C_out]
    w_big = torch.einsum('dtu,dio->tiuo', sel, kernel).reshape(t * c_in, t * c_out)
    y = h.to(_COMPUTE).reshape(b, t * c_in) @ w_big + bias.to(_COMPUTE).repeat(t)
    return y.reshape(b, t, c_out)


def _xavier_relu_(weight: torch.Tensor, fan_in: int, fan_out: int,
                  generator: Optional[torch.Generator]) -> None:
    std = math.sqrt(2.0 / ((fan_in + fan_out) / 2.0)) / _TRUNC_STD
    w = torch.empty(weight.shape)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    with torch.no_grad():
        weight.copy_(w)


class Groundlink(nn.Module):
    def __init__(self, num_dofs: int, num_contact_bodies: int,
                 root_history_len: int,
                 output_data_format: str = 'all_frames',
                 cnn_kernel: int = 7,
                 cnn_features: Sequence[int] = (128, 128, 256, 256),
                 cnn_dropout: float = 0.0, fc_depth: int = 3,
                 fc_dropout: float = 0.2, conv_impl: str = 'xla', *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f'conv_impl must be one of {CONV_IMPLS}, got {conv_impl!r}')
        if cnn_kernel % 2 != 1:
            raise ValueError(f'cnn_kernel must be odd, got {cnn_kernel}')
        if fc_depth < 1 or not cnn_features:
            raise ValueError('Groundlink needs at least one conv and fc_depth >= 1')
        if not (0.0 <= cnn_dropout <= 1.0 and 0.0 <= fc_dropout <= 1.0):
            raise ValueError(f'dropout rates must lie in [0, 1], got cnn_dropout '
                             f'{cnn_dropout}, fc_dropout {fc_dropout}')
        self.num_contact_bodies = num_contact_bodies
        self.output_data_format = output_data_format
        self.cnn_dropout, self.fc_dropout = float(cnn_dropout), float(fc_dropout)
        self.fc_depth = fc_depth
        self.conv_impl = conv_impl
        device = 'cpu' if device is None else device
        channels = sum(w for _, w in input_layout(num_dofs, root_history_len))
        dims = [channels, *cnn_features]
        self.convs = nn.ModuleList(
            nn.utils.skip_init(nn.Conv1d, c0, c1, cnn_kernel, device=device)
            for c0, c1 in zip(dims[:-1], dims[1:]))
        width = dims[-1]
        self.fcs = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, width, width, device=device)
            for _ in range(fc_depth - 1))
        self.head = nn.utils.skip_init(
            nn.Linear, width, output_head_size(num_contact_bodies, 1),
            bias=False, device=device)
        for conv in self.convs:
            _xavier_relu_(conv.weight, cnn_kernel * conv.in_channels,
                          cnn_kernel * conv.out_channels, generator)
        for fc in self.fcs:
            _xavier_relu_(fc.weight, width, width, generator)
        k = 1.0 / math.sqrt(width)
        with torch.no_grad():
            for layer in (*self.convs, *self.fcs):
                layer.bias.zero_()
            self.head.weight.copy_(
                torch.empty(self.head.weight.shape).uniform_(-k, k, generator=generator))
        self.dropout_masks: Optional[MaskSource] = None
        self._packed: Optional[PackedGroundlink] = None
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module._drop_packed())

    def _drop_packed(self) -> None:
        self._packed = None

    def train(self, mode: bool = True):
        if mode:    # training changes the weights; eval() keeps what is packed
            self._drop_packed()
        return super().train(mode)

    def layer_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The flax tree ops/fused_groundlink.py takes: ``Conv_{i}`` kernels
        ``[k, C_in, C_out]``, ``Dense_{j}`` kernels ``[in, out]``, the last
        Dense (the head) without a bias."""
        tree = {f'Conv_{i}': {'kernel': conv.weight.permute(2, 1, 0), 'bias': conv.bias}
                for i, conv in enumerate(self.convs)}
        for j, fc in enumerate(self.fcs):
            tree[f'Dense_{j}'] = {'kernel': fc.weight.t(), 'bias': fc.bias}
        tree[f'Dense_{self.fc_depth - 1}'] = {'kernel': self.head.weight.t()}
        return tree

    def packed(self) -> PackedGroundlink:
        """The kernel's packed weights, made once after each train() or load."""
        device = self.head.weight.device
        if self._packed is None or self._packed.device != device:
            with torch.no_grad():
                self._packed = pack_groundlink_params(
                    {name: {k: v.detach() for k, v in p.items()}
                     for name, p in self.layer_params().items()}, device)
        return self._packed

    def _drop(self, h: torch.Tensor, kind: str) -> torch.Tensor:
        """Dropout before a conv (``kind`` 'conv') or a Dense ('fc')."""
        p = self.cnn_dropout if kind == 'conv' else self.fc_dropout
        return dropout(h, p, self.dropout_masks or generator_masks())

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The flax module's forward in its compute dtype (bf16) under
        autograd: before each conv its dropout, replicate padding, the conv
        and ELU; then on the last frame or on every frame, before each Dense
        its dropout, the hidden Dense layers with ELU and the bias-free head.
        Returns the head vector [B, frames, 30] in float32."""
        drop = self._drop
        h = x.to(_COMPUTE)
        for conv in self.convs:
            if self.conv_impl == 'banded':
                h = F.elu(banded_conv(drop(h, 'conv'), conv.weight, conv.bias))
                continue
            h = drop(h, 'conv').transpose(1, 2)                      # [B, C, T]
            half = conv.kernel_size[0] // 2
            h = F.conv1d(F.pad(h, (half, half), mode='replicate'), conv.weight.to(_COMPUTE))
            h = F.elu(h.transpose(1, 2) + conv.bias.to(_COMPUTE))     # [B, T, C]
        if self.output_data_format != 'all_frames':
            h = h[:, -1:, :]
        for fc in self.fcs:
            h = F.elu(F.linear(drop(h, 'fc'), fc.weight.to(_COMPUTE)) + fc.bias.to(_COMPUTE))
        return F.linear(drop(h, 'fc'), self.head.weight.to(_COMPUTE)).float()

    def forward(self, inputs: ModelInput):
        x = pack_inputs(inputs)
        if x.ndim != 3:
            raise ValueError(f'expected (B, T, C), got {tuple(x.shape)}')
        x = x.float().contiguous()
        if self.training:
            out = self._train_forward(x)
        else:
            out = fused_groundlink_forward(x, self.packed(), self.output_data_format)
        return slice_output_heads(out, self.num_contact_bodies, out.shape[1])
