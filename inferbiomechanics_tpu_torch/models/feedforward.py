"""Feedforward MLP baseline.

PyTorch counterpart of ``inferbiomechanics_tpu/models/feedforward.py``: an
MLP over the flattened window of all 10 input streams, emitting the 4
contact output groups per output frame.

- Layers are ``nn.Linear`` (``layers.{i}``), with the JAX model's
  ``hidden_dims`` and ``activation``.
- ``init_style='torch'`` (the default) is torch's own Linear init, kernel
  and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)), which the JAX model's
  'torch' style reproduces; 'lecun' is flax's lecun-normal/zeros. Draws
  come from the ``generator`` the caller passes, on the CPU, so a seed gives
  the same weights on every device.
- The eval forward runs the fused MLP kernel (``ops/fused_mlp.py``) on
  weights packed once per ``eval()``; it is the same function as the JAX
  model's ``use_pallas`` eval path and, to bf16 rounding, its Dense path.
  The training forward is the kernel's plain version, which autograd
  differentiates.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from inferbiomechanics_tpu_torch.data.dataset import input_layout
from inferbiomechanics_tpu_torch.models.common import (
    ModelInput, init_linear, output_head_size, pack_inputs, slice_output_heads,
)
from inferbiomechanics_tpu_torch.ops.fused_mlp import (
    ACTIVATIONS, PackedMLP, fused_mlp_forward, mlp_reference, pack_mlp_params,
)

_TRAINING_SLICE = 'ROADMAP.md Queue 1 item 2 (feedforward training)'


class FeedForwardBaseline(nn.Module):
    def __init__(self, num_dofs: int, num_contact_bodies: int,
                 history_len: int, stride: int, root_history_len: int,
                 output_data_format: str = 'last_frame',
                 activation: str = 'sigmoid',
                 hidden_dims: Sequence[int] = (512, 512),
                 batchnorm: bool = False, dropout: bool = False,
                 dropout_prob: float = 0.0, init_style: str = 'torch', *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        if batchnorm or dropout:
            raise NotImplementedError(
                f'feedforward batchnorm/dropout are not ported yet; they come '
                f'with {_TRAINING_SLICE}')
        if activation not in ACTIVATIONS:
            raise ValueError(f'unknown activation {activation!r}; expected '
                             f'one of {sorted(ACTIVATIONS)}')
        self.activation = activation
        self.num_contact_bodies = num_contact_bodies
        num_frames = history_len // stride
        self.num_output_frames = (num_frames if output_data_format == 'all_frames'
                                  else 1)
        channels = sum(w for _, w in input_layout(num_dofs, root_history_len))
        dims = [num_frames * channels, *hidden_dims,
                output_head_size(num_contact_bodies, self.num_output_frames)]
        device = 'cpu' if device is None else device
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, d0, d1, device=device)
            for d0, d1 in zip(dims[:-1], dims[1:]))
        for layer in self.layers:
            init_linear(layer, init_style, generator)
        self._packed: Optional[PackedMLP] = None
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module._drop_packed())

    def _drop_packed(self) -> None:
        self._packed = None

    def train(self, mode: bool = True):
        if mode:    # training changes the weights; eval() keeps what is packed
            self._drop_packed()
        return super().train(mode)

    def layer_params(self):
        """[(W [in, out], b [out]), ...]: the JAX layout ops/fused_mlp.py takes."""
        return [(layer.weight.t(), layer.bias) for layer in self.layers]

    def packed(self) -> PackedMLP:
        """The kernel's packed weights, made once after each train() or load."""
        device = self.layers[0].weight.device
        if self._packed is None or self._packed.device != device:
            with torch.no_grad():
                self._packed = pack_mlp_params(
                    [(W.detach(), b.detach()) for W, b in self.layer_params()],
                    device)
        return self._packed

    def forward(self, inputs: ModelInput):
        x = pack_inputs(inputs)
        if x.ndim != 3:
            raise ValueError(f'expected (B, T, C), got {tuple(x.shape)}')
        x = x.reshape(x.shape[0], -1).float().contiguous()
        if self.training:
            out = mlp_reference(x, self.layer_params(), self.activation)
        else:
            out = fused_mlp_forward(x, self.packed(), self.activation)
        return slice_output_heads(out, self.num_contact_bodies,
                                  self.num_output_frames)
