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
- ``batchnorm`` adds a flax-exact BatchNorm (``models/norm.py``,
  ``norms.{i}``) before each Dense layer ``layers.{i}``, the head's too;
  ``dropout`` adds flax's dropout at ``dropout_prob`` before each of them,
  ahead of the BatchNorm, as the JAX model orders them. Keep masks come from
  ``dropout_masks`` (``models.common.generator_masks`` of a generator the
  train loop seeds; torch's default generator when it is None).
- The eval forward runs the fused MLP kernel (``ops/fused_mlp.py``) on
  weights packed once per ``eval()`` or load; it is the same function as the
  JAX model's ``use_pallas`` eval path and, to bf16 rounding, its Dense
  path. At eval dropout is the identity and each BatchNorm an affine map,
  folded into the packed weights of the Dense layer after it
  (``pack_mlp_params``' ``norms``).
- The training forward is the kernel's plain version, which autograd
  differentiates; with batchnorm or dropout it is the JAX model's Dense
  path instead, layer by layer in bf16 (a bf16 product, a bf16 bias add, the
  activation on bf16), which the plain version cannot host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from inferbiomechanics_tpu_torch.data.dataset import input_layout
from inferbiomechanics_tpu_torch.models.common import (
    MaskSource, ModelInput, dropout, generator_masks, init_linear, output_head_size,
    pack_inputs, slice_output_heads,
)
from inferbiomechanics_tpu_torch.models.norm import BatchNorm
from inferbiomechanics_tpu_torch.ops.fused_mlp import (
    ACTIVATIONS, PackedMLP, fused_mlp_forward, mlp_reference, pack_mlp_params,
)

_COMPUTE = torch.bfloat16      # the JAX model's compute dtype


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
        self.norms = (nn.ModuleList(BatchNorm(d, device=device) for d in dims[:-1])
                      if batchnorm else None)
        self.dropout_prob = float(dropout_prob) if dropout else 0.0
        self.dropout_masks: Optional[MaskSource] = None
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
        """The kernel's packed weights, made once after each train() or load;
        each BatchNorm's eval affine map folded into the layer after it."""
        device = self.layers[0].weight.device
        if self._packed is None or self._packed.device != device:
            with torch.no_grad():
                norms = (None if self.norms is None
                         else [norm.affine() for norm in self.norms])
                self._packed = pack_mlp_params(
                    [(W.detach(), b.detach()) for W, b in self.layer_params()],
                    device, norms=norms)
        return self._packed

    def _dense_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX model's Dense path in training, in bf16: before each Dense
        its dropout, then its BatchNorm; the activation after every Dense but
        the head. Returns the head [B, out] in float32."""
        act = ACTIVATIONS[self.activation]
        masks = self.dropout_masks or generator_masks()
        h = x.to(_COMPUTE)
        for i, layer in enumerate(self.layers):
            h = dropout(h, self.dropout_prob, masks)
            if self.norms is not None:
                h = self.norms[i](h)
            h = h @ layer.weight.to(_COMPUTE).t() + layer.bias.to(_COMPUTE)
            if i < len(self.layers) - 1:
                h = act(h)
        return h.float()

    def forward(self, inputs: ModelInput):
        x = pack_inputs(inputs)
        if x.ndim != 3:
            raise ValueError(f'expected (B, T, C), got {tuple(x.shape)}')
        x = x.reshape(x.shape[0], -1).float().contiguous()
        if not self.training:
            out = fused_mlp_forward(x, self.packed(), self.activation)
        elif self.norms is not None or self.dropout_prob > 0:
            out = self._dense_forward(x)
        else:
            out = mlp_reference(x, self.layer_params(), self.activation)
        return slice_output_heads(out, self.num_contact_bodies,
                                  self.num_output_frames)
