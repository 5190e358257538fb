"""int8 weight and activation quantization for serving.

PyTorch counterpart of ``inferbiomechanics_tpu/ops/quant.py``, the forward
behind ``serve --quantize int8``, ``analyze --quantize int8`` and ``export
--quantize int8``. The same symmetric post-training scheme:

- weights: per-output-channel symmetric int8, ``w_q = round(w / s_w)`` with
  ``s_w[j] = max_i |w[i, j]| / 127`` (1 for an all-zero column), quantized
  once at load;
- activations: dynamic per-row symmetric int8, ``s_x[b] = max_j |x[b, j]| /
  127`` (1 for an all-zero row), at every call;
- products summed in int32, dequantized by the outer product ``s_x * s_w``
  and biased in float32, in the JAX package's order.

The int8 product is ``torch._int_mm``, on the card and on the CPU alike: the
JAX package leaves it to XLA (``lax.dot_general`` with an int32 result)
outside any Pallas kernel, so it is a library call here too. On CUDA that
call takes only more than 16 rows and inner and output widths that are
multiples of 8, so every product runs on operands padded with zeros (16
more rows, the widths rounded up to 8) and is sliced back; zeros add
nothing to an int32 sum, so the result is exact. The padding is the same on
every device and every batch, so an exported program carries no branch on
the batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from inferbiomechanics_tpu_torch.models.common import (
    ModelInput, pack_inputs, slice_output_heads,
)
from inferbiomechanics_tpu_torch.ops.fused_mlp import ACTIVATIONS

# torch._int_mm on CUDA: more than 16 rows, inner and output widths multiples of 8
_PAD_ROWS = 16
_WIDTH_UNIT = 8


@dataclass(frozen=True)
class QuantizedDense:
    """One Dense layer quantized: ``w_q`` int8 ``[in, out]``, ``s_w`` f32
    ``[out]``, the bias ``b`` f32 ``[out]``, and ``w_mm``, ``w_q`` padded
    with zeros to widths that are multiples of 8 for ``torch._int_mm``."""
    w_q: torch.Tensor
    s_w: torch.Tensor
    b: torch.Tensor
    w_mm: torch.Tensor


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: ``(w_q [in, out], s_w [out])``."""
    w = w.float()
    s_w = w.abs().amax(dim=0) / 127.0
    s_w = torch.where(s_w == 0, 1.0, s_w)       # all-zero column guard
    w_q = torch.clamp(torch.round(w / s_w), -127, 127).to(torch.int8)
    return w_q, s_w


def _pad_weight(w_q: torch.Tensor) -> torch.Tensor:
    k, n = w_q.shape
    return F.pad(w_q, (0, -n % _WIDTH_UNIT, 0, -k % _WIDTH_UNIT)).contiguous()


def _qdense(x: torch.Tensor, layer: QuantizedDense) -> torch.Tensor:
    s_x = x.abs().amax(dim=-1, keepdim=True) / 127.0
    s_x = torch.where(s_x == 0, 1.0, s_x)
    x_q = torch.clamp(torch.round(x / s_x), -127, 127).to(torch.int8)
    k_pad, n = layer.w_mm.shape[0], layer.w_q.shape[1]
    a = F.pad(x_q, (0, k_pad - x_q.shape[1], 0, _PAD_ROWS))
    acc = torch._int_mm(a, layer.w_mm)[:x.shape[0], :n]
    return acc.float() * (s_x * layer.s_w[None, :]) + layer.b


def qdense(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """``x [B, in] f32 -> [B, out] f32`` through an int8 product."""
    return _qdense(x.float(), QuantizedDense(w_q, s_w, b.float(), _pad_weight(w_q)))


def quantize_feedforward_params(params: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                                ) -> Tuple[QuantizedDense, ...]:
    """Quantize every Dense layer of a feedforward model, given in the JAX
    layout ``[(W [in, out], b [out]), ...]`` (``FeedForwardBaseline.
    layer_params()``), in layer order."""
    layers = []
    with torch.no_grad():
        for W, b in params:
            w_q, s_w = quantize_weight(W.detach())
            layers.append(QuantizedDense(w_q, s_w, b.detach().float(), _pad_weight(w_q)))
    return tuple(layers)


def quantized_feedforward_forward(model) -> Callable[[ModelInput], Dict[str, torch.Tensor]]:
    """``fn(x [B, T, C_in]) -> outputs dict``: the int8 forward of a
    ``FeedForwardBaseline`` (its eval semantics: no dropout, f32 head
    outputs), its weights quantized here, once, on the model's device.
    Batchnorm models are refused, in the JAX package's words."""
    if model.norms is not None:
        raise ValueError('--quantize int8 does not support batchnorm '
                         'checkpoints (stats folding not implemented)')
    layers = quantize_feedforward_params(model.layer_params())
    act = ACTIVATIONS[model.activation]

    def forward(inputs: ModelInput) -> Dict[str, torch.Tensor]:
        x = pack_inputs(inputs)
        x = x.reshape(x.shape[0], -1).float()
        for layer in layers[:-1]:
            x = act(_qdense(x, layer))
        out = _qdense(x, layers[-1])
        return slice_output_heads(out, model.num_contact_bodies, model.num_output_frames)

    return forward


__all__ = ['QuantizedDense', 'qdense', 'quantize_feedforward_params', 'quantize_weight',
           'quantized_feedforward_forward']
