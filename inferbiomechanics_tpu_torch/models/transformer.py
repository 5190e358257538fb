"""Transformer sequence regressor.

PyTorch counterpart of ``inferbiomechanics_tpu/models/transformer.py``: a
pre-LN transformer encoder over the window's frames with a learned temporal
embedding, emitting the 4 contact output groups per frame (or for the last
frame only) plus the auxiliary tau / COM-acceleration / contact heads.

With ``attn_impl='vpu'`` the modules hold the JAX model's ``vpu``
parameter tree (``weights.py`` maps the names) and there are two forwards
over it:

- ``TransformerRegressor.forward``: the ``vpu`` math in plain PyTorch, bf16
  compute with a bf16 residual stream, as ``model.apply`` runs it;
- :func:`fused_transformer_forward`: inference through the fused encoder
  layer kernel (``ops/fused_encoder.py``), one launch per layer, with an f32
  residual stream inside the encoder. The two differ at bf16-residual level
  by design.

With ``attn_impl='pallas'`` the encoder is the JAX model's flat
``enc{i}_{name}`` tree instead: 12 parameters a layer in
``fused_encoder.PARAM_NAMES`` order, kernels stored ``[in, out]`` as the
JAX package stores them (so the per-step packing for the kernels needs no
transpose). Its one forward, in training and in evaluation, runs every
layer through ``FusedEncoderLayerFn`` on an f32 residual stream: the
encoder layer kernel forward and the backward kernels on a CUDA tensor,
their plain versions on a CPU tensor. The kernels read bf16 weights in
mma fragment order, so the layers are packed again whenever a parameter
has changed (once a train step; once per load when serving).

With ``attn_impl='flax'`` the blocks hold the JAX model's
``MultiHeadDotProductAttention_0`` tree (:class:`FlaxAttention`: the
``query`` / ``key`` / ``value`` / ``out`` ``DenseGeneral`` parameters in
flax's shapes) and compute what flax 0.12 computes: q divided by sqrt(dh)
in bf16 before the logits, the softmax on the bf16 logits. Its one forward
is the plain bf16 one, in training and in evaluation, as in the JAX
package, which fuses only the ``vpu`` tree (serving with
``--fused-inference`` warns and takes the plain forward).

Dropout (the ``vpu`` and ``flax`` trees; the fused layer takes none, as in
the JAX package): at ``dropout`` in training, in each encoder block where the
JAX ``EncoderBlock`` places it: ``vpu``, after the attention's projection
and after the GELU; ``flax``, on the attention weights (one ``[1, 1, T, T]``
keep mask shared by the batch and the heads, flax's ``broadcast_dropout``)
and after the GELU. Keep masks come from ``dropout_masks``
(``models.common.generator_masks`` of a generator the train loop seeds;
torch's default generator when it is None). Both eval forwards ignore it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from inferbiomechanics_tpu_torch.data import keys as K
from inferbiomechanics_tpu_torch.data.dataset import input_layout
from inferbiomechanics_tpu_torch.models.common import (
    MaskSource, ModelInput, dropout, generator_masks, init_linear, lecun_normal_,
    output_head_size, pack_inputs, slice_output_heads,
)
from inferbiomechanics_tpu_torch.ops.fused_encoder import (
    LN_EPS, PARAM_NAMES, FusedEncoderLayerFn, PackedEncoderLayer,
    encoder_layer_reference, fused_encoder_layer, init_encoder_params,
    pack_encoder_params,
)

_DT = torch.bfloat16      # the compute dtype of both forwards
ATTN_IMPLS = ('vpu', 'flax', 'pallas')


def _bf16(v: float) -> float:
    """``v`` rounded to bf16, as a Python number: a bf16 tensor divided by
    it rounds as a division by a bf16 scalar (and it is a constant inside a
    captured step, where a scalar tensor on the device would be a copy)."""
    return float(torch.tensor(v, dtype=_DT))


def _dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """flax ``Dense(dtype=bf16)``: a bf16 product, then a bf16 bias add."""
    return x.to(_DT) @ layer.weight.to(_DT).t() + layer.bias.to(_DT)


def _layernorm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``LayerNorm(dtype=bf16)``: statistics and affine in f32, the
    result rounded to bf16."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(_DT)


class ShortWindowAttention(nn.Module):
    """Multi-head self-attention over a short window (T around 10): scores
    and the value mix as broadcast-multiply + reduce, in bf16 with an f32
    softmax. The ``3 d`` columns of ``qkv`` are ``[q | k | v]``, each
    ``[H, dh]``."""

    def __init__(self, d_model: int, num_heads: int, *, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.utils.skip_init(nn.Linear, d_model, 3 * d_model, device=device)
        self.proj = nn.utils.skip_init(nn.Linear, d_model, d_model, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        dh = d // self.num_heads
        qkv = _dense(x, self.qkv).reshape(b, t, 3, self.num_heads, dh)
        q = qkv[:, :, 0] * (dh ** -0.5)                     # [B, T, H, dh]
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        scores = (q[:, :, None] * k[:, None, :]).sum(-1)    # [B, Tq, Tk, H]
        probs = torch.softmax(scores.float(), dim=2).to(_DT)
        out = (probs[..., None] * v[:, None]).sum(2)        # [B, Tq, H, dh]
        return _dense(out.reshape(b, t, d), self.proj)


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral``'s parameters in flax's shapes: ``kernel``
    ``[*in_shape, *out_shape]`` and ``bias`` ``out_shape``; the product
    contracts the input's trailing ``len(in_shape)`` axes, in bf16, then
    adds the bias in bf16."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...], *,
                 device=None):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.kernel = nn.Parameter(torch.empty(*in_shape, *out_shape, device=device))
        self.bias = nn.Parameter(torch.zeros(*out_shape, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = math.prod(self.in_shape)
        lead = x.shape[:x.ndim - len(self.in_shape)]
        w = self.kernel.to(_DT).reshape(n_in, -1)
        y = x.to(_DT).reshape(*lead, n_in) @ w + self.bias.to(_DT).reshape(-1)
        return y.reshape(*lead, *self.out_shape)


class FlaxAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (0.12) as the JAX
    ``EncoderBlock`` builds it with ``attn_impl='flax'``: self-attention in
    bf16, q divided by sqrt(dh) in bf16 before the logits, the softmax on
    the bf16 logits (``force_fp32_for_softmax=False``), dropout on the
    attention weights with one ``[1, 1, T, T]`` keep mask for the batch and
    the heads (``broadcast_dropout=True``), each kept weight times
    ``bf16(1) / bf16(1 - p)``; no dropout after the output projection."""

    def __init__(self, d_model: int, num_heads: int, *, device=None):
        super().__init__()
        self.num_heads = num_heads
        dh = d_model // num_heads
        self.query = DenseGeneral((d_model,), (num_heads, dh), device=device)
        self.key = DenseGeneral((d_model,), (num_heads, dh), device=device)
        self.value = DenseGeneral((d_model,), (num_heads, dh), device=device)
        self.out = DenseGeneral((num_heads, dh), (d_model,), device=device)

    def forward(self, x: torch.Tensor, p: float = 0.0,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)      # [B, T, H, dh]
        dh = q.shape[-1]
        q = q / _bf16(math.sqrt(dh))
        logits = torch.einsum('bqhd,bkhd->bhqk', q, k)
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        w = e / e.sum(-1, keepdim=True)
        if p > 0.0 and masks is not None:
            t = w.shape[-1]
            keep = masks((1, 1, t, t), p, w.device, shared=True)
            w = w * (keep.to(_DT) / _bf16(1.0 - p))
        return self.out(torch.einsum('bhqk,bkhd->bqhd', w, v))

    def init_params(self, generator: Optional[torch.Generator]) -> None:
        """flax's defaults: lecun-normal kernels (fan-in the contracted
        axes), zero biases."""
        for dense in (self.query, self.key, self.value, self.out):
            w = lecun_normal_(torch.empty(dense.kernel.shape), math.prod(dense.in_shape),
                              generator)
            with torch.no_grad():
                dense.kernel.copy_(w)
                dense.bias.zero_()


class EncoderBlock(nn.Module):
    """The JAX ``EncoderBlock`` on the ``vpu`` tree (:class:`ShortWindowAttention`)
    or, with ``attn_impl='flax'``, on the flax tree (:class:`FlaxAttention`);
    ``dropout`` (the transformer's rate; the diffusion denoiser keeps 0, as
    in JAX) applies when ``forward`` is given ``masks`` (a
    :data:`MaskSource`)."""

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: int = 4,
                 dropout: float = 0.0, attn_impl: str = 'vpu', *, device=None):
        super().__init__()
        self.dropout = float(dropout)
        self.attn_impl = attn_impl
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.attn = (FlaxAttention(d_model, num_heads, device=device) if attn_impl == 'flax'
                     else ShortWindowAttention(d_model, num_heads, device=device))
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.mlp1 = nn.utils.skip_init(nn.Linear, d_model, d_model * mlp_ratio,
                                       device=device)
        self.mlp2 = nn.utils.skip_init(nn.Linear, d_model * mlp_ratio, d_model,
                                       device=device)

    def forward(self, x: torch.Tensor, masks: Optional[MaskSource] = None) -> torch.Tensor:
        p = self.dropout if masks is not None else 0.0
        if self.attn_impl == 'flax':
            x = x + self.attn(_layernorm(x, self.ln1), p, masks)
        else:
            x = x + dropout(self.attn(_layernorm(x, self.ln1)), p, masks)
        y = F.gelu(_dense(_layernorm(x, self.ln2), self.mlp1), approximate='tanh')
        return x + _dense(dropout(y, p, masks), self.mlp2)

    def layer_params(self) -> Tuple[torch.Tensor, ...]:
        """The flat tuple ``ops/fused_encoder.py`` takes (``PARAM_NAMES``
        order, kernels ``[in, out]``); the ``vpu`` tree's only."""
        if self.attn_impl != 'vpu':
            raise ValueError(f"the fused encoder layer takes the 'vpu' tree, not "
                             f"attn_impl={self.attn_impl!r}")
        return (self.ln1.weight, self.ln1.bias,
                self.attn.qkv.weight.t(), self.attn.qkv.bias,
                self.attn.proj.weight.t(), self.attn.proj.bias,
                self.ln2.weight, self.ln2.bias,
                self.mlp1.weight.t(), self.mlp1.bias,
                self.mlp2.weight.t(), self.mlp2.bias)


@dataclass(frozen=True)
class PackedTransformer:
    """What :func:`fused_transformer_forward` reads, made once per load:
    every encoder layer packed for the kernel, and bf16 copies of the
    weights around it (``[in, out]`` kernels, biases, the temporal
    embedding); the final LayerNorm stays f32."""
    layers: Tuple[PackedEncoderLayer, ...]
    dense: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    temporal_embedding: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.temporal_embedding.device


class TransformerRegressor(nn.Module):
    HEADS = ('contact_head', 'tau_head', 'com_acc_head', 'contact_cls_head')

    def __init__(self, num_dofs: int, num_contact_bodies: int,
                 history_len: int, stride: int, root_history_len: int,
                 output_data_format: str = 'last_frame', d_model: int = 256,
                 num_layers: int = 4, num_heads: int = 8, mlp_ratio: int = 4,
                 dropout: float = 0.0, predict_tau: bool = True,
                 predict_com_acc: bool = True, predict_contact: bool = True,
                 attn_impl: str = 'vpu', *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f'attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}')
        if dropout and attn_impl == 'pallas':
            raise ValueError('the fused encoder layer (attn_impl=\'pallas\') '
                             'does not support dropout')
        if not 0.0 <= dropout <= 1.0:
            raise ValueError(f'dropout must lie in [0, 1], got {dropout}')
        if d_model % num_heads:
            raise ValueError(f'd_model {d_model} does not divide into '
                             f'{num_heads} heads')
        self.num_dofs = num_dofs
        self.num_contact_bodies = num_contact_bodies
        self.num_frames = history_len // stride
        self.output_data_format = output_data_format
        self.num_output_frames = (self.num_frames
                                  if output_data_format == 'all_frames' else 1)
        self.d_model, self.num_layers, self.num_heads = d_model, num_layers, num_heads
        self.attn_impl = attn_impl
        device = 'cpu' if device is None else device
        channels = sum(w for _, w in input_layout(num_dofs, root_history_len))

        def linear(d_in: int, d_out: int) -> nn.Linear:
            return nn.utils.skip_init(nn.Linear, d_in, d_out, device=device)

        self.input_proj = linear(channels, d_model)
        self.temporal_embedding = nn.Parameter(
            torch.empty(self.num_frames, d_model, device=device))
        self.dropout = float(dropout)
        self.dropout_masks: Optional[MaskSource] = None
        self.blocks = nn.ModuleList(
            EncoderBlock(d_model, num_heads, mlp_ratio, self.dropout, attn_impl,
                         device=device)
            for _ in range(num_layers if attn_impl != 'pallas' else 0))
        self.final_ln = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.contact_head = linear(d_model, output_head_size(num_contact_bodies, 1))
        self.tau_head = linear(d_model, num_dofs) if predict_tau else None
        self.com_acc_head = linear(d_model, 3) if predict_com_acc else None
        self.contact_cls_head = (linear(d_model, num_contact_bodies)
                                 if predict_contact else None)
        # flax's defaults, drawn on the CPU so that a seed gives the same
        # weights on every device: lecun-normal kernels, zero biases,
        # N(0, 0.02) temporal embedding (LayerNorm is ones / zeros already)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                init_linear(module, 'lecun', generator)
            elif isinstance(module, FlaxAttention):
                module.init_params(generator)
        with torch.no_grad():
            self.temporal_embedding.copy_(
                torch.randn(self.num_frames, d_model, generator=generator) * 0.02)
        if attn_impl == 'pallas':
            # the flat enc{i}_* tree: lecun-normal kernels [in, out], unit
            # LayerNorm scales, zero biases
            for i in range(num_layers):
                for name, p in zip(PARAM_NAMES, init_encoder_params(
                        generator, d_model, mlp_ratio)):
                    self.register_parameter(f'enc{i}_{name}',
                                            nn.Parameter(p.to(device)))
        self._packed: Optional[PackedTransformer] = None
        self._packed_layers = None      # (key, layers) of the pallas tree
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module._drop_packed())

    def _drop_packed(self) -> None:
        self._packed = None
        self._packed_layers = None

    def layer_params(self, i: int) -> Tuple[torch.Tensor, ...]:
        """Layer ``i``'s parameters as the flat tuple ``ops/fused_encoder.py``
        takes (``PARAM_NAMES`` order, kernels ``[in, out]``)."""
        if self.attn_impl == 'pallas':
            return tuple(getattr(self, f'enc{i}_{name}') for name in PARAM_NAMES)
        return self.blocks[i].layer_params()

    def packed_layers(self, transposes: bool) -> Tuple[PackedEncoderLayer, ...]:
        """The ``pallas`` tree's layers packed for the kernels (with the
        transposed weights the backward reads when ``transposes``); packed
        again only when a parameter has changed since, or has moved."""
        params = [self.layer_params(i) for i in range(self.num_layers)]
        key = (transposes, params[0][0].device,
               tuple(p._version for layer in params for p in layer))
        if self._packed_layers is None or self._packed_layers[0] != key:
            with torch.no_grad():
                self._packed_layers = (key, tuple(
                    pack_encoder_params(layer, layer[0].device,
                                        transposes=transposes)
                    for layer in params))
        return self._packed_layers[1]

    def train(self, mode: bool = True):
        if mode:    # training changes the weights; eval() keeps what is packed
            self._drop_packed()
        return super().train(mode)

    def _heads(self):
        return [(name, getattr(self, name)) for name in self.HEADS
                if getattr(self, name) is not None]

    def packed(self) -> PackedTransformer:
        """The fused forward's weights, made once after each train() or load."""
        device = self.temporal_embedding.device
        if self._packed is None or self._packed.device != device:
            with torch.no_grad():
                dense = {name: (layer.weight.detach().t().to(_DT).contiguous(),
                                layer.bias.detach().to(_DT))
                         for name, layer in [('input_proj', self.input_proj),
                                             *self._heads()]}
                self._packed = PackedTransformer(
                    tuple(pack_encoder_params(self.layer_params(i), device)
                          for i in range(self.num_layers)),
                    dense, self.temporal_embedding.detach().to(_DT))
        return self._packed

    def _check_shape(self, x: torch.Tensor) -> None:
        if x.ndim != 3 or x.shape[1] != self.num_frames:
            raise ValueError(f'expected (B, {self.num_frames}, C), got '
                             f'{tuple(x.shape)}')

    def _outputs(self, x: torch.Tensor, head) -> Dict[str, torch.Tensor]:
        """``x`` [B, T, d] bf16 after the final LayerNorm -> the output dict;
        ``head(name, x)`` is one head's bf16 affine map."""
        if self.output_data_format != 'all_frames':
            x = x[:, -1:, :]
        main = head('contact_head', x).float()
        out = slice_output_heads(main, self.num_contact_bodies, main.shape[1])
        for name, key in (('tau_head', K.OutputDataKeys.TAU),
                          ('com_acc_head', K.OutputDataKeys.COM_ACC_IN_ROOT_FRAME),
                          ('contact_cls_head', K.OutputDataKeys.CONTACT)):
            if getattr(self, name) is not None:
                out[key] = head(name, x).float()
        return out

    def embed(self, inputs: ModelInput) -> torch.Tensor:
        """The encoder's input [B, T, d] bf16: the input projection plus the
        temporal embedding."""
        x = pack_inputs(inputs)                      # [B, T, C_in]
        self._check_shape(x)
        return _dense(x, self.input_proj) + self.temporal_embedding.to(_DT)

    def tail(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The encoder's output [B, T, d] -> the output dict: the final
        LayerNorm (f32, one bf16 rounding after the affine) and the heads."""
        x = _layernorm(x, self.final_ln)
        return self._outputs(x, lambda name, h: _dense(h, getattr(self, name)))

    def forward(self, inputs: ModelInput) -> Dict[str, torch.Tensor]:
        x = self.embed(inputs)
        if self.attn_impl == 'pallas':
            needs_grad = torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters())
            x = x.float().contiguous()
            for i, layer in enumerate(self.packed_layers(needs_grad)):
                x = FusedEncoderLayerFn.apply(x, layer, self.num_heads,
                                              *self.layer_params(i))
            x = x.to(_DT)
        else:
            masks = (self.dropout_masks or generator_masks()) if self.training else None
            for blk in self.blocks:
                x = blk(x, masks)
        return self.tail(x)


def fused_transformer_forward(model: TransformerRegressor, inputs: ModelInput,
                              *, use_kernel: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """Inference forward through the fused encoder layer on ``vpu`` weights.

    The input projection, the temporal embedding and the heads run in bf16
    (bf16 product, bf16 bias add); each encoder layer is one call of
    ``fused_encoder_layer`` on an f32 residual stream (the kernel for a CUDA
    tensor, its plain version for a CPU tensor); the final LayerNorm is
    computed in f32 and rounded to bf16. ``use_kernel=False`` takes the
    layer's plain version on any device: the reference that a served answer
    is held against.
    """
    packed = model.packed()
    x = pack_inputs(inputs)
    model._check_shape(x)

    def dense(name: str, h: torch.Tensor) -> torch.Tensor:
        w, b = packed.dense[name]
        return h.to(_DT) @ w + b

    x = dense('input_proj', x) + packed.temporal_embedding
    x = x.float().contiguous()
    for layer in packed.layers:
        if use_kernel:
            x = fused_encoder_layer(x, layer, model.num_heads)
        else:
            x = encoder_layer_reference(x, layer.params, model.num_heads)
    x = _layernorm(x, model.final_ln)
    return model._outputs(x, dense)
