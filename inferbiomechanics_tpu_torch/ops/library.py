"""The eval forwards of K1, K2 and K4 as PyTorch custom operators.

``torch.export`` traces with fake tensors, which have no ``data_ptr()``, so it
cannot follow a wrapper that launches its kernel through ``ctypes``. Each
forward is therefore also an operator of the ``ib_torch`` namespace that an
exported program keeps as one node:

- ``ib_torch::fused_mlp`` (K1, ``ops/fused_mlp.py::fused_mlp_forward``);
- ``ib_torch::fused_encoder_layer`` (K2, ``ops/fused_encoder.py::
  fused_encoder_layer``, the forward only: K3 is a backward and is not
  exported);
- ``ib_torch::fused_groundlink`` (K4, ``ops/fused_groundlink.py::
  fused_groundlink_forward``).

An operator takes the packed weights as tensors, the widths as lists of
ints and the activation or output format as a string, and calls the wrapper,
which picks the launch's plan from the batch inside the call (an exported
program's batch is symbolic) and, for a CUDA tensor, launches the kernel and
counts the launch or raises; for a CPU tensor it runs the kernel's plain
version. ``register_fake`` gives each operator's output for shapes alone.

While ``torch.export`` traces (``torch.compiler.is_exporting()``), the three
wrappers call these operators instead of launching; everywhere else they
launch directly, since an operator call costs host time that a forward at
B=1 feels (PERF.md gives both times). A program that holds the operators
needs this module imported before ``torch.export.load``::

    import inferbiomechanics_tpu_torch.ops.library   # registers ib_torch::*
    outputs = torch.export.load('model.pt2').module()(windows)
"""

from __future__ import annotations

from typing import List

import torch

from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg
from inferbiomechanics_tpu_torch.ops import fused_mlp as fm

NAMESPACE = 'ib_torch'


@torch.library.custom_op(f'{NAMESPACE}::fused_mlp', mutates_args=())
def fused_mlp(x: torch.Tensor, weights: torch.Tensor, biases: torch.Tensor,
              layer_weights: List[torch.Tensor], layer_biases: List[torch.Tensor],
              dims: List[int], pdims: List[int], activation: str) -> torch.Tensor:
    """K1 on ``x [B, C_in]`` f32: ``weights`` and ``biases`` as
    ``PackedMLP`` holds them, ``layer_weights`` / ``layer_biases`` its
    unpadded layers (the plain version's)."""
    packed = fm.PackedMLP(weights, biases, tuple(dims), tuple(pdims),
                          tuple(zip(layer_weights, layer_biases)))
    return fm.fused_mlp_forward(x, packed, activation)


@fused_mlp.register_fake
def _(x, weights, biases, layer_weights, layer_biases, dims, pdims, activation):
    return x.new_empty((x.shape[0], dims[-1]), dtype=torch.float32)


@torch.library.custom_op(f'{NAMESPACE}::fused_encoder_layer', mutates_args=())
def fused_encoder_layer(x: torch.Tensor, weights: torch.Tensor, rows: torch.Tensor,
                        params: List[torch.Tensor], d_model: int, mlp_dim: int,
                        num_heads: int) -> torch.Tensor:
    """K2 on ``x [B, T, d]`` f32: ``weights`` and ``rows`` as
    ``PackedEncoderLayer`` holds them, ``params`` its flat tuple (the plain
    version's)."""
    packed = fe.PackedEncoderLayer(weights, rows, d_model, mlp_dim, tuple(params))
    return fe.fused_encoder_layer(x, packed, num_heads)


@fused_encoder_layer.register_fake
def _(x, weights, rows, params, d_model, mlp_dim, num_heads):
    return torch.empty_like(x)


def _groundlink_names(n_conv: int, fc_depth: int) -> List[str]:
    return [f'Conv_{i}' for i in range(n_conv)] + [f'Dense_{j}' for j in range(fc_depth)]


@torch.library.custom_op(f'{NAMESPACE}::fused_groundlink', mutates_args=())
def fused_groundlink(x: torch.Tensor, weights: torch.Tensor, biases: torch.Tensor,
                     kernels: List[torch.Tensor], layer_biases: List[torch.Tensor],
                     widths: List[int], pwidths: List[int], n_conv: int, fc_depth: int,
                     taps: int, output_data_format: str) -> torch.Tensor:
    """K4 on ``x [B, T, C_in]`` f32: ``weights`` and ``biases`` as
    ``PackedGroundlink`` holds them, ``kernels`` and ``layer_biases`` its
    unpadded tree layer by layer (every layer but the head has a bias)."""
    tree = {name: {'kernel': k} for name, k in
            zip(_groundlink_names(n_conv, fc_depth), kernels)}
    for name, b in zip(_groundlink_names(n_conv, fc_depth), layer_biases):
        tree[name]['bias'] = b
    packed = fg.PackedGroundlink(weights, biases, tuple(widths), tuple(pwidths), n_conv,
                                 fc_depth, taps, tree)
    return fg.fused_groundlink_forward(x, packed, output_data_format)


@fused_groundlink.register_fake
def _(x, weights, biases, kernels, layer_biases, widths, pwidths, n_conv, fc_depth, taps,
      output_data_format):
    frames = x.shape[1] if output_data_format == 'all_frames' else 1
    return x.new_empty((x.shape[0], frames, widths[-1]), dtype=torch.float32)


def mlp(x: torch.Tensor, packed: 'fm.PackedMLP', activation: str) -> torch.Tensor:
    """:func:`fused_mlp` on a ``PackedMLP``."""
    return fused_mlp(x, packed.weights, packed.biases, [w for w, _ in packed.layers],
                     [b for _, b in packed.layers], list(packed.dims), list(packed.pdims),
                     activation)


def encoder_layer(x: torch.Tensor, packed: 'fe.PackedEncoderLayer',
                  num_heads: int) -> torch.Tensor:
    """:func:`fused_encoder_layer` on a ``PackedEncoderLayer``."""
    return fused_encoder_layer(x, packed.weights, packed.rows, list(packed.params),
                               packed.d_model, packed.mlp_dim, num_heads)


def groundlink(x: torch.Tensor, packed: 'fg.PackedGroundlink',
               output_data_format: str) -> torch.Tensor:
    """:func:`fused_groundlink` on a ``PackedGroundlink``."""
    names = _groundlink_names(packed.n_conv, packed.fc_depth)
    return fused_groundlink(
        x, packed.weights, packed.biases, [packed.params[n]['kernel'] for n in names],
        [packed.params[n]['bias'] for n in names[:-1]], list(packed.widths),
        list(packed.pwidths), packed.n_conv, packed.fc_depth, packed.taps,
        output_data_format)


__all__ = ['NAMESPACE', 'encoder_layer', 'fused_encoder_layer', 'fused_groundlink',
           'fused_mlp', 'groundlink', 'mlp']
