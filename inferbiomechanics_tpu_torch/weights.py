"""Move feedforward weights between the JAX package and the port.

The JAX ``FeedForwardBaseline`` (``inferbiomechanics_tpu/models/
feedforward.py``) keeps one of two parameter trees:

- ``Dense_{i}: {kernel, bias}`` with ``use_pallas=False`` (flax
  ``nn.Dense``);
- ``W{i}``, ``b{i}`` with ``use_pallas=True`` (feedforward.py:114-115).

Kernels are ``[in, out]``; ``nn.Linear`` stores ``weight [out, in]``, so
they are transposed. Both sides use the same frame-major output head, so
no column is permuted. Arrays cross as numpy.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _layers_from_jax(params: Mapping) -> list:
    dense = sorted(int(m.group(1)) for k in params
                   if (m := re.fullmatch(r'Dense_(\d+)', k)))
    flat = sorted(int(m.group(1)) for k in params
                  if (m := re.fullmatch(r'W(\d+)', k)))
    if dense and not flat:
        idx, get = dense, lambda i: (params[f'Dense_{i}']['kernel'],
                                     params[f'Dense_{i}']['bias'])
    elif flat and not dense:
        idx, get = flat, lambda i: (params[f'W{i}'], params[f'b{i}'])
    else:
        raise ValueError(f'expected a Dense_{{i}} or a W{{i}}/b{{i}} '
                         f'feedforward tree, got keys {sorted(params)}')
    if idx != list(range(len(idx))):
        raise ValueError(f'layer indices are not 0..{len(idx) - 1}: {idx}')
    return [get(i) for i in idx]


def feedforward_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX feedforward params (either tree) -> the port's state dict."""
    sd = {}
    for i, (kernel, bias) in enumerate(_layers_from_jax(params)):
        sd[f'layers.{i}.weight'] = torch.from_numpy(
            np.asarray(kernel, np.float32).T.copy())
        sd[f'layers.{i}.bias'] = torch.from_numpy(
            np.asarray(bias, np.float32).copy())
    return sd


def feedforward_params_to_jax(state_dict: Mapping[str, torch.Tensor],
                              use_pallas: bool = False) -> Dict:
    """The port's state dict -> a JAX feedforward tree of numpy arrays:
    ``W{i}``/``b{i}`` if ``use_pallas``, else ``Dense_{i}``."""
    n = len([k for k in state_dict if re.fullmatch(r'layers\.\d+\.weight', k)])
    out = {}
    for i in range(n):
        kernel = state_dict[f'layers.{i}.weight'].detach().cpu().numpy().T.copy()
        bias = state_dict[f'layers.{i}.bias'].detach().cpu().numpy().copy()
        if use_pallas:
            out[f'W{i}'], out[f'b{i}'] = kernel, bias
        else:
            out[f'Dense_{i}'] = {'kernel': kernel, 'bias': bias}
    return out
