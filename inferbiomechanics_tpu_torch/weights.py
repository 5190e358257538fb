"""Move feedforward, GroundLink, transformer and diffusion denoiser weights
between the JAX package and the port.

The JAX ``FeedForwardBaseline`` (``inferbiomechanics_tpu/models/
feedforward.py``) keeps one of two parameter trees:

- ``Dense_{i}: {kernel, bias}`` with ``use_pallas=False`` (flax
  ``nn.Dense``);
- ``W{i}``, ``b{i}`` with ``use_pallas=True`` (feedforward.py:114-115).

Kernels are ``[in, out]``; ``nn.Linear`` stores ``weight [out, in]``, so
they are transposed. Both sides use the same frame-major output head, so
no column is permuted. Arrays cross as numpy. With ``batchnorm`` the Dense
tree also holds ``BatchNorm_{i}: {scale, bias}`` (the norm before
``Dense_{i}``; the port's ``norms.{i}.weight`` / ``.bias``) and the model's
``batch_stats`` collection ``BatchNorm_{i}: {mean, var}`` (the port's
``norms.{i}.running_mean`` / ``.running_var`` buffers).

The JAX ``TransformerRegressor`` with ``attn_impl='vpu'``
(``inferbiomechanics_tpu/models/transformer.py``) keeps the flax tree that
``_TRANSFORMER_DENSE`` and ``_BLOCK_NORM`` list; the QKV columns are
``[q | k | v]`` on both sides.

With ``attn_impl='pallas'`` the JAX model keeps the encoder as flat
``enc{i}_{name}`` parameters instead (kernels ``[in, out]``). The port's
``pallas`` model stores them under the same names in the same layout, as
``nn.Parameter``s, so they cross untransposed: the kernels' packing reads
``[in, out]`` and a step spares the transpose. Everything around the
encoder (``Dense_0``, ``LayerNorm_0``, the heads) maps as in the ``vpu``
tree.

With ``attn_impl='flax'`` each ``EncoderBlock_{i}`` keeps flax's
``MultiHeadDotProductAttention_0`` in place of ``ShortWindowAttention_0``:
``query``, ``key``, ``value`` (``DenseGeneral`` kernels ``[d, H, dh]``,
biases ``[H, dh]``) and ``out`` (kernel ``[H, dh, d]``, bias ``[d]``)
(:data:`_FLAX_ATTENTION`). The port's ``FlaxAttention`` stores them in
those shapes under the same names, so they cross untransposed; the rest of
the block (its LayerNorms and MLP) maps as in the ``vpu`` tree. The
families ``transformer_flax`` and ``diffusion_flax`` are the transformer's
and the denoiser's with this block.

The JAX ``DiffusionDenoiser`` (``inferbiomechanics_tpu/models/diffusion.py``)
keeps ``target_proj``, ``cond_proj``, ``t_mlp1``, ``t_mlp2``, ``eps_head``,
``temporal_embedding``, the ``vpu`` tree's ``EncoderBlock_{i}`` and the final
``LayerNorm_0``; the port's denoiser keeps the Dense names and stores the
blocks and the final LayerNorm as the transformer does.

The JAX ``Groundlink`` (``inferbiomechanics_tpu/models/groundlink.py``) keeps
``Conv_{i}: {kernel [k, C_in, C_out], bias}`` and ``Dense_{j}: {kernel [in,
out], bias}``, the last Dense (the head) without a bias. ``nn.Conv1d``
stores ``weight [C_out, C_in, k]``; both sides cross-correlate, so the axes
are permuted and no tap is flipped. The head is frame-major on both sides.

The rest of a JAX checkpoint crosses too (``train/checkpoint.py`` reads and
``chip_smoke.py`` writes it): ``batch_stats``; the optax ``opt_state``,
whose moments (rmsprop ``nu``; adam, adamw and adamax ``count``, ``mu``,
``nu``; adagrad ``sum_of_squares``, the port's ``sum``; adadelta ``e_g``,
``e_x``) are trees shaped like the parameters and go through the same
family mapping, at the chain positions the JAX package's optimizer factory
puts them (:func:`optax_layout`); ``step``; and ``ema_params``. The family
comes from the class of the port's model (:func:`model_family`), or, for a
file read without one, from the parameter tree's keys (:func:`tree_family`).
"""

from __future__ import annotations

import re
from itertools import product
from typing import Dict, Iterator, Mapping, Optional

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


# BatchNorm_{i}'s entries: (params name, batch_stats name) -> the port's
_NORM_KEYS = (('scale', None, 'weight'), ('bias', None, 'bias'),
              (None, 'mean', 'running_mean'), (None, 'var', 'running_var'))


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def feedforward_state_dict_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None,
                                    *, params_only: bool = False) -> Dict[str, torch.Tensor]:
    """JAX feedforward params (either tree) -> the port's state dict; a
    batchnorm model's ``BatchNorm_{i}`` params need its ``batch_stats``
    unless ``params_only`` (a tree shaped like the parameters: an
    optimizer's moments, an EMA)."""
    sd = {}
    for i, (kernel, bias) in enumerate(_layers_from_jax(params)):
        sd[f'layers.{i}.weight'] = _f32(kernel).t().contiguous()
        sd[f'layers.{i}.bias'] = _f32(bias)
    norms = sorted(int(m.group(1)) for k in params
                   if (m := re.fullmatch(r'BatchNorm_(\d+)', k)))
    if norms and (norms != list(range(len(sd) // 2)) or
                  (batch_stats is None and not params_only)):
        raise ValueError(f'a batchnorm tree needs BatchNorm_0..{len(sd) // 2 - 1} '
                         f'and its batch_stats; got {norms}, batch_stats '
                         f'{None if batch_stats is None else sorted(batch_stats)}')
    for i in norms:
        for p_name, s_name, port in _NORM_KEYS:
            if p_name or not params_only:
                src = params if p_name else batch_stats
                sd[f'norms.{i}.{port}'] = _f32(src[f'BatchNorm_{i}'][p_name or s_name])
    return sd


def feedforward_params_to_jax(state_dict: Mapping[str, torch.Tensor],
                              use_pallas: bool = False) -> Dict:
    """The port's state dict (or its parameters, gradients) -> a JAX
    feedforward tree of numpy arrays: ``W{i}``/``b{i}`` if ``use_pallas``,
    else ``Dense_{i}`` (and a batchnorm model's ``BatchNorm_{i}`` scale and
    bias; :func:`feedforward_batch_stats_to_jax` gives its statistics)."""
    n = len([k for k in state_dict if re.fullmatch(r'layers\.\d+\.weight', k)])
    to_np = lambda t: t.detach().cpu().float().numpy().copy()   # noqa: E731
    out = {}
    for i in range(n):
        kernel = to_np(state_dict[f'layers.{i}.weight']).T.copy()
        bias = to_np(state_dict[f'layers.{i}.bias'])
        if use_pallas:
            out[f'W{i}'], out[f'b{i}'] = kernel, bias
        else:
            out[f'Dense_{i}'] = {'kernel': kernel, 'bias': bias}
        if f'norms.{i}.weight' in state_dict:
            if use_pallas:
                raise ValueError('the use_pallas tree has no BatchNorm')
            out[f'BatchNorm_{i}'] = {p: to_np(state_dict[f'norms.{i}.{port}'])
                                     for p, _, port in _NORM_KEYS if p}
    return out


def feedforward_batch_stats_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """A batchnorm model's running statistics -> the JAX ``batch_stats``
    collection ``{BatchNorm_{i}: {mean, var}}`` ({} without batchnorm)."""
    out = {}
    for k in state_dict:
        if m := re.fullmatch(r'norms\.(\d+)\.running_mean', k):
            i = m.group(1)
            out[f'BatchNorm_{i}'] = {
                s: state_dict[f'norms.{i}.{port}'].detach().cpu().float().numpy().copy()
                for _, s, port in _NORM_KEYS if s}
    return out


def groundlink_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX GroundLink params -> the port's state dict (``convs.{i}``,
    ``fcs.{j}``, ``head``)."""
    convs = sorted(int(m.group(1)) for k in params
                   if (m := re.fullmatch(r'Conv_(\d+)', k)))
    dense = sorted(int(m.group(1)) for k in params
                   if (m := re.fullmatch(r'Dense_(\d+)', k)))
    if (not convs or not dense or convs != list(range(len(convs)))
            or dense != list(range(len(dense)))
            or len(params) != len(convs) + len(dense)):
        raise ValueError(f'expected a Conv_{{i}}/Dense_{{j}} GroundLink tree, '
                         f'got keys {sorted(params)}')
    as_f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    sd = {}
    for i in convs:
        sd[f'convs.{i}.weight'] = torch.from_numpy(
            as_f32(params[f'Conv_{i}']['kernel']).transpose(2, 1, 0).copy())
        sd[f'convs.{i}.bias'] = torch.from_numpy(as_f32(params[f'Conv_{i}']['bias']).copy())
    for j in dense:
        node = params[f'Dense_{j}']
        last = j == dense[-1]
        if ('bias' in node and node['bias'] is not None) == last:
            raise ValueError('every Dense but the last (the head) has a bias')
        prefix = 'head' if last else f'fcs.{j}'
        sd[f'{prefix}.weight'] = torch.from_numpy(as_f32(node['kernel']).T.copy())
        if not last:
            sd[f'{prefix}.bias'] = torch.from_numpy(as_f32(node['bias']).copy())
    return sd


def groundlink_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's GroundLink state dict -> the JAX tree of numpy arrays."""
    to_np = lambda t: t.detach().cpu().float().numpy()   # noqa: E731
    n_conv = len([k for k in state_dict if re.fullmatch(r'convs\.\d+\.weight', k)])
    n_fc = len([k for k in state_dict if re.fullmatch(r'fcs\.\d+\.weight', k)])
    if not n_conv or 'head.weight' not in state_dict:
        raise ValueError(f'not a GroundLink state dict: keys {sorted(state_dict)}')
    out = {}
    for i in range(n_conv):
        out[f'Conv_{i}'] = {
            'kernel': to_np(state_dict[f'convs.{i}.weight']).transpose(2, 1, 0).copy(),
            'bias': to_np(state_dict[f'convs.{i}.bias']).copy()}
    for j in range(n_fc):
        out[f'Dense_{j}'] = {'kernel': to_np(state_dict[f'fcs.{j}.weight']).T.copy(),
                             'bias': to_np(state_dict[f'fcs.{j}.bias']).copy()}
    out[f'Dense_{n_fc}'] = {'kernel': to_np(state_dict['head.weight']).T.copy()}
    return out


# state-dict prefix of the port's TransformerRegressor -> path in the flax
# tree ('{i}' is the layer index); LayerNorms carry scale/bias, Dense layers
# kernel/bias. The encoder blocks' entries are the diffusion denoiser's too.
_BLOCK_MLP = {
    'blocks.{i}.mlp1': ('EncoderBlock_{i}', 'Dense_0'),
    'blocks.{i}.mlp2': ('EncoderBlock_{i}', 'Dense_1'),
}
_BLOCK_DENSE = {
    'blocks.{i}.attn.qkv': ('EncoderBlock_{i}', 'ShortWindowAttention_0', 'qkv'),
    'blocks.{i}.attn.proj': ('EncoderBlock_{i}', 'ShortWindowAttention_0', 'proj'),
    **_BLOCK_MLP,
}
# the flax attention's DenseGeneral layers: kernel and bias cross as they are
_FLAX_ATTENTION = {
    f'blocks.{{i}}.attn.{name}': ('EncoderBlock_{i}', 'MultiHeadDotProductAttention_0', name)
    for name in ('query', 'key', 'value', 'out')
}
_BLOCK_NORM = {
    'blocks.{i}.ln1': ('EncoderBlock_{i}', 'LayerNorm_0'),
    'blocks.{i}.ln2': ('EncoderBlock_{i}', 'LayerNorm_1'),
    'final_ln': ('LayerNorm_0',),
}
_TRANSFORMER_DENSE = {
    'input_proj': ('Dense_0',),
    **_BLOCK_DENSE,
    'contact_head': ('contact_head',),
    'tau_head': ('tau_head',),
    'com_acc_head': ('com_acc_head',),
    'contact_cls_head': ('contact_cls_head',),
}
# the diffusion denoiser's Dense layers keep their names on both sides
_DIFFUSION_DENSE = {
    **{name: (name,) for name in ('target_proj', 'cond_proj', 't_mlp1', 't_mlp2')},
    **_BLOCK_DENSE,
    'eps_head': ('eps_head',),
}
_OPTIONAL_HEADS = ('tau_head', 'com_acc_head', 'contact_cls_head')


def _flax_table(dense_table: Mapping) -> Dict:
    """``dense_table`` with the ``vpu`` attention's entries left out (the
    flax block's attention crosses through :data:`_FLAX_ATTENTION`)."""
    return {k: v for k, v in dense_table.items() if '.attn.' not in k}


_ENC_RE = re.compile(r'enc(\d+)_\w+')
# how an entry crosses: a Dense (kernel transposed), a LayerNorm, a
# DenseGeneral (kernel and bias as they are)
DENSE, NORM, GENERAL = 'dense', 'norm', 'general'


def _transformer_entries(num_layers: int, dense_table=_TRANSFORMER_DENSE,
                         flax_attention: bool = False):
    """(state-dict prefix, flax path, kind) for every module; with
    ``num_layers`` 0, the modules around the encoder only."""
    tables = [(_flax_table(dense_table) if flax_attention else dense_table, DENSE),
              (_BLOCK_NORM, NORM)]
    if flax_attention:
        tables.append((_FLAX_ATTENTION, GENERAL))
    for table, kind in tables:
        for prefix, path in table.items():
            for i in (range(num_layers) if '{i}' in prefix else (0,)):
                yield (prefix.format(i=i),
                       tuple(part.format(i=i) for part in path), kind)


def _has_flax_attention(params: Mapping) -> bool:
    """True for a tree whose encoder blocks hold flax's attention."""
    return any(re.fullmatch(r'EncoderBlock_\d+', k) and isinstance(v, Mapping)
               and 'MultiHeadDotProductAttention_0' in v for k, v in params.items())


def _num_blocks(params: Mapping) -> int:
    return len([k for k in params if re.fullmatch(r'EncoderBlock_\d+', k)])


def _num_state_dict_blocks(state_dict: Mapping) -> int:
    return len([k for k in state_dict if re.fullmatch(r'blocks\.\d+\.ln1\.weight', k)])


def _state_dict_has_flax_attention(state_dict: Mapping) -> bool:
    return any(re.fullmatch(r'blocks\.\d+\.attn\.query\.kernel', k) for k in state_dict)


def transformer_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``vpu`` transformer params -> the port's state dict."""
    if any(_ENC_RE.fullmatch(k) for k in params):
        raise ValueError("this is an attn_impl='pallas' tree (enc{i}_*); use "
                         "transformer_pallas_state_dict_from_jax")
    if _has_flax_attention(params):
        raise ValueError("this is an attn_impl='flax' tree "
                         "(MultiHeadDotProductAttention_0); use "
                         "transformer_flax_state_dict_from_jax")
    return _transformer_sd_from_jax(params, _num_blocks(params))


def transformer_flax_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``flax`` transformer params (``MultiHeadDotProductAttention_0``
    blocks) -> the port's state dict."""
    if not _has_flax_attention(params):
        raise ValueError("no MultiHeadDotProductAttention_0 blocks: not an "
                         "attn_impl='flax' tree")
    return _transformer_sd_from_jax(params, _num_blocks(params), flax_attention=True)


def transformer_pallas_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``pallas`` transformer params (flat ``enc{i}_*`` encoder) -> the
    port's state dict; the ``enc{i}_*`` arrays cross as they are."""
    enc = sorted(k for k in params if _ENC_RE.fullmatch(k))
    if not enc:
        raise ValueError("no enc{i}_* parameters: not an attn_impl='pallas' tree")
    sd = _transformer_sd_from_jax(params, 0)
    for k in enc:
        sd[k] = torch.from_numpy(np.asarray(params[k], np.float32).copy())
    return sd


# a ``vpu`` EncoderBlock_{i}'s entries under the ``pallas`` tree's
# enc{i}_{name} (kernels [in, out] in both trees)
_ENC_FROM_BLOCK = {
    'ln1_scale': ('LayerNorm_0', 'scale'), 'ln1_bias': ('LayerNorm_0', 'bias'),
    'wqkv': ('ShortWindowAttention_0', 'qkv', 'kernel'),
    'bqkv': ('ShortWindowAttention_0', 'qkv', 'bias'),
    'wproj': ('ShortWindowAttention_0', 'proj', 'kernel'),
    'bproj': ('ShortWindowAttention_0', 'proj', 'bias'),
    'ln2_scale': ('LayerNorm_1', 'scale'), 'ln2_bias': ('LayerNorm_1', 'bias'),
    'wmlp1': ('Dense_0', 'kernel'), 'bmlp1': ('Dense_0', 'bias'),
    'wmlp2': ('Dense_1', 'kernel'), 'bmlp2': ('Dense_1', 'bias'),
}


def transformer_vpu_tree_to_pallas(params: Mapping) -> Dict:
    """A JAX ``vpu`` transformer tree -> the ``pallas`` tree of the same
    function: each ``EncoderBlock_{i}`` flattened into ``enc{i}_*``, the
    rest as it is."""
    if any(_ENC_RE.fullmatch(k) for k in params) or _has_flax_attention(params):
        raise ValueError("not an attn_impl='vpu' transformer tree")
    out = {k: v for k, v in params.items() if not re.fullmatch(r'EncoderBlock_\d+', k)}
    for i in range(_num_blocks(params)):
        for name, path in _ENC_FROM_BLOCK.items():
            node = params[f'EncoderBlock_{i}']
            for part in path:
                node = node[part]
            out[f'enc{i}_{name}'] = np.asarray(node)
    return out


def transformer_pallas_tree_to_vpu(params: Mapping) -> Dict:
    """The inverse of :func:`transformer_vpu_tree_to_pallas`."""
    layers = sorted({int(m.group(1)) for k in params if (m := _ENC_RE.fullmatch(k))})
    if not layers:
        raise ValueError("no enc{i}_* parameters: not an attn_impl='pallas' tree")
    out = {k: v for k, v in params.items() if not _ENC_RE.fullmatch(k)}
    for i in layers:
        for name, (*parents, leaf) in _ENC_FROM_BLOCK.items():
            node = out.setdefault(f'EncoderBlock_{i}', {})
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = np.asarray(params[f'enc{i}_{name}'])
    return out


def _transformer_sd_from_jax(params: Mapping, num_layers: int,
                             dense_table=_TRANSFORMER_DENSE,
                             flax_attention: bool = False) -> Dict[str, torch.Tensor]:
    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32).copy())

    sd = {'temporal_embedding': f32(params['temporal_embedding'])}
    for prefix, path, kind in _transformer_entries(num_layers, dense_table, flax_attention):
        node = params
        for part in path:
            node = node.get(part) if node is not None else None
        if node is None:
            if prefix in _OPTIONAL_HEADS:
                continue
            raise ValueError(f'transformer tree has no {"/".join(path)}')
        if kind == GENERAL:
            sd[f'{prefix}.kernel'] = f32(node['kernel'])
        else:
            w = np.asarray(node['kernel' if kind == DENSE else 'scale'], np.float32)
            sd[f'{prefix}.weight'] = f32(w.T if kind == DENSE else w)
        sd[f'{prefix}.bias'] = f32(node['bias'])
    return sd


def transformer_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's transformer state dict -> the JAX ``vpu`` tree of numpy
    arrays."""
    if any(_ENC_RE.fullmatch(k) for k in state_dict):
        raise ValueError("this is an attn_impl='pallas' state dict (enc{i}_*); "
                         "use transformer_pallas_params_to_jax")
    if _state_dict_has_flax_attention(state_dict):
        raise ValueError("this is an attn_impl='flax' state dict; use "
                         "transformer_flax_params_to_jax")
    return _transformer_sd_to_jax(state_dict, _num_state_dict_blocks(state_dict))


def transformer_flax_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's ``flax`` transformer state dict -> the JAX ``flax`` tree
    of numpy arrays."""
    if not _state_dict_has_flax_attention(state_dict):
        raise ValueError("no blocks.{i}.attn.query: not an attn_impl='flax' state dict")
    return _transformer_sd_to_jax(state_dict, _num_state_dict_blocks(state_dict),
                                  flax_attention=True)


def transformer_pallas_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's ``pallas`` transformer state dict -> the JAX ``pallas``
    tree of numpy arrays."""
    enc = sorted(k for k in state_dict if _ENC_RE.fullmatch(k))
    if not enc:
        raise ValueError("no enc{i}_* entries: not an attn_impl='pallas' state dict")
    out = _transformer_sd_to_jax(state_dict, 0)
    for k in enc:
        out[k] = state_dict[k].detach().cpu().float().numpy().copy()
    return out


def _transformer_sd_to_jax(state_dict: Mapping[str, torch.Tensor],
                           num_layers: int, dense_table=_TRANSFORMER_DENSE,
                           flax_attention: bool = False) -> Dict:
    to_np = lambda t: t.detach().cpu().float().numpy().copy()   # noqa: E731
    out: Dict = {'temporal_embedding': to_np(state_dict['temporal_embedding'])}
    for prefix, path, kind in _transformer_entries(num_layers, dense_table, flax_attention):
        weight = f'{prefix}.kernel' if kind == GENERAL else f'{prefix}.weight'
        if weight not in state_dict:
            if prefix in _OPTIONAL_HEADS:
                continue
            raise ValueError(f'state dict has no {weight}')
        node = out
        for part in path:
            node = node.setdefault(part, {})
        w = to_np(state_dict[weight])
        node['scale' if kind == NORM else 'kernel'] = w.T.copy() if kind == DENSE else w
        node['bias'] = to_np(state_dict[f'{prefix}.bias'])
    return out


def diffusion_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``DiffusionDenoiser`` params (the ``vpu`` tree) -> the port's
    state dict."""
    missing = [k for k in _DIFFUSION_DENSE if '{' not in k and k not in params]
    if missing:
        raise ValueError(f'not a diffusion denoiser tree: no {missing}; keys '
                         f'{sorted(params)}')
    return _transformer_sd_from_jax(params, _num_blocks(params), _DIFFUSION_DENSE,
                                    flax_attention=_has_flax_attention(params))


def diffusion_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's denoiser state dict -> the JAX ``DiffusionDenoiser`` tree
    of numpy arrays (either attention)."""
    if 'eps_head.weight' not in state_dict:
        raise ValueError(f'not a diffusion denoiser state dict: keys {sorted(state_dict)}')
    return _transformer_sd_to_jax(state_dict, _num_state_dict_blocks(state_dict),
                                  _DIFFUSION_DENSE,
                                  flax_attention=_state_dict_has_flax_attention(state_dict))


# ---- the whole of a JAX checkpoint: family, batch stats, optimizer, EMA ----

FAMILIES = ('feedforward', 'groundlink', 'transformer', 'transformer_flax', 'pallas',
            'diffusion', 'diffusion_flax')


def model_family(model) -> str:
    """The JAX parameter tree the port's ``model`` reads and writes: its
    class, and for the transformer its ``attn_impl``."""
    from inferbiomechanics_tpu_torch.models import (
        DiffusionDenoiser, FeedForwardBaseline, Groundlink, TransformerRegressor,
    )
    if isinstance(model, FeedForwardBaseline):
        return 'feedforward'
    if isinstance(model, Groundlink):
        return 'groundlink'
    if isinstance(model, DiffusionDenoiser):
        return 'diffusion' if model.attn_impl == 'vpu' else 'diffusion_flax'
    if isinstance(model, TransformerRegressor):
        return {'vpu': 'transformer', 'flax': 'transformer_flax'}.get(model.attn_impl,
                                                                    model.attn_impl)
    raise ValueError(f'no JAX parameter tree for a {type(model).__name__}')


def tree_family(params: Mapping) -> str:
    """The family a JAX parameter tree belongs to, from its keys alone (for
    a file read without a model: ``convert-checkpoint``)."""
    keys = set(params)
    flax = '_flax' if _has_flax_attention(params) else ''
    if 'eps_head' in keys:
        return 'diffusion' + flax
    if any(_ENC_RE.fullmatch(k) for k in keys):
        return 'pallas'
    if any(re.fullmatch(r'EncoderBlock_\d+', k) for k in keys):
        return 'transformer' + flax
    if any(re.fullmatch(r'Conv_\d+', k) for k in keys):
        return 'groundlink'
    if any(re.fullmatch(r'(Dense_|W)\d+', k) for k in keys):
        return 'feedforward'
    raise ValueError(f'the parameter tree (keys {sorted(keys)[:6]}) is none of the '
                     f'families {FAMILIES}')


def params_from_jax(family: str, tree: Mapping) -> Dict[str, torch.Tensor]:
    """A tree shaped like ``family``'s parameters (the parameters, an
    optimizer's moments, an EMA) -> the port's parameter names."""
    if family == 'feedforward':
        return feedforward_state_dict_from_jax(tree, params_only=True)
    return {'groundlink': groundlink_state_dict_from_jax,
            'transformer': transformer_state_dict_from_jax,
            'transformer_flax': transformer_flax_state_dict_from_jax,
            'pallas': transformer_pallas_state_dict_from_jax,
            'diffusion': diffusion_state_dict_from_jax,
            'diffusion_flax': diffusion_state_dict_from_jax}[family](tree)


def params_to_jax(family: str, named: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`params_from_jax` (feedforward: the Dense tree)."""
    return {'feedforward': feedforward_params_to_jax,
            'groundlink': groundlink_params_to_jax,
            'transformer': transformer_params_to_jax,
            'transformer_flax': transformer_flax_params_to_jax,
            'pallas': transformer_pallas_params_to_jax,
            'diffusion': diffusion_params_to_jax,
            'diffusion_flax': diffusion_params_to_jax}[family](named)


def state_dict_from_jax(family: str, params: Mapping,
                        batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """A JAX model's parameters and ``batch_stats`` -> the port's state dict
    (parameters and BatchNorm buffers)."""
    if family == 'feedforward':
        return feedforward_state_dict_from_jax(params, batch_stats or None)
    if batch_stats:
        raise ValueError(f'a {family} model keeps no batch_stats; got {sorted(batch_stats)}')
    return params_from_jax(family, params)


def _sorted_tree(tree):
    """Dicts with sorted keys, as ``jax.device_get`` hands a train state to
    the JAX package's writer."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


# The optax state of each rule as the JAX package's factory chains it
# (inferbiomechanics_tpu/train/optimizers.py): one entry a link of the
# chain, each the fields its state keeps. TREE is a tree shaped like the
# parameters, COUNT the update count (int32), SCHEDULE the link that scales
# by the learning rate, which counts the updates only under a schedule.
TREE, COUNT, SCHEDULE = 'tree', 'count', 'schedule'
_ADAM = {'count': COUNT, 'mu': TREE, 'nu': TREE}
_OPTAX_CHAINS = {
    'sgd': ({}, SCHEDULE),
    'rmsprop': ({'nu': TREE}, SCHEDULE, {}),
    'adagrad': ({'sum_of_squares': TREE}, SCHEDULE),
    'adam': (_ADAM, SCHEDULE),
    'adamax': (_ADAM, SCHEDULE),
    'adamw': (_ADAM, {}, SCHEDULE),
    'adadelta': ({}, {'e_g': TREE, 'e_x': TREE}, SCHEDULE),
}
# optax's field -> the port's per-parameter state key (train/optimizers.py::_STATE)
_OPTAX_KEYS = {'nu': 'nu', 'mu': 'mu', 'sum_of_squares': 'sum', 'e_g': 'e_g', 'e_x': 'e_x'}


def _links(xs) -> Dict:
    return {str(i): x for i, x in enumerate(xs)}


def optax_layout(opt_type: str, schedule: bool = False, clip: bool = False,
                 freeze: bool = False) -> Dict:
    """The layout of the JAX package's ``opt_state`` (as flax writes it) for
    ``opt_type`` with a learning-rate schedule, ``--grad-clip-norm`` and
    ``--freeze-params``: nested dicts whose leaves are TREE or COUNT."""
    links = [({'count': COUNT} if schedule else {}) if link == SCHEDULE else link
             for link in _OPTAX_CHAINS[opt_type]]
    layout = _links(links)
    if clip:
        layout = _links([{}, layout])
    if freeze:
        layout = _links([layout, {'inner_state': {}}])
    return layout


def optimizer_layout(optimizer) -> Dict:
    """:func:`optax_layout` of the port's ``train/optimizers.py::Optimizer``."""
    return optax_layout(optimizer.opt_type, callable(optimizer.learning_rate),
                        bool(optimizer.grad_clip_norm and optimizer.grad_clip_norm > 0),
                        bool(optimizer.frozen))


def _match(tree, layout, path: tuple, moments: Dict, counts: list) -> None:
    if layout == TREE:
        moments[path[-1]] = tree
    elif layout == COUNT:
        counts.append(int(np.asarray(tree)))
    elif not isinstance(tree, dict) or set(tree) != set(layout):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f'opt_state/{"/".join(path)} holds {got} where the optimizer '
                         f'keeps {sorted(layout)}')
    else:
        for k, sub in layout.items():
            _match(tree[k], sub, path + (k,), moments, counts)


def optimizer_state_from_jax(family: str, opt_state: Mapping, layout: Mapping,
                             named_params: Mapping[str, torch.Tensor]) -> Dict:
    """The JAX package's ``opt_state`` -> the port's optimizer ``state_dict``
    over ``named_params`` (name -> parameter, in the optimizer's order),
    when it has ``layout`` (:func:`optax_layout`). The moments go through
    the family's mapping, as the parameters do. Raises ValueError when the
    layout, a name or a shape disagrees."""
    moments: Dict = {}
    counts: list = []
    _match(opt_state, layout, (), moments, counts)
    per_key = {}
    for field, tree in moments.items():
        named = params_from_jax(family, tree)
        wrong = sorted(n for n in set(named) | set(named_params)
                       if n not in named or n not in named_params
                       or named[n].shape != named_params[n].shape)
        if wrong:
            raise ValueError(f'opt_state {field} does not match the parameters at {wrong[:5]}')
        per_key[_OPTAX_KEYS[field]] = named
    names = list(named_params)
    group: Dict = {'params': list(range(len(names)))}
    if counts:
        group['count'] = counts[0]
    return {'state': ({i: {k: v[n] for k, v in per_key.items()} for i, n in enumerate(names)}
                      if per_key else {}),
            'param_groups': [group]}


def _fill(layout, trees: Mapping, count: int):
    if layout == TREE:
        return trees
    if layout == COUNT:
        return np.asarray(count, np.int32)
    return {k: (trees[k] if sub == TREE else _fill(sub, trees, count))
            for k, sub in layout.items()}


def optimizer_state_to_jax(family: str, optimizer) -> Dict:
    """The port's ``Optimizer`` -> the JAX package's ``opt_state`` tree
    (a parameter with no state yet, as before its first update, gets the
    rule's initial value)."""
    from inferbiomechanics_tpu_torch.train.optimizers import _STATE
    params = optimizer.param_groups[0]['params']
    inits = _STATE[optimizer.opt_type]
    trees = {}
    for field, key in _OPTAX_KEYS.items():
        if key in inits:
            named = {n: optimizer.state[p][key] if key in optimizer.state.get(p, {})
                     else torch.full_like(p, inits[key])
                     for n, p in zip(optimizer.names, params)}
            trees[field] = _sorted_tree(params_to_jax(family, named))
    return _fill(optimizer_layout(optimizer), trees,
                 int(optimizer.param_groups[0].get('count', 0)))


def jax_payload(model, optimizer, epoch: int, batch: int, step: int = 0,
                ema_params: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
    """The tree the JAX package's ``save_checkpoint`` writes for the port's
    ``model`` and ``optimizer`` (``utils/flax_msgpack.py::dumps`` writes
    it): ``{step, params, opt_state, batch_stats, epoch, batch[,
    ema_params]}``, keys sorted as a JAX train state's are."""
    family = model_family(model)
    sd = model.state_dict()
    named = dict(model.named_parameters())
    payload = {
        'step': np.asarray(step, np.int32),
        'params': _sorted_tree(params_to_jax(family, named)),
        'opt_state': optimizer_state_to_jax(family, optimizer),
        'batch_stats': _sorted_tree(feedforward_batch_stats_to_jax(sd)
                                    if family == 'feedforward' else {}),
        'epoch': np.asarray(epoch, np.int64),
        'batch': np.asarray(batch, np.int64),
    }
    if ema_params is not None:
        payload['ema_params'] = _sorted_tree(params_to_jax(family, ema_params))
    return payload


def _layouts(opt_type: str) -> Iterator[Dict]:
    """Every layout of ``opt_type``'s state: with and without a schedule,
    clipping and freezing."""
    for flags in product((False, True), repeat=3):
        yield optax_layout(opt_type, *flags)


def optimizer_candidates(opt_state: Mapping, prefer=()) -> list:
    """The optimizer types whose layout ``opt_state`` has, those in
    ``prefer`` first (adam and adamax keep the same state, so a file alone
    cannot tell them apart)."""
    from inferbiomechanics_tpu_torch.train.optimizers import OPT_TYPES
    found = []
    for opt_type in OPT_TYPES:
        for layout in _layouts(opt_type):
            try:
                _match(opt_state, layout, (), {}, [])
            except ValueError:
                continue
            found.append(opt_type)
            break
    prefer = [t for t in prefer if t in found]
    return prefer + [t for t in found if t not in prefer]


def torch_payload_from_jax(raw: Mapping, prefer=()) -> Dict:
    """A JAX package checkpoint (the tree its ``save_checkpoint`` wrote) ->
    the port's payload (``train/checkpoint.py``), without a model: the
    family comes from the parameter tree, the optimizer type from the
    ``opt_state`` layout (``prefer`` first, see
    :func:`optimizer_candidates`). The optimizer's state is keyed by
    parameter name (``param_names``), which the port's loader reads.
    Without a matching optimizer type the payload holds the model only."""
    family = tree_family(raw['params'])
    payload: Dict = {
        'epoch': int(np.asarray(raw.get('epoch', -1))),
        'batch': int(np.asarray(raw.get('batch', 0))),
        'model_state_dict': state_dict_from_jax(family, raw['params'],
                                                raw.get('batch_stats') or None),
        'step': int(np.asarray(raw.get('step', 0))),
    }
    named = params_from_jax(family, raw['params'])
    candidates = optimizer_candidates(raw.get('opt_state', {}), prefer)
    for layout in (_layouts(candidates[0]) if candidates else ()):
        try:
            opt = optimizer_state_from_jax(family, raw['opt_state'], layout, named)
        except ValueError:
            continue
        opt['param_groups'][0]['param_names'] = list(named)
        payload.update(optimizer_state_dict=opt, opt_type=candidates[0])
        break
    if 'ema_params' in raw:
        payload['ema_params'] = params_from_jax(family, raw['ema_params'])
    return payload
