"""Parameter sharding rules for a tensor-parallel layout.

PyTorch counterpart of ``inferbiomechanics_tpu/parallel/sharding_rules.py``,
the JAX rule ``_param_spec`` restated for the port's trees: with
``model_parallel`` mp > 1 a 2-D ``kernel`` whose output (last) dimension is
at least 64 wide and divisible by mp is split by columns over the ``model``
axis, and everything else is replicated. A leaf is judged by its JAX name
and shape, reached through the port's own name mapping (``weights.py``;
:func:`jax_leaves`), so that the same leaves split as in JAX for every
family: the ``pallas`` transformer's flat ``enc{i}_*`` encoder, whose names
do not end in ``kernel``, stays whole as it does in JAX. In an ``nn.Linear``
the JAX kernel's last dimension is the weight's dimension 0, so a JAX column
block is a row block of the port's weight.

Optimizer moments follow JAX's shape match (``shard_params_for_mesh``): a
moment of two or more dimensions is split as the first parameter, in the
JAX tree's leaf order, of its JAX shape is.

This is a library, as it is in the JAX package: no loop calls it (the loops
replicate the state on every rank, ``train/loop.py``). :func:`shard_state`
gives rank j of the ``model`` axis its slices of a train state;
:func:`gather_state` puts them back together over the ``model`` group.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.parallel import dist

MIN_SHARD_DIM = 64      # kernels at least this wide get column-split


@dataclass(frozen=True)
class Leaf:
    """A parameter's JAX leaf: its path and shape in the JAX tree, and the
    port tensor's dimension that is the JAX leaf's last one (2-D leaves;
    None otherwise)."""
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    column_dim: Optional[int]


def _flatten(tree: Mapping, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    """(path, leaf) of a nested dict in JAX's leaf order (sorted keys)."""
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, Mapping):
            yield from _flatten(node, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(node)


def jax_leaves(model: torch.nn.Module) -> Dict[str, Leaf]:
    """Every parameter of ``model`` by name -> its :class:`Leaf`, in the JAX
    tree's leaf order. The mapping is ``weights.py``'s, read off two probes:
    each parameter filled with its own number (which JAX leaf it becomes),
    and each 2-D one with its row index (which JAX axis its rows become)."""
    family = weights.model_family(model)
    named = list(model.named_parameters())
    ids = weights.params_to_jax(family, {n: torch.full(tuple(p.shape), float(j))
                                         for j, (n, p) in enumerate(named)})
    rows = weights.params_to_jax(family, {
        n: (torch.arange(p.shape[0], dtype=torch.float32)[:, None].expand(*p.shape)
            if p.dim() == 2 else torch.zeros(tuple(p.shape)))
        for n, p in named})
    rows = dict(_flatten(rows))
    out: Dict[str, Leaf] = {}
    for path, leaf in _flatten(ids):
        name = named[int(leaf.flat[0])][0]
        column_dim = None
        if leaf.ndim == 2:
            r = rows[path]
            column_dim = 0 if r.shape[1] > 1 and r[0, 1] != r[0, 0] else 1
        out[name] = Leaf(path, tuple(leaf.shape), column_dim)
    missing = [n for n, _ in named if n not in out]
    if missing:
        raise ValueError(f'parameters without a JAX leaf: {missing}')
    return out


def is_split(leaf: Leaf, mp: int) -> bool:
    """The JAX rule: a 2-D ``kernel`` whose last dimension is at least
    :data:`MIN_SHARD_DIM` wide and divisible by ``mp`` (> 1)."""
    return (mp > 1 and leaf.path[-1] == 'kernel' and len(leaf.shape) == 2
            and leaf.shape[-1] % mp == 0 and leaf.shape[-1] >= MIN_SHARD_DIM)


def split_dims(model: torch.nn.Module, mp: int
               ) -> Tuple[Dict[str, Optional[int]], Dict[str, Optional[int]]]:
    """By parameter name, the port tensor's dimension split over the
    ``model`` axis (None: replicated): the parameter's, and that of its
    optimizer moments (the JAX shape match)."""
    leaves = jax_leaves(model)
    params = {n: leaf.column_dim if is_split(leaf, mp) else None for n, leaf in leaves.items()}
    first: Dict[Tuple[int, ...], str] = {}
    for n, leaf in leaves.items():
        first.setdefault(leaf.shape, n)
    moments = {n: leaf.column_dim if len(leaf.shape) >= 2 and params[first[leaf.shape]] is not None
               else None for n, leaf in leaves.items()}
    return params, moments


@dataclass
class StateShard:
    """Rank ``index`` of ``mp``'s part of a train state: each parameter and
    optimizer moment by name (and moment key), sliced along its dimension in
    ``dims`` (None: whole)."""
    mp: int
    index: int
    params: Dict[str, torch.Tensor] = field(default_factory=dict)
    moments: Dict[str, Dict[str, torch.Tensor]] = field(default_factory=dict)
    param_dims: Dict[str, Optional[int]] = field(default_factory=dict)
    moment_dims: Dict[str, Dict[str, Optional[int]]] = field(default_factory=dict)

    def nbytes(self) -> int:
        """The bytes this rank holds."""
        tensors = [*self.params.values(), *(t for m in self.moments.values() for t in m.values())]
        return sum(t.numel() * t.element_size() for t in tensors)


def _slice(t: torch.Tensor, dim: Optional[int], mp: int, index: int) -> torch.Tensor:
    if dim is None:
        return t.detach()
    return t.detach().chunk(mp, dim)[index].clone()


def shard_state(state, mp: int, index: int) -> StateShard:
    """``state``'s (a TrainState) part on rank ``index`` of a ``model``
    axis of ``mp`` ranks: the column slice of each split parameter, and of
    every optimizer moment shaped like its parameter that the shape match
    splits; every other tensor whole."""
    pdims, mdims = split_dims(state.model, mp)
    shard = StateShard(mp, index)
    named = list(state.model.named_parameters())
    for n, p in named:
        shard.params[n] = _slice(p, pdims[n], mp, index)
        shard.param_dims[n] = pdims[n]
    opt = state.optimizer
    by_id = {id(p): n for n, p in named}
    for p in opt.param_groups[0]['params']:
        n = by_id[id(p)]
        dims = {key: mdims[n] if t.shape == p.shape and t.dim() >= 2 else None
                for key, t in opt.state[p].items()}
        shard.moments[n] = {key: _slice(t, dims[key], mp, index)
                            for key, t in opt.state[p].items()}
        shard.moment_dims[n] = dims
    return shard


def _gather(t: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    return t if dim is None else torch.cat(dist.all_gather(t, group), dim)


def gather_state(shard: StateShard, group: Optional[dist.Group] = None) -> StateShard:
    """The inverse of :func:`shard_state`: every split tensor's slices
    gathered over the ``model`` group (None: the world), in the group's
    order; every rank of the group calls it."""
    whole = StateShard(1, 0, param_dims={n: None for n in shard.param_dims},
                       moment_dims={n: {k: None for k in d} for n, d in shard.moment_dims.items()})
    for n, t in shard.params.items():
        whole.params[n] = _gather(t, shard.param_dims[n], group)
    for n, m in shard.moments.items():
        whole.moments[n] = {k: _gather(t, shard.moment_dims[n][k], group) for k, t in m.items()}
    return whole


__all__ = ['Leaf', 'MIN_SHARD_DIM', 'StateShard', 'gather_state', 'is_split', 'jax_leaves',
           'shard_state', 'split_dims']
