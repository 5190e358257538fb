"""Rank layouts: the JAX package's meshes laid over processes.

PyTorch counterpart of ``inferbiomechanics_tpu/parallel/mesh.py``. One rank
stands for one JAX device, and a :class:`Layout` maps rank r to the
coordinates JAX gives device r, in ``jax.devices()`` order:

- :func:`make_mesh` (``model_parallel=mp``): the n ranks reshaped to
  (n / mp, mp) on the axes (``data``, ``model``); rank r is ``data`` r // mp
  and ``model`` r % mp. The training loops lay their ranks out on it: the
  state is replicated on every rank and the batch split over ``data``, so
  the mp ranks of a ``data`` row hold the same parameters and see the same
  rows, as the JAX loops' replicated state does (``parallel/
  sharding_rules.py`` has the column split, which no loop calls).
- :func:`make_pipeline_mesh` (``pipe``): (n / pipe, pipe) on the axes
  (``data``, ``pipe``), as ``parallel/pipeline.py`` lays devices out; rank
  r is ``data`` r // pipe and ``pipe`` r % pipe, so ``pipe`` consecutive
  ranks form one pipeline.
- :func:`make_sweep_mesh` (``k_configs``): (c, n / c) on the axes
  (``config``, ``data``), c the largest divisor of n that also divides K;
  rank r is ``config`` r // (n / c) and ``data`` r % (n / c)
  (:func:`sweep_layout` for a given c).

Every collective that JAX makes over one axis runs here over that axis's
group (:meth:`Layout.group`): the ranks that share every other coordinate.
Every rank makes every group of two or more ranks (``parallel/dist.py::
subgroup``), in one order: first the groups of the first axis, then those
of the second. An axis over the whole world has no group of its own (None:
the default group); one of one rank makes no collective. Without a process
group the layout is rank 0 of 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

from inferbiomechanics_tpu_torch.parallel import dist

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
CONFIG_AXIS = 'config'   # the sweep grid's axis (train/sweep.py)
PIPE_AXIS = 'pipe'       # the pipeline's stages (parallel/pipeline.py)


@dataclass(frozen=True)
class Layout:
    """``shape`` ranks on ``axes`` (row-major, as ``np.reshape`` lays
    ``jax.devices()`` out), seen from ``rank``, with this rank's group
    along each axis."""
    axes: Tuple[str, str]
    shape: Tuple[int, int]
    rank: int
    groups: Tuple[Optional[dist.Group], Optional[dist.Group]]

    def _axis(self, axis: str) -> int:
        return self.axes.index(axis)

    def size(self, axis: str) -> int:
        return self.shape[self._axis(axis)]

    def coord(self, axis: str) -> int:
        return (self.rank // self.shape[1], self.rank % self.shape[1])[self._axis(axis)]

    def group(self, axis: str) -> Optional[dist.Group]:
        """The ranks that share this rank's other coordinate (None: all)."""
        return self.groups[self._axis(axis)]

    def rank_at(self, coords: Mapping[str, int]) -> int:
        """The rank at ``coords`` (a coordinate for each axis)."""
        return coords[self.axes[0]] * self.shape[1] + coords[self.axes[1]]


def _layout(axes: Tuple[str, str], shape: Tuple[int, int]) -> Layout:
    rows, cols = shape
    me = dist.rank()
    along_rows = [dist.subgroup([r * cols + c for r in range(rows)]) for c in range(cols)]
    along_cols = [dist.subgroup([r * cols + c for c in range(cols)]) for r in range(rows)]
    return Layout(axes, shape, me, (along_rows[me % cols], along_cols[me // cols]))


def make_mesh(model_parallel: int = 1) -> Layout:
    """The (``data``, ``model``) layout of the world's ranks, with the JAX
    package's refusal of a world that ``model_parallel`` does not divide."""
    n = dist.world_size()
    if n % model_parallel != 0:
        raise ValueError(f'{n} devices not divisible by model_parallel={model_parallel}')
    return _layout((DATA_AXIS, MODEL_AXIS), (n // model_parallel, model_parallel))


def make_pipeline_mesh(pipe: int = 2) -> Layout:
    """The (``data``, ``pipe``) layout of the world's ranks, with the JAX
    package's refusal of a world that ``pipe`` does not divide."""
    n = dist.world_size()
    if n % pipe != 0:
        raise ValueError(f'{n} devices not divisible by pipe={pipe}')
    return _layout((DATA_AXIS, PIPE_AXIS), (n // pipe, pipe))


def config_axis_size(k_configs: int, n: int) -> int:
    """``make_sweep_mesh``'s config axis: the largest divisor of ``n`` that
    also divides K (1 when K is coprime to n)."""
    for cand in range(min(k_configs, n), 0, -1):
        if n % cand == 0 and k_configs % cand == 0:
            return cand
    return 1


def sweep_layout(config_ways: int) -> Layout:
    """The (``config``, ``data``) layout of the world's ranks with
    ``config_ways`` ranks on the ``config`` axis (a divisor of the world).
    ``sweep_layout(n)`` is ``make_mesh()`` with the configs on its ``data``
    axis, ``sweep_layout(1)`` with the trials on it."""
    return _layout((CONFIG_AXIS, DATA_AXIS), (config_ways, dist.world_size() // config_ways))


def make_sweep_mesh(k_configs: int) -> Layout:
    """The (``config``, ``data``) layout of the world's ranks for a sweep
    of ``k_configs`` configs over sharded data."""
    return sweep_layout(config_axis_size(k_configs, dist.world_size()))


__all__ = ['CONFIG_AXIS', 'DATA_AXIS', 'Layout', 'MODEL_AXIS', 'PIPE_AXIS',
           'config_axis_size', 'make_mesh', 'make_pipeline_mesh', 'make_sweep_mesh',
           'sweep_layout']
