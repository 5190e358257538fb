"""Batch normalisation as flax's ``nn.BatchNorm`` computes it.

PyTorch counterpart of the ``nn.BatchNorm`` layers of the JAX package's
feedforward model (flax's defaults there: momentum 0.99, epsilon 1e-5,
``use_fast_variance``, ``force_float32_reductions``, output in the compute
dtype). ``torch.nn.BatchNorm1d`` differs from it in three ways that show at
the suite's tolerances, so it is not used:

- torch's ``momentum`` is the weight of the new statistic (flax's is that of
  the running one);
- torch updates ``running_var`` with the unbiased variance, flax with the
  biased one;
- flax computes the batch statistics in float32 as E[x^2] - E[x]^2, clipped
  at 0.

In training the batch statistics normalise (under data parallelism those of
the global batch: :func:`batch_stats` with a sum over the ranks, so every
rank updates the same running statistics) and the running ones are updated
in place (``mul_`` / ``add_`` on the registered buffers, so that a CUDA
graph of the train step updates them on every replay); in evaluation the
running statistics normalise, and the layer is the affine map
:meth:`BatchNorm.affine` gives.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

MOMENTUM = 0.99
EPS = 1e-5


def batch_stats(x: torch.Tensor, sync: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance of ``x`` [N, C] over its rows, in float32,
    the variance as E[x^2] - E[x]^2 clipped at 0 (flax's
    ``use_fast_variance``). With ``sync`` (a differentiable sum over the
    ranks of a data-parallel run's ``data`` axis, every rank holding N rows:
    ``parallel/dist.py::RankSum``, whose ``size`` counts them) the
    statistics are those of the global batch: the sums of x and x^2 go over
    the ranks in one collective, as pjit's statistics go over the global
    batch."""
    x = x.float()
    if sync is None:
        mean = x.mean(0)
        var = torch.clamp((x * x).mean(0) - mean * mean, min=0.0)
        return mean, var
    sums = sync(torch.stack([x.sum(0), (x * x).sum(0)]))
    n = x.shape[0] * sync.size
    mean = sums[0] / n
    var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    return mean, var


def batch_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """flax's ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in float32, the result in ``x``'s dtype."""
    mul = torch.rsqrt(var + eps) * scale.float()
    return ((x.float() - mean) * mul + bias.float()).to(x.dtype)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(use_running_average=not train)`` over the last
    axis of ``x`` [N, C]: parameters ``weight`` (flax's ``scale``, ones) and
    ``bias`` (zeros), buffers ``running_mean`` (zeros) and ``running_var``
    (ones), both float32."""

    def __init__(self, num_features: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer('running_mean', torch.zeros(num_features, device=device))
        self.register_buffer('running_var', torch.ones(num_features, device=device))
        # under data parallelism a sum over the data axis's ranks
        # (parallel/dist.py::RankSum)
        self.stats_sync: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias)
        mean, var = batch_stats(x, self.stats_sync)
        with torch.no_grad():
            self.running_mean.mul_(MOMENTUM).add_(mean * (1.0 - MOMENTUM))
            self.running_var.mul_(MOMENTUM).add_(var * (1.0 - MOMENTUM))
        return batch_norm(x, mean, var, self.weight, self.bias)

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval layer as ``x * s + t`` (float32 ``s``, ``t`` [C]):
        ``s = scale * rsqrt(running_var + eps)``, ``t = bias - running_mean * s``."""
        s = torch.rsqrt(self.running_var + EPS) * self.weight.float()
        return s, self.bias.float() - self.running_mean * s
