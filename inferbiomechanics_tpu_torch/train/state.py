"""Train state: what one checkpoint holds.

PyTorch counterpart of ``inferbiomechanics_tpu/train/state.py``. The JAX
state is an immutable pytree that every step replaces; here the model and
the optimizer are updated in place and the state is the handle on both,
plus the count of updates made, the per-step generators (the dropout one and,
with ``--augment-*``, the augmentation one) and, for ``--ema-decay``, an
exponential moving average of the parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from inferbiomechanics_tpu_torch.train.optimizers import Optimizer

# the augmentation generator's seed is the dropout one's XOR this (the JAX
# package folds 0xA06 into the step's key for its augmentation draws)
AUG_SEED_SALT = 0xA06 << 48


class ParamEMA:
    """An exponential moving average of a model's parameters, float32 on
    their device: after every update, ``e <- e * decay + p * (1 - decay)``
    for every parameter (the JAX package's formula). Seeded from ``init`` (a state dict of the model's keys: a
    checkpoint's ``ema_params``, which ``checkpoint.load_ema_params``
    checks against the model) or else from the parameters."""

    def __init__(self, model: nn.Module, decay: float,
                 init: Optional[Mapping[str, torch.Tensor]] = None):
        named = list(model.named_parameters())
        self.decay = float(decay)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        with torch.no_grad():
            self.tensors = [(init[n] if init is not None else p).detach().to(
                device=p.device, dtype=torch.float32).clone() for n, p in named]

    @torch.no_grad()
    def update(self) -> None:
        torch._foreach_mul_(self.tensors, self.decay)
        torch._foreach_add_(self.tensors, torch._foreach_mul(self.params, 1.0 - self.decay))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.tensors))


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    # the generator the model's dropout masks come from, reseeded from
    # dropout_seed and the step count before every step, so that a step's
    # masks do not depend on where a run was resumed (None: no reseeding)
    dropout_gen: Optional[torch.Generator] = None
    dropout_seed: int = 0
    # the generator the augmentation's draws come from (None: no
    # augmentation), reseeded the same way under a constant of its own, so
    # that turning augmentation on moves no dropout mask (the JAX package
    # folds a key of its own for it, for the same reason)
    aug_gen: Optional[torch.Generator] = None
    # the parameters' moving average, updated after every update (None: off)
    ema: Optional[ParamEMA] = None
    # data parallelism (parallel/dist.py): the gradient all-reduce after
    # every backward, ``sync(metrics) -> metrics`` (None: one process;
    # ``attach``), and (rank, world size) when the per-step draws are those
    # of the global batch, of which the step keeps its rank's rows
    grad_sync: Optional[Callable] = None
    draw_shard: Optional[Tuple[int, int]] = None

    def generators(self) -> List[torch.Generator]:
        """The per-step generators the state keeps (a captured step
        registers them with its graph)."""
        return [g for g in (self.dropout_gen, self.aug_gen) if g is not None]

    def reseed_generators(self) -> None:
        """Seed the per-step generators for the step about to run."""
        seed = self.dropout_seed * 1_000_003 + self.step
        if self.dropout_gen is not None:
            self.dropout_gen.manual_seed(seed)
        if self.aug_gen is not None:
            self.aug_gen.manual_seed(seed ^ AUG_SEED_SALT)

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients on the parameters, then
        the EMA's."""
        self.optimizer.step()
        self.update_ema()
        self.step += 1

    def update_ema(self) -> None:
        if self.ema is not None:
            self.ema.update()


def create_train_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, step=0)


def num_params(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
