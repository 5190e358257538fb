"""Train state: what one checkpoint holds.

PyTorch counterpart of ``inferbiomechanics_tpu/train/state.py``. The JAX
state is an immutable pytree that every step replaces; here the model and
the optimizer are updated in place and the state is the handle on both,
plus the count of updates made and the dropout generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from inferbiomechanics_tpu_torch.train.optimizers import Optimizer


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

    def reseed_dropout(self) -> None:
        """Seed the dropout generator for the step about to run."""
        if self.dropout_gen is not None:
            self.dropout_gen.manual_seed(self.dropout_seed * 1_000_003 + self.step)

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients on the parameters."""
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, step=0)


def num_params(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
