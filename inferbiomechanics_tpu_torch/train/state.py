"""Train state: what one checkpoint holds.

PyTorch counterpart of ``inferbiomechanics_tpu/train/state.py``. The JAX
state is an immutable pytree that every step replaces; here the model and
the optimizer are updated in place and the state is the handle on both,
plus the count of updates made.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from inferbiomechanics_tpu_torch.train.optimizers import Optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients on the parameters."""
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, step=0)


def num_params(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
