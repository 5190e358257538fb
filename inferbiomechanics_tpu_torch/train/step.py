"""Train and eval steps.

PyTorch counterpart of ``inferbiomechanics_tpu/train/step.py``: one step is
forward, loss, all reported metrics, backward and the optimizer update, on
the packed ``[B, T, C]`` batch tensors straight from the data layer (label
dicts are column-slice views). PyTorch runs it eagerly; the state is
updated in place and the step returns the metrics, which stay on the
device.

``grad_accum > 1`` splits the batch into that many equal microbatches,
runs them one after the other (activation memory of one microbatch) and
averages gradients and metrics before the single update.

``make_eval_chunk_runner`` is the counterpart of the JAX ``analyze``'s
``lax.scan`` chunk: K same-shape batches through the eval step one after
the other, their metrics kept on the device and brought to the host in one
copy. The chunked K-step train dispatch and the reduced-precision gradient
all-reduce are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from inferbiomechanics_tpu_torch.data.dataset import unpack
from inferbiomechanics_tpu_torch.loss.evaluator import LossConfig, loss_and_metrics
from inferbiomechanics_tpu_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]


def accumulate_grads(state: TrainState, grad_accum: int, batch_size: int,
                     loss_for: Callable[[slice], Tuple[torch.Tensor, Metrics]]
                     ) -> Metrics:
    """Leave on the parameters the gradient of the mean loss over
    ``grad_accum`` equal microbatches, and return the metrics averaged over
    them. ``loss_for(rows)`` is the loss and metrics of the microbatch made
    of those rows of the batch."""
    if batch_size % grad_accum:
        raise ValueError(f'batch size {batch_size} not divisible by '
                         f'--grad-accum-steps {grad_accum}')
    mb = batch_size // grad_accum
    state.optimizer.zero_grad(set_to_none=True)
    history = []
    for k in range(grad_accum):
        loss, metrics = loss_for(slice(k * mb, (k + 1) * mb))
        (loss / grad_accum).backward()      # gradients add up on .grad
        history.append(metrics)
    if grad_accum == 1:
        return history[0]
    return {k: torch.stack([m[k] for m in history]).mean(0) for k in history[0]}


def make_train_step(model, lab_offsets: Dict[str, Tuple[int, int]],
                    loss_config: LossConfig, grad_accum: int = 1) -> Callable:
    """Build ``step(state, inputs, labels) -> metrics`` (``state`` is
    updated in place)."""

    def step(state: TrainState, batch_inputs: torch.Tensor,
             batch_labels: torch.Tensor) -> Metrics:
        model.train()

        def loss_for(rows: slice):
            outputs = model(batch_inputs[rows])
            return loss_and_metrics(outputs, unpack(batch_labels[rows], lab_offsets),
                                    loss_config)

        metrics = accumulate_grads(state, grad_accum, batch_inputs.shape[0], loss_for)
        state.apply_gradients()
        return metrics

    return step


def make_eval_step(model, lab_offsets: Dict[str, Tuple[int, int]],
                   loss_config: LossConfig) -> Callable:
    """Build ``eval_step(state, inputs, labels) -> (outputs, metrics)``."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch_inputs: torch.Tensor,
                  batch_labels: torch.Tensor):
        model.eval()
        outputs = model(batch_inputs)
        _, metrics = loss_and_metrics(outputs, unpack(batch_labels, lab_offsets),
                                      loss_config)
        return outputs, metrics

    return eval_step


def _aligned_batches(a: np.ndarray, device) -> list:
    """``a`` [K, ...] float32 uploaded in one copy, as K contiguous views that
    each start on a 16-byte boundary (the kernels read their inputs in
    16-byte pieces)."""
    k, n = a.shape[0], int(np.prod(a.shape[1:]))
    buf = np.zeros((k, -(-n // 4) * 4), np.float32)
    buf[:, :n] = a.reshape(k, n)
    dev = torch.from_numpy(buf).to(device)
    return [row[:n].view(a.shape[1:]) for row in dev]


def make_eval_chunk_runner(eval_step: Callable, device) -> Callable:
    """Build ``run(state, inputs, labels) -> metrics`` for K same-shape
    batches: ``inputs`` [K, B, T, C] and ``labels`` [K, B, ...] float32 host
    arrays, each uploaded in one copy; the K eval forwards run one after the other
    with their metrics on the device, then one device-to-host copy brings
    them all back as host arrays [K, ...] by metric."""

    def run(state, inputs: np.ndarray, labels: np.ndarray) -> Dict[str, np.ndarray]:
        xs, ys = _aligned_batches(inputs, device), _aligned_batches(labels, device)
        history = [eval_step(state, x, y)[1] for x, y in zip(xs, ys)]
        stacked = {k: torch.stack([m[k] for m in history]).float() for k in history[0]}
        flat = torch.cat([v.reshape(len(history), -1) for v in stacked.values()],
                         dim=1).cpu().numpy()
        out, at = {}, 0
        for k, v in stacked.items():
            width = v[0].numel()
            out[k] = flat[:, at:at + width].reshape(v.shape)
            at += width
        return out

    return run
