"""Optimizer factory.

PyTorch counterpart of ``inferbiomechanics_tpu/train/optimizers.py``: the
seven optimizers {adagrad, adam, sgd, rmsprop (default), adadelta, adamax,
adamw}, the four learning-rate schedules, global-norm gradient clipping and
``wrap_freeze``.

The JAX package builds these from optax, and optax's update rules and
defaults differ from ``torch.optim``'s (adagrad starts its accumulator at
0.1 with eps 1e-7 inside the root; adamw decays by 1e-4; clipping scales by
``max_norm / max(norm, max_norm)`` with no epsilon; ``warmup_cosine``'s
``decay_steps`` includes the warm-up). So that a run of the port follows a
run of the JAX package update for update, :class:`Optimizer` implements
optax's rules directly, on lists of tensors (``torch._foreach_*``: a few
kernel launches a step, not a few per parameter). rmsprop is the rule the
JAX package configures: decay 0.99, eps 1e-8 added outside the root.

The update is linear in the learning rate and the learning rate is not part
of the optimizer's state; a constant schedule keeps no step counter.

The values that change from one update to the next (the learning rate of a
schedule, adam's bias corrections) are computed on the host in float32, as
optax rounds them, and read by the update from a small tensor beside the
parameters (:attr:`Optimizer.scalars`), never passed as Python numbers: a
step captured as a CUDA graph replays the update with whatever that tensor
holds (``train/step.py::GraphedStep``), and the eager step takes the same
operations, so the two stay bitwise equal.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

OPT_TYPES = ('adagrad', 'adam', 'sgd', 'rmsprop', 'adadelta', 'adamax',
             'adamw')
LR_SCHEDULES = ('constant', 'cosine', 'warmup_cosine', 'linear')

Schedule = Callable[[int], float]


def make_lr_schedule(schedule: str, learning_rate: float,
                     decay_steps: int = 0, warmup_steps: int = 0
                     ) -> Union[float, Schedule]:
    """LR schedule factory: 'constant' returns the plain float, the others a
    function of the number of updates already made."""
    if schedule == 'constant':
        return learning_rate
    if decay_steps <= 0:
        raise ValueError(f'--lr-schedule {schedule} requires '
                         f'--lr-decay-steps > 0 (total steps to decay over)')

    def cosine(count: int, steps: int) -> float:
        count = min(count, steps)
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * count / steps))

    if schedule == 'cosine':
        return lambda count: cosine(count, decay_steps)
    if schedule == 'warmup_cosine':
        # linear 0 -> lr over the warm-up, then a cosine over the REST of
        # decay_steps (which includes the warm-up)
        warm = max(1, warmup_steps)
        return lambda count: (learning_rate * count / warm if count < warm
                              else cosine(count - warm, decay_steps - warm))
    if schedule == 'linear':
        return lambda count: learning_rate * (
            1.0 - min(max(count, 0), decay_steps) / decay_steps)
    raise ValueError(f'unknown lr schedule {schedule!r}; expected one of '
                     f'{LR_SCHEDULES}')


# per-parameter state tensors of each rule, with their initial values
_STATE = {
    'sgd': {}, 'rmsprop': {'nu': 0.0}, 'adagrad': {'sum': 0.1},
    'adam': {'mu': 0.0, 'nu': 0.0}, 'adamw': {'mu': 0.0, 'nu': 0.0},
    'adamax': {'mu': 0.0, 'nu': 0.0}, 'adadelta': {'e_g': 0.0, 'e_x': 0.0},
}
_COUNTED = ('adam', 'adamw', 'adamax')      # rules with bias correction


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` rounded as optax rounds it, in float32: at
    ``decay`` 0.999 and ``count`` 1 that is 1.3e-5 away from the exact value,
    which an update-for-update comparison sees."""
    return float(np.float32(1) - np.power(np.float32(decay), np.float32(count)))


class Optimizer(torch.optim.Optimizer):
    """optax's update rules over named parameters.

    ``step()`` clips the gradients' global norm (when asked to), applies the
    rule to every parameter that has a gradient and is not frozen, and
    counts the update. It is three parts, which a captured step calls apart:
    :meth:`next_scalars` (host: the step-dependent values of the next
    update), :meth:`update` (device: the rule, reading those values from
    :attr:`scalars`) and :meth:`advance` (host: count the update).
    ``state_dict()`` is ``torch.optim.Optimizer``'s: the per-parameter
    tensors, and in the one parameter group ``count`` (only for rules with
    bias correction or a schedule).
    """

    # the step-dependent values an update reads: learning rate, then the
    # bias corrections 1 - 0.9**count and 1 - 0.999**count (1 where unused)
    N_SCALARS = 3

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 opt_type: str, learning_rate: Union[float, Schedule],
                 weight_decay: float = 1e-4, grad_clip_norm: float = 0.0):
        if opt_type not in OPT_TYPES:
            raise ValueError(f'unknown optimizer {opt_type!r}; expected one of '
                             f'{OPT_TYPES}')
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.opt_type = opt_type
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.frozen: set = set()
        # global_norm(names, grads) -> the clipped global norm of the
        # gradients (None: theirs; a pipeline stage's adds the other stages')
        self.global_norm: Optional[Callable[[List[str], List[torch.Tensor]],
                                            torch.Tensor]] = None
        # float32 [N_SCALARS] beside the parameters, made at the first update
        self.scalars: Optional[torch.Tensor] = None
        group: Dict = {'params': [p for _, p in named]}
        if callable(learning_rate) or opt_type in _COUNTED:
            group['count'] = 0
        super().__init__([group], {})

    def current_lr(self, ahead: int = 0) -> float:
        """The learning rate of the next update (of the one ``ahead``
        updates after it)."""
        lr = self.learning_rate
        return lr(self.param_groups[0]['count'] + ahead) if callable(lr) else lr

    def next_scalars(self, ahead: int = 0) -> np.ndarray:
        """The :attr:`scalars` of the next update (of the one ``ahead``
        updates after it), float32 on the host."""
        out = np.ones(self.N_SCALARS, np.float32)
        out[0] = self.current_lr(ahead)
        if self.opt_type in _COUNTED:
            count = self.param_groups[0]['count'] + 1 + ahead
            out[1] = _bias_correction(0.9, count)
            out[2] = _bias_correction(0.999, count)
        return out

    def scalars_on(self, device) -> torch.Tensor:
        """:attr:`scalars`, made on ``device`` the first time."""
        if self.scalars is None:
            self.scalars = torch.ones(self.N_SCALARS, dtype=torch.float32, device=device)
        return self.scalars

    def advance(self) -> None:
        """Count one update."""
        group = self.param_groups[0]
        if 'count' in group:
            group['count'] += 1

    def _state_lists(self, params: Sequence[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
        lists: Dict[str, List[torch.Tensor]] = {k: [] for k in _STATE[self.opt_type]}
        for p in params:
            st = self.state[p]
            for key, init in _STATE[self.opt_type].items():
                if key not in st:
                    st[key] = torch.full_like(p, init)
                lists[key].append(st[key])
        return lists

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError('closures are not supported')
        params = self.param_groups[0]['params']
        if not any(p.grad is not None for p in params):
            return None
        scalars = self.scalars_on(params[0].device)
        # no wait for the device: the copy leaves from pageable memory
        scalars.copy_(torch.from_numpy(self.next_scalars()), non_blocking=True)
        self.update()
        self.advance()
        return None

    @torch.no_grad()
    def update(self) -> None:
        """Apply the rule on the device with the step-dependent values in
        :attr:`scalars`; the host neither reads nor counts anything."""
        group = self.param_groups[0]
        with_grad = [(n, p) for n, p in zip(self.names, group['params'])
                     if p.grad is not None]
        if not with_grad:
            return
        grads = [p.grad for _, p in with_grad]
        if self.grad_clip_norm and self.grad_clip_norm > 0:
            # optax.clip_by_global_norm, over frozen parameters too
            norm = (self.global_norm([n for n, _ in with_grad], grads)
                    if self.global_norm is not None else
                    torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))))
            scale = self.grad_clip_norm / torch.clamp(norm, min=self.grad_clip_norm)
            grads = torch._foreach_mul(grads, scale)
        keep = [i for i, (n, _) in enumerate(with_grad) if n not in self.frozen]
        params = [with_grad[i][1] for i in keep]
        g = [grads[i] for i in keep]
        lr, bc1, bc2 = self.scalars_on(with_grad[0][1].device).unbind()
        st = self._state_lists(params)
        kind = self.opt_type
        # every rule ends params -= lr * update, as optax scales by -lr last
        if kind == 'sgd':
            update = torch._foreach_mul(g, lr)
        elif kind == 'rmsprop':
            torch._foreach_mul_(st['nu'], 0.99)
            torch._foreach_addcmul_(st['nu'], g, g, value=1 - 0.99)
            denom = torch._foreach_sqrt(st['nu'])
            torch._foreach_add_(denom, 1e-8)
            update = torch._foreach_div(g, denom)
            torch._foreach_mul_(update, lr)
        elif kind == 'adagrad':
            torch._foreach_addcmul_(st['sum'], g, g)
            denom = torch._foreach_add(st['sum'], 1e-7)
            torch._foreach_sqrt_(denom)
            update = torch._foreach_div(g, denom)
            torch._foreach_mul_(update, lr)
        elif kind in ('adam', 'adamw'):
            torch._foreach_mul_(st['mu'], 0.9)
            torch._foreach_add_(st['mu'], g, alpha=1 - 0.9)
            torch._foreach_mul_(st['nu'], 0.999)
            torch._foreach_addcmul_(st['nu'], g, g, value=1 - 0.999)
            denom = torch._foreach_div(st['nu'], bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, 1e-8)
            update = torch._foreach_div(st['mu'], bc1)
            torch._foreach_div_(update, denom)
            if kind == 'adamw':
                torch._foreach_add_(update, params, alpha=self.weight_decay)
            torch._foreach_mul_(update, lr)
        elif kind == 'adamax':
            torch._foreach_mul_(st['mu'], 0.9)
            torch._foreach_add_(st['mu'], g, alpha=1 - 0.9)
            torch._foreach_mul_(st['nu'], 0.999)
            mag = torch._foreach_abs(g)
            torch._foreach_add_(mag, 1e-8)
            torch._foreach_maximum_(st['nu'], mag)
            update = torch._foreach_div(st['mu'], bc1)
            torch._foreach_div_(update, st['nu'])
            torch._foreach_mul_(update, lr)
        elif kind == 'adadelta':
            torch._foreach_mul_(st['e_g'], 0.9)
            torch._foreach_addcmul_(st['e_g'], g, g, value=1 - 0.9)
            num = torch._foreach_add(st['e_x'], 1e-6)
            torch._foreach_sqrt_(num)
            den = torch._foreach_add(st['e_g'], 1e-6)
            torch._foreach_sqrt_(den)
            torch._foreach_div_(num, den)
            update = torch._foreach_mul(num, g)
            torch._foreach_mul_(st['e_x'], 0.9)
            torch._foreach_addcmul_(st['e_x'], update, update, value=1 - 0.9)
            torch._foreach_mul_(update, lr)
        torch._foreach_sub_(params, update)


def make_optimizer(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                   opt_type: str,
                   learning_rate: Union[float, Schedule],
                   lr_schedule: str = 'constant',
                   lr_decay_steps: int = 0,
                   lr_warmup_steps: int = 0,
                   weight_decay: float = 1e-4,
                   grad_clip_norm: float = 0.0) -> Optimizer:
    """The optimizer over ``named_params`` (``model.named_parameters()``).
    ``weight_decay`` applies to 'adamw' only; ``grad_clip_norm > 0`` clips
    the global norm before the update."""
    if isinstance(learning_rate, float):
        learning_rate = make_lr_schedule(lr_schedule, learning_rate,
                                         lr_decay_steps, lr_warmup_steps)
    return Optimizer(named_params, opt_type, learning_rate,
                     weight_decay=weight_decay, grad_clip_norm=grad_clip_norm)


def wrap_freeze(optimizer: Optimizer, patterns: Sequence[str]) -> Optimizer:
    """Freeze parameters for transfer learning (``--freeze-params``): a
    parameter whose name (as in ``model.named_parameters()``) matches one of
    the ``patterns`` regexes gets no update, so it stays bitwise at its
    value; its gradient still counts in the clipped global norm. A pattern
    that matches no parameter raises with the available names."""
    pats = [re.compile(p) for p in patterns]
    unmatched = [p.pattern for p in pats
                 if not any(p.search(n) for n in optimizer.names)]
    if unmatched:
        raise ValueError(f'--freeze-params pattern(s) {unmatched} match no '
                         f'parameter; available names: {sorted(optimizer.names)}')
    optimizer.frozen = {n for n in optimizer.names
                        if any(p.search(n) for p in pats)}
    return optimizer
