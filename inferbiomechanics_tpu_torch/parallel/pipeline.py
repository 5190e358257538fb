"""Pipeline parallelism for the transformer (GPipe), one rank a stage.

PyTorch counterpart of ``inferbiomechanics_tpu/parallel/pipeline.py``. The
ranks are laid out as the JAX package lays its devices out
(``parallel/mesh.py::make_pipeline_mesh``: (``data``, ``pipe``), ``pipe``
consecutive ranks a pipeline). The encoder's L blocks are split into S
stages of L / S consecutive blocks, stage s on the rank at ``pipe`` s; the
rest of the model (input projection, temporal embedding, final LayerNorm and
heads: "the rest") is replicated on every rank of the pipeline.

The JAX package runs the schedule as one SPMD program (a ``lax.scan`` of
M + S - 1 ticks, ``ppermute`` between stages, ``jax.grad`` for the reverse
pipeline). Here each rank runs its stage eagerly: the local batch is cut
into M microbatches (default 2 S); stage 0 embeds each, every stage runs its
blocks on it and sends the [mb, T, d] bf16 activation to the next stage
(``parallel/dist.py::send`` / ``recv``: NCCL device to device; gloo through
host memory), so the stages work on different microbatches at once. The
last stage joins the M outputs and computes the loss over the whole local
batch (not a mean of per-microbatch losses, as in JAX), and its backward
sends each microbatch's input gradient back the same way, stage by stage.

Gradients: a stage's blocks' stay on its rank; the rest's (the embedding's
from stage 0, the tail's from the last stage, none elsewhere) are summed
over the pipeline, so its replicas stay identical (the transpose of their
broadcast in JAX), and the last stage's metrics go to every rank of the
pipeline in the same float32 collective. Then the state's data-parallel
all-reduce (``dist.GradAllReduce``, over the ``data`` axis) averages all of
it, and the optimizer updates the rank's own parameters; a global-norm clip
adds the other stages' squared norms (``Optimizer.global_norm``).
Augmentation runs on the local batch before the split, on every rank of the
pipeline with the same draws (the plain step's), so stage 0's inputs and the
last stage's labels agree.

Every rank holds the canonical model (``TransformerRegressor``, the JAX
package's canonical tree), of which it trains its own blocks and the rest;
:func:`pipeline_trainstate_from_canonical` makes a canonical train state
(fresh, or loaded from a checkpoint) the rank's stage, and
:func:`canonical_trainstate_from_pipeline` gathers every stage's blocks (and
their optimizer moments) over the pipeline back into it, on every rank: the
training loop does so before a dev evaluation (parameters, once a state) and
before a checkpoint (parameters and moments), so that checkpoints are always
canonical and ``serve``, ``analyze``, resume and ``convert-checkpoint`` read
them unchanged. :func:`to_pipeline_params` / :func:`to_canonical_params` are
the JAX package's layouts of a parameter-shaped tree (``{'stages': each
block parameter stacked on a leading [L] axis, 'rest': ...}``), which the
gather goes through.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from inferbiomechanics_tpu_torch.data.dataset import unpack
from inferbiomechanics_tpu_torch.loss.evaluator import LossConfig, loss_and_metrics
from inferbiomechanics_tpu_torch.parallel import dist
from inferbiomechanics_tpu_torch.parallel.mesh import (
    DATA_AXIS, PIPE_AXIS, Layout, make_pipeline_mesh,
)
from inferbiomechanics_tpu_torch.train.augment import Augmenter, maybe_augment
from inferbiomechanics_tpu_torch.train.optimizers import _STATE
from inferbiomechanics_tpu_torch.train.state import TrainState, create_train_state
from inferbiomechanics_tpu_torch.train.step import MetricLayout, aug_draws_of, as_train_step

_BLOCK_RE = re.compile(r'blocks\.(\d+)\.(.+)')
_DT = torch.bfloat16
# the JAX train loop's words for a pallas tree, which has no blocks to split
PALLAS_REFUSAL = ("--pipeline-parallel supports attn_impl 'vpu'/'flax' only (pallas "
                  "checkpoints store flat enc{i}_* params the stage converters cannot "
                  "restructure)")


@dataclass(frozen=True)
class StagePlan:
    """Where this rank sits in the pipeline of a ``num_layers`` encoder
    over ``layout`` (``make_pipeline_mesh``'s)."""
    layout: Layout
    num_layers: int

    @property
    def n_stages(self) -> int:
        return self.layout.size(PIPE_AXIS)

    @property
    def n_dp(self) -> int:
        return self.layout.size(DATA_AXIS)

    @property
    def stage(self) -> int:
        return self.layout.coord(PIPE_AXIS)

    @property
    def layers_per_stage(self) -> int:
        return self.num_layers // self.n_stages

    @property
    def layers(self) -> range:
        k = self.layers_per_stage
        return range(self.stage * k, (self.stage + 1) * k)

    @property
    def pipe_group(self) -> Optional[dist.Group]:
        return self.layout.group(PIPE_AXIS)

    @property
    def data_group(self) -> Optional[dist.Group]:
        return self.layout.group(DATA_AXIS)

    def rank_of(self, stage: int) -> int:
        """The rank of ``stage`` in this rank's pipeline."""
        return self.layout.rank_at({DATA_AXIS: self.layout.coord(DATA_AXIS),
                                    PIPE_AXIS: stage})

    def owns(self, name: str) -> bool:
        """True for a parameter this rank trains: its stage's blocks and
        the rest."""
        m = _BLOCK_RE.fullmatch(name)
        return m is None or int(m.group(1)) in self.layers


def make_stage_plan(num_layers: int, pipe: int) -> StagePlan:
    """The plan of ``make_pipeline_mesh(pipe)`` (the JAX refusal of a world
    ``pipe`` does not divide)."""
    return StagePlan(make_pipeline_mesh(pipe), num_layers)


# -- layouts: canonical names <-> {stages: [L, ...], rest} ------------------------------


def to_pipeline_params(named: Mapping[str, torch.Tensor], num_layers: int) -> Dict:
    """A canonical parameter-shaped tree (the transformer's names ->
    tensors: parameters, optimizer moments, gradients) -> ``{'stages':
    {block parameter name: its L blocks stacked on a leading [L] axis},
    'rest': everything else}``, the JAX package's pipeline layout."""
    stages: Dict[str, List[torch.Tensor]] = {}
    rest = {}
    for name, t in named.items():
        m = _BLOCK_RE.fullmatch(name)
        if m is None:
            rest[name] = t
        else:
            stages.setdefault(m.group(2), [None] * num_layers)[int(m.group(1))] = t
    return {'stages': {k: torch.stack(v) for k, v in stages.items()}, 'rest': rest}


def to_canonical_params(pp: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`to_pipeline_params`."""
    out = dict(pp['rest'])
    for i in range(num_layers):
        for k, v in pp['stages'].items():
            out[f'blocks.{i}.{k}'] = v[i]
    return out


def _global_norm(plan: StagePlan) -> Callable:
    """``Optimizer.global_norm`` for a stage: the rest's squared norm once,
    plus every stage's blocks' squared norm (summed over the pipeline)."""
    def squares(grads: List[torch.Tensor]) -> torch.Tensor:
        return torch.stack(torch._foreach_norm(grads)).square().sum().reshape(1)

    def norm(names: List[str], grads: List[torch.Tensor]) -> torch.Tensor:
        blocks = [_BLOCK_RE.fullmatch(n) is not None for n in names]
        stage = dist.sum_over_ranks(squares([g for g, b in zip(grads, blocks) if b]),
                                    plan.pipe_group)
        return torch.sqrt(stage + squares([g for g, b in zip(grads, blocks) if not b]))[0]
    return norm


def pipeline_trainstate_from_canonical(state: TrainState, plan: StagePlan) -> TrainState:
    """Make a canonical train state (fresh, or loaded from a checkpoint)
    this rank's stage, in place: the other stages' blocks take no gradient
    and their optimizer moments are let go (their ranks keep them), and a
    global-norm clip spans the pipeline. Returns the state."""
    opt = state.optimizer
    for name, p in state.model.named_parameters():
        p.requires_grad_(plan.owns(name))
        if not plan.owns(name):
            opt.state.pop(p, None)
    if plan.n_stages > 1:
        opt.global_norm = _global_norm(plan)
    return state


def canonical_trainstate_from_pipeline(state: TrainState, plan: StagePlan,
                                       optimizer: bool = True) -> TrainState:
    """Gather every stage's blocks over the pipeline into the canonical
    state, on every rank of it (a collective: every rank calls it at the
    same point): the parameters and, with ``optimizer``, their optimizer
    moments. Each tree goes through the JAX layout: the stage's blocks
    stacked (:func:`to_pipeline_params`), the stages' stacks gathered and
    joined on the [L] axis, then unstacked (:func:`to_canonical_params`).
    Returns the state, whole; each rank still trains its own stage."""
    if plan.n_stages == 1:
        return state
    model, opt = state.model, state.optimizer
    params = dict(model.named_parameters())
    names = [n for n in params if _BLOCK_RE.fullmatch(n) and plan.owns(n)]
    first, k = plan.layers[0], plan.layers_per_stage

    def local(tree: Mapping[str, torch.Tensor]) -> Dict:
        """The stage's blocks renumbered from 0, stacked."""
        renamed = {}
        for n, t in tree.items():
            m = _BLOCK_RE.fullmatch(n)
            renamed[f'blocks.{int(m.group(1)) - first}.{m.group(2)}'] = t
        return to_pipeline_params(renamed, k)['stages']

    # every stage sends every moment of the rule, a parameter without one
    # yet (before its first update, or frozen) its initial value
    inits = _STATE[opt.opt_type] if optimizer else {}
    keys = sorted(inits)
    trees = [local({n: params[n].detach() for n in names})]
    trees += [local({n: opt.state.get(params[n], {}).get(
        key, torch.full_like(params[n], inits[key])) for n in names}) for key in keys]
    flat = torch.cat([t.reshape(-1).float() for tree in trees for t in tree.values()])
    parts = dist.all_gather(flat, plan.pipe_group)
    with torch.no_grad():
        for j, tree in enumerate(trees):
            stacks = {}
            for at_stage, part in enumerate(parts):
                at = sum(t.numel() for tr in trees[:j] for t in tr.values())
                for name, t in tree.items():
                    piece = part[at:at + t.numel()].view(t.shape).to(t.dtype)
                    stacks.setdefault(name, []).append(t if at_stage == plan.stage else piece)
                    at += t.numel()
            whole = to_canonical_params({'stages': {n: torch.cat(v) for n, v in stacks.items()},
                                         'rest': {}}, plan.num_layers)
            for n, t in whole.items():
                if plan.owns(n):
                    continue
                if j == 0:
                    params[n].copy_(t)
                else:
                    opt.state.setdefault(params[n], {})[keys[j - 1]] = t.clone()
    return state


def create_pipeline_state(model, optimizer, plan: StagePlan) -> TrainState:
    """A train state of ``model`` and ``optimizer`` as this rank's stage."""
    return pipeline_trainstate_from_canonical(create_train_state(model, optimizer), plan)


# -- the schedule ---------------------------------------------------------------------


def _check(model, plan: StagePlan, batch: int, num_micro: int) -> None:
    """The JAX package's refusals (``batch`` is the global batch: the local
    one times the ``data`` axis); a ``pallas`` tree with the JAX train
    loop's words."""
    n_stages, n_dp = plan.n_stages, plan.n_dp
    if model.attn_impl == 'pallas':
        raise ValueError(PALLAS_REFUSAL)
    if model.num_layers % n_stages:
        raise ValueError(f'num_layers={model.num_layers} not divisible by '
                         f'pipe={n_stages}')
    if getattr(model, 'dropout', 0.0):
        raise ValueError('pipeline parallelism requires dropout == 0 '
                         '(stages run without per-layer RNG plumbing)')
    if batch % (n_dp * num_micro):
        raise ValueError(f'batch {batch} not divisible by data axis '
                         f'({n_dp}) x microbatches ({num_micro})')


def _stage_fn(model, plan: StagePlan, remat: bool) -> Callable:
    """This rank's blocks (``remat``: recomputed in the backward,
    ``torch.utils.checkpoint``)."""
    blocks = [model.blocks[i] for i in plan.layers]

    def stage(h: torch.Tensor) -> torch.Tensor:
        for blk in blocks:
            h = blk(h)
        return h

    if remat:
        return lambda h: checkpoint(stage, h, use_reentrant=False)
    return stage


def _run_forward(model, plan: StagePlan, stage: Callable, inputs: torch.Tensor,
                 num_micro: int, keep_inputs: bool):
    """The forward half of the schedule: each microbatch embedded (stage 0)
    or received from the previous stage, run through this stage and sent on.
    Returns [(input, output)] per microbatch; a received input is a leaf
    that takes its gradient when ``keep_inputs``."""
    s, n = plan.stage, plan.n_stages
    mb = inputs.shape[0] // num_micro
    shape = (mb, model.num_frames, model.d_model)
    saved = []
    for m in range(num_micro):
        if s == 0:
            inp = model.embed(inputs[m * mb:(m + 1) * mb])
        else:
            inp = dist.recv(shape, _DT, plan.rank_of(s - 1), inputs.device)
            inp.requires_grad_(keep_inputs)
        out = stage(inp)
        if s < n - 1:
            dist.send(out, plan.rank_of(s + 1))
        saved.append((inp, out))
    return saved


def make_pipeline_forward(model, plan: StagePlan, num_microbatches: Optional[int] = None,
                          remat: bool = False) -> Callable:
    """``forward(x) -> outputs`` through the pipeline (eval): ``x`` is the
    rank's local batch [B, T, C_in] (the same on every rank of a pipeline);
    the last stage's outputs are broadcast to every rank of the pipeline."""
    num_micro = num_microbatches or 2 * plan.n_stages
    stage = _stage_fn(model, plan, remat)

    @torch.no_grad()
    def forward(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        _check(model, plan, x.shape[0] * plan.n_dp, num_micro)
        model.eval()
        saved = _run_forward(model, plan, stage, x, num_micro, keep_inputs=False)
        last = plan.n_stages - 1
        h = (torch.cat([out for _, out in saved]) if plan.stage == last
             else torch.zeros(x.shape[0], model.num_frames, model.d_model, dtype=_DT,
                              device=x.device))
        h = dist.broadcast_from(h, plan.rank_of(last), plan.pipe_group)
        return model.tail(h)

    return forward


def make_pipeline_train_step(model, lab_offsets: Dict[str, Tuple[int, int]],
                             loss_config: LossConfig, plan: StagePlan,
                             num_microbatches: Optional[int] = None, remat: bool = False,
                             augment: Optional[Augmenter] = None) -> Callable:
    """Build ``step(state, inputs, labels) -> metrics`` for this rank's
    stage (``state`` from :func:`create_pipeline_state` or
    :func:`pipeline_trainstate_from_canonical`, updated in place): the
    state's per-step generators reseeded, augmentation, the GPipe forward
    and backward over the pipeline, the rest's gradients summed over it with
    the metrics, the state's ``data`` all-reduce, the update. ``inputs`` and
    ``labels`` are the rank's local batch, the same on every rank of a
    pipeline; the metrics come back on every rank."""
    num_micro = num_microbatches or 2 * plan.n_stages
    stage = _stage_fn(model, plan, remat)
    s, last = plan.stage, plan.n_stages - 1
    rest = [p for n, p in model.named_parameters() if _BLOCK_RE.fullmatch(n) is None]
    layouts: Dict[Tuple[int, ...], MetricLayout] = {}

    def metric_layout(labels) -> MetricLayout:
        """The metrics' names and shapes, probed once a batch shape (the
        tail on zeros; no collective)."""
        key = tuple(labels.shape)
        if key not in layouts:
            with torch.no_grad():
                h = torch.zeros(labels.shape[0], model.num_frames, model.d_model, dtype=_DT,
                                device=labels.device)
                _, probe = loss_and_metrics(model.tail(h), unpack(labels, lab_offsets),
                                            loss_config)
            layouts[key] = MetricLayout(probe)
        return layouts[key]

    def grads(state: TrainState, batch_inputs: torch.Tensor,
              batch_labels: torch.Tensor):
        _check(model, plan, batch_inputs.shape[0] * plan.n_dp, num_micro)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        inputs, labels = maybe_augment(augment, batch_inputs, batch_labels,
                                       aug_draws_of(state, None))
        saved = _run_forward(model, plan, stage, inputs, num_micro, keep_inputs=True)
        mb = inputs.shape[0] // num_micro
        layout = metric_layout(labels)
        if s == last:
            outputs = model.tail(torch.cat([out for _, out in saved]))
            loss, metrics = loss_and_metrics(outputs, unpack(labels, lab_offsets), loss_config)
            loss.backward()
            mflat = layout.flatten(metrics)
            if s > 0:
                for m in reversed(range(num_micro)):
                    dist.send(saved[m][0].grad, plan.rank_of(s - 1))
        else:
            shape = (mb, model.num_frames, model.d_model)
            for m in reversed(range(num_micro)):
                g = dist.recv(shape, _DT, plan.rank_of(s + 1), inputs.device)
                inp, out = saved[m]
                out.backward(g)
                if s > 0:
                    dist.send(inp.grad, plan.rank_of(s - 1))
            mflat = torch.zeros(sum(math.prod(shape) for _, shape in layout.items),
                                device=inputs.device)
        if plan.n_stages == 1:
            return layout.split(mflat)
        with torch.no_grad():
            rest_grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in rest]
            sizes = [g.numel() for g in rest_grads]
            flat = dist.sum_over_ranks(
                torch.cat([g.reshape(-1).float() for g in rest_grads] + [mflat]),
                plan.pipe_group)
            for p, part in zip(rest, flat[:sum(sizes)].split(sizes)):
                p.grad = part.view_as(p).to(p.dtype)
        return layout.split(flat[sum(sizes):])

    return as_train_step(grads)


__all__ = ['PIPE_AXIS', 'StagePlan', 'canonical_trainstate_from_pipeline',
           'create_pipeline_state', 'make_pipeline_forward', 'make_pipeline_mesh',
           'make_pipeline_train_step', 'make_stage_plan', 'pipeline_trainstate_from_canonical',
           'to_canonical_params', 'to_pipeline_params']
