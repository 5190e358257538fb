"""Hyperparameter sweeps: an lr x seed grid of K configs trained together.

PyTorch counterpart of ``inferbiomechanics_tpu/train/sweep.py``. The reference sweeps hyperparameters as bash loops over sbatch, one
training job a point (reference ``src/slurm/slurm_loop.sh:13-22``); here
every config of one model shape trains at once: a step gathers (or takes
from the host) ONE batch, augments it once from the sweep's own generator,
and runs each config's forward, loss and backward on it, then every
config's optimizer update. The JAX package ``vmap``s its step over a config
axis; here the K configs are a loop inside the step's body, and the body is
captured as ONE CUDA graph a step shape and replayed in chunks
(``train/step.py::ChunkedStep``), so the K configs' launches cost no host
time. The fused kernels take one weight set each, and with the loop config
i of a K-config sweep is bitwise a one-config sweep of (lr_i, seed_i).

Sweepable axes (shape-preserving): learning rate x init seed. Each config's
model is initialised from its own seed as ``train --seed s`` initialises
it, and its dropout masks come from its own generator, reseeded from its
seed and the step count. Shape-changing axes (hidden dims) run as an outer
sequential loop in ``cli/sweep_cmd.py``.

The exact-lr rule: every optimizer's update is linear in the learning rate,
which is no part of the optimizer's state (``train/optimizers.py``: ``params
-= lr * update``, lr read from the device tensor ``Optimizer.scalars``). So
a config's learning rate is one number its optimizer reads each step;
population-based training (PBT) changes it there (:func:`set_learning_rate`)
and never recaptures. A schedule other than constant is refused, as in the
JAX package.

Resume: the grid's state (each config's parameters, optimizer state and
step) is written after every epoch under ``<checkpoint_dir>/_grid/``, with
``sweep_state.json`` (the host-side trackers), written atomically and pruned
to two; the same sweep command resumes at the next epoch when the grid
matches, and starts fresh with a warning when it does not.

Over several ranks (one rank a JAX device; ``parallel/mesh.py``), as the
JAX sweep spreads over its mesh (:func:`sweep_placement`):

- ``--shard-configs``: rank r of n owns configs [r K/n, (r+1) K/n) (the
  block ``PartitionSpec('data')`` gives device r) and builds only their
  models and optimizers; every rank draws the same batches and augmentation
  and its captured step loops over its own configs, with no collective.
  When n does not divide K every rank runs all K configs (the JAX
  warning).
- ``--device-data sharded``: the configs replicated, the trials split over
  the ranks (``train/sharded_data.py``), each rank gathering its B / n
  windows from its own shard, and one flat all-reduce of every config's
  gradients a step.
- both: ``make_sweep_mesh``'s (config, data) layout; the config blocks
  over ``config`` and the trials over ``data`` (the same shard in every
  ``config`` row), the all-reduce over ``data`` only.

Every rank holds the host-side trackers: the dev losses of each dev eval,
and the last train losses, are gathered from the ranks, so that every rank
ranks, stops early and decides PBT alike; a PBT exploit between configs of
two ranks moves the winner's parameters and optimizer state from one to
the other. The rank at ``data`` coordinate 0 of a config's block writes
its files (best and final checkpoints, ``_grid/config_{i}``); rank 0 writes
``sweep_state.json`` once every config's checkpoint is on disk, so a grid
written at one world size resumes at another.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset, unpack
from inferbiomechanics_tpu_torch.data.loader import PrefetchLoader
from inferbiomechanics_tpu_torch.loss.evaluator import LossConfig, loss_and_metrics
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.models.common import generator_masks, pack_inputs
from inferbiomechanics_tpu_torch.models.diffusion import (
    DDPMSchedule, TrainDraws, diffusion_targets_from_labels, drop_conditioning,
    generator_draws, target_scales,
)
from inferbiomechanics_tpu_torch.models.norm import BatchNorm
from inferbiomechanics_tpu_torch.parallel import dist
from inferbiomechanics_tpu_torch.parallel.mesh import (
    CONFIG_AXIS, DATA_AXIS, Layout, make_sweep_mesh, sweep_layout,
)
from inferbiomechanics_tpu_torch.train.augment import (
    AugmentDraws, Augmenter, augmenter_from_config, maybe_augment,
)
from inferbiomechanics_tpu_torch.train.checkpoint import (
    BEST_NAME, checkpoint_name, load_checkpoint_file, prune_checkpoints, save_checkpoint,
)
from inferbiomechanics_tpu_torch.train.device_data import SegmentBuffer
from inferbiomechanics_tpu_torch.train.loop import (
    SigtermStop, check_tier_options, epoch_batches, loss_config_from,
    make_dispatch, resident_train_data, run_chunks, train_loader, upload_dtype,
)
from inferbiomechanics_tpu_torch.train.optimizers import Optimizer, make_optimizer
from inferbiomechanics_tpu_torch.train.run_config import save_run_config
from inferbiomechanics_tpu_torch.train.sharded_data import ShardedDeviceData, ShardedEpoch
from inferbiomechanics_tpu_torch.train.state import AUG_SEED_SALT, TrainState
from inferbiomechanics_tpu_torch.train.step import (
    ChunkedStep, Metrics, as_train_step, aug_draws_of,
)
from inferbiomechanics_tpu_torch.train.streaming_data import (
    StreamingEpoch, StreamingPlan, host_seed_for, metrics_on_host, segment_trainer,
    streaming_windows_per_epoch,
)

logger = logging.getLogger(__name__)

GRID_DIR = '_grid'
SIDE_NAME = 'sweep_state.json'
# the fixed noising of the diffusion sweep's dev score (the JAX package
# uses PRNGKey(123) for every dev batch)
EVAL_NOISE_SEED = 123


@dataclass
class SweepPoint:
    """One config of the sweep grid and its outcome."""
    index: int
    learning_rate: float
    seed: int
    final_dev_loss: Optional[float] = None
    final_train_loss: Optional[float] = None
    checkpoint_path: Optional[str] = None
    best_dev_loss: Optional[float] = None     # min over per-epoch evals
    best_epoch: Optional[int] = None
    dev_curve: Optional[List[float]] = None   # dev loss after each epoch
    final_learning_rate: Optional[float] = None   # != learning_rate under PBT
    best_checkpoint_path: Optional[str] = None    # params at best_epoch


@dataclass
class SweepResult:
    points: List[SweepPoint] = field(default_factory=list)
    best_index: int = -1
    windows_per_sec: float = 0.0   # aggregate over all configs
    pbt_events: List[dict] = field(default_factory=list)
    preempted: bool = False        # SIGTERM: grid state saved, then exit

    @property
    def best(self) -> SweepPoint:
        return self.points[self.best_index]

    def to_json(self) -> str:
        return json.dumps({
            'points': [vars(p) for p in self.points],
            'best_index': self.best_index,
            'windows_per_sec': self.windows_per_sec,
            'pbt_events': self.pbt_events,
            'preempted': self.preempted,
        }, indent=2)


def sweep_grid(lrs: Sequence[float], seeds: Sequence[int]) -> List[Tuple[float, int]]:
    """Cartesian lr x seed grid, lr-major (the reference's nested bash
    loops, slurm_loop.sh:17-22)."""
    return list(itertools.product([float(v) for v in lrs], [int(s) for s in seeds]))


# ---------------------------------------------------------------------------
# The stacked state
# ---------------------------------------------------------------------------


def set_learning_rate(optimizer: Optimizer, lr: float) -> None:
    """The exact-lr rule: a constant learning rate is one float32 number the
    update reads from ``optimizer.scalars`` each step (``params -= lr *
    update``), so setting it changes the next update, and only its scale,
    with nothing recaptured."""
    if callable(optimizer.learning_rate):
        raise ValueError('a scheduled learning rate cannot be set')
    optimizer.learning_rate = float(np.float32(lr))


class SweepOptimizer:
    """K configs' optimizers as one, for a captured step: ``scalars`` is
    one float32 device tensor of K rows of :attr:`Optimizer.N_SCALARS`
    values, each optimizer reading its own row (a view); ``next_scalars``,
    ``update``, ``advance`` and ``step`` do the K optimizers' in config
    order."""

    def __init__(self, optimizers: Sequence[Optimizer]):
        self.optimizers = list(optimizers)
        self.scalars: Optional[torch.Tensor] = None

    def scalars_on(self, device) -> torch.Tensor:
        if self.scalars is None:
            n = Optimizer.N_SCALARS
            self.scalars = torch.ones(n * len(self.optimizers), dtype=torch.float32,
                                      device=device)
            for k, opt in enumerate(self.optimizers):
                opt.scalars = self.scalars[k * n:(k + 1) * n]
        return self.scalars

    def next_scalars(self, ahead: int = 0) -> np.ndarray:
        return np.concatenate([o.next_scalars(ahead) for o in self.optimizers])

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=set_to_none)

    def update(self) -> None:
        for opt in self.optimizers:
            opt.update()

    def advance(self) -> None:
        for opt in self.optimizers:
            opt.advance()

    def step(self) -> None:
        device = self.optimizers[0].param_groups[0]['params'][0].device
        self.scalars_on(device)
        for opt in self.optimizers:
            opt.step()


class SweepState:
    """The K configs' train states, stepped together.

    A duck-typed :class:`TrainState` for the step builders and
    ``train/step.py``'s captured step: ``model`` (the K models as one
    ``nn.ModuleList``, so ``train()`` reaches them all), ``optimizer`` (a
    :class:`SweepOptimizer`), ``step``, and the per-step generators: each
    config's dropout generator (reseeded from the config's seed and the
    step count, as ``train --seed s`` reseeds its own), the sweep's
    augmentation generator and, for diffusion, its draws' generator (both
    reseeded from ``--seed`` and the step count, and shared by every
    config). ``configs`` are the states' indices in the grid (this rank's
    block of it under ``--shard-configs``)."""

    def __init__(self, states: Sequence[TrainState], seed: int,
                 configs: Optional[Sequence[int]] = None):
        self.states = list(states)
        self.configs = list(range(len(self.states)) if configs is None else configs)
        self.model = nn.ModuleList([s.model for s in self.states])
        self.optimizer = SweepOptimizer([s.optimizer for s in self.states])
        self.step = 0
        self.dropout_seed = seed
        self.dropout_gen: Optional[torch.Generator] = None    # shared draws (diffusion)
        self.aug_gen: Optional[torch.Generator] = None
        self.ema = None
        self.grad_sync: Optional[Callable] = None     # the sharded tier's all-reduce
        self.draw_shard: Optional[Tuple[int, int]] = None

    def local(self, i: int) -> int:
        """The state index of grid config ``i``."""
        return self.configs.index(i)

    @property
    def models(self) -> List[nn.Module]:
        return [s.model for s in self.states]

    def generators(self) -> List[torch.Generator]:
        own = [g for g in (self.dropout_gen, self.aug_gen) if g is not None]
        return own + [g for s in self.states for g in s.generators()]

    def reseed_generators(self) -> None:
        seed = self.dropout_seed * 1_000_003 + self.step
        if self.dropout_gen is not None:
            self.dropout_gen.manual_seed(seed)
        if self.aug_gen is not None:
            self.aug_gen.manual_seed(seed ^ AUG_SEED_SALT)
        for s in self.states:
            s.step = self.step
            s.reseed_generators()

    def apply_gradients(self) -> None:
        self.optimizer.step()
        self.step += 1

    def update_ema(self) -> None:
        pass


def init_sweep_states(config: Config, train_ds: WindowDataset, grid: Sequence[Tuple[float, int]],
                      device, init_weights: Optional[Callable[[int], Dict]] = None,
                      configs: Optional[Sequence[int]] = None,
                      draw_shard: Optional[Tuple[int, int]] = None) -> SweepState:
    """The state of the grid's ``configs`` (all K by default): each model
    built from its own seed exactly as ``train --seed s`` builds it, on
    whichever rank it lives (or, for tests, loaded with
    ``init_weights(seed)``, a state dict), each optimizer the flags' rule at
    its config's learning rate (no schedule, no freezing: the JAX sweep
    builds ``make_optimizer(opt_type, 1.0, weight_decay, grad_clip_norm)``).
    Dropout masks are this rank's rows of the global batch's under
    ``draw_shard`` (the sharded tier). A batchnorm model is refused with the
    JAX package's words."""
    configs = list(range(len(grid)) if configs is None else configs)
    states = []
    for lr, seed in (grid[i] for i in configs):
        model = build_model_for_dataset(
            config, train_ds, generator=torch.Generator().manual_seed(seed), device=device)
        if any(isinstance(m, BatchNorm) for m in model.modules()):
            raise ValueError('sweep does not support batchnorm models '
                             '(mutable batch_stats cannot stack under vmap '
                             'with a shared batch); drop --batchnorm')
        if init_weights is not None:
            model.load_state_dict(init_weights(seed))
        opt = make_optimizer(model.named_parameters(), config.opt_type, 1.0,
                             weight_decay=config.weight_decay,
                             grad_clip_norm=config.grad_clip_norm)
        set_learning_rate(opt, lr)
        st = TrainState(model=model, optimizer=opt)
        if hasattr(model, 'dropout_masks'):
            st.dropout_gen = torch.Generator(device=device)
            st.dropout_seed = seed
            model.dropout_masks = generator_masks(st.dropout_gen, draw_shard)
        states.append(st)
    state = SweepState(states, config.seed, configs)
    state.draw_shard = draw_shard
    return state


def slice_config(state: SweepState, i: int) -> TrainState:
    """Grid config ``i`` as a plain TrainState (its model, its optimizer, the
    grid's step): a checkpoint of it is one that ``train``, ``serve``,
    ``analyze`` and ``convert-checkpoint`` load."""
    st = state.states[state.local(i)]
    return TrainState(model=st.model, optimizer=st.optimizer, step=state.step)


def config_tensors(state: SweepState, i: int) -> List[torch.Tensor]:
    """Grid config ``i``'s parameters, then its optimizer's state, in one
    order on every rank."""
    st = state.states[state.local(i)]
    opt = st.optimizer
    return [*st.model.parameters(),
            *(t for p in opt.param_groups[0]['params'] for t in opt.state[p].values())]


@dataclass(frozen=True)
class SweepPlacement:
    """Where a sweep's K configs and its data live on the ranks: the
    (``config``, ``data``) ``layout`` (``parallel/mesh.py``), the configs in
    ``blocks`` contiguous blocks of K / ``blocks`` over its ``config`` axis
    (this rank's is ``block``), the trials split over its ``data`` axis
    (this rank's coordinate ``dp_index`` of ``n_dp``, in the group
    ``dp_group``). Without a layout every rank holds every config and reads
    all the trials. The rank at ``data`` coordinate 0 of a block writes its
    configs' files."""
    k: int
    layout: Optional[Layout] = None

    @property
    def blocks(self) -> int:
        return self.layout.size(CONFIG_AXIS) if self.layout else 1

    @property
    def block(self) -> int:
        return self.layout.coord(CONFIG_AXIS) if self.layout else 0

    @property
    def n_dp(self) -> int:
        return self.layout.size(DATA_AXIS) if self.layout else 1

    @property
    def dp_index(self) -> int:
        return self.layout.coord(DATA_AXIS) if self.layout else 0

    @property
    def dp_group(self) -> Optional[dist.Group]:
        return self.layout.group(DATA_AXIS) if self.layout else None

    @property
    def per_block(self) -> int:
        return self.k // self.blocks

    @property
    def configs(self) -> List[int]:
        return list(range(self.block * self.per_block, (self.block + 1) * self.per_block))

    @property
    def draw_shard(self) -> Optional[Tuple[int, int]]:
        """(``data`` coordinate, size) when a step's draws are those of the
        global batch over the data shards; None for one."""
        return (self.dp_index, self.n_dp) if self.n_dp > 1 else None

    def block_of(self, i: int) -> int:
        return int(i) // self.per_block

    def rank_at(self, block: int, j: int = 0) -> int:
        """The rank of config block ``block`` at ``data`` coordinate ``j``."""
        return self.layout.rank_at({CONFIG_AXIS: block, DATA_AXIS: j}) if self.layout else 0

    def writes(self, i: int) -> bool:
        """True on the rank that writes config ``i``'s files."""
        return dist.rank() == self.rank_at(self.block_of(i))

    def gather(self, local: np.ndarray) -> np.ndarray:
        """[K] from every block's [K / blocks] (the rank's own configs'
        values), on every rank."""
        if self.blocks == 1:
            return np.asarray(local)
        rows = dist.gather_host(local)
        return np.concatenate([rows[self.rank_at(b)] for b in range(self.blocks)])


def sweep_placement(config: Config, k: int, shard_configs: bool) -> SweepPlacement:
    """The JAX sweep's mesh over the ranks, with its log lines: with
    ``--shard-configs`` and ``--device-data sharded`` the (config, data)
    layout of ``make_sweep_mesh``; with ``--shard-configs`` alone the configs
    over ``make_mesh()``'s ``data`` axis (replicated, with a warning, when
    the ranks do not divide K); with ``--device-data sharded`` alone the
    trials over it; else every rank holds everything."""
    sharded_data = config.device_data == 'sharded'
    if shard_configs and sharded_data:
        layout = make_sweep_mesh(k)
        c, n_dp = layout.size(CONFIG_AXIS), layout.size(DATA_AXIS)
        if c > 1:
            logger.info('sweep 2-D mesh: %d-way config x %d-way data sharding', c, n_dp)
        else:
            logger.warning('--shard-configs: %d configs share no divisor with %d devices; '
                           'configs stay replicated, all devices carry data shards', k, n_dp)
        return SweepPlacement(k, layout)
    if not (shard_configs or sharded_data):
        return SweepPlacement(k)
    n = dist.world_size()
    if sharded_data:
        return SweepPlacement(k, sweep_layout(1))
    if k % n == 0:
        logger.info('sweep configs sharded %d-way across the mesh', n)
        return SweepPlacement(k, sweep_layout(n))
    logger.warning('--shard-configs: %d configs do not divide the %d-device data axis; '
                   'configs stay replicated', k, n)
    return SweepPlacement(k)


def sweep_chunk_steps(config: Config, train_ds: WindowDataset, on_device: bool) -> int:
    """Steps a dispatch of a sweep step that holds no collective (every rank
    reads all the trials): ``--device-chunk-steps`` or
    ``--host-chunk-steps``, clamped to the epoch. The train loop's one step
    at world size > 1 (``loop.chunk_steps``) is the JAX loop's policy, which
    counts processes; the JAX sweep runs its grid in one process, so a
    sweep's step runs in chunks at any world size."""
    asked = config.device_chunk_steps if on_device else config.host_chunk_steps
    return min(max(1, asked), max(1, len(train_ds) // config.batch_size))


@torch.no_grad()
def exploit(state: SweepState, src: Sequence[int], dst: Sequence[int],
            placement: Optional[SweepPlacement] = None) -> None:
    """PBT's exploit: every ``dst`` config takes its ``src`` config's
    parameters and optimizer state (in place: a captured step's addresses
    stay), as the JAX package's gather ``x[perm]`` over the stacked state
    does; the configs step together, so their update counts are equal
    already. Under ``placement``'s config blocks a copy between two blocks
    goes from each rank of the winner's block to the rank of the loser's at
    the same ``data`` coordinate; every rank calls this with the same
    pairs."""
    p = placement or SweepPlacement(len(state.states))
    for d, s in zip(dst, src):
        bd, bs = p.block_of(d), p.block_of(s)
        if bd == bs:
            if p.block == bd:
                for a, b in zip(config_tensors(state, int(s)), config_tensors(state, int(d))):
                    b.copy_(a)
            continue
        for j in range(p.n_dp):
            src_rank, dst_rank = p.rank_at(bs, j), p.rank_at(bd, j)
            if dist.rank() in (src_rank, dst_rank):
                own = int(s) if dist.rank() == src_rank else int(d)
                dist.move_host_tensors(config_tensors(state, own), src_rank, dst_rank)


def pbt_events_for(dev_losses: np.ndarray, cur_lrs: np.ndarray, seed: int, epoch: int
                   ) -> Tuple[np.ndarray, np.ndarray, List[dict]]:
    """PBT's exploit and explore after a dev eval, as the JAX package draws
    them: the bottom quartile (at least one) of ``dev_losses`` copies the top
    quartile and adopts its learning rate x0.8 or x1.25, from numpy's
    ``default_rng((seed, 0x9b7, epoch))``. Updates ``cur_lrs`` (float32) in
    place; returns (src, dst, events)."""
    k = dev_losses.shape[0]
    order = np.argsort(dev_losses)                  # best loss first
    n_rep = max(1, k // 4)
    src, dst = order[:n_rep], order[-n_rep:]
    rng = np.random.default_rng((seed, 0x9b7, epoch))
    events = []
    for d, s in zip(dst, src):
        factor = float(rng.choice([0.8, 1.25]))
        cur_lrs[d] = cur_lrs[s] * factor
        events.append({'epoch': int(epoch), 'winner': int(s), 'replaced': int(d),
                       'new_lr': float(cur_lrs[d])})
    return src, dst, events


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def make_sweep_grads(models: Sequence[nn.Module], lab_offsets: Dict[str, Tuple[int, int]],
                     loss_config: LossConfig, augment: Optional[Augmenter] = None,
                     aug_draws: Optional[AugmentDraws] = None,
                     gather: Optional[Callable] = None) -> Callable:
    """``grads(state, *inputs) -> metrics [K, ...]``: the batch (``inputs``
    and labels from the host, or ``gather(idx)`` on the device) augmented
    once, from the sweep's augmentation generator, then each config's
    forward, loss and backward on it, in config order; each metric stacked
    over the configs."""

    def grads(state: SweepState, *inputs: torch.Tensor) -> Metrics:
        batch = gather(*inputs) if gather is not None else inputs
        x, labels = maybe_augment(augment, *batch, aug_draws_of(state, aug_draws))
        labels = unpack(labels, lab_offsets)
        state.optimizer.zero_grad(set_to_none=True)
        history = []
        for model in models:
            model.train()
            loss, metrics = loss_and_metrics(model(x), labels, loss_config)
            loss.backward()
            history.append(metrics)
        return {k: torch.stack([m[k] for m in history]) for k in history[0]}

    return grads


def make_sweep_diffusion_grads(models: Sequence[nn.Module], schedule: DDPMSchedule,
                               lab_offsets: Dict[str, Tuple[int, int]],
                               cond_dropout: float = 0.0, draws: Optional[TrainDraws] = None,
                               augment: Optional[Augmenter] = None,
                               aug_draws: Optional[AugmentDraws] = None,
                               gather: Optional[Callable] = None) -> Callable:
    """The diffusion sweep's ``grads(state, *inputs) -> {'loss': [K]}``:
    every config denoises the SAME noised batch (one draw of t, the noise and
    the conditioning's keep mask a step, from ``draws`` or the sweep's draws
    generator, in ``models/diffusion.py::diffusion_loss``'s order) with its
    own parameters."""
    nb = models[0].num_contact_bodies
    scales = target_scales(nb, schedule.alpha_bars.device)

    def grads(state: SweepState, *inputs: torch.Tensor) -> Metrics:
        cond, labels = gather(*inputs) if gather is not None else inputs
        source = draws if draws is not None else generator_draws(state.dropout_gen,
                                                                 state.draw_shard)
        cond, labels = maybe_augment(augment, pack_inputs(cond), labels,
                                     aug_draws_of(state, aug_draws))
        x0 = diffusion_targets_from_labels(labels, lab_offsets, nb, scales)
        t = source.timesteps(x0.shape[0], schedule.timesteps, x0.device)
        noise = source.noise(tuple(x0.shape), x0.device)
        cond = drop_conditioning(cond, cond_dropout, source.masks)
        x_t = schedule.q_sample(x0, t, noise)
        state.optimizer.zero_grad(set_to_none=True)
        losses = []
        for model in models:
            model.train()
            loss = torch.mean((model(x_t, t, cond) - noise) ** 2)
            loss.backward()
            losses.append(loss.detach())
        return {'loss': torch.stack(losses)}

    return grads


def make_sweep_eval(models: Sequence[nn.Module], lab_offsets: Dict[str, Tuple[int, int]],
                    loss_config: LossConfig) -> Callable:
    """``losses(inputs, labels) -> [K]`` host array: each config's dev loss
    on one shared batch (the eval forward: K1 / K2 / K4 for the kernel
    models, one launch a config)."""

    @torch.no_grad()
    def losses(inputs: torch.Tensor, labels: torch.Tensor) -> np.ndarray:
        unpacked = unpack(labels, lab_offsets)
        out = []
        for model in models:
            model.eval()
            out.append(loss_and_metrics(model(inputs), unpacked, loss_config)[1]['loss'])
        return torch.stack(out).float().cpu().numpy()

    return losses


def make_sweep_diffusion_eval(models: Sequence[nn.Module], schedule: DDPMSchedule,
                              lab_offsets: Dict[str, Tuple[int, int]],
                              draws: Optional[TrainDraws] = None) -> Callable:
    """``losses(inputs, labels) -> [K]``: each config's eps-MSE on the SAME
    fixed noising of the dev batch (t and the noise from a generator seeded
    :data:`EVAL_NOISE_SEED` for every batch, or from ``draws``), so that
    dev values compare across configs and epochs."""
    nb = models[0].num_contact_bodies
    scales = target_scales(nb, schedule.alpha_bars.device)

    @torch.no_grad()
    def losses(inputs: torch.Tensor, labels: torch.Tensor) -> np.ndarray:
        x0 = diffusion_targets_from_labels(labels, lab_offsets, nb, scales)
        source = draws if draws is not None else generator_draws(
            torch.Generator(device=x0.device).manual_seed(EVAL_NOISE_SEED))
        t = source.timesteps(x0.shape[0], schedule.timesteps, x0.device)
        noise = source.noise(tuple(x0.shape), x0.device)
        x_t = schedule.q_sample(x0, t, noise)
        out = []
        for model in models:
            model.eval()
            out.append(torch.mean((model(x_t, t, inputs) - noise) ** 2))
        return torch.stack(out).cpu().numpy()

    return losses


# ---------------------------------------------------------------------------
# Resume
# ---------------------------------------------------------------------------


class GridStore:
    """The resume artifact under ``<checkpoint_dir>/_grid/``: config i's
    state as a checkpoint in ``config_{i}/`` (pruned to 2; written by the
    rank that writes config i) and the host-side trackers in
    ``sweep_state.json``, written last, atomically and by rank 0 once every
    config's checkpoint is on disk, naming the epoch the checkpoints hold.
    Nothing in it depends on how the configs were spread over the ranks."""

    def __init__(self, checkpoint_dir: str, grid_spec: List[List]):
        self.dir = os.path.join(checkpoint_dir, GRID_DIR)
        self.side = os.path.join(self.dir, SIDE_NAME)
        self.grid_spec = grid_spec

    def _config_dir(self, i: int) -> str:
        return os.path.join(self.dir, f'config_{i}')

    def save(self, state: SweepState, epoch: int, side: Dict,
             placement: Optional[SweepPlacement] = None) -> None:
        placement = placement or SweepPlacement(len(self.grid_spec))
        for i in state.configs:
            if placement.writes(i):
                save_checkpoint(self._config_dir(i), slice_config(state, i), epoch, 0)
                prune_checkpoints(self._config_dir(i), 2)
        dist.barrier()          # every config's checkpoint is on disk
        if not dist.is_main():
            return
        tmp = self.side + '.tmp'
        with open(tmp, 'w') as f:
            json.dump({'grid': self.grid_spec, 'epoch': int(epoch), 'step': int(state.step),
                       **side}, f)
        os.replace(tmp, self.side)

    def load(self, state: SweepState) -> Optional[Dict]:
        """The trackers of the saved epoch, with the state of ``state``'s
        configs restored; None (a fresh start) when there is nothing to
        resume or it is another grid's (with the JAX package's warning)."""
        if not os.path.exists(self.side):
            return None
        with open(self.side) as f:
            side = json.load(f)
        paths = [os.path.join(self._config_dir(i), checkpoint_name(side.get('epoch', -1), 0))
                 for i in range(len(self.grid_spec))]
        if side.get('grid') != self.grid_spec or not all(map(os.path.exists, paths)):
            logger.warning('sweep grid checkpoint in %s does not match the requested '
                           'lr x seed grid; starting fresh', self.dir)
            return None
        for i in state.configs:
            load_checkpoint_file(slice_config(state, i), paths[i])
        state.step = int(side['step'])
        logger.info('sweep resume: grid state restored from epoch %d', side['epoch'])
        return side


# ---------------------------------------------------------------------------
# The sweep loop
# ---------------------------------------------------------------------------


def make_sweep_sharded_epoch(grads: Callable, sdata: ShardedDeviceData, batch_size: int,
                             chunk_steps: int = 1, steps_per_call: int = 0) -> ShardedEpoch:
    """The sharded tier's sweep epoch (the JAX ``make_sweep_sharded_train_step``
    and ``make_sweep_sharded_diffusion_step``, a step at a time): ``grads``
    (built over ``sdata.gather``) as the step, each rank drawing its
    ``batch_size / n_dp`` windows from its shard, the state's all-reduce
    after every backward. ``epoch.rows(state, host_seed[, sel])`` trains
    ``steps_per_call`` steps (``num_windows // batch_size`` when 0) and
    returns their metric rows; ``chunk_steps`` > 1 replays the step captured
    once."""
    step = as_train_step(grads)
    chunked = ChunkedStep(step, (torch.int64,), sdata.device) if chunk_steps > 1 else None
    return ShardedEpoch(sdata, batch_size,
                        segment_trainer(step, chunked, chunk_steps, sdata.device),
                        steps_per_call)


def run_sweep(config: Config, train_ds: WindowDataset,
              dev_ds: Optional[WindowDataset],
              lrs: Sequence[float], seeds: Sequence[int],
              max_batches_per_epoch: Optional[int] = None,
              shard_configs: bool = False,
              pbt_every: int = 0,
              metric_logger=None,
              metric_prefix: str = '',
              device='cuda',
              init_weights: Optional[Callable[[int], Dict]] = None) -> SweepResult:
    """Train the whole lr x seed grid together on ``device``; every config
    is dev-evaluated after every epoch on one shared dev stream and ranked
    by its BEST dev loss (its final train loss, with a warning, when no dev
    split is usable). ``config.early_stop_patience`` stops the grid once no
    config has improved for that many evals; ``--keep-best``'s checkpoint
    of each config (``best.torch.pt``) is written when it improves.

    ``pbt_every=N``: population-based training. After every N-th dev eval
    the bottom quartile of configs copies the top quartile's parameters and
    optimizer state and adopts its learning rate x0.8 or x1.25
    (:func:`pbt_events_for`, numpy's generator as the JAX package seeds it);
    ``SweepResult.pbt_events`` records the lineage, and a slot's
    ``dev_curve`` then describes the slot, not one hyperparameter point.

    The data tier is ``train``'s choice (``--device-data stream``, else
    :func:`loop.resident_train_data`, else the host loader), or the sharded
    tier under ``--device-data sharded`` (:func:`make_sweep_sharded_epoch`,
    ``max(1, num_windows // batch_size)`` steps an epoch, as the JAX sweep
    runs it). The batch order is shared by the configs and seeded by
    ``config.seed`` (one gather a step; on the device tier the JAX sweep's
    at least one whole batch, ``epoch_batches(pad_to_batch=True)``); the
    per-config ``seeds`` drive the initialisation and the dropout masks.
    Over several ranks the configs and the data are placed as
    :func:`sweep_placement` says (``shard_configs``: ``--shard-configs``);
    the sweep never reads ``--model-parallel``, as the JAX sweep does not.
    ``init_weights(seed)`` replaces a config's initial weights (the tests'
    seam for the JAX package's)."""
    from inferbiomechanics_tpu_torch.serve import resolve_device
    check_tier_options(config)
    device = resolve_device(device)
    grid = sweep_grid(lrs, seeds)
    k = len(grid)
    lc = loss_config_from(config)
    is_diffusion = config.model_type == 'diffusion'
    if is_diffusion and config.output_data_format != 'all_frames':
        raise ValueError('sweep --model-type diffusion requires '
                         '--output-data-format all_frames (like train)')
    if config.lr_schedule != 'constant':
        raise ValueError('sweep supports constant learning rates only '
                         '(the exact-lr vmap trick needs lr out of the '
                         'optimizer state); drop --lr-schedule')
    placement = sweep_placement(config, k, shard_configs)
    sharded_data = config.device_data == 'sharded'
    dp_group = placement.dp_group
    state = init_sweep_states(config, train_ds, grid, device, init_weights,
                              configs=placement.configs, draw_shard=placement.draw_shard)
    models = state.models
    augment = augmenter_from_config(config, train_ds, logger, device=device)
    if augment is not None:
        state.aug_gen = torch.Generator(device=device)
    if sharded_data:       # the all-reduce over data, and the global batch's noise scale
        dist.attach(state, state.model, None, augment, dp_group)
    schedule = None
    if is_diffusion:
        schedule = DDPMSchedule(config.diffusion_timesteps, device=device)
        state.dropout_gen = torch.Generator(device=device)

    stop = SigtermStop()
    grid_spec = [[float(lr), int(sd)] for lr, sd in grid]
    store = GridStore(config.checkpoint_dir, grid_spec) if config.checkpoint_dir else None
    resumed = store.load(state) if store is not None else None
    start_epoch = int(resumed['epoch']) + 1 if resumed is not None else 0

    def grads_for(gather=None):
        if is_diffusion:
            return make_sweep_diffusion_grads(models, schedule, train_ds.lab_offsets,
                                              config.cond_dropout, augment=augment,
                                              gather=gather)
        return make_sweep_grads(models, train_ds.lab_offsets, lc, augment=augment,
                                gather=gather)

    # ---- the data tier: sharded, stream, device-resident, or the host loader ----
    streaming = device_data = sharded = None
    if sharded_data:
        sdata = ShardedDeviceData(train_ds, placement.dp_index, placement.n_dp, device)
        n_steps = max(1, sdata.num_windows // config.batch_size)
        if max_batches_per_epoch is not None:
            n_steps = min(n_steps, max_batches_per_epoch)
        sharded = make_sweep_sharded_epoch(
            grads_for(sdata.gather), sdata, config.batch_size,
            max(1, config.device_chunk_steps) if dist.can_capture(dp_group) else 1, n_steps)
        logger.info('sweep sharded data: %d shards, %.0f MB on %s', sdata.num_shards,
                    sdata.device_bytes / 1e6, device)
    elif config.device_data == 'stream':
        plan = StreamingPlan(train_ds, config.device_data_max_bytes)
        buffer = SegmentBuffer(train_ds, plan.rows_pad, device)
        step = as_train_step(grads_for(buffer.gather))
        chunk_k = max(1, config.device_chunk_steps)
        chunked = ChunkedStep(step, (torch.int64,), device) if chunk_k > 1 else None
        streaming = StreamingEpoch(plan, buffer, config.batch_size,
                                   segment_trainer(step, chunked, chunk_k, device))
        stream_windows = streaming_windows_per_epoch(plan, config.batch_size)
        logger.info('sweep streaming data: %d segments of %d rows', len(plan.segments),
                    plan.rows_pad)
    else:
        device_data, _ = resident_train_data(config, train_ds, device)
    on_device = device_data is not None
    dispatch = chunk_k = None
    if streaming is None and sharded is None:
        chunk_k = sweep_chunk_steps(config, train_ds, on_device)
        if on_device:
            step = as_train_step(grads_for(device_data.gather))
            chunked = ChunkedStep(step, (torch.int64,), device) if chunk_k > 1 else None
        else:
            step = as_train_step(grads_for())
            chunked = (ChunkedStep(step, (upload_dtype(config), torch.float32), device)
                       if chunk_k > 1 else None)
        loader = train_loader(config, train_ds, device, chunked is not None)
        dispatch = make_dispatch(state, step, chunked, on_device, device)
        if chunked is not None:
            logger.info('sweep chunked dispatch: %d steps a chunk, %d configs a step',
                        chunk_k, len(models))

    dev_loader = (PrefetchLoader(dev_ds, config.batch_size, device=device, shuffle=False)
                  if dev_ds is not None and len(dev_ds) >= config.batch_size else None)
    if dev_loader is None:
        logger.warning(
            'sweep: no usable dev split (%s) — configs will be ranked by '
            'FINAL TRAIN loss, which favors overfitting',
            'none provided' if dev_ds is None else
            f'{len(dev_ds)} dev windows < batch size {config.batch_size}; '
            f'lower --batch-size to enable dev ranking')
    dev_eval = (make_sweep_diffusion_eval(models, schedule, train_ds.lab_offsets)
                if is_diffusion else make_sweep_eval(models, train_ds.lab_offsets, lc))

    def dev_losses_now() -> Optional[np.ndarray]:
        """Every config scored on the identical dev stream ([K], every
        rank's configs gathered), or None."""
        if dev_loader is None:
            return None
        acc, n = np.zeros(len(models)), 0
        for batch in dev_loader.epoch(seed=0):
            acc += dev_eval(batch.inputs, batch.labels)
            n += 1
        return placement.gather(acc / n) if n else None

    windows_seen = 0
    t0 = time.time()
    last_train = None
    dev_curves: List[np.ndarray] = []      # [epoch][K]: dev loss AFTER epoch
    best_dev = np.full(k, np.inf)
    best_epoch = np.full(k, -1, np.int64)
    stale = 0
    cur_lrs = np.asarray([lr for lr, _ in grid], np.float32)
    pbt_events: List[dict] = []
    preempted = False
    if resumed is not None:
        cur_lrs = np.asarray(resumed['cur_lrs'], np.float32)
        best_dev = np.asarray(resumed['best_dev'], np.float64)
        best_epoch = np.asarray(resumed['best_epoch'], np.int64)
        dev_curves = [np.asarray(c) for c in resumed['dev_curves']]
        stale = int(resumed['stale'])
        pbt_events = list(resumed['pbt_events'])

    def set_learning_rates() -> None:
        for i, opt in zip(state.configs, state.optimizer.optimizers):
            set_learning_rate(opt, cur_lrs[i])

    if resumed is not None:
        set_learning_rates()

    def point_dir(i: int) -> str:
        lr_i, seed_i = grid[i]
        return os.path.join(config.checkpoint_dir, f'lr{lr_i:g}_seed{seed_i}')

    def persist_grid(epoch: int) -> None:
        if store is not None:
            store.save(state, epoch, {
                'cur_lrs': cur_lrs.tolist(), 'best_dev': best_dev.tolist(),
                'best_epoch': best_epoch.tolist(),
                'dev_curves': [list(map(float, c)) for c in dev_curves],
                'stale': stale, 'pbt_events': pbt_events}, placement)

    last_epoch = start_epoch - 1
    for epoch in range(start_epoch, config.epochs):
        last_epoch = epoch
        if sharded is not None:
            last_train = sharded.rows(state, host_seed_for(config.seed, epoch))[-1]
            windows_seen += sharded.n_steps * config.batch_size * k
        elif streaming is not None:
            # one streamed epoch a call; PBT moves learning rates between
            # epochs, which is when it moves them anyway
            # {} when no segment holds a whole batch
            last_train = streaming(state, host_seed_for(config.seed, epoch)) or last_train
            windows_seen += stream_windows * k
        else:
            batches = epoch_batches(config, train_ds, loader, epoch, on_device,
                                    pad_to_batch=True)
            never = 1 << 62
            n, _, last = run_chunks(
                dispatch, batches, chunk_k, skip=0, cap=max_batches_per_epoch,
                log_every=never, checkpoint_every=never, account=lambda row: None,
                log=lambda i, row: None, checkpoint=lambda i: None, stop=lambda: False)
            if last is not None:
                last_train = last
            windows_seen += n * config.batch_size * k
        dl = dev_losses_now()
        if dl is None:
            logger.info('sweep epoch %d done', epoch)
            persist_grid(epoch)
            if dist.any_rank(stop.requested):
                preempted = True
                break
            continue
        dev_curves.append(dl)
        if metric_logger is not None:
            p = metric_prefix
            metric_logger.log({'epoch': epoch,
                               **{f'sweep/{p}config_{i}/dev_loss': float(v)
                                  for i, v in enumerate(dl)},
                               f'sweep/{p}best_dev_loss': float(dl.min())})
        improved = dl < best_dev
        best_epoch = np.where(improved, epoch, best_epoch)
        best_dev = np.minimum(best_dev, dl)
        if config.checkpoint_dir:
            # the best checkpoint is written when a config improves, so that
            # a preempted (and resumed) sweep never loses its ranked artifact
            for i in np.nonzero(improved)[0]:
                if int(i) in state.configs and placement.writes(int(i)):
                    save_checkpoint(point_dir(int(i)), slice_config(state, int(i)), int(epoch),
                                    0, filename=BEST_NAME)
        logger.info('sweep epoch %d: best dev loss %.6f (config %d)',
                    epoch, float(best_dev.min()), int(best_dev.argmin()))
        stale = 0 if improved.any() else stale + 1
        if config.early_stop_patience and stale >= config.early_stop_patience:
            logger.info('sweep early stop after epoch %d: no config '
                        'improved in %d evals', epoch, stale)
            break
        if (pbt_every and k >= 2 and len(dev_curves) % pbt_every == 0
                and epoch + 1 < config.epochs):
            src, dst, events = pbt_events_for(dl, cur_lrs, config.seed, epoch)
            exploit(state, src, dst, placement)
            set_learning_rates()
            pbt_events.extend(events)
            logger.info('PBT at epoch %d: slots %s adopted %s (lrs now %s)',
                        epoch, dst.tolist(), src.tolist(), ['%.2g' % v for v in cur_lrs])
        persist_grid(epoch)
        if dist.any_rank(stop.requested):
            preempted = True
            logger.warning('sweep preempted: grid state saved at epoch %d', epoch)
            break
    stop.restore()

    train_losses = (np.asarray(metrics_on_host(last_train)['loss'], np.float64)
                    if last_train is not None
                    else np.full(len(models), np.nan))
    train_losses = placement.gather(train_losses)
    elapsed = time.time() - t0
    dev_losses = dev_curves[-1] if dev_curves else None
    ranking = best_dev if dev_curves else train_losses
    result = SweepResult(windows_per_sec=windows_seen / elapsed if elapsed > 0 else 0.0,
                         pbt_events=pbt_events, preempted=preempted)
    if config.checkpoint_dir:
        for i in state.configs:
            if placement.writes(i):
                sub = point_dir(i)
                save_checkpoint(sub, slice_config(state, i), max(0, last_epoch), 0)
                lr, seed = grid[i]
                save_run_config(sub, replace(config, learning_rate=lr, seed=seed,
                                             checkpoint_dir=sub))
        dist.barrier()      # every point's files are on disk
    for i, (lr, seed) in enumerate(grid):
        pt = SweepPoint(index=i, learning_rate=lr, seed=seed,
                        final_train_loss=float(train_losses[i]),
                        final_dev_loss=float(dev_losses[i]) if dev_losses is not None else None,
                        best_dev_loss=float(best_dev[i]) if dev_curves else None,
                        best_epoch=int(best_epoch[i]) if dev_curves else None,
                        dev_curve=[float(c[i]) for c in dev_curves] if dev_curves else None,
                        final_learning_rate=float(cur_lrs[i]))
        if config.checkpoint_dir:
            sub = point_dir(i)
            pt.checkpoint_path = os.path.join(sub, checkpoint_name(max(0, last_epoch), 0))
            bpath = os.path.join(sub, BEST_NAME)
            if os.path.exists(bpath):
                pt.best_checkpoint_path = bpath
        result.points.append(pt)
    if k and np.isfinite(ranking).any():
        result.best_index = int(np.nanargmin(ranking))
    elif k:
        result.best_index = 0   # nothing ran (e.g. --epochs 0): arbitrary
    return result


__all__ = ['GridStore', 'SweepOptimizer', 'SweepPlacement', 'SweepPoint', 'SweepResult',
           'SweepState', 'config_tensors', 'exploit', 'init_sweep_states',
           'make_sweep_diffusion_eval', 'make_sweep_diffusion_grads', 'make_sweep_eval',
           'make_sweep_grads', 'make_sweep_sharded_epoch', 'pbt_events_for', 'run_sweep',
           'set_learning_rate', 'slice_config', 'sweep_grid', 'sweep_placement']
