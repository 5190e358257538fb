"""What the data-parallel tests run on each rank (``parallel/dist.py::spawn``).

This module imports torch and the port only, so that a spawned rank starts
without the JAX package. Each function also runs in the test process
itself, without a process group: one process, the reference a world of
ranks is held to.
"""

import os

import numpy as np
import torch

from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.parallel import dist


def _config(fields: dict) -> Config:
    cfg = Config()
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def _dataset(job: dict) -> WindowDataset:
    return WindowDataset(job['data'], skip_loading_skeletons=True, **job.get('ds', {}))


def _mask_source(masks, r: int, n: int):
    """Hands out the rows of this rank (``r`` of ``n``) of the given global
    masks, in order."""
    it = iter(masks)

    def source(shape, p, device):
        m = np.asarray(next(it))
        b = m.shape[0] // n
        assert (b, *m.shape[1:]) == tuple(shape), (m.shape, shape, n)
        return torch.from_numpy(m[r * b:(r + 1) * b].copy()).to(device)
    return source


def _snapshot(model) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def run_jobs(jobs):
    """Each job through the function its ``fn`` names; their results in
    order."""
    fns = {'steps': steps, 'sharded_epoch': sharded_epoch, 'loop': loop,
           'loops': loop, 'collectives': collectives, 'state_loop': state_loop,
           'shard_gather': shard_gather, 'sweep_cli': sweep_cli, 'sweep_epoch': sweep_epoch,
           'exploit': exploit, 'pipeline_step': pipeline_step}
    return [fns[job['fn']](job) for job in jobs]


def collectives(job):
    """The collectives on this rank's rows of fixed float32 data (rank r of
    n takes rows r N .. (r+1) N of 2N... as one process takes them all):
    synced BatchNorm statistics, the global standard deviation, averaged
    metrics, a flag raised on rank 1 only, and the gradient of a sum over
    the ranks (its first row)."""
    from inferbiomechanics_tpu_torch.models.norm import batch_stats
    r, n = dist.rank(), dist.world_size()
    rng = np.random.default_rng(11)
    x_all = torch.from_numpy((rng.normal(size=(16, 6)) * 3 + 1).astype(np.float32))
    x3_all = torch.from_numpy(rng.normal(size=(16, 4, 6)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(6,)).astype(np.float32))
    b = 16 // n
    x, x3 = x_all[r * b:(r + 1) * b], x3_all[r * b:(r + 1) * b]
    mean, var = batch_stats(x, dist.RankSum() if n > 1 else None)
    metric = dist.mean_over_ranks({'m': x.mean()})['m']
    xg = x.clone().requires_grad_(True)
    (dist.sum_over_ranks(xg.sum(0)) * w).sum().backward()
    return {'mean': mean.numpy(), 'var': var.numpy(),
            'std': dist.global_std(x3, (0, 1)).numpy(), 'metric': metric.numpy(),
            'flags': [dist.any_rank(False), dist.any_rank(r == 1), dist.any_rank(True)],
            'grad': xg.grad[0].numpy()}


def steps(job):
    """A model of ``cfg`` (its state dict from ``sd``, a
    ``torch.save`` file, else built from the seed) trained for K steps of
    ``make_train_step`` on this rank's rows of the global batches
    ``inputs`` [K, G, ...] / ``labels`` [K, G, ...] (rank r of n takes rows
    r G/n .. (r+1) G/n). ``masks`` (K lists of global masks) are fed
    through the dropout seam; ``generators`` seeds the state's per-step
    generators (dropout, augmentation) instead. Returns the state dict after
    the steps and the per-step metrics."""
    from inferbiomechanics_tpu_torch.train.loop import (
        loss_config_from, optimizer_for, per_step_generators,
    )
    from inferbiomechanics_tpu_torch.train.state import create_train_state
    from inferbiomechanics_tpu_torch.train.step import make_train_step
    r, n = dist.rank(), dist.world_size()
    cfg = _config(job['cfg'])
    ds = _dataset(job)
    model = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(cfg.seed))
    if job.get('sd'):
        model.load_state_dict(torch.load(job['sd'], weights_only=True))
    state = create_train_state(model, optimizer_for(cfg, model))
    augment = None
    if job.get('generators'):
        augment = per_step_generators(cfg, state, ds, 'cpu')
    # the loops' rule: the bf16 all-reduce applies from two ranks on
    lowp = torch.bfloat16 if job.get('lowp') and n > 1 else None
    dist.attach(state, model, lowp, augment)
    step = make_train_step(model, ds.lab_offsets, loss_config_from(cfg),
                           grad_accum=cfg.grad_accum_steps, augment=augment)
    if job.get('masks') is not None:
        model.dropout_masks = _mask_source([m for ms in job['masks'] for m in ms], r, n)
    metrics = []
    for x, y in zip(job['inputs'], job['labels']):
        b = x.shape[0] // n
        m = step(state, torch.from_numpy(x[r * b:(r + 1) * b].copy()),
                 torch.from_numpy(y[r * b:(r + 1) * b].copy()))
        metrics.append({k: v.detach().cpu().numpy().copy() for k, v in m.items()})
    return {'state': _snapshot(model), 'metrics': metrics}


def sharded_epoch(job):
    """The sharded tier's epoch (``train/sharded_data.py``) of
    ``cfg`` on this rank's shard, fed ``sel`` [n_shards, n_steps, b_local]
    (this rank's row) when given; for the denoiser the state keeps an EMA
    (``ema_decay``) and ``draws`` (t [n_steps, B], noise [n_steps, B, ...],
    global) are fed through the ``TrainDraws`` seam. Returns the state dict
    (and the EMA's) after the epoch and the epoch's metrics."""
    from inferbiomechanics_tpu_torch.models import diffusion as pd
    from inferbiomechanics_tpu_torch.train import sharded_data as shd
    from inferbiomechanics_tpu_torch.train.loop import loss_config_from, optimizer_for
    from inferbiomechanics_tpu_torch.train.state import ParamEMA, create_train_state
    r, n = dist.rank(), dist.world_size()
    cfg = _config(job['cfg'])
    ds = _dataset(job)
    model = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(cfg.seed))
    if job.get('sd'):
        model.load_state_dict(torch.load(job['sd'], weights_only=True))
    state = create_train_state(model, optimizer_for(cfg, model))
    dist.attach(state, model)
    sdata = shd.ShardedDeviceData(ds, r, n, 'cpu')
    if cfg.model_type == 'diffusion':
        state.ema = ParamEMA(model, cfg.ema_decay)
        draws = None
        if job.get('draws') is not None:
            t_all, noise_all = job['draws']
            b = t_all.shape[1] // n
            it, cur = iter(range(t_all.shape[0])), {}

            def timesteps(bl, steps_, device):
                cur['k'] = next(it)
                return torch.from_numpy(t_all[cur['k'], r * b:(r + 1) * b].copy()).long()

            def noise(shape, device):
                return torch.from_numpy(noise_all[cur['k'], r * b:(r + 1) * b].copy())

            draws = pd.TrainDraws(timesteps=timesteps, noise=noise, masks=None)
        epoch = shd.make_sharded_diffusion_epoch_runner(
            model, sdata, pd.DDPMSchedule(cfg.diffusion_timesteps), cfg.batch_size,
            chunk_steps=job.get('chunk', 1), draws=draws)
    else:
        epoch = shd.make_sharded_epoch_runner(model, sdata, loss_config_from(cfg),
                                              cfg.batch_size, chunk_steps=job.get('chunk', 1))
    sel = job.get('sel')
    m = epoch(state, job.get('host_seed', 0), None if sel is None else sel[r])
    res = {'state': _snapshot(model), 'metrics': m, 'steps': state.step,
           'local_windows': sdata.local_windows, 'trials': sdata.trials}
    if state.ema is not None:
        res['ema'] = {k: v.numpy().copy() for k, v in state.ema.state_dict().items()}
    return res


def loop(job):
    """``train()`` (or ``train_diffusion``) of ``cfg`` on the ``train`` (and,
    with ``dev``, ``dev``) split under ``data``, with this rank's writes of
    checkpoints and sidecars counted; with ``stop_after`` rank 1 alone asks
    to stop (as its SIGTERM handler would) from its ``stop_after``-th step
    boundary on. Returns the loop's result, the rank's writes and the
    checkpoint directory's files, or the error a refused run raised."""
    from inferbiomechanics_tpu_torch.train import checkpoint as ckpt
    from inferbiomechanics_tpu_torch.train import loop as L
    from inferbiomechanics_tpu_torch.train.diffusion_loop import train_diffusion
    writes = []
    saved = (L.save_checkpoint, L.save_run_config, ckpt.AsyncCheckpointer.save, dist.any_rank)
    save, save_sidecar, save_async, any_rank = saved

    def counting_save(d, target, epoch, batch, **kw):
        writes.append(('ckpt', epoch, batch, kw.get('filename')))
        return save(d, target, epoch, batch, **kw)

    def counting_sidecar(d, config):
        writes.append(('sidecar',))
        return save_sidecar(d, config)

    def counting_async(self, d, state, epoch, batch, **kw):
        writes.append(('ckpt', epoch, batch, kw.get('filename')))
        return save_async(self, d, state, epoch, batch, **kw)

    calls = {'n': 0}

    def asked(flag):
        calls['n'] += 1
        return any_rank(flag or calls['n'] >= job['stop_after'])

    L.save_checkpoint, L.save_run_config = counting_save, counting_sidecar
    ckpt.AsyncCheckpointer.save = counting_async
    if job.get('stop_after') is not None and dist.rank() == 1:
        dist.any_rank = asked
    cfg = _config(job['cfg'])
    try:
        train_ds = _dataset(dict(job, data=os.path.join(job['data'], 'train')))
        dev_ds = (_dataset(dict(job, data=os.path.join(job['data'], 'dev')))
                  if job.get('dev') else None)
        run = train_diffusion if cfg.model_type == 'diffusion' else L.train
        result = run(cfg, train_ds, dev_ds, device='cpu')
    except (ValueError, NotImplementedError) as e:
        return {'error': f'{type(e).__name__}: {e}'}
    finally:
        (L.save_checkpoint, L.save_run_config, ckpt.AsyncCheckpointer.save,
         dist.any_rank) = saved
    return {'epochs_run': result.epochs_run, 'preempted': result.preempted,
            'final_dev': {k: float(v) for k, v in result.final_dev_metrics.items()},
            'final_train': {k: float(np.mean(v)) for k, v in result.final_train_metrics.items()},
            'writes': list(writes), 'ckpt_dir': cfg.checkpoint_dir,
            'files': sorted(os.listdir(cfg.checkpoint_dir))
            if os.path.isdir(cfg.checkpoint_dir) else []}


def state_loop(job):
    """:func:`loop`, with the rank's train state after the run (its
    parameters and buffers, and the EMA's, by name)."""
    from inferbiomechanics_tpu_torch.train import diffusion_loop as DL
    from inferbiomechanics_tpu_torch.train import loop as L
    made = []
    saved = (L.create_train_state, DL.create_train_state)

    def keep(model, optimizer):
        made.append(saved[0](model, optimizer))
        return made[-1]

    L.create_train_state = DL.create_train_state = keep
    try:
        out = loop(job)
    finally:
        L.create_train_state, DL.create_train_state = saved
    if made:
        out['state'] = _snapshot(made[-1].model)
        if made[-1].ema is not None:
            out['ema'] = {k: v.numpy().copy() for k, v in made[-1].ema.state_dict().items()}
    return out


def shard_gather(job):
    """``parallel/sharding_rules.py`` on the ``model`` axis of
    ``make_mesh(model_parallel=mp)``: a model of each config in ``cfgs``
    (adam moments moved off zero by two updates on seeded gradients, alike
    on every rank), this rank's shard of its state, and the state gathered
    back from the shards over the ``model`` group. Returns, by config,
    whether the gathered state is bitwise the whole one, the split
    parameters, and the bytes of the shard and of the whole state."""
    from inferbiomechanics_tpu_torch.parallel import sharding_rules as sr
    from inferbiomechanics_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh
    from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
    from inferbiomechanics_tpu_torch.train.state import create_train_state
    layout = make_mesh(model_parallel=job['mp'])
    out = []
    for fields in job['cfgs']:
        cfg = _config(fields)
        ds = _dataset(dict(job, ds=dict(job.get('ds', {}),
                                        output_data_format=cfg.output_data_format)))
        model = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(1))
        state = create_train_state(model, make_optimizer(model.named_parameters(), 'adam', 1e-3))
        g = torch.Generator().manual_seed(2)
        for _ in range(2):
            for prm in model.parameters():
                prm.grad = torch.randn(prm.shape, generator=g)
            state.optimizer.step()
        shard = sr.shard_state(state, job['mp'], layout.coord(MODEL_AXIS))
        whole = sr.gather_state(shard, layout.group(MODEL_AXIS))
        full = sr.shard_state(state, 1, 0)
        equal = (whole.params.keys() == full.params.keys()
                 and all(torch.equal(whole.params[n], t) for n, t in full.params.items())
                 and all(torch.equal(whole.moments[n][k], t)
                         for n, m in full.moments.items() for k, t in m.items()))
        out.append({'equal': equal, 'nbytes': shard.nbytes(), 'full_nbytes': full.nbytes(),
                    'split': sorted(n for n, d in shard.param_dims.items() if d is not None)})
    return out


class _Lines:
    """A logging handler that keeps the messages."""

    def __init__(self):
        import logging
        self.lines = []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.lines.append(record.getMessage())


def sweep_cli(job):
    """``python -m inferbiomechanics_tpu_torch sweep <argv>`` on this rank
    (the process group exists already). Returns the exit code, the sweep
    module's log messages and the files under the checkpoint directory."""
    import logging

    from inferbiomechanics_tpu_torch.__main__ import main
    lines = _Lines()
    log = logging.getLogger('inferbiomechanics_tpu_torch.train.sweep')
    level = log.level
    log.setLevel(logging.INFO)
    log.addHandler(lines.handler)
    try:
        rc = main(['sweep', *job['argv']])
    finally:
        log.removeHandler(lines.handler)
        log.setLevel(level)
    root = job['ckpt']
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    return {'rc': rc, 'log': lines.lines, 'files': files}


def sweep_epoch(job):
    """One epoch of the sharded sweep (``train/sweep.py::
    make_sweep_sharded_epoch``) of ``cfg`` over ``grid`` on this rank's
    placement (``sweep_placement``: ``shard`` is ``--shard-configs``), each
    config's weights from ``weights[seed]`` (a ``torch.save`` file), fed
    ``sel`` [n_dp, n_steps, b_local] (this rank's ``data`` row) and, for the
    denoiser, the sweep's draws' generator (``weights`` None: each config
    initialised from its seed). Returns each of the rank's
    configs' state dict by its grid index, and the epoch's metric rows."""
    from inferbiomechanics_tpu_torch.models.diffusion import DDPMSchedule
    from inferbiomechanics_tpu_torch.train import sweep as S
    from inferbiomechanics_tpu_torch.train.loop import loss_config_from
    from inferbiomechanics_tpu_torch.train.sharded_data import ShardedDeviceData
    cfg = _config(dict(job['cfg'], device_data='sharded'))
    ds = _dataset(job)
    grid = [tuple(g) for g in job['grid']]
    placement = S.sweep_placement(cfg, len(grid), job['shard'])
    init = ((lambda seed: torch.load(job['weights'][seed], weights_only=True))
            if job.get('weights') else None)
    state = S.init_sweep_states(cfg, ds, grid, 'cpu', init, configs=placement.configs,
                                draw_shard=placement.draw_shard)
    dist.attach(state, state.model, None, None, placement.dp_group)
    sdata = ShardedDeviceData(ds, placement.dp_index, placement.n_dp, 'cpu')
    if cfg.model_type == 'diffusion':
        state.dropout_gen = torch.Generator()
        grads = S.make_sweep_diffusion_grads(state.models, DDPMSchedule(cfg.diffusion_timesteps),
                                             ds.lab_offsets, gather=sdata.gather)
    else:
        grads = S.make_sweep_grads(state.models, ds.lab_offsets, loss_config_from(cfg),
                                   gather=sdata.gather)
    sel = np.asarray(job['sel'])[placement.dp_index]
    epoch = S.make_sweep_sharded_epoch(grads, sdata, cfg.batch_size, job.get('chunk', 1),
                                       sel.shape[0])
    rows = epoch.rows(state, 0, sel)
    return {'states': {i: _snapshot(state.states[state.local(i)].model) for i in state.configs},
            'rows': rows, 'placement': (placement.blocks, placement.block, placement.n_dp,
                                        placement.dp_index)}


def exploit(job):
    """PBT's exploit over ``--shard-configs``' blocks: the grid of ``cfg``
    (one update on seeded gradients, so that every config has optimizer
    state), then ``train/sweep.py::exploit`` of ``src`` into ``dst``.
    Returns each of the rank's configs' parameters and optimizer state
    before and after, by grid index."""
    from inferbiomechanics_tpu_torch.train import sweep as S
    cfg = _config(job['cfg'])
    ds = _dataset(job)
    grid = [tuple(g) for g in job['grid']]
    placement = S.sweep_placement(cfg, len(grid), True)
    state = S.init_sweep_states(cfg, ds, grid, 'cpu', configs=placement.configs)
    g = torch.Generator().manual_seed(dist.rank())
    for prm in state.model.parameters():
        prm.grad = torch.randn(prm.shape, generator=g)
    state.optimizer.step()

    def tensors():
        return {i: [t.detach().numpy().copy() for t in S.config_tensors(state, i)]
                for i in state.configs}

    before = tensors()
    S.exploit(state, job['src'], job['dst'], placement)
    return {'before': before, 'after': tensors()}


def pipeline_step(job):
    """``parallel/pipeline.py`` at ``--pipeline-parallel`` ``pipe``: the
    model of ``cfg`` holding ``state`` (a canonical state dict of numpy
    arrays), its pipeline forward of this rank's rows of ``x`` (the ``data``
    coordinate's block of the global batch), then ``steps`` train steps
    under ``opt`` at ``lr`` on its rows of ``x`` / ``y``. Returns the
    forward's outputs, each step's metrics, the canonical state gathered
    after the steps (with the optimizer's moments) and the point-to-point
    traffic."""
    from inferbiomechanics_tpu_torch.parallel import pipeline as P
    from inferbiomechanics_tpu_torch.parallel.mesh import DATA_AXIS
    from inferbiomechanics_tpu_torch.train.loop import loss_config_from
    from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
    cfg = _config(job['cfg'])
    ds = _dataset(job)
    model = build_model_for_dataset(cfg, ds)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in job['state'].items()})
    plan = P.make_stage_plan(model.num_layers, job['pipe'])
    d, b = plan.layout.coord(DATA_AXIS), job['x'].shape[0] // plan.n_dp
    x = torch.from_numpy(job['x'][d * b:(d + 1) * b].copy())
    y = torch.from_numpy(job['y'][d * b:(d + 1) * b].copy())
    dist.reset_p2p_stats()
    out = P.make_pipeline_forward(model, plan, job.get('micro'))(x)
    state = P.create_pipeline_state(
        model, make_optimizer(model.named_parameters(), job['opt'], job['lr'],
                              grad_clip_norm=job.get('clip', 0.0)), plan)
    dist.attach(state, model, None, None, plan.data_group)
    step = P.make_pipeline_train_step(model, ds.lab_offsets, loss_config_from(cfg), plan,
                                      job.get('micro'), remat=job.get('remat', False))
    metrics = [{k: v.detach().numpy().copy() for k, v in step(state, x, y).items()}
               for _ in range(job.get('steps', 1))]
    P.canonical_trainstate_from_pipeline(state, plan)
    opt = state.optimizer
    return {'out': {k: v.numpy().copy() for k, v in out.items()}, 'metrics': metrics,
            'state': _snapshot(model), 'stage': plan.stage,
            'moments': {n: {k: v.numpy().copy() for k, v in opt.state[p].items()}
                        for n, p in model.named_parameters() if p in opt.state},
            'p2p': dict(dist.p2p_stats)}
