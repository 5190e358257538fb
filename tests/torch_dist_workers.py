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
           'loops': loop, 'collectives': collectives}
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
    mean, var = batch_stats(x, dist.sum_over_ranks if n > 1 else None)
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
