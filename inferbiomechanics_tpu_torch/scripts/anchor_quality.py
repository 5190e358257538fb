"""Whole-run learning quality of the port's transformer and diffusion
families on the study split of :mod:`parity_rmse`.

PyTorch counterpart of the JAX package's ``scripts/anchor_quality.py``.
The transformer (shipped defaults: d_model 256, 4 layers, 8 heads, aux
heads, ``all_frames``; ``--attn-impl vpu`` or ``pallas``) trains through
:func:`parity_rmse.run_port` with the RMSprop 1e-4, batch-64 protocol.

The diffusion denoiser (shipped defaults, cosine DDPM schedule, 1000
timesteps) trains with adam 3e-4, an EMA of 0.999 and conditioning dropout
0.1, and is scored every ``--eval-every`` epochs on the first
``--eval-subset`` dev windows through 50-step DDIM chains of its EMA
weights, keeping the snapshot of the best force. That snapshot is then
scored on the whole dev split through every sampling surface the JAX run
scores: raw and EMA weights, guidance 1 and 2, the mean of 8 chains, and
partial denoising (0.3) from an ``all_frames`` feedforward proposal trained
on the same schedule for 10 epochs, which is scored too. Every chain runs
through the fused encoder layer (``make_sampler(fused_inference=True)``):
on the card each denoiser call is 4 K2 launches, 200 a 50-step chain; the
proposal evaluates through K1.

Draws: a train step's timesteps, noise and conditioning mask come from the
state's generator, reseeded from ``seed + 1000`` and the step count
(``train_draws(i)`` hands step ``i`` other draws, a
``models/diffusion.py::TrainDraws``). A chain over the dev batch that starts
at window ``i`` draws from a ``torch.Generator`` seeded from ``(seed, i,
k)``, ``k`` the chain of a mean of K (``chain_noise(i, k)`` hands it a
``NoiseSource`` instead: the seam through which tests feed the JAX
sampler's own draws).

``--init-from DIR`` starts each seed from ``DIR/seed{N}.npz``: for the
transformer a JAX parameter tree (the ``vpu`` tree serves ``pallas`` too),
for diffusion the denoiser's tree under ``denoiser/`` and the proposal's
under ``proposal/`` (``tests/torch_parity_split.py --write-inits``).

Run on the card::

    python -m inferbiomechanics_tpu_torch.scripts.anchor_quality --family transformer \\
        --attn-impl pallas --epochs 10 --seeds 0 1 2 --out docs/port_parity/port_transformer_pallas.json
    python -m inferbiomechanics_tpu_torch.scripts.anchor_quality --family diffusion \\
        --epochs 30 --seeds 0 1 2 --out docs/port_parity/port_diffusion.json
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from inferbiomechanics_tpu_torch.models.diffusion import (
    DDPMSchedule, NoiseSource, TrainDraws, diffusion_targets_from_outputs,
    make_diffusion_train_step, make_sampler, target_scales,
)
from inferbiomechanics_tpu_torch.scripts import parity_rmse as P
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
from inferbiomechanics_tpu_torch.train.state import ParamEMA, create_train_state
from inferbiomechanics_tpu_torch.train.step import make_train_step
from inferbiomechanics_tpu_torch.weights import params_from_jax

DIFF_LR = 3e-4           # adam
EMA_DECAY = 0.999
COND_DROPOUT = 0.1
GUIDANCE = 2.0
DDIM_STEPS = 50          # the shipped eval setting
PARTIAL_FRAC = 0.3
MEAN_K = 8
PROPOSAL_EPOCHS = 10

Weights = Dict[str, torch.Tensor]


def short_keys():
    return dict(P.SHORT)


# ---------------------------------------------------------------------------
# Diffusion
# ---------------------------------------------------------------------------

def train_proposal(ds, x_tr, y_tr, seed, epochs, schedule, *, device='cuda',
                   init_params=None):
    """The ``all_frames`` feedforward proposal for partial denoising,
    trained on ``schedule`` (RMSprop 1e-4); returned in eval mode."""
    model = P.study_model('feedforward', ds, output_data_format='all_frames',
                          generator=torch.Generator().manual_seed(seed), device=device)
    if init_params is not None:
        P.load_jax_params(model, init_params)
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'rmsprop', P.LR))
    step = make_train_step(model, ds.lab_offsets, P.study_loss_config())
    x, y = P.to_device(x_tr, device), P.to_device(y_tr, device)
    for ep in range(epochs):
        for bi in P.epoch_batches(schedule, ep, device):
            step(state, x[bi], y[bi])
    return model.eval()


def chain_seed(seed: int, start: int, k: Optional[int]) -> int:
    """The generator seed of the chain over the dev batch at ``start``
    (``k``: the chain's index in a mean of K, None for a lone chain)."""
    return ((seed + 3000) * 1_000_003 + start) * 64 + (0 if k is None else k + 1)


def _fed_draws(source: Callable[[], TrainDraws]) -> TrainDraws:
    """A TrainDraws that asks ``source()`` for the current step's draws."""
    return TrainDraws(timesteps=lambda b, steps, dev: source().timesteps(b, steps, dev),
                      noise=lambda shape, dev: source().noise(shape, dev),
                      masks=lambda shape, p, dev, shared=False: source().masks(shape, p, dev))


def run_diffusion(ds, x_tr, y_tr, x_dev, lab_dev, seed, epochs, schedule,
                  eval_every, eval_subset, log=print, *, device='cuda', fused: bool = True,
                  init_params=None, proposal_params=None,
                  train_draws: Optional[Callable[[int], TrainDraws]] = None,
                  chain_noise: Optional[Callable[[int, Optional[int]], NoiseSource]] = None
                  ) -> dict:
    """Train the port's denoiser and score it as the JAX ``run_diffusion``
    does; returns ``{'curve', 'best_epoch', 'final'}`` in its layout.
    ``fused`` False samples through the plain ``vpu`` forward (bf16
    residual stream, as the JAX study's chains run) instead of K2 (f32
    residual stream). ``init_params`` / ``proposal_params`` (JAX trees)
    replace the seeded initial weights of the denoiser / the proposal."""
    device = torch.device(device)
    model = P.get_model('diffusion', num_dofs=ds.num_dofs,
                        num_contact_bodies=ds.num_contact_bodies, history_len=P.WINDOW,
                        stride=P.STRIDE, root_history_len=ds.root_history_len,
                        generator=torch.Generator().manual_seed(seed), device=device)
    if init_params is not None:
        model.load_state_dict(params_from_jax('diffusion', init_params))
    sched = DDPMSchedule(model.timesteps, device=device)
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'adam', DIFF_LR))
    state.ema = ParamEMA(model, EMA_DECAY)
    state.dropout_gen = torch.Generator(device=device)
    state.dropout_seed = seed + 1000
    current = {}
    step = make_diffusion_train_step(
        model, ds.lab_offsets, sched, cond_dropout=COND_DROPOUT,
        draws=None if train_draws is None else _fed_draws(lambda: current['draws']))

    # the snapshots are scored by a second denoiser of the same shapes
    net = P.get_model('diffusion', num_dofs=ds.num_dofs,
                      num_contact_bodies=ds.num_contact_bodies, history_len=P.WINDOW,
                      stride=P.STRIDE, root_history_len=ds.root_history_len,
                      device=device).eval()

    def sampler(**kw):
        return make_sampler(model, sched, num_steps=DDIM_STEPS, fused_inference=fused, **kw)

    plain = sampler()
    shorts = short_keys()

    def sample_metrics(weights: Weights, xs: torch.Tensor, labs: dict, sample=plain,
                       init: Optional[torch.Tensor] = None, chains: Optional[int] = None):
        net.load_state_dict(weights)

        def chain(xb, start, k, **kw):
            gen = torch.Generator(device=device).manual_seed(chain_seed(seed, start, k))
            noise = None if chain_noise is None else chain_noise(start, k)
            return sample(net, xb, generator=gen, noise=noise, **kw)

        preds = []
        for i in range(0, xs.shape[0], P.DEV_BATCH):
            xb = xs[i:i + P.DEV_BATCH]
            kw = {} if init is None else {'init': init[i:i + P.DEV_BATCH]}
            if chains is None:
                out = chain(xb, i, None, **kw)
            else:
                outs = [chain(xb, i, k, **kw) for k in range(chains)]
                out = {key: torch.stack([o[key] for o in outs]).mean(0) for key in outs[0]}
            preds.append({k: out[full].float().cpu().numpy() for k, full in shorts.items()})
        pred = {k: np.concatenate([p[k] for p in preds]) for k in shorts}
        return P.dev_metrics(pred, labs)

    def snapshot(weights: Weights) -> Weights:
        return {k: v.detach().float().clone() for k, v in weights.items()}

    x, y, xd = P.to_device(x_tr, device), P.to_device(y_tr, device), P.to_device(x_dev, device)
    sub = slice(0, eval_subset)
    lab_sub = {k: v[sub] for k, v in lab_dev.items()}

    best = {'force': float('inf'), 'epoch': -1, 'params': None, 'ema': None}
    curve = []
    it = 0
    t_start = time.perf_counter()
    for ep in range(epochs):
        for bi in P.epoch_batches(schedule, ep, device):
            if train_draws is not None:
                current['draws'] = train_draws(it)
            m = step(state, x[bi], y[bi])
            it += 1
        if (ep + 1) % eval_every == 0 or ep == epochs - 1:
            dm = sample_metrics(state.ema.state_dict(), xd[sub], lab_sub)
            dm['epoch'] = ep
            dm['train_loss'] = float(m['loss'])
            curve.append(dm)
            log(f'  ep {ep + 1}/{epochs} loss {dm["train_loss"]:.4f} '
                f'sub-dev force {dm["force_avg_err"]:.3f} '
                f'cop {dm["cop_avg_err"]:.4f} '
                f'({time.perf_counter() - t_start:.0f}s)', flush=True)
            if dm['force_avg_err'] < best['force']:
                best.update(force=dm['force_avg_err'], epoch=ep,
                            params=snapshot(dict(model.named_parameters())),
                            ema=snapshot(state.ema.state_dict()))
    out = {'curve': curve, 'best_epoch': best['epoch']}

    # every sampling surface on the whole dev split, from the best snapshot
    bp, be = best['params'], best['ema']
    log(f'  final full-dev evals (best snapshot, epoch {best["epoch"] + 1})', flush=True)
    final = out['final'] = {}
    final['raw_g1'] = sample_metrics(bp, xd, lab_dev)
    final['ema_g1'] = sample_metrics(be, xd, lab_dev)
    final[f'ema_g{GUIDANCE:g}'] = sample_metrics(be, xd, lab_dev,
                                                 sample=sampler(guidance_scale=GUIDANCE))
    final[f'ema_mean{MEAN_K}'] = sample_metrics(be, xd, lab_dev, chains=MEAN_K)

    proposal = train_proposal(ds, x_tr, y_tr, seed, PROPOSAL_EPOCHS, schedule, device=device,
                              init_params=proposal_params)
    with torch.no_grad():
        init_full = torch.cat([diffusion_targets_from_outputs(proposal(xd[i:i + P.DEV_BATCH]))
                               for i in range(0, xd.shape[0], P.DEV_BATCH)]).float()
    final[f'ema_partial{PARTIAL_FRAC:g}'] = sample_metrics(
        be, xd, lab_dev, sample=sampler(partial_frac=PARTIAL_FRAC), init=init_full)
    # the proposal itself, scored in raw units
    init_raw = init_full.cpu().numpy() * target_scales(ds.num_contact_bodies).numpy()
    pred = {k: init_raw[..., o:o + w] for k, (o, w) in _target_slices(ds).items()}
    final['proposal_ff'] = P.dev_metrics(pred, lab_dev)
    return out


def _target_slices(ds):
    """Head-slice order of diffusion_targets_from_labels: cops, forces,
    torques, wrenches — offsets within the packed target tensor."""
    sl, off = {}, 0
    nb = ds.num_contact_bodies
    widths = {'cops': 3 * nb, 'forces': 3 * nb, 'torques': 3 * nb,
              'wrenches': 6 * nb}
    for name in ('cops', 'forces', 'torques', 'wrenches'):
        sl[name] = (off, widths[name])
        off += widths[name]
    return sl


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--family', choices=('transformer', 'diffusion'), required=True)
    ap.add_argument('--epochs', type=int, default=None,
                    help='default: 10 transformer / 40 diffusion')
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    ap.add_argument('--eval-every', type=int, default=5)
    ap.add_argument('--eval-subset', type=int, default=512)
    ap.add_argument('--out', default=os.path.join('outputs', 'port_anchor_quality.json'))
    ap.add_argument('--data', default=os.path.join('outputs', 'ib_parity_data_af'))
    ap.add_argument('--trial-length', type=int, default=1500)
    ap.add_argument('--device', default='cuda',
                    help='cuda (default; stops when there is no GPU) or cpu')
    ap.add_argument('--attn-impl', choices=('vpu', 'pallas'), default='vpu',
                    help='the transformer\'s tree: pallas trains through K3 and '
                         'evaluates through K2 on the card')
    ap.add_argument('--init-from', default=None,
                    help='a directory of seed{N}.npz JAX parameter trees (diffusion: '
                         'denoiser/ and proposal/); each seed starts from its tree '
                         'instead of the seeded draw')
    args = ap.parse_args(argv)
    device = P.study_device(args.device)
    if args.family == 'diffusion' and args.attn_impl != 'vpu':
        raise SystemExit('--attn-impl applies to --family transformer')
    epochs = args.epochs or (10 if args.family == 'transformer' else 40)

    ds_tr, ds_dev, x_tr, y_tr, x_dev, lab_dev, sl, digest = P.build_study_data(
        args.data, args.trial_length, 'all_frames')
    print(f'train windows {len(ds_tr)}  dev windows {len(ds_dev)}  '
          f'input [{x_tr.shape[1]}x{x_tr.shape[2]}]  data sha256 {digest}', flush=True)

    results = {'config': {'family': args.family, 'window': P.WINDOW,
                          'stride': P.STRIDE, 'batch': P.BATCH,
                          'epochs': epochs, 'seeds': args.seeds,
                          'n_train': len(ds_tr), 'n_dev': len(ds_dev),
                          'trial_length': args.trial_length, 'init_from': args.init_from},
               **P.provenance(device, digest), 'runs': {}}
    if args.family == 'diffusion':
        results['config'].update(
            lr=DIFF_LR, opt='adam', ema_decay=EMA_DECAY,
            cond_dropout=COND_DROPOUT, guidance=GUIDANCE,
            ddim_steps=DDIM_STEPS, partial_frac=PARTIAL_FRAC,
            mean_k=MEAN_K, eval_every=args.eval_every, eval_subset=args.eval_subset,
            sampler_draws='torch.Generator a chain, seeded from (seed, dev batch, chain)')
    else:
        results['config'].update(lr=P.LR, opt='rmsprop', attn_impl=args.attn_impl)

    for seed in args.seeds:
        schedule = P.batch_schedule(len(ds_tr), seed, epochs)
        init = P.init_params_for(args.init_from, seed)
        t0, before = time.perf_counter(), P.kernel_launches()
        if args.family == 'transformer':
            curve = P.run_port(ds_tr, x_tr, y_tr, x_dev, lab_dev, sl, seed, epochs,
                               schedule, model_type='transformer', device=device,
                               attn_impl=args.attn_impl, init_params=init)
            run = results['runs'][str(seed)] = P.run_record(
                curve, time.perf_counter() - t0, P.launches_since(before))
            b = run['best']
            print(f'seed {seed}: {run["seconds"]:.1f}s  best force '
                  f'{b["force_avg_err"]:.3f} cop {b["cop_avg_err"]:.4f} '
                  f'com {b["com_acc_avg_err"]:.3f}', flush=True)
        else:
            r = run_diffusion(ds_tr, x_tr, y_tr, x_dev, lab_dev, seed, epochs, schedule,
                              args.eval_every, args.eval_subset, device=device,
                              init_params=None if init is None else init['denoiser'],
                              proposal_params=None if init is None else init['proposal'])
            r['seconds'] = time.perf_counter() - t0
            r['launches'] = P.launches_since(before)
            results['runs'][str(seed)] = r
            print(f'seed {seed}: {r["seconds"]:.1f}s  '
                  + '  '.join(f'{k}: force {v["force_avg_err"]:.3f}'
                              for k, v in r['final'].items()), flush=True)
        P.write_json(args.out, results)
    print(f'wrote {args.out}')

    if args.family == 'transformer':
        P.print_summary(results, args.seeds)
    else:
        for v in results['runs'][str(args.seeds[0])]['final']:
            for m in P.METRICS:
                vals = [results['runs'][str(s)]['final'][v][m] for s in args.seeds]
                print(f'{v} {m}: mean {np.mean(vals):.4f} '
                      f'(range {min(vals):.4f}-{max(vals):.4f})')
    return 0


if __name__ == '__main__':
    sys.exit(main())
