"""The port's sweep (inferbiomechanics_tpu_torch/train/sweep.py and
``python -m inferbiomechanics_tpu_torch sweep``) on the CPU, against the JAX
package's ``train/sweep.py`` on the same synthetic subjects and weights.

- The exact-lr rule: an optimizer whose learning rate is set after it was
  built (PBT's write) is bitwise one built at that rate, for every rule,
  with and without clipping; and it follows the JAX sweep's rule (built at
  1.0, each update scaled by the rate) at the tolerance of
  tests/test_torch_optimizers.py (rtol 1e-5, atol 1e-7).
- The sweep step over K = 4 configs from the JAX package's initial
  parameters (converted), three steps on the same batches: each config's
  loss within 2e-2 relative (tests/test_torch_train.py's step tolerance),
  and each config's parameter change within 5e-2 x the largest of the JAX
  change's tensor (tests/test_torch_streaming.py's tolerance).
  GroundLink's dropout masks and the denoiser's t and noise are JAX's own,
  fed through ``dropout_masks`` and ``TrainDraws``.
- ``run_sweep`` against the JAX ``run_sweep`` on the device and host tiers:
  each config's dev curve within 2e-2 relative; the PBT events identical
  given the same dev losses (both sides' dev scores replaced by one table).
- The port against itself, bitwise: config i of a sweep is a one-config
  sweep of (lr_i, seed_i); resume, and SIGTERM then resume, equal an
  uninterrupted sweep; another grid starts fresh.
"""

import dataclasses
import json
import logging
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from inferbiomechanics_tpu.config import Config as JaxConfig
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.models.diffusion import DDPMSchedule as JaxSchedule
from inferbiomechanics_tpu.models.diffusion import diffusion_targets_from_labels as jax_targets
from inferbiomechanics_tpu.train import optimizers as jopt
from inferbiomechanics_tpu.train import sweep as jsweep
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu.train.loop import loss_config_from as jax_loss_config_from
from inferbiomechanics_tpu.train.state import TrainState as JaxTrainState
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.__main__ import main
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.models import diffusion as pd
from inferbiomechanics_tpu_torch.models.diffusion import DDPMSchedule
from inferbiomechanics_tpu_torch.train import sweep
from inferbiomechanics_tpu_torch.train import optimizers as topt
from inferbiomechanics_tpu_torch.train.checkpoint import BEST_NAME, load_checkpoint_file
from inferbiomechanics_tpu_torch.train.loop import loss_config_from
from inferbiomechanics_tpu_torch.train.state import TrainState
from inferbiomechanics_tpu_torch.train.step import as_train_step

LOSS_REL = 2e-2
DELTA_REL = 5e-2
OPT_TOL = dict(rtol=1e-5, atol=1e-7)
BATCH = 16
LRS, SEEDS = [1e-4, 3e-5], [0, 1]    # RMSprop at test_torch_train.py's 1e-4
FAMILIES = {
    'feedforward': dict(hidden_dims=[32, 32]),
    'groundlink': dict(),
    'pallas': dict(model_type='transformer', attn_impl='pallas', d_model=128, num_layers=1,
                   num_heads=4),
    'diffusion': dict(output_data_format='all_frames', window_size=20, d_model=64,
                      num_layers=1, num_heads=4, diffusion_timesteps=64),
}


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """Small models beside other test processes: one thread throughout."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_sweep')
    for split, trials, seed in (('train', 2, 0), ('dev', 1, 1)):
        os.makedirs(root / split)
        write_synthetic_subject(str(root / split / 's.b3d'), num_trials=trials,
                                trial_length=150, seed=seed)
    return root


def _configs(root, ckpt, family='feedforward', **fields):
    out = []
    for cls in (JaxConfig, Config):
        cfg = cls()
        cfg.dataset_home, cfg.checkpoint_dir = str(root), str(ckpt)
        cfg.model_type = family
        cfg.batch_size, cfg.epochs = BATCH, 2
        for k, v in {**FAMILIES[family], **fields}.items():
            setattr(cfg, k, v)
        out.append(cfg)
    return out


def _splits(root, cfg):
    kw = dict(window_size=cfg.window_size, stride=cfg.stride,
              output_data_format=cfg.output_data_format, skip_loading_skeletons=True)
    return {name: (WindowDataset(str(root / name), **kw), JaxWindowDataset(str(root / name), **kw))
            for name in ('train', 'dev')}


def _jax_init(jcfg, jds, seeds):
    """The JAX sweep's initial state: each seed's parameters as its
    ``init_sweep_states`` draws them (``init(PRNGKey(seed))``, here jitted
    once rather than traced op by op under ``vmap``), stacked, with the
    optimizer at 1.0; and the host trees by seed."""
    jmodel = jax_build(jcfg, jds)
    sample = jnp.asarray(jds.gather(np.arange(BATCH)).inputs)
    if jcfg.model_type == 'diffusion':
        x0 = jnp.zeros((sample.shape[0], sample.shape[1], jmodel.target_channels))
        t0 = jnp.zeros((sample.shape[0],), jnp.int32)
        init = jax.jit(lambda key: jmodel.init({'params': key, 'dropout': key}, x0, t0,
                                               sample)['params'])
    else:
        init = jax.jit(lambda key: jmodel.init({'params': key, 'dropout': key}, sample,
                                               train=False)['params'])
    trees = {int(s): jax.device_get(init(jax.random.PRNGKey(int(s)))) for s in seeds}
    params = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[trees[int(s)] for s in seeds])
    tx = jopt.make_optimizer(jcfg.opt_type, 1.0)
    jstate = JaxTrainState(step=jnp.zeros((len(seeds),), jnp.int32), params=params,
                           opt_state=jax.vmap(tx.init)(params), batch_stats={}, tx=tx,
                           apply_fn=jmodel.apply)
    return jmodel, tx, jstate, trees


def _family(cfg, ds):
    return weights.model_family(build_model_for_dataset(cfg, ds))


# -- the grid and the exact-lr rule -----------------------------------------------


def test_sweep_grid_is_lr_major():
    assert sweep.sweep_grid([1e-3, 1e-4], [0, 1]) == jsweep.sweep_grid([1e-3, 1e-4], [0, 1]) \
        == [(1e-3, 0), (1e-3, 1), (1e-4, 0), (1e-4, 1)]


@pytest.mark.parametrize('clip', [0.0, 0.5])
@pytest.mark.parametrize('opt_type', topt.OPT_TYPES)
def test_exact_lr_rule(opt_type, clip):
    """An optimizer built at 1.0 and set to 3e-3 makes bitwise the updates of
    one built at 3e-3 (five updates), and follows the JAX sweep's rule."""
    rng = np.random.default_rng(len(opt_type))
    shapes = {'a.weight': (5, 7), 'a.bias': (5,), 'b.weight': (3, 5)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10 ** rng.uniform(-2, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    lr = 3e-3
    sides = []
    for built_at in (1.0, lr):
        tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
        opt = topt.make_optimizer(list(tp.items()), opt_type, built_at, grad_clip_norm=clip)
        if built_at == 1.0:
            sweep.set_learning_rate(opt, lr)
        sides.append((tp, opt))
    tx = jopt.make_optimizer(opt_type, 1.0, grad_clip_norm=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    for i, g in enumerate(grads):
        for tp, opt in sides:
            for k, p in tp.items():
                p.grad = torch.from_numpy(g[k].copy())
            opt.step()
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, jax.tree_util.tree_map(lambda u: u * jnp.float32(lr),
                                                            updates))
        for k in shapes:
            assert torch.equal(sides[0][0][k], sides[1][0][k]), (opt_type, i, k)
            np.testing.assert_allclose(sides[0][0][k].detach().numpy(), np.asarray(jp[k]),
                                       err_msg=f'{opt_type} update {i} {k}', **OPT_TOL)


# -- the sweep step ----------------------------------------------------------------


def _jax_mask_fn(jm):
    """``masks(params, x, key)``: the keep masks of ``jm``'s dropout sites
    with a rate above 0, in call order (a Dropout's captured output is 0
    exactly where it dropped)."""
    rates = [jm.cnn_dropout] * len(jm.cnn_features) + [jm.fc_dropout] * jm.fc_depth

    @jax.jit
    def captured(p, x, key):
        _, st = jm.apply({'params': p}, x, train=True, rngs={'dropout': key},
                         capture_intermediates=True, mutable=['intermediates'])
        return [st['intermediates'][f'Dropout_{i}']['__call__'][0]
                for i, rate in enumerate(rates) if rate > 0]

    return lambda p, x, key: [np.asarray(m) != 0 for m in captured(p, x, key)]


def _mask_source(masks):
    it = iter(masks)

    def source(shape, p, device):
        m = next(it)
        assert m.shape == shape, (m.shape, shape)
        return torch.from_numpy(m)
    return source


def _assert_deltas_close(fam, state, jstate, trees, grid, family):
    """Each config's parameter change over the steps against the JAX
    sweep's change of that config's slice of the stacked state, tensor by
    tensor, within DELTA_REL x the JAX change's largest magnitude (the
    tolerance tests/test_torch_streaming.py holds a streamed epoch to), plus
    the float32 resolution of three updates to the parameter (3 ulp of its
    starting value: a LayerNorm scale near 1 moves by a few ulp a step). A
    head the loss does not read stays put on both sides; every config moves."""
    flat_j = jax.tree_util.tree_flatten_with_path(jax.device_get(jstate.params))[0]
    for i, (model, (lr, seed)) in enumerate(zip(state.models, grid)):
        now = weights.params_to_jax(fam, {n: p.detach() for n, p in model.named_parameters()})
        flat_now = dict(jax.tree_util.tree_flatten_with_path(now)[0])
        flat_b = dict(jax.tree_util.tree_flatten_with_path(trees[seed])[0])
        assert set(flat_now) == {path for path, _ in flat_j}
        moved = 0.0
        for path, stacked in flat_j:
            before = np.asarray(flat_b[path], np.float32)
            dj = np.asarray(stacked[i], np.float64) - before
            dt = np.asarray(flat_now[path], np.float64) - before
            moved = max(moved, float(np.abs(dj).max()))
            limit = DELTA_REL * np.abs(dj).max() + 3 * np.spacing(np.abs(before))
            bad = np.abs(dt - dj) > limit
            assert not bad.any(), (
                f'{family} config {i} (lr {lr}, seed {seed}) {jax.tree_util.keystr(path)}: '
                f'{int(bad.sum())} of {bad.size} changes off, port {dt[bad][:4]} against '
                f'JAX {dj[bad][:4]} (limit {limit[bad][:4]})')
        assert moved > 0, (family, i)


def _three_sweep_steps(root, ckpt, family, **fields):
    """Three sweep steps of the port and of the JAX package over the same
    batches from the same (converted) initial parameters, each config's
    loss held step by step; returns what the tests read after them."""
    jcfg, cfg = _configs(root, ckpt, family, **fields)
    data = _splits(root, cfg)
    ds, jds = data['train']
    grid = sweep.sweep_grid(LRS, SEEDS)
    jmodel, tx, jstate, trees = _jax_init(jcfg, jds, [s for _, s in grid])
    fam = _family(cfg, ds)
    state = sweep.init_sweep_states(cfg, ds, grid, 'cpu',
                                    init_weights=lambda s: weights.params_from_jax(fam, trees[s]))
    lrs = [lr for lr, _ in grid]
    diffusion = family == 'diffusion'
    fed, draws = {}, None
    if diffusion:
        jstep = jsweep.make_sweep_diffusion_step(jmodel, tx, jds.lab_offsets, lrs,
                                                 schedule=JaxSchedule(64), donate=False)
        draws = pd.TrainDraws(
            timesteps=lambda b, steps, device: torch.from_numpy(fed['t'].copy()).long(),
            noise=lambda shape, device: torch.from_numpy(fed['noise'].copy()),
            masks=lambda *a: pytest.fail('no conditioning dropout'))
        grads = sweep.make_sweep_diffusion_grads(state.models, DDPMSchedule(64), ds.lab_offsets,
                                                 draws=draws)
    else:
        jstep = jsweep.make_sweep_train_step(jmodel, tx, jds.lab_offsets,
                                             jax_loss_config_from(jcfg), lrs, donate=False)
        grads = sweep.make_sweep_grads(state.models, ds.lab_offsets, loss_config_from(cfg))
    step = as_train_step(grads)
    masks_of = _jax_mask_fn(jmodel) if family == 'groundlink' else None
    for s in range(3):
        batch = ds.gather(np.arange(s * BATCH, (s + 1) * BATCH))
        x, y = jnp.asarray(batch.inputs), jnp.asarray(batch.labels)
        key = jax.random.PRNGKey(100 + s)
        if diffusion:      # the JAX step's own noising, drawn here too
            x0 = jax_targets(y, jds.lab_offsets, jmodel.num_contact_bodies)
            _, t, noise = jsweep._noising(JaxSchedule(64), x0, key)
            fed.update(t=np.asarray(t), noise=np.asarray(noise))
        if masks_of is not None:
            for i, model in enumerate(state.models):
                p_i = jax.tree_util.tree_map(lambda a, i=i: a[i], jstate.params)
                model.dropout_masks = _mask_source(masks_of(p_i, x, jax.random.fold_in(key, i)))
        jstate, jm = jstep(jstate, x, y, key)
        m = step(state, torch.from_numpy(batch.inputs), torch.from_numpy(batch.labels))
        assert m['loss'].shape == (len(grid),)
        np.testing.assert_allclose(m['loss'].numpy(), np.asarray(jm['loss']), rtol=LOSS_REL,
                                   err_msg=f'{family} step {s}')
    assert state.step == 3
    return dict(cfg=cfg, jcfg=jcfg, data=data, grid=grid, jmodel=jmodel, jstate=jstate,
                trees=trees, fam=fam, state=state, fed=fed, draws=draws)


@pytest.mark.parametrize('family', list(FAMILIES))
def test_sweep_step_tracks_the_jax_sweep_step(root, tmp_path, family):
    run = _three_sweep_steps(root, tmp_path, family)
    cfg, jcfg, jmodel, state = run['cfg'], run['jcfg'], run['jmodel'], run['state']
    fed, draws = run['fed'], run['draws']
    # the dev score of every config after the steps, on one shared batch (the
    # denoiser's at the JAX eval's fixed noising, fed through the seam)
    dev, jdev = run['data']['dev']
    batch = dev.gather(np.arange(BATCH))
    x, y = jnp.asarray(batch.inputs), jnp.asarray(batch.labels)
    if family == 'diffusion':
        jeval = jsweep.make_sweep_diffusion_eval(jmodel, jdev.lab_offsets,
                                                 schedule=JaxSchedule(64))
        _, t, noise = jsweep._noising(JaxSchedule(64), jax_targets(
            y, jdev.lab_offsets, jmodel.num_contact_bodies), jax.random.PRNGKey(123))
        fed.update(t=np.asarray(t), noise=np.asarray(noise))
        evaluate = sweep.make_sweep_diffusion_eval(state.models, DDPMSchedule(64),
                                                   dev.lab_offsets, draws=draws)
    else:
        jeval = jsweep.make_sweep_eval_step(jmodel, jdev.lab_offsets,
                                            jax_loss_config_from(jcfg))
        evaluate = sweep.make_sweep_eval(state.models, dev.lab_offsets, loss_config_from(cfg))
    np.testing.assert_allclose(
        evaluate(torch.from_numpy(batch.inputs), torch.from_numpy(batch.labels)),
        np.asarray(jeval(run['jstate'].params, x, y)['loss']), rtol=LOSS_REL,
        err_msg=f'{family} dev')


@pytest.mark.parametrize('family', list(FAMILIES))
def test_sweep_step_parameters_track_the_jax_sweep_step(root, tmp_path, family):
    """Each config's parameters after three SGD steps: SGD's update is
    linear in the gradient, so the change is held element by element
    (RMSprop's first updates are nearly lr x sign(g), whose sign flips
    where a gradient is near 0 and bf16 rounds it either way)."""
    run = _three_sweep_steps(root, tmp_path, family, opt_type='sgd')
    _assert_deltas_close(run['fam'], run['state'], run['jstate'], run['trees'], run['grid'],
                         family)


# -- run_sweep ----------------------------------------------------------------------


def _run_port(cfg, data, lrs=LRS, seeds=SEEDS, **kw):
    ds, _ = data['train']
    dev, _ = data['dev']
    return sweep.run_sweep(cfg, ds, dev, lrs, seeds, device='cpu', **kw)


@pytest.mark.parametrize('tier', ['auto', 'off'])
def test_run_sweep_tracks_the_jax_sweep(root, tmp_path, tier):
    """Two epochs of 4 batches on the device tier and the host tier: each
    config's dev curve; the checkpoints and sidecars of each point."""
    jcfg, cfg = _configs(root, tmp_path / 'port', device_data=tier)
    jcfg.checkpoint_dir = str(tmp_path / 'jax')
    data = _splits(root, cfg)
    ds, jds = data['train']
    grid = sweep.sweep_grid(LRS, SEEDS)
    _, _, _, trees = _jax_init(jcfg, jds, SEEDS)
    fam = _family(cfg, ds)
    got = _run_port(cfg, data, max_batches_per_epoch=4,
                    init_weights=lambda s: weights.params_from_jax(fam, trees[s]))
    want = jsweep.run_sweep(jcfg, jds, data['dev'][1], LRS, SEEDS, max_batches_per_epoch=4)
    assert set(json.loads(got.to_json())) == set(json.loads(want.to_json()))
    for p, q in zip(got.points, want.points):
        assert set(vars(p)) == set(vars(q))
        assert (p.learning_rate, p.seed, p.best_epoch) == (q.learning_rate, q.seed, q.best_epoch)
        np.testing.assert_allclose(p.dev_curve, q.dev_curve, rtol=LOSS_REL)
        assert p.final_train_loss == pytest.approx(q.final_train_loss, rel=LOSS_REL)
        assert p.best_checkpoint_path.endswith(BEST_NAME)
    assert got.best_index == want.best_index
    # each point's checkpoint loads as a train run's, with its sidecar
    for (lr, seed), p in zip(grid, got.points):
        model = build_model_for_dataset(cfg, ds)
        st = TrainState(model=model, optimizer=topt.make_optimizer(
            model.named_parameters(), cfg.opt_type, lr))
        assert load_checkpoint_file(st, p.checkpoint_path) == (1, 0)
        side = json.load(open(os.path.join(os.path.dirname(p.checkpoint_path),
                                           'run_config.json')))
        assert (side['learning_rate'], side['seed']) == (lr, seed)


def test_pbt_events_are_the_jax_events(root, tmp_path, monkeypatch):
    """PBT every eval, 8 configs over 4 epochs, both sides' dev scores
    replaced by one table of losses: the same exploit/explore events and
    final learning rates."""
    jcfg, cfg = _configs(root, tmp_path / 'port', epochs=4)
    jcfg.checkpoint_dir = str(tmp_path / 'jax')
    data = _splits(root, cfg)
    lrs, seeds = [1e-3, 5e-4, 2e-4, 1e-4], [0, 1]
    table = np.random.default_rng(9).uniform(1, 2, size=(4, 8)).astype(np.float32)
    n_batches = len(data['dev'][0]) // BATCH

    def fake(calls):
        def losses(*_):
            calls[0] += 1
            return table[(calls[0] - 1) // n_batches]
        return losses

    monkeypatch.setattr(jsweep, 'make_sweep_eval_step',
                        lambda *a, **k: (lambda f: lambda *b: {'loss': f(*b)})(fake([0])))
    monkeypatch.setattr(sweep, 'make_sweep_eval', lambda *a, **k: fake([0]))
    want = jsweep.run_sweep(jcfg, data['train'][1], data['dev'][1], lrs, seeds,
                            max_batches_per_epoch=1, pbt_every=1)
    got = _run_port(cfg, data, lrs, seeds, max_batches_per_epoch=1, pbt_every=1)
    assert len(want.pbt_events) == 3 * 2
    assert got.pbt_events == want.pbt_events
    assert [p.final_learning_rate for p in got.points] == \
        [p.final_learning_rate for p in want.points]
    assert [p.dev_curve for p in got.points] == [p.dev_curve for p in want.points]


def test_early_stop_is_the_jax_early_stop(root, tmp_path, monkeypatch):
    """--early-stop-patience 1 with dev losses that improve once, then not:
    both sides stop after the same epoch, with the same curves and best
    epochs."""
    jcfg, cfg = _configs(root, tmp_path / 'port', epochs=5, early_stop_patience=1)
    jcfg.checkpoint_dir = str(tmp_path / 'jax')
    data = _splits(root, cfg)
    table = np.asarray([[3, 2, 1, 4], [2, 1, 2, 3], [2.5, 1.5, 1.5, 3.5], [1, 1, 1, 1]],
                       np.float32)
    n_batches = len(data['dev'][0]) // BATCH

    def fake(calls):
        def losses(*_):
            calls[0] += 1
            return table[(calls[0] - 1) // n_batches]
        return losses

    monkeypatch.setattr(jsweep, 'make_sweep_eval_step',
                        lambda *a, **k: (lambda f: lambda *b: {'loss': f(*b)})(fake([0])))
    monkeypatch.setattr(sweep, 'make_sweep_eval', lambda *a, **k: fake([0]))
    want = jsweep.run_sweep(jcfg, data['train'][1], data['dev'][1], LRS, SEEDS,
                            max_batches_per_epoch=1)
    got = _run_port(cfg, data, max_batches_per_epoch=1)
    assert [p.dev_curve for p in got.points] == [p.dev_curve for p in want.points]
    assert len(got.points[0].dev_curve) == 3
    assert [p.best_epoch for p in got.points] == [p.best_epoch for p in want.points]
    assert got.best_index == want.best_index


def _curves(result):
    return [p.dev_curve for p in result.points], [p.final_train_loss for p in result.points]


def _params(result):
    return [torch.load(p.checkpoint_path, weights_only=True)['model_state_dict']
            for p in result.points]


def test_config_i_is_a_one_config_sweep(root, tmp_path):
    """With dropout (each config's masks from its own seed) and
    augmentation (the sweep's draws, shared): config i of the grid, bitwise
    a sweep of (lr_i, seed_i) alone."""
    _, cfg = _configs(root, tmp_path / 'grid', dropout=True, dropout_prob=0.2,
                      augment_mirror=True, augment_noise_std=0.05, device_chunk_steps=2)
    data = _splits(root, cfg)
    grid = _run_port(cfg, data, max_batches_per_epoch=3)
    for i, (lr, seed) in enumerate(sweep.sweep_grid(LRS, SEEDS)):
        one = _run_port(dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / f'one{i}')),
                        data, [lr], [seed], max_batches_per_epoch=3)
        assert one.points[0].dev_curve == grid.points[i].dev_curve
        assert one.points[0].final_train_loss == grid.points[i].final_train_loss
        for k, v in _params(one)[0].items():
            assert torch.equal(v, _params(grid)[i][k]), k


def test_resume_and_sigterm_equal_an_uninterrupted_sweep(root, tmp_path, caplog):
    _, cfg = _configs(root, tmp_path / 'whole', epochs=3)
    data = _splits(root, cfg)
    whole = _run_port(cfg, data, max_batches_per_epoch=2, pbt_every=1)

    # without PBT (which skips the last epoch, so --epochs moves it): one
    # epoch, then the same sweep asked for three resumes the grid saved
    plain = _run_port(dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / 'plain')), data,
                      max_batches_per_epoch=2)
    cut = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / 'cut'))
    for epochs in (1, 3):
        part = _run_port(dataclasses.replace(cut, epochs=epochs), data, max_batches_per_epoch=2)
    assert _curves(part)[0] == _curves(plain)[0]

    # SIGTERM during epoch 0: the grid is saved at its end, and the rerun
    # goes on from there
    class Kill:
        def log(self, row):
            if row.get('epoch') == 0:
                os.kill(os.getpid(), signal.SIGTERM)

    term = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / 'term'))
    first = _run_port(term, data, max_batches_per_epoch=2, pbt_every=1, metric_logger=Kill())
    assert first.preempted and len(first.points[0].dev_curve) == 1
    rest = _run_port(term, data, max_batches_per_epoch=2, pbt_every=1)
    assert _curves(rest)[0] == _curves(whole)[0] and rest.pbt_events == whole.pbt_events
    for a, b in zip(_params(rest), _params(whole)):
        for k in a:
            assert torch.equal(a[k], b[k]), k

    # another grid in the same directory: a warning and a fresh start
    with caplog.at_level(logging.WARNING):
        other = _run_port(term, data, [1e-3], [0], max_batches_per_epoch=2)
    assert 'does not match the requested lr x seed grid' in caplog.text
    assert len(other.points[0].dev_curve) == 3


def test_stream_tier_sweeps(root, tmp_path):
    """The streaming tier: a segment a trial, its windows a segment at a
    time; chunked equal to step by step."""
    _, cfg = _configs(root, tmp_path / 'a', device_data='stream', device_chunk_steps=4)
    cfg.device_data_max_bytes = 200 * (177 + 63) * 4
    data = _splits(root, cfg)
    a = _run_port(cfg, data)
    b = _run_port(dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / 'b'),
                                      device_chunk_steps=1), data)
    assert _curves(a) == _curves(b)
    assert a.windows_per_sec > 0


def test_sweep_cli_writes_the_jax_results_keys(root, tmp_path, capsys):
    rc = main(['sweep', '--dataset-home', str(root), '--checkpoint-dir', str(tmp_path),
               '--device', 'cpu', '--batch-size', str(BATCH), '--epochs', '1',
               '--hidden-dims', '32', '32', '--lrs', '1e-3', '3e-4', '--seeds', '0',
               '--max-batches-per-epoch', '2', '--no-wandb',
               '--hidden-dims-grid', '32,32', '16'])
    assert rc == 0
    out = json.load(open(tmp_path / 'sweep' / 'feedforward' / 'sweep_results.json'))
    assert set(out) == {'points', 'best', 'pbt_events'}
    point_keys = set(vars(jsweep.SweepPoint(0, 1.0, 0))) | {'hidden_dims'}
    assert len(out['points']) == 4 and all(set(p) == point_keys for p in out['points'])
    assert {tuple(p['hidden_dims']) for p in out['points']} == {(32, 32), (16,)}
    assert os.path.isdir(tmp_path / 'sweep' / 'feedforward' / 'hid16' / 'lr0.001_seed0')
    assert 'sweep winner: lr=' in capsys.readouterr().out
    assert main(['sweep', '--dataset-home', str(root), '--checkpoint-dir', str(tmp_path),
                 '--model-type', 'analytical', '--device', 'cpu']) == 0
    assert 'nothing to sweep' in capsys.readouterr().out


@pytest.mark.parametrize('fields,shard,err,words', [
    (dict(batchnorm=True), False, ValueError, 'sweep does not support batchnorm models'),
    (dict(lr_schedule='cosine', lr_decay_steps=10), False, ValueError,
     'sweep supports constant learning rates only'),
    (dict(model_type='diffusion', output_data_format='last_frame'), False, ValueError,
     'requires --output-data-format all_frames'),
    # ported: the cases hold the flags working in one process, bitwise what
    # they are there: --shard-configs the plain sweep (configs sharded 1-way),
    # --device-data sharded each config's `train --device-data sharded`
    # (the sharded tier at one shard, the same selections)
    (dict(), True, None, None),
    (dict(device_data='sharded'), False, None, None),
], ids=[  # each case keeps the id it is known by
    'fields0-False-ValueError-sweep does not support batchnorm models',
    'fields1-False-ValueError-sweep supports constant learning rates only',
    'fields2-False-ValueError-requires --output-data-format all_frames',
    'fields3-True-NotImplementedError-shard-configs is not yet ported .* item 8b',
    'fields4-False-NotImplementedError-sharded is not yet ported .* item 8b'])
def test_refusals(root, tmp_path, fields, shard, err, words):
    _, cfg = _configs(root, tmp_path, **fields)
    data = _splits(root, dataclasses.replace(cfg, output_data_format='last_frame'))
    if err is not None:
        with pytest.raises(err, match=words):
            _run_port(cfg, data, shard_configs=shard)
        return
    got = _run_port(cfg, data, shard_configs=shard, max_batches_per_epoch=3 if shard else None)
    if shard:
        want = _run_port(dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / 'plain')), data,
                         max_batches_per_epoch=3)
        assert _curves(got) == _curves(want)
        for a, b in zip(_params(got), _params(want)):
            assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        return
    from inferbiomechanics_tpu_torch.train.loop import train
    # train's --seed draws the selections too: the configs of the sweep's seed
    for i, (lr, seed) in enumerate(sweep.sweep_grid(LRS, SEEDS)):
        if seed != cfg.seed:
            continue
        one = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / f'train{i}'),
                                  learning_rate=lr, seed=seed)
        assert train(one, data['train'][0], data['dev'][0], device='cpu').epochs_run == 2
        want = torch.load(tmp_path / f'train{i}' / 'epoch_1_batch_0.torch.pt',
                          weights_only=True)['model_state_dict']
        got_i = _params(got)[i]
        assert got_i.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got_i[k], v), (i, k)
