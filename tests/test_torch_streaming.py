"""The port's streaming tier (``--device-data stream``:
inferbiomechanics_tpu_torch/train/streaming_data.py, the segment buffer in
train/device_data.py, and the streaming epoch of both train loops) on the
CPU, against the JAX package's ``train/streaming_data.py`` on the same
synthetic subjects.

The JAX epoch seeds its host generator from its ``jax.random`` key; the
tests pass that integer to the port's epoch through its ``host_seed`` seam,
so both visit the same segments and windows in the same order. A diffusion
step's draws are JAX's own, fed through ``models/diffusion.py::TrainDraws``.

Tolerances (those of tests/test_torch_train.py for the same step): the
epoch's mean metrics within 2e-2 relative; the parameters' change over the
epoch within 5e-2 x its largest magnitude, with SGD so that the change is
linear in the gradients (RMSprop's first update is about lr x sign(g), so
a bf16-level difference in a near-zero gradient flips it). The plan, the
segment arrays, and the port against itself (chunked, on demand) are held
exactly.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.config import Config as JaxConfig
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.train import streaming_data as jsd
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu.train.loop import loss_config_from as jax_loss_config_from
from inferbiomechanics_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from inferbiomechanics_tpu.train.state import TrainState as JaxTrainState
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.models import diffusion as pd
from inferbiomechanics_tpu_torch.models.diffusion import DDPMSchedule
from inferbiomechanics_tpu_torch.train import streaming_data as sd
from inferbiomechanics_tpu_torch.train.diffusion_loop import train_diffusion
from inferbiomechanics_tpu_torch.train.loop import loss_config_from, train
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
from inferbiomechanics_tpu_torch.train.state import ParamEMA, create_train_state

LOSS_REL = 2e-2
DELTA_REL = 5e-2
BATCH = 16
LR = 1e-4
DIFF = dict(d_model=64, num_layers=1, num_heads=4, diffusion_timesteps=64)


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """Small models beside other test processes: one thread throughout."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """Two train subjects of unequal trials (3 x 150 and 2 x 220 frames) and
    a dev subject."""
    root = tmp_path_factory.mktemp('torch_streaming')
    os.makedirs(root / 'train')
    os.makedirs(root / 'dev')
    write_synthetic_subject(str(root / 'train' / 'a.b3d'), num_trials=3, trial_length=150, seed=0)
    write_synthetic_subject(str(root / 'train' / 'b.b3d'), num_trials=2, trial_length=220, seed=1)
    write_synthetic_subject(str(root / 'dev' / 'c.b3d'), num_trials=1, trial_length=120, seed=2)
    return root


def _datasets(root, split='train', **kw):
    kw = dict(dict(window_size=50, stride=5, skip_loading_skeletons=True), **kw)
    return (WindowDataset(str(root / split), **kw), JaxWindowDataset(str(root / split), **kw))


def _budget(ds, rows):
    return rows * (ds.num_input_channels + ds.num_label_channels) * 4


def test_plan_is_the_jax_plan(root):
    ds, jds = _datasets(root)
    for rows in (220, 300, 460, 10_000):
        plan, jplan = sd.StreamingPlan(ds, _budget(ds, rows)), jsd.StreamingPlan(jds, _budget(ds, rows))
        assert len(plan.segments) == len(jplan.segments) > 0
        assert plan.rows_pad == jplan.rows_pad
        for s, js in zip(plan.segments, jplan.segments):
            assert s.trials == js.trials and s.n_rows == js.n_rows
            np.testing.assert_array_equal(s.win_base, js.win_base)
        for si in range(len(plan.segments)):
            for a, b in zip(plan.segment_arrays(si), jplan.segment_arrays(si)):
                np.testing.assert_array_equal(a, b)
    # 150 + 150 | 150 | 220 | 220 rows under a budget of 300 float32 rows
    assert [s.n_rows for s in sd.StreamingPlan(ds, _budget(ds, 300)).segments] == \
        [300, 150, 220, 220]
    for mod, d in ((sd, ds), (jsd, jds)):
        with pytest.raises(ValueError, match=r'trial 3 has 220 rows > segment budget 219; '
                                             r'raise hbm_budget_bytes'):
            mod.StreamingPlan(d, _budget(ds, 219))


def test_on_demand_segments_are_the_materialized_ones(root):
    ds, _ = _datasets(root)
    lazy, _ = _datasets(root, materialize_features=False)
    assert lazy.features_all is None
    plan, lplan = sd.StreamingPlan(ds, _budget(ds, 300)), sd.StreamingPlan(lazy, _budget(ds, 300))
    for si in range(len(plan.segments)):
        for a, b in zip(plan.segment_arrays(si), lplan.segment_arrays(si)):
            np.testing.assert_array_equal(a, b)


def _jax_host_seed(rng):
    return int(jax.device_get(jax.random.randint(rng, (), 0, 2**31 - 1)))


def _family_pair(cfg_fields, ds, jds, seed=0):
    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        for k, v in cfg_fields.items():
            setattr(c, k, v)
    jmodel = jax_build(jcfg, jds)
    model = build_model_for_dataset(cfg, ds)
    family = weights.model_family(model)
    sample = jnp.asarray(jds.gather(np.arange(4)).inputs)
    if cfg.model_type == 'diffusion':
        x0 = jnp.zeros((4, sample.shape[1], jmodel.target_channels))
        params = jmodel.init({'params': jax.random.PRNGKey(seed)}, x0,
                             jnp.zeros((4,), jnp.int32), sample)['params']
    else:
        params = jmodel.init({'params': jax.random.PRNGKey(seed)}, sample, train=False)['params']
    params = jax.device_get(params)
    model.load_state_dict(weights.params_from_jax(family, params))
    return jcfg, cfg, jmodel, model, params, family


def _assert_delta_close(family, model, before, jax_after, msg=''):
    """The port's parameter change against the JAX package's, tensor by
    tensor, within DELTA_REL x the JAX change's largest magnitude."""
    now = weights.params_to_jax(family, {n: p.detach() for n, p in model.named_parameters()})
    flat_now = dict(jax.tree_util.tree_flatten_with_path(now)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(before)[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jax_after)[0])
    assert set(flat_now) == set(flat_j)
    for path, want in flat_j.items():
        dj = np.asarray(want, np.float64) - np.asarray(flat_b[path], np.float64)
        dt = np.asarray(flat_now[path], np.float64) - np.asarray(flat_b[path], np.float64)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=DELTA_REL * np.abs(dj).max() + 1e-9,
                                   err_msg=f'{msg} {jax.tree_util.keystr(path)}')


def _assert_metrics_close(m, jm):
    assert set(m) == set(jm)
    for k in jm:
        want = np.asarray(jm[k], np.float64)
        np.testing.assert_allclose(np.asarray(m[k], np.float64), want, rtol=LOSS_REL,
                                   atol=LOSS_REL * np.abs(want).max() + 1e-9, err_msg=k)


@pytest.mark.parametrize('fmt,window,stride', [('last_frame', 50, 5), ('all_frames', 50, 5),
                                               ('last_frame', 50, 7)])
def test_streamed_epoch_tracks_the_jax_epoch(root, fmt, window, stride):
    """One streamed feedforward epoch from the same weights, with JAX's host
    seed, over 4 segments: the mean of the per-segment mean metrics and the
    parameters' change."""
    kw = dict(window_size=window, stride=stride, output_data_format=fmt)
    ds, jds = _datasets(root, **kw)
    jcfg, cfg, jmodel, model, params, family = _family_pair(
        dict(model_type='feedforward', batch_size=BATCH, window_size=window, stride=stride,
             output_data_format=fmt), ds, jds)
    budget = _budget(ds, 300)
    jplan = jsd.StreamingPlan(jds, budget)
    tx = jax_make_optimizer('sgd', LR)
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           opt_state=tx.init(params), batch_stats={}, tx=tx,
                           apply_fn=jmodel.apply)
    rng = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    jstate, jm = jsd.make_streaming_epoch(jmodel, jds, jplan, jax_loss_config_from(jcfg),
                                          BATCH)(jstate, rng)

    state = create_train_state(model, make_optimizer(model.named_parameters(), 'sgd', LR))
    plan = sd.StreamingPlan(ds, budget)
    epoch = sd.make_streaming_epoch(model, ds, plan, loss_config_from(cfg), BATCH, 'cpu')
    m = epoch(state, _jax_host_seed(rng))
    assert len(epoch.stats) == len(plan.segments) == 4
    assert state.step == int(jstate.step) == sum(s.steps for s in epoch.stats)
    assert sum(s.windows for s in epoch.stats) == sd.streaming_windows_per_epoch(plan, BATCH)
    _assert_metrics_close(m, jm)
    _assert_delta_close(family, model, params, jax.device_get(jstate.params))


def _ff_epoch(ds, chunk_steps, seed=0, epochs=2):
    cfg = Config()
    cfg.batch_size = BATCH
    model = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'rmsprop', 1e-3))
    plan = sd.StreamingPlan(ds, _budget(ds, 300))
    epoch = sd.make_streaming_epoch(model, ds, plan, loss_config_from(cfg), BATCH, 'cpu',
                                    chunk_steps=chunk_steps)
    metrics = [epoch(state, sd.host_seed_for(0, e)) for e in range(epochs)]
    return metrics, {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_on_demand_and_chunked_epochs_are_bitwise_the_plain_one(root):
    ds, _ = _datasets(root)
    lazy, _ = _datasets(root, materialize_features=False)
    want_m, want_p = _ff_epoch(ds, 1)
    for data, k in ((ds, 4), (lazy, 1)):
        got_m, got_p = _ff_epoch(data, k)
        for a, b in zip(got_m, want_m):
            assert set(a) == set(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
        for key in want_p:
            assert torch.equal(got_p[key], want_p[key]), key


def _jax_diffusion_draws(plan, host_seed, rng, batch, frames, channels, timesteps):
    """JAX's per-step (t, noise) of a streamed diffusion epoch, in the order
    the port's epoch asks for them: the segments' visiting order from the
    host seed, and within a segment the scan's ``split(rng, 3)`` chain from
    ``fold_in(rng, segment)``."""
    host = np.random.default_rng(host_seed)
    order = [si for si in host.permutation(len(plan.segments))
             if plan.segments[si].win_base.shape[0] >= batch]

    @jax.jit
    def one(r):
        r, rt, rn = jax.random.split(r, 3)
        return r, jax.random.randint(rt, (batch,), 0, timesteps), jax.random.normal(
            rn, (batch, frames, channels))

    out = []
    for si in order:
        r = jax.random.fold_in(rng, int(si))
        for _ in range(plan.segments[si].win_base.shape[0] // batch):
            r, t, noise = one(r)
            out.append((np.asarray(t), np.asarray(noise)))
    return out


def test_streamed_diffusion_epoch_with_ema_tracks_the_jax_epoch(root):
    kw = dict(window_size=20, stride=5, output_data_format='all_frames')
    ds, jds = _datasets(root, **kw)
    jcfg, cfg, jmodel, model, params, family = _family_pair(
        dict(model_type='diffusion', batch_size=BATCH, window_size=20, stride=5,
             output_data_format='all_frames', **DIFF), ds, jds)
    budget = _budget(ds, 460)     # two segments: two JAX compiles
    jplan = jsd.StreamingPlan(jds, budget)
    tx = jax_make_optimizer('sgd', LR)
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           opt_state=tx.init(params), batch_stats={}, tx=tx,
                           apply_fn=jmodel.apply)
    from inferbiomechanics_tpu.models.diffusion import DDPMSchedule as JaxSchedule
    rng = jax.random.fold_in(jax.random.PRNGKey(5), 1)
    run = jsd.make_streaming_diffusion_epoch(jmodel, jds, jplan, JaxSchedule(64), BATCH,
                                             ema_decay=0.9)
    jstate, jema, jm = run(jstate, params, rng)

    plan = sd.StreamingPlan(ds, budget)
    fed = iter(_jax_diffusion_draws(plan, _jax_host_seed(rng), rng, BATCH, model.num_frames,
                                    model.target_channels, 64))
    cur = {}

    def timesteps(b, steps, device):
        cur['t'], cur['noise'] = next(fed)
        return torch.from_numpy(cur['t'].copy()).long()

    draws = pd.TrainDraws(timesteps=timesteps,
                          noise=lambda shape, device: torch.from_numpy(cur['noise'].copy()),
                          masks=lambda shape, p, device: pytest.fail('no conditioning dropout'))
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'sgd', LR))
    state.ema = ParamEMA(model, 0.9)
    epoch = sd.make_streaming_diffusion_epoch(model, ds, plan, DDPMSchedule(64), BATCH, 'cpu',
                                              draws=draws)
    m = epoch(state, _jax_host_seed(rng))
    assert next(fed, None) is None                 # every JAX draw was used
    _assert_metrics_close(m, jm)
    _assert_delta_close(family, model, params, jax.device_get(jstate.params), 'params')
    ema_model = build_model_for_dataset(cfg, ds)
    ema_model.load_state_dict(state.ema.state_dict())
    _assert_delta_close(family, ema_model, params, jax.device_get(jema), 'ema')


# -- the loops ----------------------------------------------------------------


def _loop_config(root, ckpt, **fields):
    cfg = Config()
    cfg.dataset_home, cfg.checkpoint_dir = str(root), str(ckpt)
    cfg.batch_size, cfg.epochs = BATCH, 2
    cfg.device_data = 'stream'
    cfg.device_data_max_bytes = 300 * (177 + 63) * 4
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def test_train_streams_chunked_and_step_by_step_alike(root, tmp_path):
    ds, _ = _datasets(root)
    dev, _ = _datasets(root, 'dev')
    cfg = _loop_config(root, tmp_path / 'a', device_chunk_steps=4)
    cfg.device_data_max_bytes = _budget(ds, 300)
    a = train(cfg, ds, dev, device='cpu')
    b = train(dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / 'b'), device_chunk_steps=1),
              ds, dev, device='cpu')
    assert a.epochs_run == b.epochs_run == 2
    assert a.final_train_metrics == b.final_train_metrics
    assert a.final_dev_metrics == b.final_dev_metrics
    assert a.windows_seen == 2 * (len(ds) // BATCH) * BATCH
    # one checkpoint an epoch, and a rerun resumes after the last one
    names = sorted(os.listdir(tmp_path / 'a'))
    assert [n for n in names if n.startswith('epoch_')] == ['epoch_0_batch_0.torch.pt',
                                                            'epoch_1_batch_0.torch.pt']
    assert train(dataclasses.replace(cfg, epochs=3), ds, dev, device='cpu').epochs_run == 1


def test_train_diffusion_streams(root, tmp_path):
    ds, _ = _datasets(root, window_size=20, stride=5, output_data_format='all_frames')
    cfg = _loop_config(root, tmp_path, model_type='diffusion', output_data_format='all_frames',
                       window_size=20, stride=5, ema_decay=0.9, **DIFF)
    cfg.device_data_max_bytes = _budget(ds, 300)
    r = train_diffusion(cfg, ds, None, device='cpu')
    assert r.epochs_run == 2 and np.isfinite(r.final_train_metrics['eps_mse'])
    from inferbiomechanics_tpu_torch.train.checkpoint import read_payload
    assert 'ema_params' in read_payload(str(tmp_path / 'epoch_1_batch_0.torch.pt'))


@pytest.mark.parametrize('fields,err,words', [
    (dict(grad_accum_steps=2), ValueError, '--grad-accum-steps applies to the host'),
    (dict(grad_allreduce_dtype='bf16'), ValueError,
     '--grad-allreduce-dtype bf16 applies to the host, device-resident, and sharded'),
    # ported: the case holds the flag working (the sharded tier, one rank)
    (dict(device_data='sharded'), None, None),
    # ported: one process is a world of one device, which --model-parallel 2
    # does not divide (the JAX package's make_mesh refusal)
    (dict(model_parallel=2), ValueError, '1 devices not divisible by model_parallel=2'),
    # ported: a streamed run under --profile (one trace, of the first epoch)
    (dict(profile=True), None, None),
], ids=[  # each case keeps the id it is known by
    'fields0-ValueError---grad-accum-steps applies to the host',
    'fields1-ValueError---grad-allreduce-dtype bf16 applies to the host, device-resident, '
    'and sharded',
    'fields2-NotImplementedError-item 8b', 'fields3-NotImplementedError-item 8b',
    'fields4-NotImplementedError-item 9'])
@pytest.mark.parametrize('loop', ['train', 'diffusion'])
def test_loop_refusals(root, tmp_path, fields, err, words, loop):
    ds, _ = _datasets(root, window_size=20, stride=5, output_data_format='all_frames')
    cfg = _loop_config(root, tmp_path, window_size=20, stride=5,
                       output_data_format='all_frames', **fields)
    cfg.profile_dir = str(tmp_path / 'trace')

    def run():
        if loop == 'train':
            return train(cfg, ds, None, device='cpu')
        return train_diffusion(dataclasses.replace(cfg, model_type='diffusion', **DIFF), ds,
                               None, device='cpu')

    if err is None:
        assert run().epochs_run == 2
        # epoch-granular, as the streaming tier: one checkpoint an epoch
        assert sorted(f for f in os.listdir(tmp_path) if f.startswith('epoch_')) == [
            'epoch_0_batch_0.torch.pt', 'epoch_1_batch_0.torch.pt']
        traces = os.listdir(tmp_path / 'trace') if cfg.profile else []
        assert len(traces) == int(cfg.profile)
        assert all(t.startswith('rank0.') and t.endswith('.pt.trace.json') for t in traces)
        return
    with pytest.raises(err, match=words.replace('(', r'\(')):
        run()
