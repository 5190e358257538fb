"""The port's sharded device tier (``--device-data sharded``:
inferbiomechanics_tpu_torch/train/sharded_data.py, and both training loops
on it) on the CPU at world size 2 (gloo ranks, ``parallel/dist.py::spawn``;
``tests/torch_dist_workers.py`` is what they run), against the JAX
package's ``train/sharded_data.py`` on a mesh of two CPU devices.

The trial partition and the shard-local gather are held exactly. The JAX
epoch draws each shard's window selections and the denoiser's t and noise
on the device from its ``jax.random`` key; the tests recompute those draws
from the same key and feed them to the port's epoch through its ``sel``
seam and ``TrainDraws``, so both train the same global batches.

Tolerances (tests/test_torch_train.py's for the same bf16 step): the
epoch's mean metrics within 2e-2 relative; the parameters' (and the EMA's)
change over the epoch within 5e-2 x its largest magnitude, with SGD so that
the change is linear in the gradients.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from inferbiomechanics_tpu.config import Config as JaxConfig
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.models.diffusion import DDPMSchedule as JaxSchedule
from inferbiomechanics_tpu.parallel.mesh import make_mesh
from inferbiomechanics_tpu.train import sharded_data as jshd
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu.train.loop import loss_config_from as jax_loss_config_from
from inferbiomechanics_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from inferbiomechanics_tpu.train.state import TrainState as JaxTrainState
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.parallel import dist
from inferbiomechanics_tpu_torch.train import sharded_data as shd

LOSS_REL = 2e-2
DELTA_REL = 5e-2
B = 16                  # the global batch; 8 windows a shard
LR = 1e-4
KW = dict(window_size=20, stride=5)
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
    root = tmp_path_factory.mktemp('torch_sharded')
    for split, subjects in (('train', [(3, 150, 0), (2, 220, 1)]), ('dev', [(1, 120, 2)])):
        os.makedirs(root / split)
        for i, (trials, length, seed) in enumerate(subjects):
            write_synthetic_subject(str(root / split / f's{i}.b3d'), num_trials=trials,
                                    trial_length=length, seed=seed)
    return root


def _datasets(root, **kw):
    kw = dict(KW, skip_loading_skeletons=True, **kw)
    return (WindowDataset(str(root / 'train'), **kw),
            JaxWindowDataset(str(root / 'train'), **kw))


@pytest.mark.parametrize('n', [1, 2, 3, 4])
def test_partition_is_the_jax_partition(root, n):
    ds, jds = _datasets(root)
    assert shd.partition_trials(ds, n) == jshd.partition_trials(jds, n)


def test_partition_refusals_are_the_jax_ones(root):
    ds, jds = _datasets(root)
    for mod, d in ((shd, ds), (jshd, jds)):
        with pytest.raises(ValueError, match='5 trials < 6 shards; use the replicated'):
            mod.partition_trials(d, 6)


@pytest.mark.parametrize('fmt', ['last_frame', 'all_frames'])
def test_shard_gather_is_the_jax_local_gather(root, fmt):
    """Each rank's gather of shard-local window ids is its rows of JAX's
    ``gather_by_local_indices`` (bf16 features, float32 labels), on a
    materialized and an on-demand dataset alike; the window tables match."""
    ds, jds = _datasets(root, output_data_format=fmt)
    lazy, _ = _datasets(root, output_data_format=fmt, materialize_features=False)
    jdata = jshd.ShardedDeviceData(jds, make_mesh(n_devices=2))
    sel = np.stack([np.random.default_rng(s).integers(0, jdata.win_global.shape[1] // 2, 9)
                    for s in range(2)])
    jin, jlab = jax.device_get(jshd.gather_by_local_indices(jdata, sel))
    for r in range(2):
        for d in (ds, lazy):
            sdata = shd.ShardedDeviceData(d, r, 2, 'cpu')
            np.testing.assert_array_equal(sdata.win_global, jdata.win_global)
            assert sdata.num_windows == jdata.num_windows
            inputs, labels = shd.gather_by_local_indices(sdata, sel[r])
            assert inputs.dtype == torch.bfloat16 and labels.dtype == torch.float32
            np.testing.assert_array_equal(inputs.float().numpy(),
                                          np.asarray(jin[r * 9:(r + 1) * 9], np.float32))
            np.testing.assert_array_equal(labels.numpy(), jlab[r * 9:(r + 1) * 9])


def _pair(root, fields, sd_path, ds, jds):
    """The JAX model of ``fields`` from flax's init and the port's state dict
    of the same weights, saved at ``sd_path``."""
    jcfg = JaxConfig()
    for k, v in dict(KW, batch_size=B, **fields).items():
        setattr(jcfg, k, v)
    jm = jax_build(jcfg, jds)
    sample = jnp.asarray(jds.gather(np.arange(4)).inputs)
    if fields['model_type'] == 'diffusion':
        x0 = jnp.zeros((4, sample.shape[1], jm.target_channels))
        params = jm.init({'params': jax.random.PRNGKey(0)}, x0, jnp.zeros((4,), jnp.int32),
                         sample)['params']
    else:
        params = jm.init({'params': jax.random.PRNGKey(0)}, sample, train=False)['params']
    params = jax.device_get(params)
    cfg = Config()
    for k, v in dict(KW, batch_size=B, **fields).items():
        setattr(cfg, k, v)
    family = weights.model_family(build_model_for_dataset(cfg, ds))
    torch.save(weights.params_from_jax(family, params), sd_path)
    tx = jax_make_optimizer('sgd', LR)
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                          opt_state=tx.init(params), batch_stats={}, tx=tx, apply_fn=jm.apply)
    return jcfg, jm, params, state, family


def _assert_delta_close(family, got_sd, before, jax_after, msg=''):
    now = weights.params_to_jax(family, {k: torch.from_numpy(v) for k, v in got_sd.items()})
    flat_now = dict(jax.tree_util.tree_flatten_with_path(now)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(before)[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jax_after)[0])
    assert set(flat_now) == set(flat_j)
    for path, want in flat_j.items():
        dj = np.asarray(want, np.float64) - np.asarray(flat_b[path], np.float64)
        dt = np.asarray(flat_now[path], np.float64) - np.asarray(flat_b[path], np.float64)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=DELTA_REL * np.abs(dj).max() + 1e-9,
                                   err_msg=f'{msg} {jax.tree_util.keystr(path)}')


def _jax_selections(jdata, rng, n_steps, n_split):
    """The JAX epoch's per-shard selections [2, n_steps, B / 2] (and the
    step keys after the selection key): its scan's ``split(rng, n_split)``
    chain, each shard's ``randint`` from the selection key folded with the
    shard index."""
    cnt = np.asarray(jax.device_get(jdata.win_count))
    sel, keys = [], []
    for _ in range(n_steps):
        parts = jax.random.split(rng, n_split)
        rng, s_rng = parts[0], parts[1]
        keys.append(parts[2:])
        sel.append([np.asarray(jax.random.randint(jax.random.fold_in(s_rng, s), (1, B // 2), 0,
                                                  int(cnt[s]), dtype=jnp.int32))[0]
                    for s in range(2)])
    return np.asarray(sel).transpose(1, 0, 2), keys


@pytest.fixture(scope='module')
def sharded_runs(root, tmp_path_factory):
    """One feedforward and one denoiser epoch (EMA 0.9) at world 2 fed the
    JAX epoch's selections and draws, and the same regression epoch in
    chunks of 4 and from the ranks' own host generator."""
    tmp = tmp_path_factory.mktemp('torch_sharded_runs')
    out = {}
    # feedforward
    ds, jds = _datasets(root)
    jcfg, jm, params, jstate, family = _pair(root, dict(model_type='feedforward'),
                                             str(tmp / 'ff.pt'), ds, jds)
    jdata = jshd.ShardedDeviceData(jds, make_mesh(n_devices=2))
    rng = jax.random.PRNGKey(3)
    n_steps = jdata.num_windows // B
    jstate, jm_metrics = jshd.make_sharded_epoch_runner(jm, jdata, jax_loss_config_from(jcfg),
                                                        B)(jstate, rng)
    sel, _ = _jax_selections(jdata, rng, n_steps, 3)
    base = dict(data=str(root / 'train'), ds=KW, fn='sharded_epoch',
                cfg=dict(KW, model_type='feedforward', batch_size=B, opt_type='sgd',
                         learning_rate=LR), sd=str(tmp / 'ff.pt'))
    jobs = [dict(base, sel=sel), dict(base, sel=sel, chunk=4), dict(base, host_seed=11),
            dict(base, host_seed=11, chunk=4)]
    out['ff'] = dict(jax=(params, jax.device_get(jstate), jax.device_get(jm_metrics), family),
                     n_steps=n_steps)
    # the denoiser
    dds, djds = _datasets(root, output_data_format='all_frames')
    fields = dict(model_type='diffusion', output_data_format='all_frames', **DIFF)
    jcfg, jm, dparams, jstate, dfamily = _pair(root, fields, str(tmp / 'diff.pt'), dds, djds)
    jdata = jshd.ShardedDeviceData(djds, make_mesh(n_devices=2))
    rng = jax.random.PRNGKey(5)
    n_steps = jdata.num_windows // B
    jstate, jema, jd_metrics = jshd.make_sharded_diffusion_epoch_runner(
        jm, jdata, JaxSchedule(64), B, ema_decay=0.9)(jstate, dparams, rng)
    dsel, keys = _jax_selections(jdata, rng, n_steps, 4)
    t = np.stack([np.asarray(jax.random.randint(k[0], (B,), 0, 64)) for k in keys])
    x_shape = (B, 4, jm.target_channels)      # 4 frames of window 20 / stride 5
    noise = np.stack([np.asarray(jax.random.normal(k[1], x_shape, jnp.float32)) for k in keys])
    jobs.append(dict(base, data=str(root / 'train'), ds=dict(KW, output_data_format='all_frames'),
                     cfg=dict(KW, batch_size=B, opt_type='sgd', learning_rate=LR,
                              ema_decay=0.9, **fields),
                     sd=str(tmp / 'diff.pt'), sel=dsel, draws=(t, noise)))
    out['diff'] = dict(jax=(dparams, jax.device_get(jstate), jax.device_get(jema),
                            jax.device_get(jd_metrics), dfamily))
    ranks = dist.spawn(W.run_jobs, 2, jobs, init_file=str(tmp / 'rdv'))
    out['ranks'] = list(zip(*ranks))
    return out


def test_sharded_epoch_tracks_the_jax_epoch(sharded_runs):
    params, jstate, jm, family = sharded_runs['ff']['jax']
    r0, r1 = sharded_runs['ranks'][0]
    assert r0['steps'] == r1['steps'] == sharded_runs['ff']['n_steps']
    for k in r0['state']:
        assert np.array_equal(r0['state'][k], r1['state'][k]), k
    assert sorted(r0['trials'] + r1['trials']) == list(range(5))
    assert set(r0['metrics']) == set(jm)
    for k in jm:
        want = np.asarray(jm[k], np.float64)
        np.testing.assert_allclose(np.asarray(r0['metrics'][k], np.float64), want,
                                   rtol=LOSS_REL, atol=LOSS_REL * np.abs(want).max() + 1e-9,
                                   err_msg=k)
    _assert_delta_close(family, r0['state'], params, jstate.params)


def test_sharded_epoch_in_chunks_is_bitwise_step_by_step(sharded_runs):
    """Chunks of 4 (captured on a GPU, eager here) against one step a
    dispatch, on the JAX selections and on the ranks' own draws; the ranks'
    own draws differ from the JAX ones and between epochs' seeds."""
    ranks = sharded_runs['ranks']
    for a, b in ((0, 1), (2, 3)):
        for r in range(2):
            for k in ranks[a][r]['state']:
                assert np.array_equal(ranks[a][r]['state'][k], ranks[b][r]['state'][k]), k
    assert any(not np.array_equal(ranks[0][0]['state'][k], ranks[2][0]['state'][k])
               for k in ranks[0][0]['state'])
    for k in ranks[2][0]['state']:
        assert np.array_equal(ranks[2][0]['state'][k], ranks[2][1]['state'][k]), k


def test_sharded_diffusion_epoch_with_ema_tracks_the_jax_epoch(sharded_runs):
    params, jstate, jema, jm, family = sharded_runs['diff']['jax']
    r0, r1 = sharded_runs['ranks'][4]
    for k in r0['state']:
        assert np.array_equal(r0['state'][k], r1['state'][k]), k
    assert float(r0['metrics']['loss']) == pytest.approx(float(jm['loss']), rel=LOSS_REL)
    _assert_delta_close(family, r0['state'], params, jstate.params, 'params')
    _assert_delta_close(family, r0['ema'], params, jema, 'ema')


MODELS = {
    'feedforward': dict(model_type='feedforward', hidden_dims=[32]),
    'pallas': dict(model_type='transformer', attn_impl='pallas', d_model=128, num_layers=1,
                   num_heads=4),
    'diffusion': dict(model_type='diffusion', output_data_format='all_frames', ema_decay=0.9,
                      **DIFF),
}


@pytest.fixture(scope='module')
def tier_runs(root, tmp_path_factory):
    """``train()`` / ``train_diffusion`` at world 2 for each model on each
    tier: the host loader, the device-resident table and the shards; one
    epoch each, with a dev split."""
    tmp = tmp_path_factory.mktemp('torch_sharded_tiers')
    jobs, keys = [], []
    for name, fields in MODELS.items():
        ds = dict(KW, output_data_format=fields.get('output_data_format', 'last_frame'))
        for tier in ('off', 'on', 'sharded'):
            cfg = dict(KW, batch_size=B, epochs=1, device_data=tier, seed=2,
                       checkpoint_dir=str(tmp / name / tier), **fields)
            jobs.append(dict(data=str(root), ds=ds, fn='loop', dev=True, cfg=cfg))
            keys.append((name, tier))
    # auto reaches the shards when only the two ranks' budgets together hold
    # the dataset
    d = WindowDataset(str(root / 'train'), skip_loading_skeletons=True, **KW)
    data_bytes = d.features_all.nbytes + d.labels_all.nbytes
    jobs.append(dict(data=str(root), ds=KW, fn='loop', cfg=dict(
        KW, batch_size=B, epochs=1, device_data='auto', device_data_max_bytes=data_bytes * 2 // 3,
        checkpoint_dir=str(tmp / 'auto'), **MODELS['feedforward'])))
    keys.append(('feedforward', 'auto'))
    ranks = dist.spawn(W.run_jobs, 2, jobs, init_file=str(tmp / 'rdv'), timeout_s=240)
    return {k: (ranks[0][i], ranks[1][i]) for i, k in enumerate(keys)}


@pytest.mark.parametrize('name', list(MODELS))
@pytest.mark.parametrize('tier', ['off', 'on', 'sharded'])
def test_every_model_trains_on_every_tier_at_world2(tier_runs, name, tier):
    r0, r1 = tier_runs[(name, tier)]
    assert 'error' not in r0, r0.get('error')
    assert r0['epochs_run'] == r1['epochs_run'] == 1
    assert r0['final_train'] == r1['final_train'] and r0['final_dev'] == r1['final_dev']
    assert all(np.isfinite(v) for v in r0['final_train'].values())
    assert 'epoch_0_batch_0.torch.pt' in r0['files'] and r1['writes'] == []


def test_auto_reaches_the_shards_when_only_the_ranks_together_hold_the_data(tier_runs):
    r0, r1 = tier_runs[('feedforward', 'auto')]
    # the sharded tier is epoch-granular: one checkpoint, the epoch's
    assert r0['epochs_run'] == 1 and r1['writes'] == []
    assert [w for w in r0['writes'] if w[0] == 'ckpt'] == [('ckpt', 0, 0, None)]
