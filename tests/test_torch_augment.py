"""The port's training-time augmentation (inferbiomechanics_tpu_torch/train/
augment.py: ``Augmenter``, ``augmenter_from_config``, ``maybe_augment``) in
every tier of both train loops, and the regression loop end to end with
feedforward batchnorm, dropout and augmentation, against the JAX package
where the two can be compared.

The JAX Augmenter draws its coins and noise from ``jax.random`` (the noise
from the ``rbg`` generator), so no torch stream can match; the tests draw
JAX's own coin and noise for a key and feed them to the port through its
draw seam (``AugmentDraws``). Window 20 / stride 5 (4 frames x 177
channels), feedforward hidden widths 64 and 48, the denoiser at d_model 128 /
1 layer / 4 heads. Tolerances: the mirror exact; the noise in float32 at
rtol 1e-5 (the two packages' population std differ in their last bits), in
bf16 at 2e-2 x max; the tiers against the host step bitwise.
"""

import contextlib
import dataclasses
import io
import logging
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.config import Config as JaxConfig
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.models import diffusion as jd
from inferbiomechanics_tpu.train import augment as jax_augment
from inferbiomechanics_tpu.train import create_train_state as jax_create_train_state
from inferbiomechanics_tpu.train import make_optimizer as jax_make_optimizer
from inferbiomechanics_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.__main__ import main
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.models import diffusion as pd
from inferbiomechanics_tpu_torch.models.common import generator_masks
from inferbiomechanics_tpu_torch.serve import InferenceService
from inferbiomechanics_tpu_torch.train import augment
from inferbiomechanics_tpu_torch.train import checkpoint as ckpt
from inferbiomechanics_tpu_torch.train.device_data import (
    DeviceResidentData, make_device_chunked_step, make_device_diffusion_chunked_step,
    make_device_diffusion_train_step, make_device_train_step,
)
from inferbiomechanics_tpu_torch.train.diffusion_loop import train_diffusion
from inferbiomechanics_tpu_torch.train.loop import (
    build_model_for_dataset, loss_config_from, train,
)
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
from inferbiomechanics_tpu_torch.train.run_config import save_run_config
from inferbiomechanics_tpu_torch.train.state import create_train_state
from inferbiomechanics_tpu_torch.train.step import make_chunked_train_step, make_train_step

BATCH = 16
KW = dict(window_size=20, stride=5, skip_loading_skeletons=True)
FF = dict(model_type='feedforward', window_size=20, stride=5, batch_size=BATCH,
          hidden_dims=[64, 48], batchnorm=True, dropout=True, dropout_prob=0.1)
AUG = dict(augment_mirror=True, augment_noise_std=0.05)
DIFF = dict(model_type='diffusion', window_size=20, stride=5, batch_size=BATCH,
            output_data_format='all_frames', d_model=128, num_layers=1, num_heads=4,
            diffusion_timesteps=64)


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """Small models beside other test processes: one thread throughout."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_augment_data')
    for split, length, seed in (('train', 200, 0), ('dev', 120, 1)):
        os.makedirs(root / split)
        write_synthetic_subject(str(root / split / 's.b3d'), num_trials=1,
                                trial_length=length, seed=seed)
    out = {'root': root}
    for split in ('train', 'dev'):
        out[split] = WindowDataset(str(root / split), **KW)
        out[f'{split}_all'] = WindowDataset(str(root / split), output_data_format='all_frames',
                                            **KW)
        out[f'jax_{split}'] = JaxWindowDataset(str(root / split), **KW)
    out['jax_train_all'] = JaxWindowDataset(str(root / 'train'),
                                            output_data_format='all_frames', **KW)
    return out


def _config(cls=Config, **fields):
    cfg = cls()
    for k, v in {**FF, **fields}.items():
        setattr(cfg, k, v)
    return cfg


def _fixed_draws(coin=None, noise=None):
    """Draws that hand out the given coin and noise (numpy)."""
    return augment.AugmentDraws(
        coin=lambda b, p, device: torch.from_numpy(np.array(coin)).to(device),
        noise=lambda shape, dtype, device: torch.from_numpy(
            np.array(noise, np.float32)).to(device=device, dtype=dtype))


def _jax_draws(key, b, shape, dtype, mirror_prob=0.5):
    """The JAX Augmenter's coin and noise for ``key``."""
    k_coin, k_noise = jax.random.split(key)
    coin = np.asarray(jax.random.bernoulli(k_coin, mirror_prob, (b,)))
    noise = np.asarray(jax_augment._fast_normal(k_noise, shape, dtype), np.float32)
    return coin, noise


# ------------------------------------------------------------------ Augmenter

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('mode', ['mirror', 'noise', 'both'])
def test_augmenter_matches_jax(data, mode, dtype):
    """The JAX Augmenter and the port's, the port fed JAX's coin and noise:
    mirrored inputs and labels exactly, noised inputs at the dtype's limit,
    labels never noised."""
    jdt, tdt = {'float32': (jnp.float32, torch.float32),
                'bfloat16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    ds, jds = data['train_all'], data['jax_train']
    spec = augment.spec_from_dataset(ds) if mode != 'noise' else None
    jspec = jax_augment.spec_from_dataset(jds) if mode != 'noise' else None
    noise_std = 0.05 if mode != 'mirror' else 0.0
    batch = ds.gather(np.arange(24))
    x, y = batch.inputs.astype(np.float32), batch.labels.astype(np.float32)
    key = jax.random.PRNGKey(3)
    want_x, want_y = jax_augment.Augmenter(jspec, noise_std)(
        jnp.asarray(x, jdt), jnp.asarray(y), key)
    coin, noise = _jax_draws(key, 24, x.shape, jdt)
    aug = augment.Augmenter(spec, noise_std)
    got_x, got_y = augment.maybe_augment(aug, torch.from_numpy(x).to(tdt), torch.from_numpy(y),
                                         _fixed_draws(coin, noise))
    assert got_x.dtype == tdt and got_y.dtype == torch.float32
    assert np.array_equal(got_y.numpy(), np.asarray(want_y))          # mirror: exact
    want_x = np.asarray(want_x, np.float32)
    if mode == 'mirror':
        assert np.array_equal(got_x.float().numpy(), want_x)
        assert 0 < coin.sum() < 24
        assert not np.array_equal(got_y.numpy()[coin], y[coin])
        assert np.array_equal(got_y.numpy()[~coin], y[~coin])
    elif dtype == 'float32':
        np.testing.assert_allclose(got_x.numpy(), want_x, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got_x.float().numpy(), want_x, rtol=0,
                                   atol=2e-2 * np.abs(want_x).max())
    if mode == 'noise':
        assert np.array_equal(got_y.numpy(), y)
    assert augment.maybe_augment(None, got_x, got_y, None) == (got_x, got_y)


def test_augmenter_refusals_are_the_jax_ones():
    for kwargs in (dict(), dict(noise_std=0.1, mirror_prob=1.5)):
        with pytest.raises(ValueError) as want:
            jax_augment.Augmenter(**kwargs)
        with pytest.raises(ValueError) as got:
            augment.Augmenter(**kwargs)
        assert str(got.value) == str(want.value)


def _crafted_spec(module):
    """A spec with an unpaired name and a revolute axis that does not mirror
    cleanly (both packages build it from the same names)."""
    joints = [types.SimpleNamespace(type='revolute', name='knee_l', axis=(1.0, 0.0, 1.0))]
    return module.build_mirror_spec(['pelvis_tx', 'knee_l', 'ankle_r'], ['pelvis'],
                                    ['calcn_r', 'calcn_l'], 2, joints=joints)


@pytest.mark.parametrize('fields', [dict(augment_mirror=True),
                                    dict(augment_noise_std=0.02),
                                    dict(augment_mirror=False)])
def test_augmenter_from_config_logs_in_the_jax_words(data, monkeypatch, caplog, fields):
    monkeypatch.setattr(jax_augment, 'spec_from_dataset', lambda ds, lateral_axis: _crafted_spec(
        jax_augment))
    monkeypatch.setattr(augment, 'spec_from_dataset', lambda ds, lateral_axis: _crafted_spec(
        augment))
    logs = {}
    for side, module, cls in (('jax', jax_augment, JaxConfig), ('port', augment, Config)):
        caplog.clear()
        log = logging.getLogger(f'augment_words.{side}')
        with caplog.at_level(logging.INFO, logger=log.name):
            made = module.augmenter_from_config(_config(cls, **fields), data['train'], log)
        logs[side] = [(r.levelname, r.getMessage()) for r in caplog.records]
        assert (made is None) == (fields == dict(augment_mirror=False))
    assert logs['port'] == logs['jax']
    if fields.get('augment_mirror'):
        assert [lvl for lvl, _ in logs['port']] == ['WARNING', 'WARNING', 'INFO']


# ------------------------------------------------------------------ the tiers

def _ff_state(cfg, ds, seed=0):
    model = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'rmsprop', 1e-3))
    state.dropout_gen, state.aug_gen, state.dropout_seed = torch.Generator(), torch.Generator(), 5
    model.dropout_masks = generator_masks(state.dropout_gen)
    return state


def _assert_same_state(a, b):
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    sa, sb = a.optimizer.state_dict()['state'], b.optimizer.state_dict()['state']
    for i, st in sa.items():
        for k, v in st.items():
            assert torch.equal(v, sb[i][k]), (i, k)
    assert a.step == b.step


@pytest.mark.parametrize('grad_accum', [1, 2])
def test_each_tier_of_the_augmented_step_is_the_host_step_bitwise(data, grad_accum):
    """A batchnorm + dropout feedforward model, augmented (mirror and noise):
    three steps of the device step, the device chunk, the host step and the
    host chunk (uploaded in bf16) from the same weights and generators; the
    device tier gathers bf16 features and the host one is fed the same bf16
    values, so every tier noises in bf16, as the JAX package's tiers do with
    ``--host-upload-dtype bf16``."""
    cfg = _config(**AUG, grad_accum_steps=grad_accum)
    ds = data['train']
    lc = loss_config_from(cfg)
    aug = augment.augmenter_from_config(cfg, ds)
    dev = DeviceResidentData(ds, 'cpu')
    idx = [np.random.default_rng(k).permutation(len(ds))[:BATCH] for k in range(3)]
    states = {name: _ff_state(cfg, ds) for name in ('device', 'device_chunk', 'host', 'host_chunk')}
    step = make_device_train_step(states['device'].model, dev, lc, grad_accum, augment=aug)
    for i in idx:
        step(states['device'], torch.from_numpy(i))
    make_device_chunked_step(states['device_chunk'].model, dev, lc, grad_accum, augment=aug)(
        states['device_chunk'], np.stack(idx)).rows()
    host = [ds.gather(i) for i in idx]
    step = make_train_step(states['host'].model, ds.lab_offsets, lc, grad_accum, augment=aug)
    for b in host:
        step(states['host'], torch.from_numpy(b.inputs).to(torch.bfloat16),
             torch.from_numpy(b.labels))
    make_chunked_train_step(states['host_chunk'].model, ds.lab_offsets, lc, grad_accum,
                            input_dtype=torch.bfloat16, device='cpu', augment=aug)(
        states['host_chunk'], [b.inputs for b in host], [b.labels for b in host]).rows()
    for name in ('device_chunk', 'host', 'host_chunk'):
        _assert_same_state(states['device'], states[name])
    assert states['device'].step == 3
    # the running statistics moved: 3 x grad_accum updates
    norm = states['device'].model.norms[0]
    assert not torch.equal(norm.running_mean, torch.zeros_like(norm.running_mean))


def _recording(draw, log):
    def wrapped(*args):
        out = draw(*args)
        log.append(out.clone())
        return out
    return wrapped


@pytest.mark.parametrize('model', ['feedforward', 'diffusion'])
def test_augmentation_moves_no_dropout_mask_or_train_draw(data, model):
    """The augmentation draws from a generator of its own: turning it on
    leaves the dropout masks (feedforward) and the step's timesteps, noise
    and keep mask (diffusion) as they were, and changes the batch."""
    seen = {}
    for on in (False, True):
        log = seen[on] = []
        if model == 'feedforward':
            cfg = _config(**(AUG if on else {}))
            ds = data['train']
            state = _ff_state(cfg, ds)
            state.model.dropout_masks = _recording(generator_masks(state.dropout_gen), log)
            step = make_device_train_step(state.model, DeviceResidentData(ds, 'cpu'),
                                          loss_config_from(cfg),
                                          augment=augment.augmenter_from_config(cfg, ds))
        else:
            cfg = _config(**DIFF, cond_dropout=0.2, **(AUG if on else {}))
            ds = data['train_all']
            pm = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(0))
            state = create_train_state(pm, make_optimizer(pm.named_parameters(), 'adam', 1e-3))
            state.dropout_gen, state.dropout_seed = torch.Generator(), 5
            state.aug_gen = torch.Generator() if on else None
            base = pd.generator_draws(state.dropout_gen)
            draws = pd.TrainDraws(timesteps=_recording(base.timesteps, log),
                                  noise=_recording(base.noise, log),
                                  masks=_recording(base.masks, log))
            step = make_device_diffusion_train_step(
                pm, DeviceResidentData(ds, 'cpu'), pd.DDPMSchedule(64), 0.2, draws,
                augment=augment.augmenter_from_config(cfg, ds))
        for k in range(2):
            step(state, torch.arange(k * BATCH, (k + 1) * BATCH))
    assert len(seen[True]) == len(seen[False]) == (6 if model == 'feedforward' else 6)
    assert all(torch.equal(a, b) for a, b in zip(seen[True], seen[False]))


def test_diffusion_device_step_is_the_host_step_with_augmentation(data):
    cfg = _config(**DIFF, **AUG)
    ds = data['train_all']
    aug = augment.augmenter_from_config(cfg, ds)
    sched = pd.DDPMSchedule(64)
    states = []
    for _ in range(2):
        pm = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(0))
        state = create_train_state(pm, make_optimizer(pm.named_parameters(), 'adam', 1e-3))
        state.dropout_gen, state.aug_gen, state.dropout_seed = (torch.Generator(),
                                                                torch.Generator(), 5)
        states.append(state)
    idx = [np.arange(k * BATCH, (k + 1) * BATCH) for k in range(3)]
    make_device_diffusion_chunked_step(states[0].model, DeviceResidentData(ds, 'cpu'), sched,
                                       augment=aug)(states[0], np.stack(idx)).rows()
    step = pd.make_diffusion_train_step(states[1].model, ds.lab_offsets, sched, augment=aug)
    for i in idx:
        b = ds.gather(i)
        step(states[1], torch.from_numpy(b.inputs).to(torch.bfloat16), torch.from_numpy(b.labels))
    _assert_same_state(*states)


# ------------------------------------------------------------------ end to end

def _final(d, epoch=1):
    return torch.load(os.path.join(d, f'epoch_{epoch}_batch_0.torch.pt'),
                      map_location='cpu', weights_only=True)


def _assert_same_final(a, b, epoch=1):
    want, got = _final(str(a), epoch), _final(str(b), epoch)
    assert want['step'] == got['step']
    assert want['model_state_dict'].keys() == got['model_state_dict'].keys()
    for k, v in want['model_state_dict'].items():
        assert torch.equal(v, got['model_state_dict'][k]), k
    for i, st in want['optimizer_state_dict']['state'].items():
        for k, v in st.items():
            assert torch.equal(v, got['optimizer_state_dict']['state'][i][k]), (i, k)
    for k, v in want.get('ema_params', {}).items():
        assert torch.equal(v, got['ema_params'][k]), k


@pytest.fixture(scope='module')
def trained(data, tmp_path_factory):
    """Two epochs of a batchnorm + dropout feedforward model with mirror and
    noise augmentation, in chunks of 4 with a checkpoint every 3 batches."""
    root = tmp_path_factory.mktemp('bn_aug_run')
    d = root / 'feedforward'
    cfg = _config(**AUG, checkpoint_dir=str(d), epochs=2, device_chunk_steps=4,
                  checkpoint_every_batches=3)
    result = train(cfg, data['train'], data['dev'], device='cpu')
    return {'root': root, 'dir': d, 'cfg': cfg, 'result': result}


def test_train_with_batchnorm_dropout_and_augmentation_resumes_bitwise(data, trained, tmp_path):
    """Chunked == step by step, and resumed from the checkpoint written
    inside a chunk == uninterrupted, bitwise: parameters, optimizer state and
    the running statistics."""
    assert trained['result'].epochs_run == 2
    sd = _final(str(trained['dir']))['model_state_dict']
    assert 'norms.0.running_mean' in sd and sd['norms.0.running_var'].abs().sum() > 0
    cfg = trained['cfg']
    train(dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / 'a'), device_chunk_steps=1,
                              checkpoint_every_batches=1000),
          data['train'], data['dev'], device='cpu')
    _assert_same_final(trained['dir'], tmp_path / 'a')
    (tmp_path / 'b').mkdir()
    shutil.copy(trained['dir'] / 'epoch_0_batch_7.torch.pt', tmp_path / 'b')
    resumed = train(dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / 'b')),
                    data['train'], data['dev'], device='cpu')
    steps = len(data['train']) // BATCH
    assert resumed.windows_seen == (2 * steps - 8) * BATCH
    _assert_same_final(trained['dir'], tmp_path / 'b')


def test_serve_and_analyze_a_batchnorm_checkpoint(data, trained):
    """``serve`` of the trained checkpoint answers its eval forward (the
    folded packing, K1's plain version here), which agrees with the JAX
    model's eval of the same weights and running statistics at 2e-2 x max;
    ``analyze`` scores it."""
    cfg = trained['cfg']
    svc = InferenceService(cfg, str(trained['dir']), data['dev'], max_batch=64, device='cpu')
    try:
        assert svc.epoch == 1 and svc.model.norms is not None
        x = data['dev'].gather(np.arange(9)).inputs
        out = svc.predict(x)
    finally:
        svc.close()
    model, epoch, _ = ckpt.load_model(cfg, data['dev'], str(trained['dir']))
    with torch.no_grad():
        want = model(torch.from_numpy(x))
    sd = model.state_dict()
    jm = jax_build(_config(JaxConfig, **AUG), data['jax_dev'])
    jout = jm.apply({'params': weights.feedforward_params_to_jax(sd),
                     'batch_stats': weights.feedforward_batch_stats_to_jax(sd)},
                    jnp.asarray(x), train=False)
    for k, v in want.items():
        assert np.array_equal(out[k], v.numpy()), k
        j = np.asarray(jout[k], np.float32)
        np.testing.assert_allclose(out[k], j, rtol=0, atol=2e-2 * np.abs(j).max(), err_msg=k)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(['analyze', '--dataset-home', str(data['root']), '--checkpoint-dir',
                     str(trained['root']), '--use-run-config', '--history-len', '20',
                     '--stride', '5', '--batch-size', '8', '--device', 'cpu',
                     '--no-wandb']) == 0
    assert '[dev] final report:' in out.getvalue()
    with open(trained['dir'] / 'dev_analysis.csv') as f:
        assert len(f.readlines()) == len(data['dev'])


def test_partial_proposal_from_a_batchnorm_feedforward_matches_jax(data, tmp_path):
    """``--diffusion-partial``'s proposal from a batchnorm + dropout
    feedforward checkpoint, with its running statistics: the JAX package's
    ``make_partial_proposal_fn`` on its own checkpoint of the same weights
    proposes the same targets within 2e-2 x max."""
    fields = dict(output_data_format='all_frames', hidden_dims=[64, 64])
    jcfg = _config(JaxConfig, **fields)
    jds = data['jax_train_all']
    jmodel = jax_build(jcfg, jds)
    state = jax_create_train_state(jmodel, jax.random.PRNGKey(2),
                                   jnp.asarray(jds.gather(np.arange(2)).inputs),
                                   jax_make_optimizer('adam', 1e-3))
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map(
        lambda s: (np.asarray(s) + 0.1 * np.abs(rng.normal(size=s.shape))).astype(np.float32),
        jax.device_get(state.batch_stats))
    state = state.replace(batch_stats=stats)
    jax_save_checkpoint(str(tmp_path), state, 0, 0)
    cfg = _config(**fields)
    model = build_model_for_dataset(cfg, data['train_all'])
    model.load_state_dict(weights.feedforward_state_dict_from_jax(
        jax.device_get(state.params), stats))
    ckpt.save_checkpoint(str(tmp_path), model, 0, 0)
    save_run_config(str(tmp_path), cfg)
    x = np.asarray(data['train_all'].gather(np.arange(3)).inputs)
    jcfg_d = _config(JaxConfig, **DIFF)
    want = np.asarray(jd.make_partial_proposal_fn(jcfg_d, jds, str(tmp_path), x)(
        jnp.asarray(x)))
    got = pd.make_partial_proposal_fn(_config(**DIFF), data['train_all'], str(tmp_path))(
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


def test_diffusion_trains_with_augmentation_in_chunks_bitwise(data, tmp_path):
    """``train --model-type diffusion --augment-mirror --augment-noise-std``
    on both tiers: chunked == step by step, bitwise, with the EMA."""
    runs = {}
    for name, fields in (('chunked', dict(device_chunk_steps=4)),
                         ('steps', dict(device_chunk_steps=1)),
                         ('host', dict(device_data='off', host_chunk_steps=4))):
        cfg = _config(**DIFF, **AUG, **fields, checkpoint_dir=str(tmp_path / name), epochs=1,
                      ema_decay=0.9, cond_dropout=0.1)
        runs[name] = train_diffusion(cfg, data['train_all'], None, device='cpu')
        assert runs[name].epochs_run == 1
    _assert_same_final(tmp_path / 'chunked', tmp_path / 'steps', epoch=0)
    assert _final(str(tmp_path / 'host'), 0)['step'] == _final(str(tmp_path / 'steps'), 0)['step']


def test_ensemble_and_tta_take_batchnorm_checkpoints(data, trained, tmp_path):
    """``serve --ensemble`` of two batchnorm checkpoints (each folded from its
    own running statistics) and ``--tta-mirror`` answer the mean of the
    members' eval forwards, and the mirror-averaged forward."""
    cfg = trained['cfg']
    member = tmp_path / 'member'
    model, _, _ = ckpt.load_model(cfg, data['dev'], str(trained['dir']))
    with torch.no_grad():
        for norm in model.norms:
            norm.running_mean.add_(0.05)
            norm.running_var.mul_(1.5)
    ckpt.save_checkpoint(str(member), model, 0, 0)
    x = data['dev'].gather(np.arange(6)).inputs
    first, _, _ = ckpt.load_model(cfg, data['dev'], str(trained['dir']))
    svc = InferenceService(cfg, str(trained['dir']), data['dev'], max_batch=64, device='cpu',
                           ensemble=[str(trained['dir']), str(member)])
    try:
        out = svc.predict(x)
    finally:
        svc.close()
    with torch.no_grad():
        a, b = first(torch.from_numpy(x)), model.eval()(torch.from_numpy(x))
    for k in out:
        np.testing.assert_allclose(out[k], ((a[k] + b[k]) / 2).numpy(), rtol=1e-6, atol=1e-6)
    svc = InferenceService(cfg, str(trained['dir']), data['dev'], max_batch=64, device='cpu',
                           tta_mirror=True)
    try:
        tta = svc.predict(x)
    finally:
        svc.close()
    spec = augment.spec_from_dataset(data['dev'])
    with torch.no_grad():
        want = augment.tta_average(spec, data['dev'].lab_offsets, first)(torch.from_numpy(x))
    for k in tta:
        np.testing.assert_allclose(tta[k], want[k].numpy(), rtol=1e-6, atol=1e-6)
