"""The port's quality studies (``inferbiomechanics_tpu_torch/scripts/``)
against the JAX package's ``scripts/parity_rmse.py`` and
``scripts/anchor_quality.py``, loaded here as modules (the scripts are not
edited).

- The study data: the port's ``build_study_data`` writes and packs the same
  bytes as the JAX one, with the same digest and the same refusals.
- The scoring and batch helpers are copies: equal on seeded inputs.
- ``run_port`` against ``run_jax`` over 2 epochs on a small split, with
  JAX's initial parameters carried across (and, for GroundLink, the JAX
  step's own dropout masks fed through ``run_port``'s ``draws`` seam): every
  epoch's dev metrics within 2e-2 relative, the bf16 tolerance of the suite
  (``tests/test_pallas_mlp.py``).
- The diffusion study against ``run_diffusion`` on a tiny denoiser, fed the
  JAX step's draws (``TrainDraws``) and the JAX sampler's (``NoiseSource``).
- ``--device`` defaults to ``cuda`` and stops on a box without a GPU.

The JAX side runs on the CPU, jitted, as its scripts run it; the port on
the CPU, where every kernel takes its plain version.
"""

import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu_torch.models.diffusion import TrainDraws
from inferbiomechanics_tpu_torch.scripts import anchor_quality as PA
from inferbiomechanics_tpu_torch.scripts import parity_rmse as PP
from inferbiomechanics_tpu_torch.scripts import parity_verdict as PV

REPO = Path(__file__).resolve().parents[1]
# bf16 compute on both sides (tests/test_pallas_mlp.py:78's tolerance)
REL = 2e-2
TRIAL = 90            # 2 x 39 windows a subject: 2 train batches of 64, 78 dev windows


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """One thread: every run of this module sums in the same order."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def jax_scripts():
    """The JAX package's two study scripts as modules (``anchor_quality``
    imports ``parity_rmse`` by name from its own directory)."""
    path, mods = list(sys.path), dict(sys.modules)
    sys.path.insert(0, str(REPO / 'scripts'))
    import anchor_quality
    import parity_rmse
    assert anchor_quality.P is parity_rmse
    yield SimpleNamespace(P=parity_rmse, A=anchor_quality)
    sys.path[:] = path
    for name in ('parity_rmse', 'anchor_quality'):
        if name not in mods:
            sys.modules.pop(name, None)


@pytest.fixture(scope='module')
def study(tmp_path_factory, jax_scripts):
    """The study split at a small trial length, built by the port in each
    format (the JAX build is held to it in ``test_study_data_*``)."""
    root = tmp_path_factory.mktemp('study')
    return {fmt: PP.build_study_data(str(root), TRIAL, fmt)
            for fmt in ('last_frame', 'all_frames')}


# -- (a) the study data --------------------------------------------------------------

@pytest.mark.parametrize('fmt', ['last_frame', 'all_frames'])
def test_study_data_is_bitwise_the_jax_data(jax_scripts, tmp_path, fmt):
    want = jax_scripts.P.build_study_data(str(tmp_path / 'jax'), 120, fmt)
    got = PP.build_study_data(str(tmp_path / 'port'), 120, fmt)
    for a, b in zip(want[2:5], got[2:5]):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert set(want[5]) == set(got[5]) and all(np.array_equal(want[5][k], got[5][k])
                                               for k in want[5])
    assert want[6] == got[6]
    assert len(want[0]) == len(got[0]) and len(want[1]) == len(got[1])
    assert got[7] == PP.data_sha256(*want[2:5])
    for split, name in (('train', 'train_s0.b3d'), ('train', 'train_s1.b3d'),
                        ('dev', 'dev_s0.b3d')):
        assert ((tmp_path / 'jax' / split / name).read_bytes()
                == (tmp_path / 'port' / split / name).read_bytes())
    assert (tmp_path / 'port' / '.trial_length').read_text() == '120'


def test_study_data_digest_moves_with_any_byte(study):
    _, _, x_tr, y_tr, x_dev, _, _, digest = study['all_frames']
    assert digest == PP.data_sha256(x_tr, y_tr, x_dev)
    moved = x_dev.copy()
    moved.flat[7] = np.nextafter(moved.flat[7], np.float32(np.inf))
    assert PP.data_sha256(x_tr, y_tr, moved) != digest
    assert study['last_frame'][7] != digest         # the labels' format counts


@pytest.mark.parametrize('case', ['other_length', 'no_marker'])
def test_study_data_refusals_are_the_jax_ones(jax_scripts, tmp_path, case):
    for side, build in (('jax', jax_scripts.P.build_study_data),
                        ('port', PP.build_study_data)):
        d = tmp_path / side
        (d / 'train').mkdir(parents=True)
        if case == 'other_length':
            (d / '.trial_length').write_text('300')
        else:
            (d / 'train' / 'train_s0.b3d').write_bytes(b'')
        with pytest.raises(SystemExit) as err:
            build(str(d), 120, 'last_frame')
        if side == 'jax':
            want = str(err.value).replace(str(d), '<dir>')
        else:
            assert str(err.value).replace(str(d), '<dir>') == want


# -- (b) the copies ------------------------------------------------------------------

def _seeded_heads(rng, b=37, t=5, nb=2):
    heads = {'cops': 0.3 * rng.normal(size=(b, t, 3 * nb)),
             'forces': 12.0 * rng.normal(size=(b, t, 3 * nb)),
             'torques': rng.normal(size=(b, t, 3 * nb)),
             'wrenches': rng.normal(size=(b, t, 6 * nb))}
    return {k: v.astype(np.float32) for k, v in heads.items()}


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_dev_metrics_is_the_jax_function(jax_scripts, seed):
    rng = np.random.default_rng(seed)
    pred, lab = _seeded_heads(rng), _seeded_heads(rng)
    assert PP.dev_metrics(pred, lab) == jax_scripts.P.dev_metrics(pred, lab)
    assert (PP._mean_norm_err(pred['wrenches'], lab['wrenches'], 6)
            == jax_scripts.P._mean_norm_err(pred['wrenches'], lab['wrenches'], 6))


def test_label_slicing_is_the_jax_one(jax_scripts, study):
    ds, y = study['all_frames'][0], study['all_frames'][3]
    sl = PP.label_slices(ds.lab_offsets)
    assert sl == jax_scripts.P.label_slices(ds.lab_offsets)
    got, want = PP.slice_labels(y, sl), jax_scripts.P.slice_labels(y, sl)
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize('n,seed,epochs', [(164, 0, 2), (5796, 2, 3), (63, 1, 1)])
def test_batch_schedule_is_the_jax_one(jax_scripts, n, seed, epochs):
    got = PP.batch_schedule(n, seed, epochs)
    want = jax_scripts.P.batch_schedule(n, seed, epochs)
    assert len(got) == len(want) == epochs
    for g, w in zip(got, want):
        assert len(g) == len(w) == n // 64 and all(np.array_equal(a, b) for a, b in zip(g, w))
    if n >= 64:
        batches = PP.epoch_batches(got, epochs, 'cpu')           # wraps around
        assert batches.shape == (n // 64, 64) and np.array_equal(batches[0].numpy(), got[0][0])


def test_short_keys_and_target_slices_are_the_jax_ones(jax_scripts):
    assert PA.short_keys() == jax_scripts.A.short_keys()
    for nb in (1, 2, 3):
        ds = SimpleNamespace(num_contact_bodies=nb)
        assert PA._target_slices(ds) == jax_scripts.A._target_slices(ds)
    assert (PA.DIFF_LR, PA.EMA_DECAY, PA.COND_DROPOUT, PA.GUIDANCE, PA.DDIM_STEPS,
            PA.PARTIAL_FRAC, PA.MEAN_K) == (
        jax_scripts.A.DIFF_LR, jax_scripts.A.EMA_DECAY, jax_scripts.A.COND_DROPOUT,
        jax_scripts.A.GUIDANCE, jax_scripts.A.DDIM_STEPS, jax_scripts.A.PARTIAL_FRAC,
        jax_scripts.A.MEAN_K)
    assert (PP.WINDOW, PP.STRIDE, PP.BATCH, PP.LR, PP.HIDDEN) == (
        jax_scripts.P.WINDOW, jax_scripts.P.STRIDE, jax_scripts.P.BATCH, jax_scripts.P.LR,
        jax_scripts.P.HIDDEN)


# -- (c) run_port against run_jax ----------------------------------------------------

def _jax_init(model_type, ds, x_tr, seed):
    """The initial parameters ``run_jax`` makes for ``model_type``: its
    ``create_train_state`` with ``PRNGKey(seed)`` on ``x_tr[:2]``."""
    from inferbiomechanics_tpu.models import get_model
    from inferbiomechanics_tpu.train import create_train_state, make_optimizer
    kw = dict(num_dofs=ds.num_dofs, num_contact_bodies=ds.num_contact_bodies,
              history_len=PP.WINDOW, stride=PP.STRIDE, root_history_len=ds.root_history_len)
    if model_type == 'feedforward':
        model = get_model('feedforward', hidden_dims=list(PP.HIDDEN), activation='sigmoid',
                          **kw)
    else:
        model = get_model(model_type, output_data_format='all_frames', **kw)
    state = create_train_state(model, jax.random.PRNGKey(seed), jnp.asarray(x_tr[:2]),
                               make_optimizer('rmsprop', PP.LR))
    return model, jax.device_get(state.params)


def _jax_groundlink_masks(jm, params, x_tr, schedule, seed):
    """``draws(i)``: the keep masks of the JAX step ``i``'s dropout sites
    (key ``fold_in(PRNGKey(seed + 1000), i)``, as ``run_jax`` hands it), read
    from each ``Dropout``'s captured output (0 exactly where it dropped)."""
    rates = [jm.cnn_dropout] * len(jm.cnn_features) + [jm.fc_dropout] * jm.fc_depth

    @jax.jit
    def captured(x, key):
        _, state = jm.apply({'params': params}, x, train=True, rngs={'dropout': key},
                            capture_intermediates=True, mutable=['intermediates'])
        return [state['intermediates'][f'Dropout_{i}']['__call__'][0]
                for i, rate in enumerate(rates) if rate > 0]

    batches = [idx for epoch in schedule for idx in epoch]
    rng = jax.random.PRNGKey(seed + 1000)

    def draws(i):
        masks = iter([np.asarray(m) != 0 for m in captured(
            jnp.asarray(x_tr[batches[i]]), jax.random.fold_in(rng, i))])

        def source(shape, p, device, shared=False):
            m = next(masks)
            assert m.shape == shape and p == 0.2, (m.shape, shape, p)
            return torch.from_numpy(m)
        return source

    return draws


@pytest.mark.parametrize('model_type', ['feedforward', 'groundlink', 'transformer',
                                        'transformer-pallas'])
def test_run_port_tracks_run_jax_over_two_epochs(jax_scripts, study, model_type):
    """Both studies from JAX's initial parameters on the same batches (and
    GroundLink's masks): every epoch's dev force, CoP and COM-acc error
    within 2e-2 relative. ``transformer-pallas``: the port's ``pallas``
    transformer (training through K3's plain version here) from the JAX
    study's ``vpu`` parameters, crossed into its ``enc{i}_*`` tree, against
    ``run_jax``'s ``vpu`` model, the same function."""
    model_type, _, attn_impl = model_type.partition('-')
    attn_impl = attn_impl or 'vpu'
    seed, epochs = 3, 2
    fmt = 'last_frame' if model_type == 'feedforward' else 'all_frames'
    ds, _, x_tr, y_tr, x_dev, lab_dev, sl, _ = study[fmt]
    schedule = PP.batch_schedule(len(ds), seed, epochs)
    jm, params = _jax_init(model_type, ds, x_tr, seed)
    want = jax_scripts.P.run_jax(ds, x_tr, y_tr, x_dev, lab_dev, sl, seed, epochs, schedule,
                                 model_type=model_type)
    draws = (_jax_groundlink_masks(jm, params, x_tr, schedule, seed)
             if model_type == 'groundlink' else None)
    got = PP.run_port(ds, x_tr, y_tr, x_dev, lab_dev, sl, seed, epochs, schedule,
                      model_type=model_type, device='cpu', attn_impl=attn_impl,
                      init_params=params, draws=draws)
    assert len(got) == len(want) == epochs
    for ep, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == set(PP.METRICS)
        for m in PP.METRICS:
            assert g[m] == pytest.approx(w[m], rel=REL), (ep, m, g[m], w[m])
    # the port's own draws and weights train too, to another place
    own = PP.run_port(ds, x_tr, y_tr, x_dev, lab_dev, sl, seed, 1, schedule,
                      model_type=model_type, device='cpu', attn_impl=attn_impl)
    assert all(np.isfinite(v) for v in own[0].values()) and own[0] != got[0]


# -- (d) the diffusion study ---------------------------------------------------------

# CoP errors of ~1e-2 m sit at the rounding of the JAX models' bf16 outputs
# (one bf16 ulp of a CoP of 0.25-0.5 m is 9.8e-4 m), which the port's f32
# outputs do not round: the CoP metrics are also held within 1e-3 m
COP_ABS = 1e-3
TINY = dict(d_model=128, num_layers=1, num_heads=4, diffusion_timesteps=64)


def _tiny(get_model):
    def tiny(model_type, **kw):
        return get_model(model_type, **{**kw, **TINY}) if model_type == 'diffusion' \
            else get_model(model_type, **kw)
    return tiny


def _jax_step_draws(seed, shape, timesteps):
    """``train_draws(i)``: what the JAX ``make_diffusion_train_step`` draws from
    its key ``fold_in(PRNGKey(seed + 1000), i)``: the keep mask from the
    folded key, t and the noise from its split."""
    rng0 = jax.random.PRNGKey(seed + 1000)

    def draws(i):
        rng = jax.random.fold_in(rng0, i)
        keep = jax.random.bernoulli(jax.random.fold_in(rng, 0xCF6), 1.0 - PA.COND_DROPOUT,
                                    (shape[0],))
        rng_t, rng_n = jax.random.split(rng)
        t = np.asarray(jax.random.randint(rng_t, (shape[0],), 0, timesteps))
        noise = np.asarray(jax.random.normal(rng_n, shape, jnp.float32))
        keep = np.asarray(keep)
        return TrainDraws(timesteps=lambda b, steps, device: torch.from_numpy(t.copy()).long(),
                          noise=lambda s, device: torch.from_numpy(noise.copy()),
                          masks=lambda s, p, device, shared=False: torch.from_numpy(keep.copy()))
    return draws


def _jax_chain_noise(seed):
    """``chain_noise(start, k)``: the JAX sampler's initial noise for the dev
    batch at ``start`` (key ``fold_in(PRNGKey(seed + 3000), start)``, folded
    with ``k`` for the k-th chain of a mean), from ``split(key)[1]``; at eta 0
    it draws nothing more that counts."""
    rng = jax.random.PRNGKey(seed + 3000)

    def chain_noise(start, k):
        key = jax.random.fold_in(rng, start)
        if k is not None:
            key = jax.random.fold_in(key, k)

        def noise(i, shape, device):
            assert i == 0, i
            return torch.from_numpy(np.array(
                jax.random.normal(jax.random.split(key)[1], shape, jnp.float32)))
        return noise
    return chain_noise


def test_diffusion_study_tracks_run_diffusion(jax_scripts, study, monkeypatch):
    """A tiny denoiser (d_model 128, one layer, 64 timesteps; adam 3e-3, EMA
    0.5) for 2 epochs of two batches, scored every epoch on 16 dev windows and then on all 78
    through 4-step chains and means of 2, from the same initial weights
    (denoiser and proposal), step draws and chain noise: the train losses
    within 2e-2; partial denoising and the proposal within 2e-2; chains
    from the top of the schedule, whose first step is x0 = 8 sign(x_t -
    eps) (a near tie flips an element), within 5e-2; the final CoP errors
    also within ``COP_ABS``. The port's chains through the fused layer and
    through the plain forward (``run_diffusion(fused=False)``) alike."""
    import inferbiomechanics_tpu.models as jax_models
    from inferbiomechanics_tpu.train import create_train_state, make_optimizer
    monkeypatch.setattr(jax_models, 'get_model', _tiny(jax_models.get_model))
    monkeypatch.setattr(PP, 'get_model', _tiny(PP.get_model))
    for mod in (jax_scripts.A, PA):
        monkeypatch.setattr(mod, 'DDIM_STEPS', 4)
        monkeypatch.setattr(mod, 'MEAN_K', 2)
        # a fast-moving EMA, so that the two evaluations, and the snapshot
        # the best one keeps, are far apart
        monkeypatch.setattr(mod, 'DIFF_LR', 3e-3)
        monkeypatch.setattr(mod, 'EMA_DECAY', 0.5)
    seed, epochs = 1, 2
    ds, _, x_tr, y_tr, x_dev, lab_dev, _, _ = study['all_frames']
    schedule = PP.batch_schedule(len(ds), seed, epochs)[:1]    # one epoch's batches, cycled
    kw = dict(num_dofs=ds.num_dofs, num_contact_bodies=ds.num_contact_bodies,
              history_len=PP.WINDOW, stride=PP.STRIDE, root_history_len=ds.root_history_len)
    jm = jax_models.get_model('diffusion', **kw)
    params = jax.device_get(jm.init(
        {'params': jax.random.PRNGKey(seed)}, jnp.zeros((2, x_tr.shape[1], jm.target_channels)),
        jnp.zeros((2,), jnp.int32), jnp.asarray(x_tr[:2]), train=False)['params'])
    pm = jax_models.get_model('feedforward', hidden_dims=list(PP.HIDDEN), activation='sigmoid',
                              output_data_format='all_frames', **kw)
    proposal = jax.device_get(create_train_state(
        pm, jax.random.PRNGKey(seed), jnp.asarray(x_tr[:2]),
        make_optimizer('rmsprop', PP.LR)).params)

    quiet = lambda *a, **k: None    # noqa: E731
    want = jax_scripts.A.run_diffusion(ds, x_tr, y_tr, x_dev, lab_dev, seed, epochs, schedule,
                                       1, 16, log=quiet)
    for fused in (True, False):
        got = PA.run_diffusion(
            ds, x_tr, y_tr, x_dev, lab_dev, seed, epochs, schedule, 1, 16, log=quiet,
            device='cpu', fused=fused, init_params=params, proposal_params=proposal,
            train_draws=_jax_step_draws(seed, (PP.BATCH, x_tr.shape[1], jm.target_channels),
                                        jm.timesteps),
            chain_noise=_jax_chain_noise(seed))
        _assert_diffusion_study_close(got, want)


def _assert_diffusion_study_close(got, want):
    assert got['best_epoch'] == want['best_epoch']
    assert [c['epoch'] for c in got['curve']] == [c['epoch'] for c in want['curve']] == [0, 1]
    for g, w in zip(got['curve'], want['curve']):
        assert g['train_loss'] == pytest.approx(w['train_loss'], rel=REL)
        for m in PP.METRICS:
            assert g[m] == pytest.approx(w[m], rel=5e-2), (g['epoch'], m)
    assert list(got['final']) == list(want['final']) == [
        'raw_g1', 'ema_g1', 'ema_g2', 'ema_mean2', 'ema_partial0.3', 'proposal_ff']
    for surface, w in want['final'].items():
        rel = REL if surface in ('ema_partial0.3', 'proposal_ff') else 5e-2
        for m in PP.METRICS:
            assert got['final'][surface][m] == pytest.approx(
                w[m], rel=rel, abs=COP_ABS if m == 'cop_avg_err' else 0), (surface, m)


# -- (e) the device ------------------------------------------------------------------

@pytest.mark.parametrize('argv', [
    ['parity_rmse', '--model', 'groundlink'],
    ['anchor_quality', '--family', 'diffusion'],
])
def test_device_defaults_to_cuda_and_stops_without_a_gpu(tmp_path, argv):
    if torch.cuda.is_available():
        pytest.skip('a GPU is here: the refusal needs a box without one')
    main = {'parity_rmse': PP.main, 'anchor_quality': PA.main}[argv[0]]
    data = tmp_path / 'data'
    with pytest.raises(SystemExit, match=r"--device cuda: device 'cuda' requested but "
                                         r"torch.cuda.is_available\(\) is False"):
        main([*argv[1:], '--data', str(data), '--out', str(tmp_path / 'o.json')])
    assert not data.exists() and not (tmp_path / 'o.json').exists()


def test_cpu_run_writes_the_jax_layout_with_provenance(study, tmp_path):
    """``--device cpu``: the JSON keeps the JAX layout (``config``,
    ``runs[seed].curve``) and adds the digest, the device, no card, each
    run's seconds and its launches (none on the CPU)."""
    data = tmp_path / 'data'
    assert PP.main(['--model', 'feedforward', '--epochs', '1', '--seeds', '4',
                    '--trial-length', str(TRIAL), '--device', 'cpu', '--data', str(data),
                    '--out', str(tmp_path / 'ff.json')]) == 0
    res = json.loads((tmp_path / 'ff.json').read_text())
    assert res['data_sha256'] == study['last_frame'][7]
    assert (res['side'], res['device'], res['card']) == ('port', 'cpu', None)
    assert res['config']['model'] == 'feedforward' and res['config']['n_train'] == 156
    run = res['runs']['4']
    assert len(run['curve']) == 1 and run['final'] == run['curve'][0] == run['best']
    assert run['seconds'] > 0 and run['launches'] == {'K1': 0, 'K2': 0, 'K3': 0, 'K4': 0}
    ds, _, x_tr, y_tr, x_dev, lab_dev, sl, _ = study['last_frame']
    again = PP.run_port(ds, x_tr, y_tr, x_dev, lab_dev, sl, 4, 1,
                        PP.batch_schedule(len(ds), 4, 1), device='cpu')
    assert again == run['curve']
    with pytest.raises(SystemExit, match='applies to the transformer'):
        PP.main(['--model', 'groundlink', '--attn-impl', 'pallas', '--device', 'cpu'])


def test_digest_only_names_both_formats(study, tmp_path):
    assert PP.main(['--digest-only', '--trial-length', str(TRIAL), '--data',
                    str(tmp_path / 'd'), '--out', str(tmp_path / 'digest.json')]) == 0
    got = json.loads((tmp_path / 'digest.json').read_text())
    assert got == {'trial_length': TRIAL, 'n_train': 156, 'n_dev': 78,
                   'last_frame': study['last_frame'][7], 'all_frames': study['all_frames'][7]}


# -- the verdict ---------------------------------------------------------------------

def _curve(force, cop=0.02, com=1.0, epochs=2, step=0.1):
    return [{'force_avg_err': force - step * e, 'cop_avg_err': cop, 'com_acc_avg_err': com}
            for e in range(epochs)]


def test_verdict_spans_and_bands():
    assert PV.span([3.0, 1.0, 2.0]) == (1.0, 3.0)
    assert PV.widened((1.0, 3.0)) == (-1.0, 5.0)
    assert PV.overlaps((1.0, 2.0), (2.0, 3.0)) and not PV.overlaps((1.0, 2.0), (2.1, 3.0))
    assert PV.within(5.0, (-1.0, 5.0)) and not PV.within(5.01, (-1.0, 5.0))
    curve = _curve(4.0, epochs=3)
    assert PV.statistic(curve, 'force_avg_err', 'best') == pytest.approx(3.8)
    assert PV.statistic(curve, 'force_avg_err', 'final') == pytest.approx(3.8)
    curve[1]['force_avg_err'] = 3.0
    assert PV.statistic(curve, 'force_avg_err', 'best') == 3.0


@pytest.mark.parametrize('shift,ok', [(0.0, True), (0.05, True), (1.0, False)])
def test_family_verdict_holds_the_ranges_and_the_widened_epochs(shift, ok):
    jax_doc = {'jax': {str(s): _curve(4.6 + 0.1 * s) for s in range(3)}}     # parity_rmse layout
    port_doc = {'runs': {str(s): {'curve': _curve(4.6 + 0.1 * s + shift)} for s in range(3)}}
    v = PV.family_verdict(jax_doc, port_doc)
    assert v['ok'] is ok and len(v['stats']) == 6 and len(v['epochs']) == 6
    force = [r for r in v['stats'] if r['metric'] == 'force_avg_err']
    assert all(r['ok'] is ok for r in force)
    assert all(r['ok'] for r in v['stats'] if r['metric'] != 'force_avg_err')
    first = next(r for r in v['epochs'] if r['metric'] == 'force_avg_err')
    assert first['band'] == pytest.approx((4.4, 5.0)) and first['port_mean'] == pytest.approx(
        4.7 + shift)
    with pytest.raises(ValueError, match='different lengths'):
        PV.family_verdict(jax_doc, {'runs': {'0': {'curve': _curve(4.6, epochs=3)}}})


def _diffusion_doc(forces, first=0):
    return {'runs': {str(first + s): {
        'curve': [dict(_curve(f)[0], epoch=4), dict(_curve(f - 10)[0], epoch=9)],
        'final': {'ema_g1': _curve(f)[0]}} for s, f in enumerate(forces)}}


@pytest.mark.parametrize('jax_force,ok', [(55.0, True), (59.5, True), (60.5, False)])
def test_diffusion_verdict_holds_the_jax_seed_in_the_widened_port_range(jax_force, ok):
    v = PV.diffusion_verdict(_diffusion_doc([jax_force]), _diffusion_doc([54.0, 56.0, 57.0]))
    assert v['ok'] is ok
    assert [r['epoch'] for r in v['epochs'][::3]] == [4, 9] and len(v['finals']) == 3
    assert v['epochs'][0]['band'] == pytest.approx((51.0, 60.0))


def test_verdict_of_a_directory_checks_the_digests(tmp_path):
    (tmp_path / 'study_data.json').write_text(json.dumps(
        {'last_frame': 'aa', 'all_frames': 'bb'}))
    jax_doc = {'jax': {str(s): _curve(4.6 + 0.1 * s) for s in range(3)},
               'torch': {str(s): _curve(4.8 + 0.1 * s) for s in range(3)}}
    for fam, jax_name, port_name, fmt in PV.FAMILIES:
        (tmp_path / jax_name).write_text(json.dumps(jax_doc))
        port = {'data_sha256': {'last_frame': 'aa', 'all_frames': 'bb'}[fmt],
                'runs': {str(s): {'curve': _curve(4.6 + 0.1 * s)} for s in range(3)}}
        (tmp_path / port_name).write_text(json.dumps(port))
    (tmp_path / 'jax_diffusion.json').write_text(json.dumps(_diffusion_doc([55.0])))
    port = dict(_diffusion_doc([54.0, 56.0, 57.0]), data_sha256='cc')
    (tmp_path / 'port_diffusion.json').write_text(json.dumps(port))
    # seeds 3-9 of the feedforward family on both sides: reported beside
    (tmp_path / 'jax_feedforward_seeds3-9.json').write_text(json.dumps(
        {'jax': {str(s): _curve(4.6 + 0.01 * s) for s in range(3, 10)},
         'torch': {str(s): _curve(4.7) for s in range(3, 10)}}))
    (tmp_path / 'port_feedforward_seeds3-9.json').write_text(json.dumps(
        {'data_sha256': 'aa', 'runs': {str(s): {'curve': _curve(9.0)} for s in range(3, 10)}}))
    more = [('feedforward', 'jax_feedforward_seeds*.json', 'port_feedforward_seeds*.json')]
    v = PV.verdict_of(str(tmp_path), more, [('jax_feedforward*.json', 'port_feedforward*.json')])
    assert v['families']['diffusion']['ok'] and v['digests']['port_diffusion.json'] is False
    assert not v['ok'] and sum(v['digests'].values()) == 5
    ref = v['paired']['jax_feedforward*.json against port_feedforward*.json']
    assert ref['seeds'] == [str(s) for s in range(10)]
    assert ref['force_avg_err'][2] > 0            # the port's seeds 3-9 at 9.0 against ~4.6
    assert not ref['rules']['ok'] and ref['rules']['seeds']['port'] == ref['seeds']
    assert list(v['more_seeds']) == ['feedforward'] and v['families']['feedforward']['ok']
    ten = v['more_seeds']['feedforward']
    assert ten['seeds']['port'] == ten['seeds']['jax'] == sorted(str(s) for s in range(10))
    assert not ten['ok']                                # seeds 3-9 of the port are far off
    # JAX seeds 1-2 of diffusion: the regression rules on its curves and finals
    (tmp_path / 'jax_diffusion_seeds1-2.json').write_text(json.dumps(
        _diffusion_doc([54.5, 57.5], first=1)))
    (tmp_path / 'port_diffusion_seeds3.json').write_text(json.dumps(
        dict(_diffusion_doc([55.5], first=3), data_sha256='bb')))
    v = PV.verdict_of(str(tmp_path), [('diffusion', 'jax_diffusion_seeds*.json',
                                       'port_diffusion_seeds*.json')])
    more = v['more_seeds']['diffusion']
    assert more['seeds'] == {'jax': ['0', '1', '2'], 'port': ['0', '1', '2', '3']}
    assert more['ok'] and v['digests']['port_diffusion_seeds3.json']
    assert [r['stat'] for r in more['stats']][-3:] == ['final ema_g1'] * 3
    assert v['families']['diffusion'] == PV.diffusion_verdict(
        json.loads((tmp_path / 'jax_diffusion.json').read_text()), port)
    assert PV.main(['--dir', str(tmp_path), '--paired', 'port_diffusion.json',
                    'port_diffusion.json']) == 1
    written = json.loads((tmp_path / 'verdict.json').read_text())
    assert written['ok'] is False and written['args']['paired'] == [['port_diffusion.json'] * 2]
    with pytest.raises(FileNotFoundError, match='matches'):
        PV.verdict_of(str(tmp_path), pairs=[('jax_nothing*.json', 'port_diffusion.json')])
    with pytest.raises(SystemExit):
        PV.main(['--dir', str(tmp_path), '--more', 'no family', 'a', 'b'])
    lines = PV.markdown(v)
    assert lines[0].startswith('| family |') and any('DIFFERS FROM' in x for x in lines)


def test_init_from_starts_each_seed_from_its_saved_jax_tree(study, tmp_path):
    """``--init-from DIR`` reads ``seed{N}.npz`` (the '/'-joined paths that
    ``tests/torch_parity_split.py --write-inits`` writes): the run is
    ``run_port`` from that tree, and differs from the seeded draw's."""
    ds, _, x_tr, y_tr, x_dev, lab_dev, sl, _ = study['last_frame']
    _, tree = _jax_init('feedforward', ds, x_tr, 5)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    (tmp_path / 'inits').mkdir()
    np.savez(tmp_path / 'inits' / 'seed5.npz',
             **{'/'.join(k.key for k in path): np.asarray(v) for path, v in flat})
    loaded = PP.load_init_tree(str(tmp_path / 'inits' / 'seed5.npz'))
    assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(tree)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(loaded),
                                                   jax.tree_util.tree_leaves(tree)))
    assert PP.main(['--model', 'feedforward', '--epochs', '1', '--seeds', '5', '--device',
                    'cpu', '--trial-length', str(TRIAL), '--data', str(tmp_path / 'd'),
                    '--init-from', str(tmp_path / 'inits'),
                    '--out', str(tmp_path / 'o.json')]) == 0
    res = json.loads((tmp_path / 'o.json').read_text())
    schedule = PP.batch_schedule(len(ds), 5, 1)
    want = PP.run_port(ds, x_tr, y_tr, x_dev, lab_dev, sl, 5, 1, schedule, device='cpu',
                       init_params=tree)
    assert res['runs']['5']['curve'] == want and res['config']['init_from']
    assert PP.run_port(ds, x_tr, y_tr, x_dev, lab_dev, sl, 5, 1, schedule,
                       device='cpu') != want
    with pytest.raises(SystemExit, match='applies to --family transformer'):
        PA.main(['--family', 'diffusion', '--attn-impl', 'pallas', '--device', 'cpu'])


def test_vpu_tree_loads_into_the_pallas_model_as_the_same_function(study):
    """The JAX study's ``vpu`` tree crosses into the port's ``pallas``
    transformer (``--init-from`` of ``--attn-impl pallas``) and back
    unchanged, and both models then predict alike (2e-2 relative: the
    ``vpu`` forward rounds to bf16)."""
    from inferbiomechanics_tpu_torch.weights import (
        params_to_jax, transformer_pallas_tree_to_vpu, transformer_vpu_tree_to_pallas,
    )
    ds, _, x_tr, *_ = study['all_frames']
    vpu = PP.study_model('transformer', ds, generator=torch.Generator().manual_seed(4),
                         device='cpu').eval()
    tree = params_to_jax('transformer', dict(vpu.named_parameters()))
    pallas = PP.study_model('transformer', ds, attn_impl='pallas', device='cpu').eval()
    PP.load_jax_params(pallas, tree)
    back = transformer_pallas_tree_to_vpu(params_to_jax('pallas',
                                                        dict(pallas.named_parameters())))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(back),
                                                   jax.tree_util.tree_leaves(tree)))
    with pytest.raises(ValueError, match="not an attn_impl='vpu'"):
        transformer_vpu_tree_to_pallas(transformer_vpu_tree_to_pallas(tree))
    x = torch.from_numpy(x_tr[:8])
    with torch.no_grad():
        a, b = vpu(x), pallas(x)
    for key in a:
        scale = a[key].float().abs().max()
        assert torch.allclose(b[key].float(), a[key].float(), atol=float(REL * scale)), key


def test_diffusion_init_from_hands_both_trees(tmp_path, monkeypatch):
    """``anchor_quality --family diffusion --init-from DIR`` starts each
    seed's denoiser from ``DIR/seed{N}.npz``'s ``denoiser/`` tree and its
    proposal from the ``proposal/`` tree."""
    (tmp_path / 'inits').mkdir()
    for seed in (0, 1):
        np.savez(tmp_path / 'inits' / f'seed{seed}.npz',
                 **{'denoiser/t_mlp1/kernel': np.full((2, 2), seed, np.float32),
                    'proposal/Dense_0/bias': np.full(3, 10 + seed, np.float32)})
    handed = {}
    metrics = dict.fromkeys(PP.METRICS, 1.0)

    def run_diffusion(ds, *args, **kw):
        seed = args[4]
        handed[seed] = (kw['init_params'], kw['proposal_params'])
        return {'curve': [dict(metrics, epoch=0)], 'best_epoch': 0,
                'final': {'ema_g1': dict(metrics)}}

    monkeypatch.setattr(PA, 'run_diffusion', run_diffusion)
    assert PA.main(['--family', 'diffusion', '--epochs', '1', '--seeds', '0', '1',
                    '--device', 'cpu', '--trial-length', str(TRIAL),
                    '--data', str(tmp_path / 'd'), '--init-from', str(tmp_path / 'inits'),
                    '--out', str(tmp_path / 'o.json')]) == 0
    for seed in (0, 1):
        denoiser, proposal = handed[seed]
        assert np.array_equal(denoiser['t_mlp1']['kernel'], np.full((2, 2), seed))
        assert np.array_equal(proposal['Dense_0']['bias'], np.full(3, 10 + seed))
    assert json.loads((tmp_path / 'o.json').read_text())['config']['init_from']


def test_paired_studies_are_held_seed_by_seed():
    a = {'jax': {'0': _curve(4.0), '1': _curve(5.0)}}
    b = {'runs': {'0': {'curve': _curve(4.04)}, '1': {'curve': _curve(5.0)},
                  '7': {'curve': _curve(9.0)}}}
    v = PV.paired(a, b)
    assert v['seeds'] == ['0', '1'] and v['cop_avg_err'] == (0.0, 0.0, 0.0)
    lo, hi, mean = v['force_avg_err']
    assert lo == 0.0 and hi == pytest.approx(0.04 / 3.9) and 0 < mean < hi
    d = _diffusion_doc([50.0, 60.0])
    e = json.loads(json.dumps(d))
    e['runs']['1']['final']['ema_g1']['com_acc_avg_err'] *= 1.5
    assert PV.paired(d, e)['com_acc_avg_err'][1] == pytest.approx(0.5)
