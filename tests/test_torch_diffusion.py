"""The port's diffusion sampling slice (inferbiomechanics_tpu_torch/models/
diffusion.py, its weights and its EMA checkpoints) against the JAX package's
(inferbiomechanics_tpu/models/diffusion.py) on the same numpy inputs.

The JAX suite's small size: window 20 / stride 5 (4 frames x 177 channels),
2 contact bodies (30 target channels), d_model 128 (the fused encoder
layer kernel takes multiples of 128), 2 layers, 4 heads, 64 timesteps,
8 sampling steps. The JAX sampler draws with ``jax.random``; the port's
takes a :data:`NoiseSource`, which these tests fill with the JAX sampler's
own draws (``_jax_draws``). Tolerances, relative to the reference's largest
value (per head for sampled outputs): the denoiser against ``model.apply``
2e-2 (both bf16; they differ only in where XLA and PyTorch round and in
which order they sum, as the transformer's tests find); the fused forward
and the sampler 5e-2, the JAX suite's own limit for its fused forward
against ``model.apply`` (a chain from the top of the schedule on 90% of the
elements: see ``test_sampler_with_jax_draws_matches_jax``); the chain's
arithmetic around an f32 stand-in denoiser 1e-4.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from inferbiomechanics_tpu.config import Config as JaxConfig
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu.models import diffusion as jd
from inferbiomechanics_tpu.train import create_train_state as jax_create_train_state
from inferbiomechanics_tpu.train import make_optimizer as jax_make_optimizer
from inferbiomechanics_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.models import diffusion as pd
from inferbiomechanics_tpu_torch.models import get_model
from inferbiomechanics_tpu_torch.train import checkpoint as ckpt
from inferbiomechanics_tpu_torch.train.loop import build_model_for_dataset
from inferbiomechanics_tpu_torch.train.run_config import save_run_config

SIZE = dict(num_dofs=23, num_contact_bodies=2, history_len=20, stride=5,
            d_model=128, num_layers=2, num_heads=4)
TIMESTEPS, STEPS = 64, 8
APPLY_REL = 2e-2
REL = 5e-2


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """Small models beside other test processes: one thread throughout."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp('torch_diffusion_data')
    write_synthetic_subject(str(d / 's.b3d'), num_trials=1, trial_length=200, seed=0)
    kw = dict(window_size=20, stride=5, output_data_format='all_frames',
              skip_loading_skeletons=True)
    return {'dir': d, 'jax_ds': JaxWindowDataset(str(d), **kw),
            'ds': WindowDataset(str(d), **kw)}


def _jax_model(**kw):
    return jd.DiffusionDenoiser(**{**SIZE, 'timesteps': TIMESTEPS, **kw})


def _port_model(**kw):
    return get_model('diffusion', root_history_len=10, diffusion_timesteps=TIMESTEPS,
                     **{**SIZE, **kw})


def _jax_params(jm, seed):
    """Initialised by flax, then every bias and LayerNorm row moved off its
    zeros / ones with seeded numpy noise, so that each one matters."""
    x0 = jnp.zeros((2, 4, jm.target_channels))
    params = jax.device_get(jm.init({'params': jax.random.PRNGKey(seed)}, x0,
                                    jnp.zeros((2,), jnp.int32),
                                    jnp.zeros((2, 4, 177)))['params'])
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (p + 0.1 * rng.normal(size=p.shape)).astype(np.float32)
        if p.ndim == 1 else np.asarray(p), params)


@pytest.fixture(scope='module')
def pair():
    """A JAX denoiser and the port's with the same weights."""
    jm = _jax_model()
    params = _jax_params(jm, 0)
    pm = _port_model()
    pm.load_state_dict(weights.diffusion_state_dict_from_jax(params))
    return jm, params, pm.eval()


def _cond(data, b=8, start=0):
    return np.asarray(data['ds'].gather(np.arange(start, start + b)).inputs)


def _jax_draws(key, shape, steps):
    """The JAX sampler's draws for ``key``: the initial noise from
    ``split(key)[1]``, then one z a step from the carried key's splits."""
    rng, rng0 = jax.random.split(key)
    draws = [jax.random.normal(rng0, shape, jnp.float32)]
    for _ in range(steps):
        rng, rng_z = jax.random.split(rng)
        draws.append(jax.random.normal(rng_z, shape, jnp.float32))
    return [np.asarray(d) for d in draws]


def jax_noise(keys, steps):
    """A NoiseSource that hands the port, for a batch of ``len(keys)``
    chains stacked key-major, the draws the JAX sampler makes for each key."""
    cache = {}

    def noise(i, shape, device):
        if shape not in cache:
            per = (shape[0] // len(keys),) + tuple(shape[1:])
            chains = [_jax_draws(k, per, steps) for k in keys]
            cache[shape] = [np.concatenate([c[j] for c in chains])
                            for j in range(steps + 1)]
        return torch.from_numpy(cache[shape][i].copy()).to(device)

    return noise


def _assert_heads_close(got, want, rel, what=''):
    assert set(got) == set(want) and len(want) == 4
    for k in want:
        a, b = np.asarray(want[k]), got[k].cpu().numpy()
        assert b.shape == a.shape and b.dtype == np.float32, (k, b.shape, a.shape)
        np.testing.assert_allclose(b, a, rtol=0, atol=rel * (np.abs(a).max() + 1e-6),
                                   err_msg=f'{what} head {k}')


# -- schedule, embedding, target space ----------------------------------------

@pytest.mark.parametrize('timesteps', [64, 1000])
def test_schedule_and_embedding_match_jax(timesteps):
    js, ps = jd.DDPMSchedule(timesteps), pd.DDPMSchedule(timesteps)
    for name in ('betas', 'alphas', 'alpha_bars'):
        got = getattr(ps, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-6, err_msg=name)
    # the embedding's frequencies are exp() of the same f32 arguments, which
    # XLA's exp and torch's round apart by up to one ulp (2^-23 relative); the
    # sin and cos of t x freq then differ by up to t x 2^-23 x freq <= t x
    # 2^-23 beside their own rounding (1e-6)
    t = np.array([0, 1, 7, 17, timesteps // 2, timesteps - 1], np.int32)
    for dim in (128, 256):
        want = np.asarray(jd.timestep_embedding(jnp.asarray(t), dim))
        got = pd.timestep_embedding(torch.from_numpy(t), dim)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-6, atol=1e-6)
        assert np.all(np.abs(got.numpy() - want)
                      <= 1e-6 * np.abs(want) + 1e-6 + t[:, None] * 2.0 ** -23)
    x0 = np.random.default_rng(0).normal(size=(6, 4, 30)).astype(np.float32)
    eps = np.random.default_rng(1).normal(size=(6, 4, 30)).astype(np.float32)
    tt = t % timesteps
    np.testing.assert_allclose(
        ps.q_sample(torch.from_numpy(x0), torch.from_numpy(tt).long(),
                    torch.from_numpy(eps)).numpy(),
        np.asarray(js.q_sample(jnp.asarray(x0), jnp.asarray(tt), jnp.asarray(eps))),
        rtol=1e-6, atol=1e-6)


def test_targets_from_labels_and_outputs_are_exact(data):
    jds = data['jax_ds']
    assert dict(jds.lab_offsets) == dict(data['ds'].lab_offsets)
    labels = np.random.default_rng(2).normal(
        0, 5, (5, 4, jds.num_label_channels)).astype(np.float32)
    want = np.asarray(jd.diffusion_targets_from_labels(jnp.asarray(labels),
                                                       jds.lab_offsets, 2))
    got = pd.diffusion_targets_from_labels(torch.from_numpy(labels),
                                           data['ds'].lab_offsets, 2).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pd.target_scales(2).numpy(),
                                  np.asarray(jd.target_scales(2)))
    rng = np.random.default_rng(3)
    outputs = {k: rng.normal(size=(5, 4, 12 if 'Wrench' in k else 6)).astype(np.float32)
               for k in pd._TARGET_KEYS}
    for space in ('normalized', 'raw'):
        want = np.asarray(jd.diffusion_targets_from_outputs(
            {k: jnp.asarray(v) for k, v in outputs.items()}, target_space=space))
        got = pd.diffusion_targets_from_outputs(
            {k: torch.from_numpy(v) for k, v in outputs.items()}, target_space=space)
        np.testing.assert_array_equal(got.numpy(), want)


# -- weights and the denoiser's forwards ---------------------------------------

def test_weights_there_and_back(pair):
    _jm, params, pm = pair
    sd = weights.diffusion_state_dict_from_jax(params)
    assert set(sd) == set(pm.state_dict())
    back = weights.diffusion_params_to_jax(pm.state_dict())
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(flat) == set(flat_back) and len(flat) == 1 + 5 * 2 + 2 * 12 + 2
    for k in flat:
        np.testing.assert_array_equal(flat_back[k], flat[k], err_msg=str(k))
    with pytest.raises(ValueError, match='not a diffusion denoiser tree'):
        weights.diffusion_state_dict_from_jax({'Dense_0': {}})
    with pytest.raises(ValueError, match='not a diffusion denoiser state dict'):
        weights.diffusion_params_to_jax({'layers.0.weight': torch.zeros(1)})


def test_seeded_init_follows_flax_defaults():
    a = _port_model(generator=torch.Generator().manual_seed(5))
    b = _port_model(generator=torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not a.eps_head.bias.any() and torch.equal(a.final_ln.weight, torch.ones(128))
    assert abs(float(a.temporal_embedding.detach().std()) - 0.02) < 0.005
    std = float(a.cond_proj.weight.detach().std())
    assert abs(std - (1 / 177) ** 0.5) < 0.1 * (1 / 177) ** 0.5


def _eps_inputs(data, b=8):
    x = np.random.default_rng(3).normal(size=(b, 4, 30)).astype(np.float32)
    t = (np.arange(b) * 7 % TIMESTEPS).astype(np.int32)
    return x, t, _cond(data, b)


def test_denoiser_matches_jax_apply(pair, data):
    jm, params, pm = pair
    x, t, cond = _eps_inputs(data)
    want = np.asarray(jm.apply({'params': params}, jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(cond)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=APPLY_REL * np.abs(want).max())


FLAX = dict(d_model=64, num_layers=4, num_heads=4, attn_impl='flax')


def test_flax_denoiser_eps_and_a_ddim_chain_match_jax(data):
    """``attn_impl='flax'`` (the JAX EncoderBlock's flax attention, d_model
    64, 4 layers, 4 heads): the weights cross bitwise both ways, eps against
    ``model.apply`` at 2e-2 x max, and a DDIM chain started part way down the
    schedule (``partial_frac`` 0.3, the JAX sampler's draws) at 5e-2 x max a
    head, the tolerance of the ``vpu`` denoiser's partial chains."""
    jm = _jax_model(**FLAX)
    params = _jax_params(jm, 7)
    assert 'MultiHeadDotProductAttention_0' in params['EncoderBlock_3']
    pm = _port_model(**FLAX).eval()
    pm.load_state_dict(weights.diffusion_state_dict_from_jax(params))
    assert weights.model_family(pm) == weights.tree_family(params) == 'diffusion_flax'
    back = dict(jax.tree_util.tree_flatten_with_path(
        weights.diffusion_params_to_jax(pm.state_dict()))[0])
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_array_equal(back[path], v, err_msg=str(path))
    x, t, cond = _eps_inputs(data)
    want = np.asarray(jax.jit(jm.apply)({'params': params}, jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(cond)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=APPLY_REL * np.abs(want).max())
    got, want = _sample_both(jm, params, pm, data, SAMPLERS['partial0.3'])
    _assert_heads_close(got, want, REL, 'flax partial0.3')


@pytest.mark.parametrize('interpret', [False, True])
def test_fused_denoiser_eps_matches_jax(pair, data, interpret, monkeypatch):
    """interpret=True runs the JAX side's Pallas kernel in interpret mode."""
    monkeypatch.setenv('IB_PALLAS_INTERPRET', '1' if interpret else '0')
    jm, params, pm = pair
    x, t, cond = _eps_inputs(data)
    want = np.asarray(jd.fused_denoiser_eps(jm, params, jnp.asarray(x), jnp.asarray(t),
                                            jnp.asarray(cond)))
    with torch.no_grad():
        got = pd.fused_denoiser_eps(pm, torch.from_numpy(x), torch.from_numpy(t),
                                    torch.from_numpy(cond))
        plain = pd.fused_denoiser_eps(pm, torch.from_numpy(x), torch.from_numpy(t),
                                      torch.from_numpy(cond), use_kernel=False)
    assert torch.equal(got, plain)      # a CPU tensor takes the plain layer
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REL * np.abs(want).max())


def test_packing_is_made_once_and_dropped_on_train_and_load(pair):
    _jm, params, _pm = pair
    pm = _port_model().eval()
    first = pm.packed()
    assert pm.packed() is first and len(first.layers) == 2
    pm.eval()
    assert pm.packed() is first
    pm.train()
    second = pm.packed()
    assert second is not first
    pm.load_state_dict(weights.diffusion_state_dict_from_jax(params))
    assert pm.packed() is not second


# -- the sampler ----------------------------------------------------------------

# case -> make_sampler keywords (besides num_steps)
SAMPLERS = {
    'eta0': dict(eta=0.0),
    'eta1': dict(eta=1.0),
    'cfg2': dict(guidance_scale=2.0),
    'partial0.3': dict(partial_frac=0.3),
    'raw': dict(target_space='raw'),
    'cfg2_partial0.3_raw': dict(guidance_scale=2.0, partial_frac=0.3, target_space='raw'),
}


class _JaxStub(flax_nn.Module):
    """An f32 stand-in for the denoiser: eps an elementwise function of x_t,
    t and the conditioning, computed alike by both frameworks."""
    timesteps: int = TIMESTEPS
    num_contact_bodies: int = 2
    attn_impl: str = 'vpu'

    @property
    def target_channels(self):
        return 30

    def __call__(self, x, t, cond, train=False):
        c = cond.mean(-1, keepdims=True) * 0.01
        return jnp.tanh(0.7 * x + c + (t / self.timesteps)[:, None, None] - 0.5)


class _PortStub(torch.nn.Module):
    timesteps, num_contact_bodies, target_channels, num_frames = TIMESTEPS, 2, 30, 4
    attn_impl, d_model = 'vpu', 128

    def forward(self, x, t, cond):
        c = cond.mean(-1, keepdim=True) * 0.01
        return torch.tanh(0.7 * x + c + (t.float() / self.timesteps)[:, None, None] - 0.5)


def _sample_both(jm, params, pm, data, kw, seed=11, b=8):
    key = jax.random.PRNGKey(seed)
    cond = _cond(data, b)
    init = None
    if 'partial_frac' in kw:
        init = np.random.default_rng(4).normal(0, 0.5, (b, 4, 30)).astype(np.float32)
    jsampler = jd.make_sampler(jm, jd.DDPMSchedule(TIMESTEPS), num_steps=STEPS, **kw)
    want = jsampler(params, jnp.asarray(cond), key,
                    None if init is None else jnp.asarray(init))
    psampler = pd.make_sampler(pm, pd.DDPMSchedule(TIMESTEPS), num_steps=STEPS, **kw)
    got = psampler(pm, torch.from_numpy(cond),
                   init=None if init is None else torch.from_numpy(init),
                   noise=jax_noise([key], len(psampler.timesteps)))
    return got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize('case', list(SAMPLERS))
def test_sampler_arithmetic_matches_jax_on_an_f32_denoiser(data, case):
    """The chain itself (steps, coefficients, clip, guidance, partial start,
    target space, where each draw goes) against the JAX sampler's, with one
    f32 function standing in for the denoiser on both sides: 1e-4 x max."""
    got, want = _sample_both(_JaxStub(), {}, _PortStub(), data, SAMPLERS[case])
    _assert_heads_close(got, want, 1e-4, case)


@pytest.mark.parametrize('case', [*SAMPLERS, 'fused', 'fused_cfg2_partial0.3'])
def test_sampler_with_jax_draws_matches_jax(pair, data, case):
    """The bf16 denoiser's chains. A chain that starts part way down the
    schedule is held at 5e-2 x max per head. One that starts at its top is
    not well conditioned: there ab_t is 4e-33, x0 is 8 x sign(x_t - eps), and
    a bf16-level difference in eps flips the sign of the elements where x_t
    and eps nearly tie. The JAX sampler's own f32 and bf16 chains differ by
    more than 5e-2 x max on up to 5.7% of a head's elements at these sizes;
    the port's and the JAX package's bf16 chains on up to 6.3%. Such a chain
    is held to 5e-2 x max on 90% of each head's elements."""
    kw = {'fused': dict(eta=1.0, fused_inference=True),
          'fused_cfg2_partial0.3': dict(fused_inference=True, guidance_scale=2.0,
                                        partial_frac=0.3)}.get(case, SAMPLERS.get(case))
    jm, params, pm = pair
    got, want = _sample_both(jm, params, pm, data, kw)
    if 'partial_frac' in kw:
        _assert_heads_close(got, want, REL, case)
        return
    assert set(got) == set(want)
    for k, a in want.items():
        b = got[k].numpy()
        assert b.shape == a.shape and b.dtype == np.float32 and np.isfinite(b).all()
        close = np.abs(b - a) <= REL * np.abs(a).max()
        assert close.mean() >= 0.9, (case, k, close.mean())


def test_sampler_steps_follow_the_jax_rounding(pair):
    """``partial_frac`` rounds t_top and the step count with Python's round
    (ties to even); the steps are numpy's ``.round()`` of a linspace."""
    _jm, _params, pm = pair
    for frac, steps in ((0.3, 50), (0.5, 7), (0.25, 10), (1.0, 50), (0.03, 50)):
        s = pd.make_sampler(pm, pd.DDPMSchedule(1000), num_steps=steps, partial_frac=frac)
        t_top = max(1, int(round(frac * 999)))
        n = max(1, min(int(round(steps * frac)), t_top + 1))
        np.testing.assert_array_equal(s.timesteps,
                                      np.linspace(t_top, 0, n).round().astype(np.int32))
    assert len(pd.make_sampler(pm, pd.DDPMSchedule(1000), num_steps=50,
                               partial_frac=0.3).timesteps) == 15


def test_sampler_is_repeatable_for_one_generator_seed(pair, data):
    _jm, _params, pm = pair
    sampler = pd.make_sampler(pm, num_steps=STEPS, eta=1.0)
    cond = torch.from_numpy(_cond(data, 4))
    runs = [sampler(pm, cond, torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
        assert not torch.equal(runs[0][k], runs[2][k]), k
        assert torch.isfinite(runs[0][k]).all()


def test_guidance_scale_one_is_the_plain_sampler(pair, data):
    _jm, _params, pm = pair
    cond = torch.from_numpy(_cond(data, 4))
    plain = pd.make_sampler(pm, num_steps=4)(pm, cond, torch.Generator().manual_seed(0))
    g1 = pd.make_sampler(pm, num_steps=4, guidance_scale=1.0)(
        pm, cond, torch.Generator().manual_seed(0))
    g2 = pd.make_sampler(pm, num_steps=4, guidance_scale=2.0)(
        pm, cond, torch.Generator().manual_seed(0))
    for k in plain:
        assert torch.equal(plain[k], g1[k]), k
    assert any(not torch.equal(plain[k], g2[k]) for k in plain)


def _error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize('case', ['partial_frac 1.5', 'partial_frac 0', 'target_space',
                                  'no init', 'init shape', 'last-frame init'])
def test_sampler_argument_errors_are_the_jax_errors(pair, data, case):
    jm, params, pm = pair
    cond = _cond(data, 2)
    kw, init = {}, None
    if case.startswith('partial_frac'):
        kw = dict(partial_frac=float(case.split()[1]))
    elif case == 'target_space':
        kw = dict(target_space='bogus')
    else:
        kw = dict(partial_frac=0.5)
        init = {'no init': None, 'init shape': np.zeros((2, 4, 29), np.float32),
                'last-frame init': np.zeros((2, 1, 30), np.float32)}[case]

    def jax_side():
        s = jd.make_sampler(jm, jd.DDPMSchedule(TIMESTEPS), num_steps=4, **kw)
        s(params, jnp.asarray(cond), jax.random.PRNGKey(0),
          None if init is None else jnp.asarray(init))

    def port_side():
        s = pd.make_sampler(pm, pd.DDPMSchedule(TIMESTEPS), num_steps=4, **kw)
        s(pm, torch.from_numpy(cond), torch.Generator().manual_seed(0),
          init=None if init is None else torch.from_numpy(init))

    want = _error(jax_side)
    assert want is not None and want[0] is ValueError
    assert _error(port_side) == want


def test_fused_inference_refuses_a_width_the_kernel_does_not_take():
    """JAX's fused path takes any width; the port's kernel takes multiples of
    128, and the sampler says so instead of taking the plain layer."""
    pm = _port_model(d_model=64)
    with pytest.raises(ValueError, match='multiple of 128.*d_model 64'):
        pd.make_sampler(pm, num_steps=4, fused_inference=True)
    pd.make_sampler(pm, num_steps=4)      # the plain chain takes it
    # the flax tree is ported; its fused path keeps the JAX refusal
    flax = _port_model(attn_impl='flax')
    with pytest.raises(ValueError, match="fused_inference consumes the vpu parameter tree; "
                                         "this denoiser was built with attn_impl='flax'"):
        pd.make_sampler(flax, num_steps=4, fused_inference=True)
    pd.make_sampler(flax, num_steps=4)


# -- checkpoints: target space, EMA, proposals ------------------------------------

def test_checkpoint_target_space_with_and_without_the_sidecar(tmp_path, caplog):
    d = tmp_path / 'c'
    d.mkdir()
    with caplog.at_level(logging.WARNING):
        assert pd.checkpoint_target_space(str(d)) == 'raw'
        assert jd.checkpoint_target_space(str(d)) == 'raw'
    port_msg = [r.getMessage() for r in caplog.records
                if r.name == 'inferbiomechanics_tpu_torch.models.diffusion']
    jax_msg = [r.getMessage() for r in caplog.records
               if r.name == 'inferbiomechanics_tpu.models.diffusion']
    assert port_msg == jax_msg and 'predates the normalized diffusion target space' \
        in port_msg[0]
    (d / 'run_config.json').write_text(json.dumps({'model_type': 'diffusion'}))
    assert pd.checkpoint_target_space(str(d)) == jd.checkpoint_target_space(str(d)) == 'raw'
    save_run_config(str(d), Config())
    assert pd.checkpoint_target_space(str(d)) == jd.checkpoint_target_space(str(d)) \
        == 'normalized'


def test_ema_params_save_load_and_require(tmp_path, pair):
    _jm, _params, pm = pair
    ema = {k: v + 1.0 for k, v in pm.state_dict().items()}
    path = ckpt.save_checkpoint(str(tmp_path / 'a'), pm, 2, 3, ema_params=ema)
    got = ckpt.load_ema_params(path)
    assert set(got) == set(ema) and all(torch.equal(got[k], ema[k]) for k in ema)
    assert ckpt.resolve_checkpoint_path(str(tmp_path / 'a')) == path
    assert all(torch.equal(v, ckpt.require_ema_params(path)[k]) for k, v in ema.items())
    model = _port_model()
    assert ckpt.load_checkpoint_file(model, path) == (2, 3)     # the params, not the EMA
    assert all(torch.equal(v, pm.state_dict()[k]) for k, v in model.state_dict().items())
    plain = ckpt.save_checkpoint(str(tmp_path / 'b'), pm, 0, 0)
    assert ckpt.load_ema_params(plain) is None
    assert ckpt.resolve_checkpoint_path(str(tmp_path / 'none')) is None
    for path in (plain, None):
        with pytest.raises(ValueError, match=f'--use-ema: checkpoint {path} carries '
                                             r'no ema_params \(train with --ema-decay\)'):
            ckpt.require_ema_params(path)


def _proposal_config(**fields):
    cfg = Config()
    cfg.model_type, cfg.window_size, cfg.stride = 'diffusion', 20, 5
    cfg.output_data_format, cfg.hidden_dims = 'all_frames', [64, 64]
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


@pytest.mark.parametrize('family', ['feedforward', 'groundlink', 'transformer'])
def test_partial_proposal_from_each_family(data, tmp_path, family):
    """With a sidecar the proposal is the family it names; the proposal is
    its eval forward, packed into the diffusion target layout."""
    prop_cfg = _proposal_config(model_type=family, d_model=128, num_layers=1,
                                num_heads=4, hidden_dims=[32])
    model = build_model_for_dataset(prop_cfg, data['ds'],
                                     generator=torch.Generator().manual_seed(1)).eval()
    d = str(tmp_path / family)
    ckpt.save_checkpoint(d, model, 0, 0)
    save_run_config(d, prop_cfg)
    propose = pd.make_partial_proposal_fn(_proposal_config(), data['ds'], d)
    x = torch.from_numpy(_cond(data, 3))
    with torch.no_grad():
        want = pd.diffusion_targets_from_outputs(model(x))
        raw = pd.make_partial_proposal_fn(_proposal_config(), data['ds'], d,
                                          target_space='raw')(x)
    got = propose(x)
    assert got.shape == (3, 4, 30) and torch.equal(got, want)
    assert torch.equal(raw, pd.diffusion_targets_from_outputs(model(x), 'raw'))


def test_partial_proposal_without_a_sidecar_matches_jax(data, tmp_path):
    """No sidecar: a feedforward model from the command's flags, as the JAX
    package builds it; the same weights propose the same targets."""
    jcfg = JaxConfig(model_type='feedforward', window_size=20, stride=5,
                     output_data_format='all_frames', hidden_dims=[64, 64])
    jds = data['jax_ds']
    jmodel = jax_build(jcfg, jds)
    state = jax_create_train_state(jmodel, jax.random.PRNGKey(2),
                                   jnp.asarray(jds.gather(np.arange(2)).inputs),
                                   jax_make_optimizer('adam', 1e-3))
    jax_save_checkpoint(str(tmp_path), state, 0, 0)
    model = build_model_for_dataset(_proposal_config(model_type='feedforward'), data['ds'])
    model.load_state_dict(weights.feedforward_state_dict_from_jax(
        jax.device_get(state.params)))
    ckpt.save_checkpoint(str(tmp_path), model, 0, 0)
    x = _cond(data, 3)
    jcfg_d = JaxConfig(model_type='diffusion', window_size=20, stride=5,
                       output_data_format='all_frames', hidden_dims=[64, 64])
    want = np.asarray(jd.make_partial_proposal_fn(jcfg_d, jds, str(tmp_path), x)(
        jnp.asarray(x)))
    got = pd.make_partial_proposal_fn(_proposal_config(), data['ds'], str(tmp_path))(
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=APPLY_REL * np.abs(want).max())


@pytest.mark.parametrize('case', ['no init', 'empty dir', 'last_frame', 'diffusion',
                                  'window', 'batchnorm'])
def test_partial_proposal_refusals(data, tmp_path, case):
    d = str(tmp_path / 'p')
    fields = {'last_frame': dict(output_data_format='last_frame'),
              'diffusion': dict(model_type='diffusion'),
              'window': dict(window_size=25),
              'batchnorm': dict(model_type='feedforward', batchnorm=True)}.get(case)
    if fields is not None:
        save_run_config(d, _proposal_config(**{'model_type': 'feedforward', **fields}))
    init = None if case == 'no init' else d
    port = _error(lambda: pd.make_partial_proposal_fn(_proposal_config(), data['ds'], init))
    jcfg = JaxConfig(model_type='diffusion', window_size=20, stride=5,
                     output_data_format='all_frames', hidden_dims=[64, 64])
    want = _error(lambda: jd.make_partial_proposal_fn(jcfg, data['jax_ds'], init,
                                                      _cond(data, 2)))
    assert want is not None and port == want
