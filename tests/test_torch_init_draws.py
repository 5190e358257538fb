"""The port's initial draws against flax's, tensor by tensor.

For every family and tree (feedforward with ``init_style`` torch and lecun,
the diffusion proposal (the all-frames feedforward model), GroundLink with
its kaiming-uniform head, the transformer's ``vpu``, ``pallas`` and ``flax``
trees, the denoiser's ``vpu`` and ``flax`` trees), ``SEEDS`` initialisations
on each side: JAX's ``get_model(...).init`` (jitted, vmapped over the keys)
and the port's model built from ``torch.Generator().manual_seed(seed)``,
its parameters mapped onto the JAX tree by ``weights.params_to_jax``. For
each parameter, over all seeds' values pooled (n of them):

- the shape is the same;
- a constant (a zero bias, a LayerNorm scale of ones) is the same constant;
- the means differ by at most ``Z`` standard errors of a difference of two
  means, ``Z * std * sqrt(2 / n)``;
- the standard deviations differ by at most ``Z`` standard errors of a
  difference of two sample deviations, ``Z * std * sqrt((kurtosis - 1) /
  (2 n))`` (JAX's sample kurtosis: 3 for a normal, 1.8 for a uniform);
- the largest |value| / std names the same distribution: below
  ``BOUNDED`` a bounded one, whose figure then matches within
  ``MAX_RATIO_REL`` (a truncated normal at two deviations 2.27, a uniform
  sqrt(3) = 1.73, each approached within 0.3% at the smallest n here, 960),
  above it an unbounded one (a plain normal: with n >= 960 its largest
  |value| lies below 2.5 deviations with a chance under 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.models import get_model as jax_get_model
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.models import get_model

SEEDS = 32
Z = 6.0
BOUNDED = 2.5
MAX_RATIO_REL = 0.03
BASE = dict(num_dofs=23, num_contact_bodies=2, history_len=50, stride=5, root_history_len=10)
SMALL_ENCODER = dict(d_model=64, num_layers=2, num_heads=4)
CASES = {
    'feedforward-torch': ('feedforward', dict(hidden_dims=(64, 64), init_style='torch')),
    'feedforward-lecun': ('feedforward', dict(hidden_dims=(64, 64), init_style='lecun')),
    'proposal': ('feedforward', dict(hidden_dims=(64, 64), output_data_format='all_frames')),
    'groundlink': ('groundlink', {}),
    'transformer-vpu': ('transformer', dict(SMALL_ENCODER, attn_impl='vpu')),
    'transformer-pallas': ('transformer', dict(SMALL_ENCODER, attn_impl='pallas')),
    'transformer-flax': ('transformer', dict(SMALL_ENCODER, attn_impl='flax')),
    'diffusion-vpu': ('diffusion', dict(SMALL_ENCODER, attn_impl='vpu')),
    'diffusion-flax': ('diffusion', dict(SMALL_ENCODER, attn_impl='flax')),
}


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float64)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_draws(model_type, kw):
    """{path: [SEEDS, *shape]} of JAX's inits for PRNGKey(0..SEEDS-1)."""
    model = jax_get_model(model_type, **BASE, **kw)
    x = jnp.zeros((2, 10, 177), jnp.float32)
    if model_type == 'diffusion':
        args = (jnp.zeros((2, 10, model.target_channels), jnp.float32),
                jnp.zeros((2,), jnp.int32), x)
    else:
        args = (x,)
    init = jax.jit(jax.vmap(lambda key: model.init({'params': key, 'dropout': key}, *args,
                                                   train=False)['params']))
    keys = jnp.stack([jax.random.PRNGKey(s) for s in range(SEEDS)])
    return _flat(jax.device_get(init(keys)))


def _port_draws(model_type, kw):
    """{path: [SEEDS, *shape]} of the port's inits, on the JAX tree."""
    per_seed = []
    for s in range(SEEDS):
        model = get_model(model_type, **BASE, **kw, generator=torch.Generator().manual_seed(s))
        named = {n: p.detach() for n, p in model.named_parameters()}
        per_seed.append(_flat(weights.params_to_jax(weights.model_family(model), named)))
    return {k: np.stack([d[k] for d in per_seed]) for k in per_seed[0]}


def _stats(v):
    v = v.ravel()
    std = v.std()
    kurt = float(((v - v.mean()) ** 4).mean() / std ** 4) if std > 0 else 0.0
    return dict(n=v.size, mean=float(v.mean()), std=float(std), kurtosis=kurt,
                max_ratio=float(np.abs(v).max() / std) if std > 0 else 0.0)


@pytest.mark.parametrize('case', list(CASES))
def test_initial_draws_follow_flax(case):
    model_type, kw = CASES[case]
    jax_side, port_side = _jax_draws(model_type, kw), _port_draws(model_type, kw)
    assert set(port_side) == set(jax_side)
    faults = []
    for path, want in jax_side.items():
        got = port_side[path]
        if got.shape != want.shape:
            faults.append(f'{path}: shape {got.shape[1:]} vs JAX {want.shape[1:]}')
            continue
        if want.min() == want.max():            # a constant
            if not (got == want.flat[0]).all():
                faults.append(f'{path}: JAX the constant {want.flat[0]}, the port '
                              f'{_stats(got)}')
            continue
        j, p = _stats(want), _stats(got)
        n = j['n']
        assert n >= 960, (path, n)
        tol_mean = Z * j['std'] * np.sqrt(2 / n)
        tol_std = Z * j['std'] * np.sqrt((j['kurtosis'] - 1) / (2 * n))
        bounded = j['max_ratio'] < BOUNDED
        if (abs(p['mean'] - j['mean']) > tol_mean or abs(p['std'] - j['std']) > tol_std
                or (p['max_ratio'] < BOUNDED) != bounded
                or (bounded and abs(p['max_ratio'] / j['max_ratio'] - 1) > MAX_RATIO_REL)):
            faults.append(f'{path}: JAX {j}, the port {p} (tolerance: mean {tol_mean:.3g}, '
                          f'std {tol_std:.3g})')
    assert not faults, f'{case}: ' + '\n'.join(faults)
