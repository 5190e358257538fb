"""The JAX package's checkpoints in the port.

- ``utils/flax_msgpack.py`` against flax: for each family's payload, written
  by the JAX package's own ``save_checkpoint`` after two updates of each of
  the seven optimizers (and with a cosine schedule, gradient clipping and
  frozen parameters), the port's reader gives the tree
  ``flax.serialization.msgpack_restore`` gives, every leaf bitwise with its
  dtype and shape; bf16 leaves, 0-d scalars, empty dicts and chunked arrays
  too; the writer's bytes are ``flax.serialization.to_bytes``'s, and reader
  and writer are inverses on nested dict trees of arrays (hypothesis).
- ``train/checkpoint.py`` reading such a file into the port's model (the
  feedforward model in both trees and with batchnorm, GroundLink, the
  ``vpu`` and ``pallas`` transformers, the denoiser with its EMA): the
  parameters are bitwise the JAX tree's through ``weights.py``, and the
  outputs match ``model.apply`` (bf16 compute on both sides: within 2e-2 x
  the output's largest value; GroundLink's float32 plain version against
  the float32 JAX model within rtol 1e-4 / atol 1e-5).
- The optimizer's state crossing: from the loaded state, the port's next
  update matches JAX's next ``apply_gradients`` given the same gradients
  (seeded numpy, fed to both, so that nothing but the carried state can
  tell the two updates apart), within the optimizer tests' rtol 1e-5 /
  atol 1e-7, for every optimizer type in every family and every chain form;
  a fresh optimizer's update does not.

Small sizes: a (64,) feedforward model, d_model 128 / 1 layer / 4 heads.
"""

import logging
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from inferbiomechanics_tpu.models import get_model as jax_get_model
from inferbiomechanics_tpu.models.groundlink import Groundlink as JaxGroundlink
from inferbiomechanics_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from inferbiomechanics_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from inferbiomechanics_tpu.train.optimizers import wrap_freeze as jax_wrap_freeze
from inferbiomechanics_tpu.train.state import TrainState as JaxTrainState
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.models import get_model
from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg
from inferbiomechanics_tpu_torch.train import checkpoint as ckpt
from inferbiomechanics_tpu_torch.train.optimizers import OPT_TYPES, make_optimizer, wrap_freeze
from inferbiomechanics_tpu_torch.train.state import create_train_state
from inferbiomechanics_tpu_torch.utils import flax_msgpack

DIMS = dict(num_dofs=23, num_contact_bodies=2, history_len=20, stride=5,
            root_history_len=10)          # 4 frames x 177 channels
TINY = dict(d_model=128, num_layers=1, num_heads=4)
LR = 1e-4
TOL = dict(rtol=1e-5, atol=1e-7)            # tests/test_torch_optimizers.py's
BF16_REL = 2e-2
# family -> (JAX get_model kwargs, the port's); 'ff_pallas' is the JAX
# feedforward model's W{i}/b{i} tree, which the port's one model reads too
FAMILIES = {
    'feedforward': (dict(model_type='feedforward', hidden_dims=(64,)),) * 2,
    'ff_pallas': (dict(model_type='feedforward', hidden_dims=(64,), use_pallas=True),
                  dict(model_type='feedforward', hidden_dims=(64,))),
    'ff_batchnorm': (dict(model_type='feedforward', hidden_dims=(64,), batchnorm=True),) * 2,
    'groundlink': (dict(model_type='groundlink', output_data_format='all_frames'),) * 2,
    'transformer': (dict(model_type='transformer', **TINY),) * 2,
    'pallas': (dict(model_type='transformer', attn_impl='pallas', **TINY),) * 2,
    'diffusion': (dict(model_type='diffusion', diffusion_timesteps=16, **TINY),) * 2,
    # the flax-attention trees (MultiHeadDotProductAttention_0 blocks)
    'transformer_flax': (dict(model_type='transformer', attn_impl='flax', **TINY),) * 2,
    'diffusion_flax': (dict(model_type='diffusion', attn_impl='flax', diffusion_timesteps=16,
                            **TINY),) * 2,
}


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _x(b=4, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 4, 177)).astype(np.float32)


def _diffusion_args(b=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 4, 30)).astype(np.float32),
            (np.arange(b) * 5 % 16).astype(np.int32), _x(b, seed + 1))


_INITS = {}


def _jax_init(family, jm):
    """The JAX model's initial variables (made once a family)."""
    if family not in _INITS:
        _INITS[family] = _init(family, jm)
    return _INITS[family]


def _init(family, jm):
    key = jax.random.PRNGKey(3)
    if family.startswith('diffusion'):
        init = jax.jit(lambda k, *a: jm.init({'params': k}, *a))
        return jax.device_get(init(key, *map(jnp.asarray, _diffusion_args())))['params'], {}
    init = jax.jit(lambda k, x: jm.init({'params': k, 'dropout': k}, x, train=False))
    variables = jax.device_get(init(key, jnp.asarray(_x())))
    return variables['params'], variables.get('batch_stats', {})


def _noise(tree, rng, scale):
    """Every bias and norm row moved off its init, so that each one counts."""
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + scale * rng.normal(size=np.shape(p)) * (np.ndim(p) == 1)
                   ).astype(np.float32), tree)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.normal(size=np.shape(p)) * 10 ** rng.uniform(-2, 0)).astype(np.float32),
        params)


def _chain(opt_type, chain):
    """The JAX optimizer and the port's factory for one chain form."""
    kw = dict(lr_schedule='cosine', lr_decay_steps=20) if 'cosine' in chain else {}
    kw['grad_clip_norm'] = 0.5 if 'clip' in chain else 0.0
    tx = jax_make_optimizer(opt_type, LR, **kw)
    if 'freeze' in chain:
        tx = jax_wrap_freeze(tx, ['Dense_0'])

    def port(model):
        opt = make_optimizer(model.named_parameters(), opt_type, LR, **kw)
        return wrap_freeze(opt, [r'layers\.0\.']) if 'freeze' in chain else opt

    return tx, port


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    return tmp_path_factory.mktemp('jax_checkpoints')


_MADE = {}
_AFTER = {}      # file -> the JAX state after one more update (g3)


@jax.jit
def _three_updates(state, g1, g2, g3):
    """The states after two updates and after a third (one compile)."""
    two = state.apply_gradients(g1).apply_gradients(g2)
    return two, two.apply_gradients(g3)


def _jax_checkpoint(tmp_path, family, opt_type='rmsprop', chain=()):
    """A JAX train state after two updates (seeded gradients; the batch
    statistics and, for the denoiser, an EMA moved off their init), saved
    by the JAX package (once a module). Returns (JAX model, state, file,
    EMA)."""
    key = (str(tmp_path), family, opt_type, tuple(chain))
    if key not in _MADE:
        *made, after = _make_jax_checkpoint(tmp_path, family, opt_type, chain)
        _MADE[key], _AFTER[made[2]] = tuple(made), after
    return _MADE[key]


def _make_jax_checkpoint(tmp_path, family, opt_type, chain):
    jkw, _ = FAMILIES[family]
    jm = jax_get_model(**{**DIMS, **jkw})
    params, batch_stats = _jax_init(family, jm)
    rng = np.random.default_rng(len(family))
    params = _noise(params, rng, 0.05)
    batch_stats = jax.tree_util.tree_map(
        lambda s: (np.abs(s + 0.3 * rng.normal(size=s.shape))).astype(np.float32), batch_stats)
    tx, _ = _chain(opt_type, chain)
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                          opt_state=tx.init(params), batch_stats=batch_stats,
                          tx=tx, apply_fn=jm.apply)
    state, after = _three_updates(state, *(_grads(params, seed) for seed in (1, 2, 3)))
    ema = _noise(jax.device_get(state.params), rng, 0.01) if family.startswith('diffusion') else None
    d = str(tmp_path / f'{family}_{opt_type}_{"_".join(chain)}')
    path = jax_save_checkpoint(d, state, 3, 5, ema_params=ema)
    return jm, state, path, ema, after


def _port_model(family):
    _, pkw = FAMILIES[family]
    return get_model(generator=torch.Generator().manual_seed(9), **{**DIMS, **pkw})


def _assert_trees_equal(got, want, where='payload'):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _assert_trees_equal(got[k], want[k], f'{where}/{k}')
        return
    if isinstance(want, np.ndarray) and want.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, where
        assert tuple(got.shape) == want.shape, where
        np.testing.assert_array_equal(got.view(torch.uint16).numpy(), want.view(np.uint16),
                                      err_msg=where)
        return
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want, where


def _reads_as_flax(path):
    with open(path, 'rb') as f:
        blob = f.read()
    tree = flax_msgpack.loads(blob)
    _assert_trees_equal(tree, serialization.msgpack_restore(blob))
    assert flax_msgpack.dumps(tree) == blob
    return tree


# ---- the reader and the writer against flax ----

@pytest.mark.parametrize('family', list(FAMILIES))
def test_reader_gives_flax_tree_for_every_family_and_optimizer(store, family):
    for opt_type in OPT_TYPES:
        _, _, path, _ = _jax_checkpoint(store, family, opt_type)
        tree = _reads_as_flax(path)
        assert set(tree) >= {'step', 'params', 'opt_state', 'batch_stats', 'epoch', 'batch'}
        assert ('ema_params' in tree) == family.startswith('diffusion')


@pytest.mark.parametrize('chain', [('cosine',), ('clip',), ('freeze',),
                                   ('cosine', 'clip', 'freeze')])
def test_reader_gives_flax_tree_for_every_chain_form(store, chain):
    for opt_type in OPT_TYPES:
        _, _, path, _ = _jax_checkpoint(store, 'feedforward', opt_type, chain)
        tree = _reads_as_flax(path)
        layout = weights.optax_layout(opt_type, 'cosine' in chain, 'clip' in chain,
                                      'freeze' in chain)
        weights._match(tree['opt_state'], layout, (), {}, [])     # the layout the port expects


def test_bf16_scalars_empty_dicts_and_every_width():
    tree = {
        'bf16': np.linspace(-3, 3, 12).astype(ml_dtypes.bfloat16).reshape(3, 4),
        'bf16_scalar': np.asarray(1.5, ml_dtypes.bfloat16),
        'zero_d': np.asarray(7, np.int64), 'np_scalar': np.float32(2.5), 'np_int': np.int16(-3),
        'empty': {}, 'nested': {'a': {}, 'b': {'c': np.zeros((0, 3), np.float32)}},
        'ints': {str(i): v for i, v in enumerate(
            [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 63])},
        'floats': 1.25, 'none': None, 'flags': {'t': True, 'f': False},
        'text': 'x' * 31, 'text8': 'y' * 200, 'text16': 'z' * 70000, 'blob': b'\x00' * 300,
        'dtypes': {str(dt): np.arange(5).astype(dt) for dt in
                   ('uint8', 'int8', 'uint16', 'int32', 'uint64', 'float16', 'float64', 'bool')},
        'big_map': {f'k{i}': i for i in range(20)},
        'long': np.zeros(70000, np.uint8), 'many_dims': np.zeros((1,) * 17, np.float32),
    }
    blob = serialization.to_bytes(tree)
    got = flax_msgpack.loads(blob)
    _assert_trees_equal(got, serialization.msgpack_restore(blob))
    assert flax_msgpack.dumps(got) == blob
    as_torch = dict(tree, bf16=torch.from_numpy(tree['bf16'].view(np.uint16).copy()).view(
        torch.bfloat16))
    assert flax_msgpack.dumps(as_torch) == blob       # a torch bf16 tensor writes as flax's


def test_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)
    monkeypatch.setattr(flax_msgpack, 'MAX_CHUNK_SIZE', 64)
    tree = {'w': np.arange(100, dtype=np.float32).reshape(4, 25),
            'inner': {'b': np.arange(40, dtype=ml_dtypes.bfloat16)}, 'small': np.ones(3)}
    blob = serialization.to_bytes(tree)
    assert b'__msgpack_chunked_array__' in blob
    got = flax_msgpack.loads(blob)
    _assert_trees_equal(got, serialization.msgpack_restore(blob))
    assert flax_msgpack.dumps(dict(got)) == serialization.to_bytes(
        serialization.msgpack_restore(blob))


@pytest.mark.parametrize('blob,what', [
    (b'\x81\xa1a\xd4\x02\x00', 'ext type 2'),                  # a native complex
    (b'\x81\xa1a\xd6\xff\x00\x00\x00\x00', 'ext type -1'),     # a timestamp
    (b'\x81\xa1a\xc1', 'unknown code 0xc1'),
    (b'\x81\xa1a\xc4\x05ab', 'truncated'),
])
def test_anything_else_raises_with_the_offset(blob, what):
    with pytest.raises(ValueError, match=f'{what}.* at byte|at byte.*'):
        flax_msgpack.loads(blob)
    with pytest.raises(ValueError, match=what.split()[0]):
        flax_msgpack.loads(blob)


_leaves = st.one_of(
    st.builds(lambda shape, dt, seed: np.random.default_rng(seed).normal(size=shape).astype(dt),
              st.lists(st.integers(0, 3), max_size=3).map(tuple),
              st.sampled_from(['float32', 'float64', 'int32', 'uint8', 'float16']),
              st.integers(0, 2 ** 16)),
    st.integers(-2 ** 63, 2 ** 64 - 1), st.floats(allow_nan=False), st.booleans(), st.none(),
    st.text(max_size=40))
_trees = st.recursive(_leaves, lambda inner: st.dictionaries(st.text(max_size=8), inner,
                                                              max_size=5), max_leaves=20)


@settings(max_examples=60, deadline=None, database=None)
@given(st.dictionaries(st.text(max_size=8), _trees, max_size=5))
def test_reader_and_writer_are_inverses(tree):
    blob = flax_msgpack.dumps(tree)
    assert blob == serialization.to_bytes(tree)
    back = flax_msgpack.loads(blob)
    _assert_trees_equal(back, serialization.msgpack_restore(blob))
    assert flax_msgpack.dumps(back) == blob


# ---- a JAX checkpoint in the port ----

def _jax_outputs(family, jm, state, ema=None):
    variables = {'params': ema if ema is not None else state.params}
    if state.batch_stats:
        variables['batch_stats'] = state.batch_stats
    if family.startswith('diffusion'):
        apply = jax.jit(jm.apply)
        return {'eps': np.asarray(apply(variables, *map(jnp.asarray, _diffusion_args(6))))}
    apply = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    return {k: np.asarray(v) for k, v in apply(variables, jnp.asarray(_x(6))).items()}


def _port_outputs(family, model):
    with torch.no_grad():
        if family.startswith('diffusion'):
            return {'eps': model(*map(torch.from_numpy, _diffusion_args(6))).numpy()}
        return {k: v.numpy() for k, v in model(torch.from_numpy(_x(6))).items()}


@pytest.mark.parametrize('family', list(FAMILIES))
def test_a_jax_checkpoint_serves_in_the_port(store, family):
    jm, state, path, ema = _jax_checkpoint(store, family)
    model = _port_model(family).eval()
    assert ckpt.load_checkpoint_file(model, path) == (3, 5)
    # the parameters (and running statistics) are bitwise the JAX tree's
    want = weights.state_dict_from_jax(weights.model_family(model),
                                       jax.device_get(state.params),
                                       jax.device_get(state.batch_stats) or None)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    model.eval()
    for (k, w), g in zip(sorted(_jax_outputs(family, jm, state).items()),
                         (v for _, v in sorted(_port_outputs(family, model).items()))):
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, atol=BF16_REL * np.abs(w).max(), err_msg=k)
    if family == 'groundlink':
        # the float32 plain version against the float32 JAX model
        jf = JaxGroundlink(num_dofs=23, num_contact_bodies=2, root_history_len=10,
                           output_data_format='all_frames', compute_dtype=jnp.float32)
        want = jax.jit(lambda p, x: jf.apply({'params': p}, x, train=False))(
            state.params, jnp.asarray(_x(6)))
        with torch.no_grad():
            exact = fg.groundlink_reference(torch.from_numpy(_x(6)), model.layer_params(),
                                            'all_frames', 3, torch.float32)
        for k, (a, b) in {'cops': (0, 6), 'forces': (6, 12)}.items():
            np.testing.assert_allclose(
                exact[..., a:b].numpy(),
                np.asarray(want[f'groundContact{"CenterOfPressure" if k == "cops" else "Force"}'
                                f'InRootFrame']), rtol=1e-4, atol=1e-5, err_msg=k)
    if family.startswith('diffusion'):
        model.load_state_dict(ckpt.load_ema_params(path, like=model))
        for k, w in _jax_outputs(family, jm, state, ema).items():
            g = _port_outputs(family, model)[k]
            np.testing.assert_allclose(g, w, rtol=0, atol=BF16_REL * np.abs(w).max())
        fresh = _port_model(family)
        ckpt.load_checkpoint_file(fresh, path, use_ema=True)
        assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(), model.parameters()))
        assert set(ckpt.require_ema_params(path)) == {n for n, _ in model.named_parameters()}


def _next_updates(family, opt_type, chain, jm, state, path, fresh=False):
    """(the port's parameters after one more update from the loaded file,
    JAX's after its next apply_gradients), both by the port's names."""
    _, port_opt = _chain(opt_type, chain)
    model = _port_model(family)
    train_state = create_train_state(model, port_opt(model))
    if fresh:
        ckpt.load_checkpoint_file(model, path)
    else:
        assert ckpt.load_checkpoint_file(train_state, path) == (3, 5)
        assert train_state.step == 2
    fam = weights.model_family(model)
    g3 = _grads(_jax_init(family, jm)[0], 3)
    named_g = weights.params_from_jax(fam, g3)
    for n, p in model.named_parameters():
        p.grad = named_g[n].clone()
    train_state.apply_gradients()
    new = _AFTER[path]
    want = weights.params_from_jax(fam, jax.device_get(new.params))
    return dict(model.named_parameters()), want, train_state, new


@pytest.mark.parametrize('family', list(FAMILIES))
def test_the_next_update_matches_jax_for_every_optimizer(store, family):
    for opt_type in OPT_TYPES:
        jm, state, path, _ = _jax_checkpoint(store, family, opt_type)
        got, want, train_state, new = _next_updates(family, opt_type, (), jm, state, path)
        for n, w in want.items():
            np.testing.assert_allclose(got[n].detach().numpy(), w.numpy(),
                                       err_msg=f'{family} {opt_type} {n}', **TOL)
        assert weights.optimizer_state_to_jax(weights.model_family(train_state.model),
                                              train_state.optimizer).keys() == \
            serialization.to_state_dict(jax.device_get(new.opt_state)).keys()
        if opt_type != 'sgd':        # the carried state, not merely a loaded file
            fresh, _, _, _ = _next_updates(family, opt_type, (), jm, state, path, fresh=True)
            assert not all(np.allclose(fresh[n].detach().numpy(), w.numpy(), **TOL)
                           for n, w in want.items()), opt_type


@pytest.mark.parametrize('chain', [('cosine',), ('clip',), ('freeze',),
                                   ('cosine', 'clip', 'freeze')])
def test_the_next_update_matches_jax_for_every_chain_form(store, chain):
    for opt_type in OPT_TYPES:
        jm, state, path, _ = _jax_checkpoint(store, 'feedforward', opt_type, chain)
        got, want, train_state, new = _next_updates('feedforward', opt_type, chain, jm,
                                                    state, path)
        for n, w in want.items():
            np.testing.assert_allclose(got[n].detach().numpy(), w.numpy(),
                                       err_msg=f'{chain} {opt_type} {n}', **TOL)
        if 'cosine' in chain or opt_type in ('adam', 'adamw', 'adamax'):
            assert train_state.optimizer.param_groups[0]['count'] == 3
        # the port's state written back has the JAX layout, moments and count
        back = flax_msgpack.loads(flax_msgpack.dumps(weights.optimizer_state_to_jax(
            'feedforward', train_state.optimizer)))
        jax_back = serialization.to_state_dict(jax.device_get(new.opt_state))
        moments, counts = {}, []
        weights._match(back, weights.optimizer_layout(train_state.optimizer), (), moments,
                       counts)
        jm_, jc = {}, []
        weights._match(jax_back, weights.optimizer_layout(train_state.optimizer), (), jm_, jc)
        assert counts == [int(c) for c in jc]
        for field, tree in jm_.items():
            for (path_, a), (_, b) in zip(
                    sorted(jax.tree_util.tree_flatten_with_path(tree)[0], key=str),
                    sorted(jax.tree_util.tree_flatten_with_path(moments[field])[0], key=str)):
                if 'freeze' in chain and 'Dense_0' in str(path_):
                    continue     # the port keeps no moments for a frozen parameter
                np.testing.assert_allclose(b, np.asarray(a), err_msg=f'{field} {path_}', **TOL)


def test_another_optimizer_starts_fresh_with_the_jax_warning(store, caplog):
    _, state, path, _ = _jax_checkpoint(store, 'feedforward', 'adam')
    model = _port_model('feedforward')
    train_state = create_train_state(model, make_optimizer(model.named_parameters(),
                                                           'rmsprop', LR))
    with caplog.at_level(logging.WARNING):
        assert ckpt.load_checkpoint_file(train_state, path) == (3, 5)
    assert 'optimizer state not restored' in caplog.text
    assert not train_state.optimizer.state and train_state.step == 2


def test_wrong_trees_raise_with_the_jax_guidance(store):
    _, _, path, _ = _jax_checkpoint(store, 'transformer')
    pallas = _port_model('pallas')           # a vpu tree into the pallas model
    with pytest.raises(ValueError, match='--attn-impl'):
        ckpt.load_checkpoint_file(pallas, path)
    _, _, ff, _ = _jax_checkpoint(store, 'feedforward')
    wide = get_model(model_type='feedforward', hidden_dims=(32,), **DIMS)
    with pytest.raises(ValueError, match='--hidden-dims'):
        ckpt.load_checkpoint_file(wide, ff)
    with pytest.raises(ValueError, match='--hidden-dims'):
        ckpt.load_checkpoint_file(_port_model('groundlink'), ff)
    bogus = store / 'bogus.ckpt'
    bogus.write_bytes(b'not a checkpoint')
    with pytest.raises(ValueError, match='neither a torch.save file nor'):
        ckpt.load_checkpoint_file(wide, str(bogus))
    with pytest.raises(ValueError, match='none of the families'):
        weights.tree_family({'Foo_0': {}})


def test_a_directory_of_jax_files_warns_once_and_starts_fresh(store, caplog):
    _, _, path, _ = _jax_checkpoint(store, 'feedforward')
    d = os.path.dirname(path)
    model = _port_model('feedforward')
    with caplog.at_level(logging.WARNING):
        assert ckpt.load_latest_checkpoint(model, d) == (-1, 0)
        assert ckpt.load_latest_checkpoint(model, d) == (-1, 0)
    assert caplog.text.count('convert-checkpoint') == 1
    assert ckpt.list_checkpoints(d) == []


# serve and analyze name a JAX checkpoint file (the flags of each family)
_FLAGS = {
    'feedforward': ['--hidden-dims', '64'],
    'groundlink': ['--model-type', 'groundlink', '--output-data-format', 'all_frames'],
    'pallas': ['--model-type', 'transformer', '--attn-impl', 'pallas', '--d-model', '128',
               '--num-layers', '1', '--num-heads', '4', '--fused-inference'],
    # --fused-inference: the flax tree is served through the plain forward,
    # with the JAX warning
    'transformer_flax': ['--model-type', 'transformer', '--attn-impl', 'flax', '--d-model',
                         '128', '--num-layers', '1', '--num-heads', '4', '--fused-inference'],
    'diffusion': ['--model-type', 'diffusion', '--output-data-format', 'all_frames',
                  '--d-model', '128', '--num-layers', '1', '--num-heads', '4',
                  '--diffusion-timesteps', '16', '--fused-inference'],
}


@pytest.fixture(scope='module')
def home(tmp_path_factory):
    from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
    root = tmp_path_factory.mktemp('jax_ckpt_home')
    for split, length in (('dev', 60), ('train', 25)):
        os.makedirs(root / split)
        write_synthetic_subject(str(root / split / 's.b3d'), num_trials=1,
                                trial_length=length, seed=0)
    return root


@pytest.mark.parametrize('family', list(_FLAGS))
def test_serve_and_analyze_name_a_jax_checkpoint(store, home, tmp_path, family):
    from inferbiomechanics_tpu_torch.__main__ import build_parser as main_parser
    from inferbiomechanics_tpu_torch.cli.analyze_cmd import analyze
    from inferbiomechanics_tpu_torch.cli.serve_cmd import build_parser, start
    from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
    _, _, path, _ = _jax_checkpoint(store, family)
    common = ['--dataset-home', str(home), '--checkpoint-dir', str(tmp_path), '--device',
              'cpu', '--history-len', '20', '--stride', '5', *_FLAGS[family]]
    svc, server = start(build_parser().parse_args(
        ['serve', '--port', '0', '--checkpoint-file', path, '--sample-steps', '2', *common]))
    try:
        assert (svc.epoch, svc.batch) == (3, 5)
        x = np.asarray(WindowDataset(str(home / 'dev'), window_size=20, stride=5,
                                     skip_loading_skeletons=True).gather(np.arange(3)).inputs)
        got = svc.predict_packed(x)
        assert all(v.shape[0] == 3 and np.isfinite(v).all() for v in got.values())
        if not family.startswith('diffusion'):      # the file's weights answer
            model = _port_model(family).eval()
            ckpt.load_checkpoint_file(model, path)
            with torch.no_grad():
                want = model(torch.from_numpy(x))
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v.numpy().reshape(got[k].shape))
        with pytest.raises(ValueError, match='--checkpoint-file'):
            svc.reload()
    finally:
        server.server_close()
        svc.close()
    out = analyze(main_parser().parse_args(
        ['analyze', '--checkpoint-file', path, '--no-wandb', *common]))
    assert out['dev']['windows'] > 0 and np.isfinite(out['dev']['summary']['loss'])
