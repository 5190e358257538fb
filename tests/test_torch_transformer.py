"""The port's transformer (inferbiomechanics_tpu_torch/models/transformer.py,
weights.py) against the JAX package's (inferbiomechanics_tpu/models/
transformer.py) on the same numpy inputs and weights.

Small size: d_model 128, 2 layers, 4 heads, window 50 / stride 5 (T = 10),
177 input channels. The JAX fused forward runs its reference layer on the
CPU and, under ``IB_PALLAS_INTERPRET=1``, the Pallas kernel in interpret
mode; the port's fused forward runs its plain layer on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.models import get_model as jax_get_model
from inferbiomechanics_tpu.models.transformer import (
    fused_transformer_forward as jax_fused_forward,
)
from inferbiomechanics_tpu_torch.models import get_model
from inferbiomechanics_tpu_torch.models.transformer import (
    TransformerRegressor, fused_transformer_forward,
)
from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
from inferbiomechanics_tpu_torch.weights import (
    transformer_flax_params_to_jax, transformer_flax_state_dict_from_jax,
    transformer_pallas_params_to_jax, transformer_pallas_state_dict_from_jax,
    transformer_params_to_jax, transformer_state_dict_from_jax,
)

SIZE = dict(num_dofs=23, num_contact_bodies=2, history_len=50, stride=5,
            root_history_len=10, d_model=128, num_layers=2, num_heads=4)
# The JAX suite holds its fused forward to model.apply at 3e-2 x max|ref|
# per head (tests/test_pallas_encoder.py). Port against JAX, the same
# forward on the same weights differs only by where XLA and PyTorch round
# to bf16 and in which order they sum: 2e-2 x max|ref|.
REL = 2e-2


def _models(fmt, attn_impl='vpu'):
    jm = jax_get_model('transformer', output_data_format=fmt, attn_impl=attn_impl, **SIZE)
    pm = get_model('transformer', output_data_format=fmt, attn_impl=attn_impl, **SIZE)
    return jm, pm


def _jax_params(jm, seed):
    """Initialised by flax, then every bias and LayerNorm row moved off its
    zeros / ones with seeded numpy noise, so that each one matters."""
    x = jnp.zeros((2, 10, 177), jnp.float32)
    params = jax.device_get(jm.init({'params': jax.random.PRNGKey(seed)}, x,
                                    train=False)['params'])
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (p + 0.1 * rng.normal(size=p.shape)).astype(np.float32)
        if p.ndim == 1 else np.asarray(p), params)


def _x(seed, b=6):
    return np.random.default_rng(seed).normal(0, 1, (b, 10, 177)).astype(np.float32)


def _assert_heads_close(got, want, fmt):
    assert set(got) == set(want) and len(want) == 7
    frames = 10 if fmt == 'all_frames' else 1
    for k in want:
        a, b = np.asarray(want[k]), got[k].numpy()
        assert b.shape == a.shape and a.shape[1] == frames, k
        assert b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=0, atol=REL * (np.abs(a).max() + 1e-6),
                                   err_msg=f'head {k}')


def test_weights_there_and_back():
    jm, pm = _models('last_frame')
    params = _jax_params(jm, 0)
    sd = transformer_state_dict_from_jax(params)
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    back = transformer_params_to_jax(pm.state_dict())
    flat, flat_back = (dict(jax.tree_util.tree_flatten_with_path(t)[0])
                       for t in (params, back))
    assert set(flat) == set(flat_back)
    for path in flat:
        np.testing.assert_array_equal(flat_back[path], flat[path], err_msg=str(path))
    # kernels are [in, out] on the JAX side, [out, in] in nn.Linear
    np.testing.assert_array_equal(
        sd['blocks.1.attn.qkv.weight'].numpy(),
        params['EncoderBlock_1']['ShortWindowAttention_0']['qkv']['kernel'].T)


def test_weights_refuse_the_pallas_tree():
    with pytest.raises(ValueError, match='pallas'):
        transformer_state_dict_from_jax({'enc0_wqkv': np.zeros((2, 6), np.float32)})


def test_pallas_weights_there_and_back():
    jm, pm = _models('last_frame', 'pallas')
    params = _jax_params(jm, 2)
    sd = transformer_pallas_state_dict_from_jax(params)
    assert set(sd) == set(pm.state_dict())
    assert sum(k.startswith('enc') for k in sd) == 2 * len(fe.PARAM_NAMES)
    pm.load_state_dict(sd)
    back = transformer_pallas_params_to_jax(pm.state_dict())
    flat, flat_back = (dict(jax.tree_util.tree_flatten_with_path(t)[0])
                       for t in (params, back))
    assert set(flat) == set(flat_back)
    for path in flat:
        np.testing.assert_array_equal(flat_back[path], flat[path], err_msg=str(path))
    # the enc{i}_* kernels are [in, out] on both sides: no transpose
    np.testing.assert_array_equal(sd['enc1_wqkv'].numpy(), params['enc1_wqkv'])
    assert sd['enc1_wqkv'].shape == (128, 384)
    # the modules around the encoder map as in the vpu tree
    np.testing.assert_array_equal(sd['input_proj.weight'].numpy(),
                                  params['Dense_0']['kernel'].T)
    # each converter refuses the other tree
    with pytest.raises(ValueError, match='pallas'):
        transformer_params_to_jax(pm.state_dict())
    vpu = _models('last_frame')[1]
    with pytest.raises(ValueError, match='enc'):
        transformer_pallas_params_to_jax(vpu.state_dict())
    with pytest.raises(ValueError, match='enc'):
        transformer_pallas_state_dict_from_jax(_jax_params(_models('last_frame')[0], 0))


@pytest.mark.parametrize('fmt', ['last_frame', 'all_frames'])
def test_pallas_forward_matches_jax_apply(fmt):
    """The ``pallas`` model's one forward (plain layers on the CPU) against
    ``model.apply`` of the JAX ``attn_impl='pallas'`` model (its reference
    layer on the CPU), in eval and in train mode."""
    jm, pm = _models(fmt, 'pallas')
    params = _jax_params(jm, 3)
    pm.load_state_dict(transformer_pallas_state_dict_from_jax(params))
    x = _x(4)
    want = jm.apply({'params': params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        _assert_heads_close(pm.eval()(torch.from_numpy(x)), want, fmt)
        _assert_heads_close(pm.train()(torch.from_numpy(x)), want, fmt)


def test_pallas_layers_are_packed_again_only_after_a_change():
    pm = get_model('transformer', attn_impl='pallas', **SIZE)
    first = pm.packed_layers(False)
    assert pm.packed_layers(False) is first and first[0].weights_t is None
    with_t = pm.packed_layers(True)
    assert with_t is not first and with_t[0].weights_t is not None
    with torch.no_grad():
        pm.enc1_bmlp2.add_(1.0)                  # as an optimizer update does
    again = pm.packed_layers(True)
    assert again is not with_t
    assert torch.equal(again[1].params[11], pm.enc1_bmlp2.detach())
    pm.load_state_dict(pm.state_dict())
    assert pm.packed_layers(True) is not again
    assert len(pm.blocks) == 0 and len(pm.layer_params(0)) == 12


def test_pallas_model_takes_no_dropout():
    with pytest.raises(ValueError, match='does not support dropout'):
        get_model('transformer', attn_impl='pallas', dropout=True, dropout_prob=0.1,
                  **SIZE)


@pytest.mark.parametrize('fmt', ['last_frame', 'all_frames'])
def test_vpu_forward_matches_jax_apply(fmt):
    jm, pm = _models(fmt)
    params = _jax_params(jm, 1)
    pm.load_state_dict(transformer_state_dict_from_jax(params))
    x = _x(1)
    want = jm.apply({'params': params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    _assert_heads_close(got, want, fmt)


@pytest.mark.parametrize('interpret', [False, True])
@pytest.mark.parametrize('fmt', ['last_frame', 'all_frames'])
def test_fused_forward_matches_jax_fused_forward(fmt, interpret, monkeypatch):
    """interpret=True runs the JAX side's Pallas kernel in interpret mode."""
    monkeypatch.setenv('IB_PALLAS_INTERPRET', '1' if interpret else '0')
    jm, pm = _models(fmt)
    params = _jax_params(jm, 2)
    pm.load_state_dict(transformer_state_dict_from_jax(params))
    x = _x(2)
    want = jax_fused_forward(jm, params, jnp.asarray(x))
    before = fe.launches
    with torch.no_grad():
        got = fused_transformer_forward(pm.eval(), torch.from_numpy(x))
        plain = fused_transformer_forward(pm, torch.from_numpy(x), use_kernel=False)
    assert fe.launches == before            # on the CPU no kernel runs
    _assert_heads_close(got, want, fmt)
    for k in got:                            # the CPU wrapper is the plain version
        assert torch.equal(got[k], plain[k])


def test_fused_and_vpu_forwards_differ_only_at_bf16_residual_level():
    jm, pm = _models('last_frame')
    pm.load_state_dict(transformer_state_dict_from_jax(_jax_params(jm, 3)))
    x = torch.from_numpy(_x(3))
    with torch.no_grad():
        vpu, fused = pm.eval()(x), fused_transformer_forward(pm, x)
    for k in vpu:
        scale = float(vpu[k].abs().max())
        assert float((vpu[k] - fused[k]).abs().max()) <= 3e-2 * scale, k
    assert any(not torch.equal(vpu[k], fused[k]) for k in vpu)


def test_packing_is_made_once_and_dropped_on_load():
    _, pm = _models('last_frame')
    pm.eval()
    packed = pm.packed()
    assert pm.packed() is packed and len(packed.layers) == 2
    assert packed.layers[0].weights.dtype == torch.bfloat16
    pm.load_state_dict(pm.state_dict())
    assert pm.packed() is not packed


def test_seeded_init_follows_flax_defaults():
    a = get_model('transformer', generator=torch.Generator().manual_seed(7), **SIZE)
    b = get_model('transformer', generator=torch.Generator().manual_seed(7), **SIZE)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    sd = a.state_dict()
    assert float(sd['blocks.0.mlp1.bias'].abs().max()) == 0
    assert torch.equal(sd['final_ln.weight'], torch.ones(128))
    assert abs(float(sd['blocks.0.mlp1.weight'].std()) * 128 ** 0.5 - 1) < 0.05
    assert abs(float(sd['temporal_embedding'].std()) / 0.02 - 1) < 0.1


@pytest.mark.parametrize('kwargs,match', [
    # ported: the case holds the option working (the flax tree, its seeded
    # init at flax's defaults, its weights there and back bitwise)
    ({'attn_impl': 'flax'}, 'MultiHeadDotProductAttention_0'),
], ids=['kwargs0-not ported'])     # the case keeps the id it is known by
def test_unported_transformer_options_raise(kwargs, match):
    jm = jax_get_model('transformer', **SIZE, **kwargs)
    pm = get_model('transformer', **SIZE, **kwargs, generator=torch.Generator().manual_seed(7))
    params = _jax_params(jm, 4)
    assert match in params['EncoderBlock_1']
    sd = transformer_flax_state_dict_from_jax(params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert tuple(sd['blocks.0.attn.query.kernel'].shape) == (128, 4, 32)
    assert tuple(sd['blocks.0.attn.out.kernel'].shape) == (4, 32, 128)
    # lecun-normal over the contracted axes, zero biases
    init = pm.state_dict()
    assert float(init['blocks.0.attn.key.bias'].abs().max()) == 0
    assert abs(float(init['blocks.0.attn.out.kernel'].std()) * 128 ** 0.5 - 1) < 0.05
    pm.load_state_dict(sd)
    back = transformer_flax_params_to_jax(pm.state_dict())
    flat, flat_back = (dict(jax.tree_util.tree_flatten_with_path(t)[0])
                       for t in (params, back))
    assert set(flat) == set(flat_back)
    for path in flat:
        np.testing.assert_array_equal(flat_back[path], flat[path], err_msg=str(path))
    # each converter refuses the other tree, and the fused forward the flax tree
    with pytest.raises(ValueError, match="'flax'"):
        transformer_state_dict_from_jax(params)
    with pytest.raises(ValueError, match="'flax'"):
        transformer_params_to_jax(pm.state_dict())
    with pytest.raises(ValueError, match='not an'):
        transformer_flax_params_to_jax(_models('last_frame')[1].state_dict())
    with pytest.raises(ValueError, match="takes the 'vpu' tree"):
        pm.packed()


# -- attn_impl='flax': d_model 64, 4 layers, 4 heads -------------------------------

FLAX = dict(SIZE, d_model=64, num_layers=4, num_heads=4, attn_impl='flax')


def _flax_models(fmt, dropout=0.0):
    jm = jax_get_model('transformer', output_data_format=fmt, dropout=bool(dropout),
                       dropout_prob=dropout, **FLAX)
    pm = get_model('transformer', output_data_format=fmt, dropout=bool(dropout),
                   dropout_prob=dropout, **FLAX)
    return jm, pm


def _flax_masks(jm, variables, x, key):
    """The keep masks of ``jm``'s dropout sites in call order, as the JAX
    model draws them: each flax attention's weights mask (``[1, 1, T, T]``,
    drawn as ``dot_product_attention_weights`` draws it, from the key its
    ``MultiHeadDotProductAttention`` passes) and each ``Dropout``'s (its
    first ``make_rng``, then ``bernoulli``)."""
    import flax.linen.attention as fattn
    from flax import linen as flax_nn
    masks = []
    plain = fattn.dot_product_attention_weights

    def weights(query, key_, bias=None, mask=None, broadcast_dropout=True, dropout_rng=None,
                dropout_rate=0.0, deterministic=False, dtype=None, precision=None,
                module=None, force_fp32_for_softmax=False, **kw):
        w = plain(query, key_, bias, mask, broadcast_dropout, None, 0.0, True, dtype,
                  precision, module, force_fp32_for_softmax, **kw)
        if deterministic or dropout_rate == 0.0:
            return w
        keep_prob = 1.0 - dropout_rate
        keep = jax.random.bernoulli(dropout_rng, keep_prob,
                                    (1,) * (key_.ndim - 2) + w.shape[-2:])
        masks.append(keep)
        return w * (keep.astype(w.dtype) / jnp.asarray(keep_prob, dtype=w.dtype))

    def record(next_fun, args, kwargs, context):
        module = context.module
        if not isinstance(module, flax_nn.Dropout) or context.method_name != '__call__':
            return next_fun(*args, **kwargs)
        inputs = args[0]
        deterministic = flax_nn.merge_param('deterministic', module.deterministic,
                                            kwargs.get('deterministic'))
        if module.rate == 0.0 or deterministic:
            return inputs
        keep_prob = 1.0 - module.rate
        keep = jax.random.bernoulli(module.make_rng(module.rng_collection), keep_prob,
                                    inputs.shape)
        masks.append(keep)
        return jnp.where(keep, inputs / keep_prob, jnp.zeros_like(inputs))

    fattn.dot_product_attention_weights = weights
    try:
        with flax_nn.intercept_methods(record):
            jm.apply(variables, jnp.asarray(x), train=True, rngs={'dropout': key})
    finally:
        fattn.dot_product_attention_weights = plain
    return [np.asarray(m) for m in masks]


def _mask_source(masks):
    it = iter(masks)

    def source(shape, p, device, shared=False):
        m = next(it)
        assert m.shape == tuple(shape) and shared == (m.shape[0] == 1), (m.shape, shape)
        return torch.from_numpy(np.array(m)).to(device)
    return source


@pytest.mark.parametrize('fmt', ['last_frame', 'all_frames'])
def test_flax_forward_matches_jax_apply(fmt):
    """The ``flax`` tree's one forward (eval and train mode without dropout)
    against ``model.apply`` of the JAX ``attn_impl='flax'`` model, 2e-2 x
    max a head."""
    jm, pm = _flax_models(fmt)
    params = _jax_params(jm, 5)
    pm.load_state_dict(transformer_flax_state_dict_from_jax(params))
    x = _x(5)
    want = jax.jit(lambda p, x: jm.apply({'params': p}, x, train=False))(params, jnp.asarray(x))
    with torch.no_grad():
        _assert_heads_close(pm.eval()(torch.from_numpy(x)), want, fmt)
        _assert_heads_close(pm.train()(torch.from_numpy(x)), want, fmt)


def test_flax_three_rmsprop_steps_with_dropout_track_the_jax_step():
    """Three RMSprop steps of the flax transformer with dropout 0.2 from the
    same weights on the same batches, each step fed the JAX step's own masks
    (attention weights and MLP, in call order): the first step's train
    forward within 2e-2 x max a head and the gradient of every parameter
    of a sum of squares of its outputs within 5e-2 x max (the limit of the
    ``vpu`` transformer's gradients, ``tests/test_torch_batchnorm_dropout.py``),
    and each step's loss within 2e-2. (The parameters after RMSprop steps
    are no sharper a probe: its first updates are near +-10 lr wherever a
    gradient is near 0, whatever its size.)"""
    from inferbiomechanics_tpu.data.dataset import _offsets, label_layout
    from inferbiomechanics_tpu.loss import LossConfig as JaxLossConfig
    from inferbiomechanics_tpu.train import create_train_state as jax_create_train_state
    from inferbiomechanics_tpu.train import make_optimizer as jax_make_optimizer
    from inferbiomechanics_tpu.train.step import make_train_step as jax_make_train_step
    from inferbiomechanics_tpu_torch.loss.evaluator import LossConfig
    from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
    from inferbiomechanics_tpu_torch.train.state import create_train_state
    from inferbiomechanics_tpu_torch.train.step import make_train_step

    torch.set_num_threads(1)
    jm, pm = _flax_models('last_frame', dropout=0.2)
    lab = _offsets(label_layout(23, 2))
    width = sum(w for _, w in label_layout(23, 2))
    rng = np.random.default_rng(11)
    xs = [rng.normal(size=(8, 10, 177)).astype(np.float32) for _ in range(3)]
    ys = [rng.normal(size=(8, 1, width)).astype(np.float32) for _ in range(3)]
    jstate = jax_create_train_state(jm, jax.random.PRNGKey(0), jnp.asarray(xs[0]),
                                    jax_make_optimizer('rmsprop', 1e-3))
    params = _jax_params(jm, 6)
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    pm.load_state_dict(transformer_flax_state_dict_from_jax(params))
    state = create_train_state(pm, make_optimizer(pm.named_parameters(), 'rmsprop', 1e-3))
    jstep = jax_make_train_step(jm, lab, JaxLossConfig(), donate=False)
    step = make_train_step(pm, lab, LossConfig())
    for k in range(3):
        key = jax.random.PRNGKey(100 + k)
        masks = _flax_masks(jm, {'params': jstate.params}, xs[k], key)
        assert [m.shape for m in masks[:2]] == [(1, 1, 10, 10), (8, 10, 256)]
        if k == 0:
            def jloss(p):
                out = jm.apply({'params': p}, jnp.asarray(xs[0]), train=True,
                               rngs={'dropout': key})
                return sum(jnp.sum(v.astype(jnp.float32) ** 2) for v in out.values()), out

            (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
                jstate.params)
            pm.train()
            pm.dropout_masks = _mask_source(masks)
            got = pm(torch.from_numpy(xs[0]))
            _assert_heads_close({k: v.detach() for k, v in got.items()}, want, 'last_frame')
            sum(v.float().square().sum() for v in got.values()).backward()
            grads = dict(jax.tree_util.tree_flatten_with_path(transformer_flax_params_to_jax(
                {n: p.grad for n, p in pm.named_parameters()}))[0])
            jflat = dict(jax.tree_util.tree_flatten_with_path(jax.device_get(jgrads))[0])
            for path, g in jflat.items():
                scale = np.abs(g).max()
                if [getattr(p, 'key', None) for p in path[-2:]] == ['key', 'bias']:
                    # exactly 0 (the softmax ignores a shift shared by all
                    # keys): both sides hold rounding noise, held at the
                    # scale of the block's query kernel's gradient
                    scale = np.abs(jflat[path[:-2] + (jax.tree_util.DictKey('query'),
                                                      jax.tree_util.DictKey('kernel'))]).max()
                np.testing.assert_allclose(grads[path], g, rtol=0, atol=5e-2 * scale,
                                           err_msg=str(path))
            pm.zero_grad(set_to_none=True)
        jstate, jmetrics = jstep(jstate, jnp.asarray(xs[k]), jnp.asarray(ys[k]), key)
        pm.dropout_masks = _mask_source(masks)
        metrics = step(state, torch.from_numpy(xs[k]), torch.from_numpy(ys[k]))
        assert float(metrics['loss']) == pytest.approx(float(jmetrics['loss']), rel=REL), k


def test_wrong_frame_count_is_refused():
    pm = TransformerRegressor(23, 2, 50, 5, 10, d_model=128, num_layers=1, num_heads=4)
    with pytest.raises(ValueError, match=r'expected \(B, 10, C\)'):
        pm(torch.zeros(2, 9, 177))
