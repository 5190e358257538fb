"""The port's feedforward model (inferbiomechanics_tpu_torch/models/) and
weight conversion (weights.py) against the JAX package's
(inferbiomechanics_tpu/models/feedforward.py, models/common.py).

Weights come from a JAX ``FeedForwardBaseline.init`` and cross with
``feedforward_state_dict_from_jax``; inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.models import common as jax_common
from inferbiomechanics_tpu.models import get_model as jax_get_model
from inferbiomechanics_tpu_torch.models import common, get_model
from inferbiomechanics_tpu_torch.ops import fused_mlp as fm
from inferbiomechanics_tpu_torch.data import keys as K
from inferbiomechanics_tpu_torch.weights import (
    feedforward_params_to_jax, feedforward_state_dict_from_jax,
)

SMALL = dict(num_dofs=23, num_contact_bodies=2, history_len=20, stride=5,
             root_history_len=10)          # 4 frames x 177 channels = 708 inputs
# bf16 compute on both sides; the JAX Dense path also rounds its matmul
# output and adds the bias in bf16, so it differs from the fused-kernel math
# by more than one ulp (5.9e-3 at full width): 2e-2. Against the JAX
# use_pallas path (the same math) one bf16 ulp below 2: 1e-2.
ATOL_DENSE = 2e-2
ATOL_PALLAS = 1e-2


def _jax_model(use_pallas, **kw):
    return jax_get_model('feedforward', use_pallas=use_pallas, **{**SMALL, **kw})


def _inputs(b, frames=4, seed=0):
    return np.random.default_rng(seed).normal(size=(b, frames, 177)).astype(np.float32)


def _jax_params(model, x, seed=0):
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    return jax.device_get(variables['params'])


def _port_model(jax_params, **kw):
    model = get_model('feedforward', **{**SMALL, **kw})
    model.load_state_dict(feedforward_state_dict_from_jax(jax_params))
    return model.eval()


def _assert_heads_close(got, want, atol):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].detach().numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize('activation', ['sigmoid', 'relu', 'gelu'])
def test_eval_matches_jax_dense_path(activation):
    x = _inputs(16, seed=1)
    jm = _jax_model(False, activation=activation, hidden_dims=(64, 48))
    params = _jax_params(jm, x)
    want = jm.apply({'params': params}, jnp.asarray(x), train=False)
    got = _port_model(params, activation=activation, hidden_dims=(64, 48))(
        torch.from_numpy(x))
    _assert_heads_close(got, want, ATOL_DENSE)


@pytest.mark.parametrize('activation', ['sigmoid', 'relu', 'tanh', 'gelu', 'elu'])
def test_eval_matches_jax_pallas_path(activation):
    x = _inputs(16, seed=2)
    jm = _jax_model(True, activation=activation, hidden_dims=(64, 48))
    params = _jax_params(jm, x, seed=1)
    want = jm.apply({'params': params}, jnp.asarray(x), train=False)
    got = _port_model(params, activation=activation, hidden_dims=(64, 48))(
        torch.from_numpy(x))
    _assert_heads_close(got, want, ATOL_PALLAS)


def test_all_frames_head_matches_jax():
    x = _inputs(8, seed=3)
    jm = _jax_model(True, hidden_dims=(32,), output_data_format='all_frames')
    params = _jax_params(jm, x)
    want = jm.apply({'params': params}, jnp.asarray(x), train=False)
    got = _port_model(params, hidden_dims=(32,), output_data_format='all_frames')(
        torch.from_numpy(x))
    assert got[K.OutputDataKeys.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME].shape == (8, 4, 12)
    _assert_heads_close(got, want, ATOL_PALLAS)


def test_full_width_forward():
    """The default model at full width: 1770 -> 512 -> 512 -> 30, B=8."""
    full = dict(SMALL, history_len=50)
    x = _inputs(8, frames=10, seed=4)
    jm = jax_get_model('feedforward', use_pallas=True, **full)
    params = _jax_params(jm, x)
    assert params['W0'].shape == (1770, 512) and params['W2'].shape == (512, 30)
    want = jm.apply({'params': params}, jnp.asarray(x), train=False)
    model = get_model('feedforward', **full)
    model.load_state_dict(feedforward_state_dict_from_jax(params))
    got = model.eval()(torch.from_numpy(x))
    assert model.packed().pdims == (1792, 512, 512, 64)
    _assert_heads_close(got, want, ATOL_PALLAS)


def test_training_forward_is_the_plain_version():
    model = get_model('feedforward', **SMALL, hidden_dims=(32,),
                      generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_inputs(4, seed=5))
    out = model.train()(x)
    loss = sum(v.square().sum() for v in out.values())
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())
    flat = fm.mlp_reference(x.reshape(4, -1), model.layer_params(), 'sigmoid')
    np.testing.assert_array_equal(
        out[K.OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME].detach().numpy()[:, 0],
        flat[:, :6].detach().numpy())


@pytest.mark.parametrize('use_pallas', [False, True])
def test_parameter_tree_round_trip(use_pallas):
    x = _inputs(2)
    params = _jax_params(_jax_model(use_pallas, hidden_dims=(64, 48)), x)
    sd = feedforward_state_dict_from_jax(params)
    assert sd['layers.0.weight'].shape == (64, 708)      # nn.Linear [out, in]
    back = feedforward_params_to_jax(sd, use_pallas=use_pallas)
    flat_a, tree_a = jax.tree_util.tree_flatten(params)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_both_trees_give_one_state_dict():
    """A Dense_{i} tree and the W{i}/b{i} tree of the same weights load into
    the same port model."""
    params = _jax_params(_jax_model(False, hidden_dims=(16,)), _inputs(2))
    as_w = feedforward_params_to_jax(feedforward_state_dict_from_jax(params),
                                     use_pallas=True)
    assert sorted(as_w) == ['W0', 'W1', 'b0', 'b1']
    sd_dense = feedforward_state_dict_from_jax(params)
    sd_w = feedforward_state_dict_from_jax(as_w)
    assert sd_dense.keys() == sd_w.keys()
    for k in sd_dense:
        assert torch.equal(sd_dense[k], sd_w[k])


def test_unknown_parameter_tree_raises():
    with pytest.raises(ValueError, match='feedforward tree'):
        feedforward_state_dict_from_jax({'Conv_0': {}})


@pytest.mark.parametrize('shape,frames', [((3, 30), 1), ((3, 120), 4), ((3, 4, 30), 4)])
def test_slice_output_heads_matches_jax(shape, frames):
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    want = jax_common.slice_output_heads(jnp.asarray(x), 2, frames)
    got = common.slice_output_heads(torch.from_numpy(x), 2, frames)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert common.output_head_size(2, frames) == jax_common.output_head_size(2, frames)


def test_pack_inputs_dict_matches_packed():
    from inferbiomechanics_tpu_torch.data.dataset import input_layout
    x = _inputs(2, seed=7)
    streams, off = {}, 0
    for key, width in input_layout(23, 10):
        streams[key] = torch.from_numpy(x[..., off:off + width])
        off += width
    assert off == 177
    packed = common.pack_inputs(streams)
    want = jax_common.pack_inputs({k: jnp.asarray(v.numpy()) for k, v in streams.items()})
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    np.testing.assert_array_equal(packed.numpy(), x)


@pytest.mark.parametrize('init_style', ['torch', 'lecun'])
def test_init_is_seeded_and_scaled(init_style):
    make = lambda seed: get_model(  # noqa: E731
        'feedforward', **SMALL, init_style=init_style,
        generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    for (ka, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                                c.state_dict().values()):
        assert torch.equal(va, vb), ka
        assert va.any() == (not torch.equal(va, vc)), ka    # lecun biases are 0
    w0, b0 = a.layers[0].weight.detach(), a.layers[0].bias.detach()
    k = 1 / np.sqrt(708)
    if init_style == 'torch':     # U(-k, k) for kernel and bias, as nn.Linear
        assert float(w0.abs().max()) <= k and float(b0.abs().max()) <= k
        assert abs(float(w0.std()) - k / np.sqrt(3)) < 0.05 * k
    else:                         # truncated normal, std sqrt(1/fan_in); zero bias
        assert abs(float(w0.std()) - k) < 0.05 * k and not b0.any()


@pytest.mark.parametrize('model_type', ['groundlink', 'transformer', 'diffusion',
                                        'analytical'])
def test_unported_model_types_name_their_roadmap_slice(model_type):
    # every model type the JAX get_model builds is ported, with every
    # option: the transformer's three parameter trees ('vpu', 'flax' and
    # 'pallas'), with dropout on the 'vpu' and 'flax' trees (the fused layer
    # of the 'pallas' tree takes none, as the JAX model asserts); GroundLink
    # with both conv lowerings, which share one parameter tree; the denoiser
    # on the 'vpu' tree and on the flax-attention tree
    if model_type == 'groundlink':
        x = torch.from_numpy(_inputs(2))
        out = get_model(model_type, **SMALL).train()(x)
        assert all(torch.isfinite(v).all() for v in out.values())
        banded = get_model(model_type, **SMALL, conv_impl='banded')
        out = banded.train()(x)
        assert banded.conv_impl == 'banded' and all(torch.isfinite(v).all()
                                                    for v in out.values())
        assert set(banded.state_dict()) == set(get_model(model_type, **SMALL).state_dict())
        return
    if model_type == 'diffusion':
        # the denoiser predicts the noise of the 30 target channels on
        # either tree; the flax tree keeps flax's attention parameters
        for attn in ('vpu', 'flax'):
            model = get_model(model_type, **SMALL, d_model=128, num_heads=4,
                              attn_impl=attn).eval()
            with torch.no_grad():
                eps = model(torch.zeros(2, 4, 30), torch.tensor([0, 999]),
                            torch.from_numpy(_inputs(2)))
            assert eps.shape == (2, 4, 30) and torch.isfinite(eps).all()
            assert ('blocks.0.attn.query.kernel' in model.state_dict()) == (attn == 'flax')
        return
    if model_type == 'transformer':
        drop = {'dropout': True, 'dropout_prob': 0.1}
        model = get_model(model_type, **SMALL, **drop, d_model=128, num_heads=4).train()
        x = torch.from_numpy(_inputs(2))
        a, b = model(x), model(x)
        assert all(torch.isfinite(v).all() for v in a.values())
        assert any(not torch.equal(a[k], b[k]) for k in a)     # new masks each forward
        with pytest.raises(ValueError, match='does not support dropout'):
            get_model(model_type, **SMALL, **drop, attn_impl='pallas')
        flax = get_model(model_type, **SMALL, **drop, d_model=128, num_heads=4,
                         attn_impl='flax').train()
        a, b = flax(x), flax(x)
        assert all(torch.isfinite(v).all() for v in a.values())
        assert any(not torch.equal(a[k], b[k]) for k in a)
        return
    # the analytical baseline has no learnable parameters: get_model does not
    # build it, as the JAX get_model does not (models/analytical.py does)
    with pytest.raises(ValueError, match="unknown model type 'analytical'"):
        get_model(model_type, **SMALL)
