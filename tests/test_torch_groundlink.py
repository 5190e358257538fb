"""The port's GroundLink model (inferbiomechanics_tpu_torch/models/groundlink.py)
and its weight conversion (weights.py) against the JAX package's
(inferbiomechanics_tpu/models/groundlink.py, torch_compat.py).

Weights come from a flax ``Groundlink.init`` (biases moved off zero) and
cross with ``groundlink_state_dict_from_jax``; inputs come from numpy with a
seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.models import get_model as jax_get_model
from inferbiomechanics_tpu.models.groundlink import Groundlink as JaxGroundlink
from inferbiomechanics_tpu.torch_compat import (
    convert_groundlink_state_dict, export_groundlink_state_dict,
)
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data import keys as K
from inferbiomechanics_tpu_torch.models import get_model
from inferbiomechanics_tpu_torch.models.groundlink import Groundlink
from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg
from inferbiomechanics_tpu_torch.weights import (
    groundlink_params_to_jax, groundlink_state_dict_from_jax,
)

SKELETON = dict(num_dofs=23, num_contact_bodies=2, root_history_len=10)
SMALL = dict(SKELETON, cnn_features=(16, 16, 24, 24))
FORMATS = ['all_frames', 'last_frame']


def _inputs(b=8, frames=4, seed=0):
    return np.random.default_rng(seed).normal(size=(b, frames, 177)).astype(np.float32)


def _jax_params(model, x, seed=0):
    params = jax.device_get(model.init({'params': jax.random.PRNGKey(seed)},
                                       jnp.asarray(x), train=False)['params'])
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.2 * rng.normal(size=p.shape)).astype(np.float32)
        if p.ndim == 1 else np.asarray(p), params)


def _port_model(params, **kw):
    model = Groundlink(**{**SMALL, **kw})
    model.load_state_dict(groundlink_state_dict_from_jax(params))
    return model.eval()


@pytest.mark.parametrize('fmt', FORMATS)
def test_eval_matches_bf16_flax_model(fmt):
    """bf16 compute on both sides, at the JAX suite's tolerance for its fused
    forward against the bf16 model: 5e-2 x max|ref| per head."""
    x = _inputs(seed=1)
    jm = JaxGroundlink(**SMALL, output_data_format=fmt)
    params = _jax_params(jm, x)
    want = jm.apply({'params': params}, jnp.asarray(x), train=False)
    got = _port_model(params, output_data_format=fmt)(torch.from_numpy(x))
    assert set(got) == set(want)
    frames = 4 if fmt == 'all_frames' else 1
    assert got[K.OutputDataKeys.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME].shape == (8, frames, 12)
    for k in want:
        a, b = got[k].detach().numpy(), np.asarray(want[k], np.float32)
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-9) < 5e-2, k


@pytest.mark.parametrize('fmt', FORMATS)
def test_train_forward_is_the_plain_version_and_differentiable(fmt):
    x = torch.from_numpy(_inputs(4, seed=2))
    model = Groundlink(**SMALL, output_data_format=fmt, fc_dropout=0.0,
                       generator=torch.Generator().manual_seed(0))
    out = model.train()(x)
    sum(v.square().sum() for v in out.values()).backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in model.parameters())
    flat = fg.groundlink_reference(x, model.layer_params(), fmt, 3)
    np.testing.assert_array_equal(
        out[K.OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME].detach().numpy(),
        flat[..., :6].detach().numpy())


def test_full_width_forward():
    """The model as ``get_model`` builds it: 177 -> 128 -> 128 -> 256 -> 256,
    k = 7, fc_depth 3, T = 10, against the bf16 flax model."""
    full = dict(SKELETON, history_len=50, stride=5, output_data_format='last_frame')
    x = _inputs(4, frames=10, seed=3)
    jm = jax_get_model('groundlink', **full)
    params = _jax_params(jm, x)
    assert params['Conv_0']['kernel'].shape == (7, 177, 128)
    assert params['Dense_2']['kernel'].shape == (256, 30) and 'bias' not in params['Dense_2']
    want = jm.apply({'params': params}, jnp.asarray(x), train=False)
    model = get_model('groundlink', **full)
    model.load_state_dict(groundlink_state_dict_from_jax(params))
    got = model.eval()(torch.from_numpy(x))
    assert model.packed().pwidths == (192, 128, 128, 256, 256, 256, 256, 32)
    assert model.packed().weights.numel() == 1114112
    for k in want:
        a, b = got[k].detach().numpy(), np.asarray(want[k], np.float32)
        assert a.shape == b.shape == (4, 1, b.shape[-1])
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-9) < 5e-2, k


def test_parameter_tree_round_trip_is_bit_exact():
    params = _jax_params(JaxGroundlink(**SMALL), _inputs(2))
    sd = groundlink_state_dict_from_jax(params)
    assert sd['convs.0.weight'].shape == (16, 177, 7)      # nn.Conv1d [out, in, k]
    assert sd['fcs.1.weight'].shape == (24, 24) and sd['head.weight'].shape == (30, 24)
    assert 'head.bias' not in sd
    assert set(sd) == set(Groundlink(**SMALL).state_dict())
    back = groundlink_params_to_jax(sd)
    flat_a, tree_a = jax.tree_util.tree_flatten(params)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_conv_taps_are_not_flipped():
    """Both sides cross-correlate: the port's Conv1d weights, run through
    ``F.conv1d`` on a replicate-padded input, give the plain version's first
    layer."""
    params = _jax_params(JaxGroundlink(**SMALL), _inputs(2), seed=3)
    model = _port_model(params)
    x = torch.from_numpy(_inputs(3, seed=4))
    conv = model.convs[0]
    xp = torch.nn.functional.pad(x.transpose(1, 2), (3, 3), mode='replicate')
    want = torch.nn.functional.conv1d(xp, conv.weight, conv.bias).transpose(1, 2)
    tree = model.layer_params()
    frames = torch.arange(4)
    got = sum(x[:, torch.clamp(frames + j - 3, 0, 3)] @ tree['Conv_0']['kernel'][j]
              for j in range(7)) + tree['Conv_0']['bias']
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('fmt', FORMATS)
def test_reference_layout_state_dict_loads_through_the_jax_converter(fmt):
    """A reference-layout ``.pt`` state dict (``cnn.{i}``/``fc.{i}``) reaches
    the port through ``convert_groundlink_state_dict`` and gives the outputs
    of the tree it was exported from."""
    x = _inputs(seed=5)
    jm = JaxGroundlink(**SMALL, output_data_format=fmt, compute_dtype=jnp.float32)
    params = _jax_params(jm, x, seed=2)
    reference_sd = export_groundlink_state_dict(params)
    assert any(k.startswith('cnn.') for k in reference_sd)
    converted = convert_groundlink_state_dict(reference_sd)
    model = _port_model(converted, output_data_format=fmt)
    direct = _port_model(params, output_data_format=fmt)
    want = jm.apply({'params': params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got, same = model(torch.from_numpy(x)), direct(torch.from_numpy(x))
        exact = fg.groundlink_reference(torch.from_numpy(x), model.layer_params(),
                                        fmt, 3, torch.float32)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), same[k].numpy())
    np.testing.assert_allclose(
        exact[..., :6].numpy(),
        np.asarray(want[K.OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME]),
        rtol=1e-4, atol=1e-5)


def test_malformed_trees_raise():
    params = _jax_params(JaxGroundlink(**SMALL), _inputs(2))
    with pytest.raises(ValueError, match='GroundLink tree'):
        groundlink_state_dict_from_jax({'W0': 1})
    with pytest.raises(ValueError, match='has a bias'):
        groundlink_state_dict_from_jax(
            dict(params, Dense_2=dict(params['Dense_2'], bias=np.zeros(30, np.float32))))
    with pytest.raises(ValueError, match='not a GroundLink state dict'):
        groundlink_params_to_jax({'layers.0.weight': torch.zeros(1)})


def test_banded_conv_is_not_ported():
    sized = dict(SKELETON, history_len=20, stride=5)
    assert isinstance(get_model('groundlink', **sized, conv_impl='xla'), Groundlink)
    with pytest.raises(ValueError, match="'banded' is not ported"):
        get_model('groundlink', **sized, conv_impl='banded')
    assert Config().conv_impl == 'xla'


@pytest.mark.parametrize('dropout', [{'cnn_dropout': 0.1, 'fc_dropout': 0.0},
                                     {'fc_dropout': 0.2}, {}])
def test_train_mode_dropout_raises(dropout):
    """The JAX defaults (fc_dropout 0.2) train with dropout, which comes with
    training; eval is unaffected."""
    model = Groundlink(**SMALL, **dropout)
    x = torch.from_numpy(_inputs(2))
    assert all(torch.isfinite(v).all() for v in model.eval()(x).values())
    with pytest.raises(NotImplementedError, match='ROADMAP.md Queue 1 item 3'):
        model.train()(x)


def test_packed_is_made_once_and_dropped_on_train_and_load():
    model = Groundlink(**SMALL, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(_inputs(2))
    before = model(x)
    packed = model.packed()
    assert model.packed() is packed                    # once per eval()
    model.train()
    assert model._packed is None
    model.eval()
    assert model.packed() is not packed
    packed = model.packed()
    other = Groundlink(**SMALL, generator=torch.Generator().manual_seed(1))
    model.load_state_dict(other.state_dict())
    assert model._packed is None                       # dropped by the load
    after = model(x)
    assert model.packed() is not packed
    assert any(not torch.equal(after[k], before[k]) for k in after)
    for k, v in other.eval()(x).items():
        assert torch.equal(after[k], v)


def test_init_is_seeded_and_scaled():
    make = lambda seed: get_model(  # noqa: E731
        'groundlink', **SKELETON, history_len=20, stride=5,
        generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    for (ka, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                                c.state_dict().values()):
        assert torch.equal(va, vb), ka
        assert va.any() == (not torch.equal(va, vc)), ka      # biases are 0
    # xavier, gain sqrt(2): variance 2 / fan_avg, the flax module's own
    w = a.convs[1].weight.detach()                     # [128, 128, 7]
    std = np.sqrt(2.0 / (7 * (128 + 128) / 2))
    assert abs(float(w.std()) - std) < 0.03 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    w = a.fcs[0].weight.detach()
    assert abs(float(w.std()) - np.sqrt(2.0 / 256)) < 0.03 * np.sqrt(2.0 / 256)
    # the head keeps torch's Linear init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    h = a.head.weight.detach()
    assert float(h.abs().max()) <= 1 / 16 and abs(float(h.std()) - 1 / 16 / np.sqrt(3)) < 3e-3
    # and the flax init has the same spread
    jw = np.asarray(_jax_init_params()['Conv_1']['kernel'])
    assert abs(float(jw.std()) - std) < 0.03 * std


def _jax_init_params():
    jm = jax_get_model('groundlink', **SKELETON, history_len=20, stride=5)
    return jax.device_get(jm.init({'params': jax.random.PRNGKey(0)},
                                  jnp.asarray(_inputs(2)), train=False)['params'])
