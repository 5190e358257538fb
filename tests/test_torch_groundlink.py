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


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """One thread: every run of this module sums in the same order."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(b=8, frames=4, seed=0):
    return np.random.default_rng(seed).normal(size=(b, frames, 177)).astype(np.float32)


def _jax_params(model, x, seed=0):
    params = jax.device_get(jax.jit(
        lambda k, xx: model.init({'params': k}, xx, train=False)['params'])(
            jax.random.PRNGKey(seed), jnp.asarray(x)))
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
def test_train_forward_is_the_plain_version_and_differentiable(fmt, monkeypatch):
    """The train forward is plain PyTorch under autograd: it never reaches
    K4's wrapper, and it is the flax module's bf16 chain (F.pad + F.conv1d),
    not K4's plain version, so the two agree at the bf16 tolerance, not
    bitwise."""
    x = torch.from_numpy(_inputs(4, seed=2))
    model = Groundlink(**SMALL, output_data_format=fmt, fc_dropout=0.0,
                       generator=torch.Generator().manual_seed(0))

    def no_kernel(*_args, **_kw):
        raise AssertionError('the train forward reached the K4 wrapper')

    monkeypatch.setattr('inferbiomechanics_tpu_torch.models.groundlink.'
                        'fused_groundlink_forward', no_kernel)
    out = model.train()(x)
    sum(v.square().sum() for v in out.values()).backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in model.parameters())
    # the plain bf16 chain (F.pad + F.conv1d, as the flax module computes)
    # against K4's plain version, which sums the same bf16 operands in f32
    flat = fg.groundlink_reference(x, model.layer_params(), fmt, 3).detach().numpy()
    got = torch.cat([out[k] for k in (K.OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME,
                                      K.OutputDataKeys.GROUND_CONTACT_FORCES_IN_ROOT_FRAME,
                                      K.OutputDataKeys.GROUND_CONTACT_TORQUES_IN_ROOT_FRAME,
                                      K.OutputDataKeys.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME)],
                    dim=-1).detach().numpy()
    assert got.shape == flat.shape
    assert np.abs(got - flat).max() <= 2e-2 * np.abs(flat).max()


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
    """Ported (the test keeps its name): ``conv_impl='banded'`` builds the
    same parameter tree; its train forward (dropout off) agrees with the JAX
    banded model's and with the port's own direct conv at 2e-2 x max a
    head, and its eval forward is K4's, the direct conv model's bitwise."""
    sized = dict(SKELETON, history_len=20, stride=5)
    assert isinstance(get_model('groundlink', **sized, conv_impl='xla'), Groundlink)
    assert get_model('groundlink', **sized, conv_impl='banded').conv_impl == 'banded'
    assert Config().conv_impl == 'xla'
    with pytest.raises(ValueError, match='conv_impl must be one of'):
        Groundlink(**SMALL, conv_impl='fft')
    x = _inputs(6, frames=5, seed=9)
    jm = JaxGroundlink(**SMALL, output_data_format='all_frames', fc_dropout=0.0,
                       conv_impl='banded')
    params = _jax_params(jm, x, seed=3)
    want = jax.jit(lambda p, xx: jm.apply({'params': p}, xx, train=True))(params, jnp.asarray(x))
    models = {impl: Groundlink(**SMALL, fc_dropout=0.0, conv_impl=impl) for impl in
              ('banded', 'xla')}
    outs = {}
    for impl, model in models.items():
        model.load_state_dict(groundlink_state_dict_from_jax(params))
        with torch.no_grad():
            outs[impl] = (model.train()(torch.from_numpy(x)), model.eval()(torch.from_numpy(x)))
    for k in want:
        b = np.asarray(want[k], np.float32)
        for impl in ('banded', 'xla'):
            a = outs[impl][0][k].numpy()
            assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), (impl, k)
        assert torch.equal(outs['banded'][1][k], outs['xla'][1][k]), k
    assert any(not torch.equal(outs['banded'][0][k], outs['xla'][0][k]) for k in want)


def test_band_selector_is_the_jax_one():
    from inferbiomechanics_tpu.models.groundlink import _band_selector
    from inferbiomechanics_tpu_torch.models.groundlink import band_selector
    for t, k in ((10, 7), (4, 7), (5, 3), (1, 7)):
        np.testing.assert_array_equal(band_selector(t, k), _band_selector(t, k))


@pytest.mark.parametrize('fmt', FORMATS)
def test_banded_train_step_with_the_jax_dropout_masks(fmt):
    """The banded model's train step against the JAX banded model's, JAX's
    own dropout masks fed to the port (cnn 0.1, fc 0.3): the outputs and
    the gradient of every parameter at 5e-2 x max, as for the direct conv
    above; the loss within 2e-2 of the JAX model's in float32, or within
    twice the JAX bf16 model's own distance from it where that is larger
    (two bf16 evaluations that round at different places)."""
    from inferbiomechanics_tpu.data.dataset import _offsets, label_layout
    from inferbiomechanics_tpu.data.dataset import unpack as jax_unpack
    from inferbiomechanics_tpu.loss.evaluator import LossConfig as JaxLossConfig
    from inferbiomechanics_tpu.loss.evaluator import loss_and_metrics as jax_loss_and_metrics
    from inferbiomechanics_tpu_torch.data.dataset import unpack
    from inferbiomechanics_tpu_torch.loss.evaluator import LossConfig, loss_and_metrics
    dropout = {'cnn_dropout': 0.1, 'fc_dropout': 0.3}
    x = _inputs(6, frames=5, seed=12)
    frames = 5 if fmt == 'all_frames' else 1
    lab = _offsets(label_layout(23, 2))
    width = sum(w for _, w in label_layout(23, 2))
    y = np.random.default_rng(13).normal(size=(6, frames, width)).astype(np.float32)
    jm = JaxGroundlink(**SMALL, output_data_format=fmt, conv_impl='banded', **dropout)
    params = _jax_params(jm, x, seed=5)
    key = jax.random.PRNGKey(17)
    masks = _jax_mask_fn(jm)(params, x, key)

    def jloss(p):
        out = jm.apply({'params': p}, jnp.asarray(x), train=True, rngs={'dropout': key})
        return jax_loss_and_metrics(out, jax_unpack(jnp.asarray(y), lab), JaxLossConfig())[0], out

    (jl, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = Groundlink(**SMALL, output_data_format=fmt, conv_impl='banded', **dropout)
    model.load_state_dict(groundlink_state_dict_from_jax(params))
    model.train()
    model.dropout_masks = _mask_source(masks)
    got = model(torch.from_numpy(x))
    for k in want:
        a, b = got[k].detach().numpy(), np.asarray(want[k], np.float32)
        assert np.abs(a - b).max() <= 5e-2 * np.abs(b).max(), k
    loss, _ = loss_and_metrics(got, unpack(torch.from_numpy(y), lab), LossConfig())
    jf = JaxGroundlink(**SMALL, output_data_format=fmt, conv_impl='banded',
                       compute_dtype=jnp.float32, **dropout)
    exact = float(jax_loss_and_metrics(
        jf.apply({'params': params}, jnp.asarray(x), train=True, rngs={'dropout': key}),
        jax_unpack(jnp.asarray(y), lab), JaxLossConfig())[0])
    limit = max(2e-2, 2 * abs(float(jl) - exact) / exact)
    assert abs(float(loss.detach()) - exact) / exact <= limit
    loss.backward()
    grads = groundlink_params_to_jax({n: p.grad for n, p in model.named_parameters()})
    flat_t = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        g = np.asarray(g)
        np.testing.assert_allclose(np.asarray(flat_t[path]), g, rtol=0,
                                   atol=5e-2 * np.abs(g).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('dropout', [{'cnn_dropout': 0.1, 'fc_dropout': 0.0},
                                     {'fc_dropout': 0.2}, {}])
def test_train_mode_dropout_raises(dropout):
    """Dropout raises only for a rate outside [0, 1]; the rates themselves,
    the JAX defaults (fc_dropout 0.2) among them, train
    (``test_train_mode_dropout_trains``)."""
    for bad in ({'cnn_dropout': -0.1}, {'fc_dropout': 1.5}):
        with pytest.raises(ValueError, match='dropout rates must lie in'):
            Groundlink(**SMALL, **{**dropout, **bad})


@pytest.mark.parametrize('dropout', [{'cnn_dropout': 0.1, 'fc_dropout': 0.0},
                                     {'fc_dropout': 0.2}, {}])
def test_train_mode_dropout_trains(dropout):
    """A model with these rates trains and draws new masks each forward;
    eval is unaffected."""
    model = Groundlink(**SMALL, **dropout)
    x = torch.from_numpy(_inputs(2))
    assert all(torch.isfinite(v).all() for v in model.eval()(x).values())
    a, b = model.train()(x), model(x)
    assert all(torch.isfinite(v).all() for v in a.values())
    assert any(not torch.equal(a[k], b[k]) for k in a)      # {} is fc_dropout 0.2


def _jax_mask_fn(jm):
    """``masks(params, x, key)``: the keep masks of ``jm``'s dropout sites
    with a rate above 0, in call order. Each ``Dropout``'s captured output is
    0 exactly where it dropped."""
    rates = [jm.cnn_dropout] * len(jm.cnn_features) + [jm.fc_dropout] * jm.fc_depth

    @jax.jit
    def captured(p, x, key):
        _, state = jm.apply({'params': p}, x, train=True, rngs={'dropout': key},
                            capture_intermediates=True, mutable=['intermediates'])
        return [state['intermediates'][f'Dropout_{i}']['__call__'][0]
                for i, rate in enumerate(rates) if rate > 0]

    return lambda p, x, key: [np.asarray(m) != 0
                              for m in captured(p, jnp.asarray(x), key)]


def _mask_source(masks: list):
    """A mask source that hands out the given masks in order."""
    it = iter(masks)

    def source(shape, p, device):
        m = next(it)
        assert m.shape == shape, (m.shape, shape)
        return torch.from_numpy(m).to(device)
    return source


@pytest.mark.parametrize('fmt,dropout', [('all_frames', {'cnn_dropout': 0.1, 'fc_dropout': 0.3}),
                                         ('last_frame', {})])
def test_train_forward_with_the_jax_dropout_masks(fmt, dropout):
    """JAX's own masks fed to the port's train forward: outputs and the
    gradients of every parameter agree at the bf16 tolerance (5e-2 x the
    tensor's largest value); the mask keeps about 1 - p."""
    x = _inputs(6, frames=5, seed=4)
    jm = JaxGroundlink(**SMALL, output_data_format=fmt, **dropout)
    params = _jax_params(jm, x)
    key = jax.random.PRNGKey(7)
    masks = _jax_mask_fn(jm)(params, x, key)
    assert len(masks) == (4 if jm.cnn_dropout else 0) + jm.fc_depth
    kept = np.mean(np.concatenate([m.ravel() for m in masks[-3:]]))
    assert abs(kept - (1 - jm.fc_dropout)) < 0.1

    def jloss(p):
        out = jm.apply({'params': p}, jnp.asarray(x), train=True, rngs={'dropout': key})
        return sum(jnp.sum(v.astype(jnp.float32) ** 2) for v in out.values()), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = Groundlink(**SMALL, output_data_format=fmt, **dropout)
    model.load_state_dict(groundlink_state_dict_from_jax(params))
    model.train()
    model.dropout_masks = _mask_source(masks)
    got = model(torch.from_numpy(x))
    for k in want:
        a, b = got[k].detach().numpy(), np.asarray(want[k], np.float32)
        assert np.abs(a - b).max() <= 5e-2 * np.abs(b).max(), k
    sum(v.square().sum() for v in got.values()).backward()
    grads = groundlink_params_to_jax({n: p.grad for n, p in model.named_parameters()})
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    assert set(flat_j) == set(flat_t)
    for path, g in flat_j.items():
        g = np.asarray(g)
        np.testing.assert_allclose(np.asarray(flat_t[path]), g, rtol=0,
                                   atol=5e-2 * np.abs(g).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


def test_three_train_steps_at_the_defaults_with_the_same_masks(tmp_path):
    """The full-width model as ``get_model`` builds it (fc_dropout 0.2) from
    flax's init, RMSprop 1e-4, three steps of the default batch of 64 on the
    same batches with the same masks on both sides: each step's loss within
    2e-2 relative."""
    from inferbiomechanics_tpu.data.dataset import unpack as jax_unpack
    from inferbiomechanics_tpu.loss.evaluator import LossConfig as JaxLossConfig
    from inferbiomechanics_tpu.loss.evaluator import loss_and_metrics as jax_loss_and_metrics
    from inferbiomechanics_tpu.train.optimizers import make_optimizer as jax_make_optimizer
    from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
    from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
    from inferbiomechanics_tpu_torch.loss.evaluator import LossConfig
    from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
    from inferbiomechanics_tpu_torch.train.state import create_train_state
    from inferbiomechanics_tpu_torch.train.step import make_train_step

    write_synthetic_subject(str(tmp_path / 's.b3d'), num_trials=1, trial_length=250, seed=5)
    ds = WindowDataset(str(tmp_path / 's.b3d'), window_size=50, stride=5,
                       skip_loading_skeletons=True)
    full = dict(SKELETON, history_len=50, stride=5, output_data_format='last_frame')
    jm = jax_get_model('groundlink', **full)
    assert (jm.fc_dropout, jm.cnn_dropout) == (0.2, 0.0)
    batches = [ds.gather(np.arange(k * 64, (k + 1) * 64)) for k in range(3)]
    params = jax.jit(lambda k, x: jm.init({'params': k}, x, train=False)['params'])(
        jax.random.PRNGKey(0), jnp.asarray(batches[0].inputs))
    model = get_model('groundlink', **full)
    model.load_state_dict(groundlink_state_dict_from_jax(jax.device_get(params)))

    tx = jax_make_optimizer('rmsprop', 1e-4)
    opt_state = jax.jit(tx.init)(params)

    def jloss(p, x, y, key):
        out = jm.apply({'params': p}, x, train=True, rngs={'dropout': key})
        return jax_loss_and_metrics(out, jax_unpack(y, ds.lab_offsets), JaxLossConfig())[0]

    @jax.jit
    def jstep(p, o, x, y, key):
        loss, g = jax.value_and_grad(jloss)(p, x, y, key)
        updates, o = tx.update(g, o, p)
        return loss, jax.tree_util.tree_map(lambda a, u: a + u, p, updates), o

    masks_of = _jax_mask_fn(jm)
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'rmsprop', 1e-4))
    step = make_train_step(model, ds.lab_offsets, LossConfig())
    for k, batch in enumerate(batches):
        key = jax.random.PRNGKey(100 + k)
        x = jnp.asarray(batch.inputs)
        model.dropout_masks = _mask_source(masks_of(params, x, key))
        jl, params, opt_state = jstep(params, opt_state, x, jnp.asarray(batch.labels), key)
        m = step(state, torch.from_numpy(batch.inputs), torch.from_numpy(batch.labels))
        assert float(m['loss']) == pytest.approx(float(jl), rel=2e-2), k


def test_eval_ignores_dropout():
    """Eval runs the fused forward: no mask is drawn, and the answer is the
    one of the same weights without dropout."""
    def never(*_):
        raise AssertionError('a mask was drawn in eval')

    model = Groundlink(**SMALL, cnn_dropout=0.3, fc_dropout=0.5,
                       generator=torch.Generator().manual_seed(2))
    model.dropout_masks = never
    plain = Groundlink(**SMALL, cnn_dropout=0.0, fc_dropout=0.0)
    plain.load_state_dict(model.state_dict())
    x = torch.from_numpy(_inputs(3))
    a, b = model.eval()(x), plain.eval()(x)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_packed_is_made_once_and_dropped_on_train_and_load():
    model = Groundlink(**SMALL, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(_inputs(2))
    before = model(x)
    packed = model.packed()
    assert model.packed() is packed                    # once per eval()
    model.eval()
    assert model.packed() is packed                    # eval() again keeps it
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
