"""The port's feedforward batchnorm and dropout, and the ``vpu`` transformer's
dropout (inferbiomechanics_tpu_torch/models/{norm,feedforward,transformer}.py,
ops/fused_mlp.py's folded packing, weights.py) against the JAX package's
flax models on the same numpy inputs and converted weights.

Sizes: window 20 / stride 5 (4 frames x 177 channels), hidden widths 64 and
48 (feedforward), d_model 32 / 2 layers / 4 heads (transformer). Dropout
masks are the JAX models' own, drawn as flax's ``Dropout`` draws them and
recorded (``_jax_masks``), and fed to the port through its mask source. Tolerances: the BatchNorm's
outputs and running statistics at rtol 1e-5 in float32 and 2e-2 in bf16;
outputs, new statistics and gradients of the bf16 models at 2e-2 x the
tensor's largest value; three RMSprop steps' losses within 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from inferbiomechanics_tpu.config import Config as JaxConfig
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.models.feedforward import FeedForwardBaseline as JaxFeedForward
from inferbiomechanics_tpu.models.transformer import TransformerRegressor as JaxTransformer
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu.train.loop import loss_config_from as jax_loss_config_from
from inferbiomechanics_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from inferbiomechanics_tpu.train.state import create_train_state as jax_create_train_state
from inferbiomechanics_tpu.train.step import make_train_step as jax_make_train_step
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.models.feedforward import FeedForwardBaseline
from inferbiomechanics_tpu_torch.models.norm import BatchNorm
from inferbiomechanics_tpu_torch.models.transformer import TransformerRegressor
from inferbiomechanics_tpu_torch.ops import fused_mlp as fm
from inferbiomechanics_tpu_torch.train.loop import build_model_for_dataset, loss_config_from
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
from inferbiomechanics_tpu_torch.train.state import create_train_state
from inferbiomechanics_tpu_torch.train.step import make_train_step

REL = 2e-2
SKELETON = dict(num_dofs=23, num_contact_bodies=2, history_len=20, stride=5)
FF = dict(SKELETON, root_history_len=10, hidden_dims=(64, 48))
TF = dict(SKELETON, d_model=32, num_layers=2, num_heads=4)
BATCH = 16


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """Small models beside other test processes: one thread throughout."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp('torch_bn_data')
    write_synthetic_subject(str(d / 's.b3d'), num_trials=1, trial_length=200, seed=0)
    kw = dict(window_size=20, stride=5, skip_loading_skeletons=True)
    return {'dir': d, 'jax_ds': JaxWindowDataset(str(d), **kw), 'ds': WindowDataset(str(d), **kw)}


def _inputs(b=BATCH, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (offset + rng.normal(size=(b, 4, 177))).astype(np.float32)


def _close(got, want, rel=REL, what=''):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max() + 1e-12,
                               err_msg=what)


def _near_exact(got, exact, jax_bf16, what=''):
    """``got`` (the port's bf16 gradients, flat) against ``exact`` (the same
    model's in float32): each within 2e-2 x max, or within twice the JAX
    package's own bf16 gradient's distance from ``exact`` where that is
    larger (two bf16 evaluations that round at different places)."""
    assert got.keys() == exact.keys() == jax_bf16.keys(), what
    for k, g in exact.items():
        scale = np.abs(g).max()
        limit = max(REL, 2 * np.abs(jax_bf16[k] - g).max() / scale)
        err = np.abs(got[k] - g).max() / scale
        assert err <= limit, (what, k, err, limit)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _mask_source(masks):
    """A mask source that hands out the given masks in order."""
    it = iter(masks)

    def source(shape, p, device):
        m = next(it)
        assert m.shape == shape, (m.shape, shape)
        return torch.from_numpy(np.array(m)).to(device)
    return source


def _jax_masks(jm, variables, x, key):
    """The keep masks of ``jm``'s dropout sites in call order: each flax
    ``Dropout`` call is intercepted and run as flax runs it (its first
    ``make_rng``, then ``bernoulli``), with its mask recorded. (A mask read
    back from a Dropout's output cannot tell a dropped element from a kept
    zero, and a GELU's output rounds to exactly 0 often enough in bf16.)"""
    masks = []

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

    with flax_nn.intercept_methods(record):
        jm.apply(variables, jnp.asarray(x), train=True, rngs={'dropout': key},
                 mutable=['batch_stats'])
    return [np.asarray(m) for m in masks]


# ---------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_batchnorm_matches_flax(dtype):
    """Train mode three times (outputs, then the running statistics), then
    eval mode on the running statistics."""
    jdt, tdt = {'float32': (jnp.float32, torch.float32),
                'bfloat16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(1)
    xs = [(3.0 + 2.0 * rng.normal(size=(24, 40))).astype(np.float32) for _ in range(4)]
    jm = flax_nn.BatchNorm(dtype=jdt)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0], jdt), use_running_average=False)
    params = {'scale': (1 + 0.3 * rng.normal(size=40)).astype(np.float32),
              'bias': (0.3 * rng.normal(size=40)).astype(np.float32)}
    stats = v['batch_stats']
    pm = BatchNorm(40)
    with torch.no_grad():
        pm.weight.copy_(torch.from_numpy(params['scale']))
        pm.bias.copy_(torch.from_numpy(params['bias']))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == 'float32' else dict(rtol=REL, atol=REL)
    pm.train()
    for x in xs[:3]:
        want, new = jm.apply({'params': params, 'batch_stats': stats}, jnp.asarray(x, jdt),
                             use_running_average=False, mutable=['batch_stats'])
        stats = new['batch_stats']
        got = pm(torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().detach().numpy(),
                                   np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(pm.running_mean.numpy(), np.asarray(stats['mean']), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pm.running_var.numpy(), np.asarray(stats['var']), rtol=1e-5,
                               atol=1e-6)
    want = jm.apply({'params': params, 'batch_stats': stats}, jnp.asarray(xs[3], jdt),
                    use_running_average=True)
    got = pm.eval()(torch.from_numpy(xs[3]).to(tdt))
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32), **tol)
    s, t = pm.affine()
    np.testing.assert_allclose((torch.from_numpy(xs[3]) * s + t).detach().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------- feedforward

def _ff_pair(batchnorm=True, dropout=True, seed=0, x=None):
    """The JAX feedforward model and the port's, with flax-initialised
    parameters (biases, BatchNorm scales and biases moved off their
    defaults) and running statistics moved off zeros / ones."""
    kw = dict(FF, batchnorm=batchnorm, dropout=dropout, dropout_prob=0.25 if dropout else 0.0)
    jm = JaxFeedForward(**kw)
    x = _inputs(seed=seed) if x is None else x
    v = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False))
    rng = np.random.default_rng(seed + 10)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.2 * rng.normal(size=p.shape) if p.ndim == 1 else 0)
                   ).astype(np.float32), v['params'])
    stats = jax.tree_util.tree_map(
        lambda s: (np.asarray(s) + 0.1 * np.abs(rng.normal(size=s.shape))).astype(np.float32),
        v.get('batch_stats', {}))
    pm = FeedForwardBaseline(**kw)
    pm.load_state_dict(weights.feedforward_state_dict_from_jax(params, stats or None))
    return jm, params, stats, pm


def test_batchnorm_weights_cross_exactly():
    jm, params, stats, pm = _ff_pair()
    sd = pm.state_dict()
    assert sorted(k for k in sd if k.startswith('norms.')) == sorted(
        f'norms.{i}.{n}' for i in range(3)
        for n in ('weight', 'bias', 'running_mean', 'running_var'))
    back = weights.feedforward_params_to_jax(sd)
    assert _flat(back).keys() == _flat(params).keys()
    for k, v in _flat(params).items():
        assert np.array_equal(_flat(back)[k], v), k
    for k, v in _flat(stats).items():
        assert np.array_equal(_flat(weights.feedforward_batch_stats_to_jax(sd))[k], v), k
    with pytest.raises(ValueError, match='batch_stats'):
        weights.feedforward_state_dict_from_jax(params)
    with pytest.raises(ValueError, match='no BatchNorm'):
        weights.feedforward_params_to_jax(sd, use_pallas=True)


@pytest.mark.parametrize('batchnorm,dropout', [(True, True), (True, False), (False, True)])
def test_feedforward_train_forward_matches_flax(batchnorm, dropout):
    """JAX's masks fed to the port's train forward: outputs and the new
    running statistics against the JAX model. Gradients: a BatchNorm's
    backward subtracts the batch means of its cotangents, which cancels most
    of them, so two bf16 evaluations of these gradients differ by more than
    their rounding (the JAX model's own bf16 gradients lie up to 8.5e-2 x max
    from its float32 ones here). Every gradient is therefore held to the
    float32 evaluation of the same model (the JAX model with
    ``compute_dtype`` float32) by ``_near_exact``."""
    x = _inputs(64, seed=2)
    jm, params, stats, pm = _ff_pair(batchnorm, dropout, seed=2, x=x)
    key = jax.random.PRNGKey(5)
    variables = {'params': params, **({'batch_stats': stats} if stats else {})}
    masks = _jax_masks(jm, variables, x, key)
    assert len(masks) == (3 if dropout else 0)

    def jloss(module):
        def loss(p):
            out, new = module.apply({**variables, 'params': p}, jnp.asarray(x), train=True,
                                    rngs={'dropout': key}, mutable=['batch_stats'])
            return sum(jnp.sum(v.astype(jnp.float32) ** 2) for v in out.values()), (out, new)
        return jax.jit(jax.value_and_grad(loss, has_aux=True))(params)

    (_, (want, new)), jgrads = jloss(jm)
    _, exact = jloss(jm.clone(compute_dtype=jnp.float32))
    pm.train()
    pm.dropout_masks = _mask_source(masks)
    got = pm(torch.from_numpy(x))
    for k in want:
        _close(got[k].detach(), want[k], what=k)
    sum(v.square().sum() for v in got.values()).backward()
    grads = _flat(weights.feedforward_params_to_jax(
        {n: p.grad for n, p in pm.named_parameters()}))
    _near_exact(grads, _flat(exact), _flat(jgrads))
    # the first BatchNorm's input is the model's input: its statistics agree
    # to float32 rounding; the others are of bf16 activations
    got_stats = _flat(weights.feedforward_batch_stats_to_jax(pm.state_dict()))
    for k, s in _flat(new.get('batch_stats', {})).items():
        if k.startswith("['BatchNorm_0']"):
            np.testing.assert_allclose(got_stats[k], s, rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            _close(got_stats[k], s, what=k)


def _jax_ff_config(**fields):
    cfg = JaxConfig(model_type='feedforward', window_size=20, stride=5, batch_size=BATCH,
                    hidden_dims=[64, 48], batchnorm=True, dropout=True, dropout_prob=0.1)
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def _port_ff_config(**fields):
    cfg = Config(model_type='feedforward', window_size=20, stride=5, batch_size=BATCH,
                 hidden_dims=[64, 48], batchnorm=True, dropout=True, dropout_prob=0.1)
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


@pytest.mark.parametrize('grad_accum', [1, 2])
def test_three_rmsprop_steps_track_the_jax_step(data, grad_accum):
    """The host train step of a batchnorm + dropout model, three RMSprop
    steps from the same weights on the same batches, each step's masks JAX's
    (with ``--grad-accum-steps 2`` each microbatch's, from its split key):
    losses within 2e-2; the running statistics after the three steps within
    5e-2 x max, the JAX suite's bf16 limit (RMSprop's first updates are
    near +-lr wherever a gradient is near 0, so weights whose bf16 gradients
    differ there part by up to 2 lr, and the statistics of the activations
    after them with them)."""
    jcfg, cfg = _jax_ff_config(), _port_ff_config()
    jds, ds = data['jax_ds'], data['ds']
    jm = jax_build(jcfg, jds)
    sample = jnp.asarray(jds.gather(np.arange(4)).inputs)
    jstate = jax_create_train_state(jm, jax.random.PRNGKey(0), sample,
                                    jax_make_optimizer('rmsprop', 1e-3))
    model = build_model_for_dataset(cfg, ds)
    model.load_state_dict(weights.feedforward_state_dict_from_jax(
        jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)))
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'rmsprop', 1e-3))
    jstep = jax_make_train_step(jm, jds.lab_offsets, jax_loss_config_from(jcfg), donate=False,
                                grad_accum=grad_accum)
    step = make_train_step(model, ds.lab_offsets, loss_config_from(cfg), grad_accum=grad_accum)
    perm = np.random.default_rng(3).permutation(len(ds))
    mb = BATCH // grad_accum
    for k in range(3):
        batch = jds.gather(perm[k * BATCH:(k + 1) * BATCH])
        key = jax.random.PRNGKey(100 + k)
        keys = jax.random.split(key, grad_accum) if grad_accum > 1 else [key]
        masks = []
        for j, kj in enumerate(keys):
            masks += _jax_masks(jm, {'params': jstate.params, 'batch_stats': jstate.batch_stats},
                                batch.inputs[j * mb:(j + 1) * mb], kj)
        jstate, jmetrics = jstep(jstate, jnp.asarray(batch.inputs), jnp.asarray(batch.labels), key)
        model.dropout_masks = _mask_source(masks)
        metrics = step(state, torch.from_numpy(batch.inputs), torch.from_numpy(batch.labels))
        assert float(metrics['loss']) == pytest.approx(float(jmetrics['loss']), rel=REL), k
    want = _flat(jax.device_get(jstate.batch_stats))
    got = _flat(weights.feedforward_batch_stats_to_jax(model.state_dict()))
    assert got.keys() == want.keys()
    for k, s in want.items():
        _close(got[k], s, rel=5e-2, what=k)


def _f64_eval(params, stats, x, n_layers):
    """The eval function in float64 (no rounding anywhere)."""
    h = x.reshape(x.shape[0], -1).astype(np.float64)
    for i in range(n_layers):
        bn, st = params[f'BatchNorm_{i}'], stats[f'BatchNorm_{i}']
        h = (h - st['mean']) / np.sqrt(st['var'].astype(np.float64) + 1e-5) * bn['scale'] + bn['bias']
        h = h @ params[f'Dense_{i}']['kernel'] + params[f'Dense_{i}']['bias']
        if i < n_layers - 1:
            h = 1 / (1 + np.exp(-h))
    return h


def _converged_stats(params, x, n_layers):
    """The running statistics a long run on ``x`` converges to: each
    BatchNorm's input's mean and biased variance, computed in float64."""
    stats, h = {}, x.reshape(x.shape[0], -1).astype(np.float64)
    for i in range(n_layers):
        mean, var = h.mean(0), h.var(0)
        stats[f'BatchNorm_{i}'] = {'mean': mean.astype(np.float32), 'var': var.astype(np.float32)}
        bn = params[f'BatchNorm_{i}']
        h = (h - mean) / np.sqrt(var + 1e-5) * bn['scale'] + bn['bias']
        h = h @ params[f'Dense_{i}']['kernel'] + params[f'Dense_{i}']['bias']
        if i < n_layers - 1:
            h = 1 / (1 + np.exp(-h))
    return stats


def _heads(out):
    return np.concatenate([np.asarray(out[k], np.float32).reshape(out[k].shape[0], -1)
                           for k in sorted(out)], 1)


def test_folded_eval_matches_jax_eval():
    """The port's eval (K1's plain version on the folded packing) against
    ``FeedForwardBaseline.apply(train=False)`` on the same weights and running
    statistics, at 2e-2 x max; dropout is the identity."""
    x = _inputs(64, seed=4)
    jm, params, stats, pm = _ff_pair(seed=4, x=x)
    want = jm.apply({'params': params, 'batch_stats': stats}, jnp.asarray(x), train=False)
    got = pm.eval()(torch.from_numpy(x))
    for k in want:
        _close(got[k], want[k], what=k)
    packed = pm.packed()
    assert len(packed.layers) == 3
    s0, t0 = pm.norms[0].affine()
    W, b = pm.layer_params()[0]
    torch.testing.assert_close(packed.layers[0][0], (s0[:, None] * W).to(torch.bfloat16))
    torch.testing.assert_close(packed.layers[0][1], b + t0 @ W, rtol=1e-5, atol=1e-5)


def test_a_load_repacks_the_fold():
    """The packing folds the running statistics it was made from: a load of
    other statistics drops it, and the next eval folds the new ones."""
    x = _inputs(8, seed=5)
    _, params, stats, pm = _ff_pair(seed=5, x=x)
    pm.eval()
    before = pm(torch.from_numpy(x))
    packed = pm.packed()
    moved = jax.tree_util.tree_map(lambda s: s * 1.5 + 0.1, stats)
    pm.load_state_dict(weights.feedforward_state_dict_from_jax(params, moved))
    assert pm.packed() is not packed
    after = pm(torch.from_numpy(x))
    assert all(not torch.equal(before[k], after[k]) for k in before)
    fresh = FeedForwardBaseline(**FF, batchnorm=True, dropout=True, dropout_prob=0.25)
    fresh.load_state_dict(weights.feedforward_state_dict_from_jax(params, moved))
    want = fresh.eval()(torch.from_numpy(x))
    assert all(torch.equal(after[k], want[k]) for k in want)


def test_folded_eval_on_converged_statistics(data):
    """On the synthetic subject's windows, whose channels have offsets of up
    to 17 standard deviations, with the running statistics a long run
    converges to: the folded eval is no further from the eval function
    computed without rounding than the JAX package's own bf16 eval is. The
    other design, which normalises the input with a plain elementwise
    BatchNorm before the kernel and folds only the hidden ones, is measured
    beside it (the assertion's message gives the three errors)."""
    x = np.asarray(data['ds'].gather(np.arange(128)).inputs, np.float32)
    jm, params, _, pm = _ff_pair(dropout=False, seed=6, x=x)
    stats = _converged_stats(params, x, 3)
    pm.load_state_dict(weights.feedforward_state_dict_from_jax(params, stats))
    exact = _f64_eval(params, stats, x, 3)
    scale = np.abs(exact).max()
    jax_err = np.abs(_heads(jm.apply({'params': params, 'batch_stats': stats},
                                     jnp.asarray(x), train=False))
                     - _heads(_split(exact))).max() / scale
    fold_err = np.abs(_heads(pm.eval()(torch.from_numpy(x))) - _heads(_split(exact))).max() / scale
    norm0 = pm.norms[0]
    pre = fm.pack_mlp_params([(W.detach(), b.detach()) for W, b in pm.layer_params()], 'cpu',
                             norms=[None] + [n.affine() for n in pm.norms[1:]])
    h = torch.from_numpy(x).reshape(x.shape[0], -1).to(torch.bfloat16)
    h = ((h.float() - norm0.running_mean) * (torch.rsqrt(norm0.running_var + 1e-5)
                                             * norm0.weight) + norm0.bias).to(torch.bfloat16)
    pre_err = np.abs(fm.mlp_reference(h.float(), pre.layers).detach().numpy()
                     - exact).max() / scale
    assert fold_err <= jax_err, dict(fold=fold_err, input_bn_plain=pre_err, jax_bf16=jax_err)


def _split(flat):
    from inferbiomechanics_tpu_torch.models.common import slice_output_heads
    return {k: v.numpy() for k, v in slice_output_heads(torch.from_numpy(flat), 2, 1).items()}


# ---------------------------------------------------------------- transformer

def test_vpu_transformer_dropout_matches_flax():
    """JAX's masks at both sites of each encoder block (after the attention's
    projection, after the GELU) fed to the port's ``vpu`` train forward:
    outputs against the JAX model at 2e-2 x max, and the gradient of every
    parameter at 5e-2 x max, the limit of the transformer's gradients without
    dropout (``tests/test_torch_train.py``: bf16 operands rounded at
    different places by XLA and PyTorch)."""
    x = _inputs(16, seed=7)
    jm = JaxTransformer(**TF, dropout=0.2, attn_impl='vpu')
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)['params'])
    rng = np.random.default_rng(8)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.1 * rng.normal(size=p.shape) if p.ndim == 1 else 0)
                   ).astype(np.float32), params)
    key = jax.random.PRNGKey(9)
    masks = _jax_masks(jm, {'params': params}, x, key)
    assert [m.shape[-1] for m in masks] == [32, 128, 32, 128]

    def jloss(p):
        out = jm.apply({'params': p}, jnp.asarray(x), train=True, rngs={'dropout': key})
        return sum(jnp.sum(v.astype(jnp.float32) ** 2) for v in out.values()), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    pm = TransformerRegressor(**TF, root_history_len=10, dropout=0.2)
    pm.load_state_dict(weights.transformer_state_dict_from_jax(params))
    pm.train()
    pm.dropout_masks = _mask_source(masks)
    got = pm(torch.from_numpy(x))
    for k in want:
        _close(got[k].detach(), want[k], what=k)
    sum(v.float().square().sum() for v in got.values()).backward()
    grads = _flat(weights.transformer_params_to_jax(
        {n: p.grad for n, p in pm.named_parameters()}))
    jgrads = _flat(jgrads)
    assert grads.keys() == jgrads.keys()
    for k, g in jgrads.items():
        _close(grads[k], g, rel=5e-2, what=k)
    # eval ignores dropout: the same function as the JAX eval
    pm.eval()
    want = jm.apply({'params': params}, jnp.asarray(x), train=False)
    got = pm(torch.from_numpy(x))
    for k in want:
        _close(got[k].detach(), want[k], what=k)
