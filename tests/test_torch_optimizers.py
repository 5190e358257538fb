"""The port's optimizers (inferbiomechanics_tpu_torch/train/optimizers.py)
against the JAX package's optax ones (inferbiomechanics_tpu/train/
optimizers.py): the same parameters and the same gradients, from a seed
with numpy, five updates, every update compared.

Tolerance: rtol 1e-5 (atol 1e-7) on every parameter after every update;
both sides compute in float32, in slightly different operation orders.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from inferbiomechanics_tpu.train import optimizers as jopt
from inferbiomechanics_tpu_torch.train import optimizers as topt

SHAPES = {'layers.0.weight': (5, 7), 'layers.0.bias': (5,), 'head.weight': (3, 5)}
TOL = dict(rtol=1e-5, atol=1e-7)


def _problem(seed, steps=5):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 10 ** rng.uniform(-2, 1)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _run_both(jax_tx, make_torch, params, grads):
    """Yield (step, jax params, torch params) after every update."""
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jax_tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_torch(list(tp.items()))
    for i, g in enumerate(grads):
        updates, state = jax_tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        yield i, jp, tp
    return


@pytest.mark.parametrize('clip', [0.0, 0.5])
@pytest.mark.parametrize('opt_type', topt.OPT_TYPES)
def test_each_optimizer_follows_optax_update_for_update(opt_type, clip):
    assert topt.OPT_TYPES == jopt.OPT_TYPES
    params, grads = _problem(len(opt_type))
    tx = jopt.make_optimizer(opt_type, 1e-2, grad_clip_norm=clip)
    for i, jp, tp in _run_both(
            tx, lambda named: topt.make_optimizer(named, opt_type, 1e-2,
                                                  grad_clip_norm=clip),
            params, grads):
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       err_msg=f'{opt_type} update {i} {k}', **TOL)


@pytest.mark.parametrize('schedule,kwargs', [
    ('constant', {}),
    ('cosine', dict(decay_steps=7)),
    ('warmup_cosine', dict(decay_steps=9, warmup_steps=3)),
    ('warmup_cosine', dict(decay_steps=9, warmup_steps=0)),
    ('linear', dict(decay_steps=4)),
])
def test_schedules_follow_optax(schedule, kwargs):
    assert topt.LR_SCHEDULES == jopt.LR_SCHEDULES
    js = jopt.make_lr_schedule(schedule, 3e-3, **kwargs)
    ts = topt.make_lr_schedule(schedule, 3e-3, **kwargs)
    if schedule == 'constant':
        assert js == ts == 3e-3
        return
    for count in (0, 1, 2, 3, 4, 6, 9, 12):
        np.testing.assert_allclose(ts(count), float(js(count)), rtol=1e-5, atol=1e-10,
                                   err_msg=f'{schedule} at {count}')


def test_scheduled_optimizer_follows_optax_and_counts_its_updates():
    params, grads = _problem(11, steps=6)
    kw = dict(lr_schedule='warmup_cosine', lr_decay_steps=5, lr_warmup_steps=2)
    tx = jopt.make_optimizer('rmsprop', 1e-2, **kw)
    opt = None

    def make(named):
        nonlocal opt
        opt = topt.make_optimizer(named, 'rmsprop', 1e-2, **kw)
        return opt

    for i, jp, tp in _run_both(tx, make, params, grads):
        assert opt.state_dict()['param_groups'][0]['count'] == i + 1
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       err_msg=f'update {i} {k}', **TOL)


def test_a_constant_schedule_keeps_no_counter():
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.make_optimizer([('p', p)], 'rmsprop', 1e-3)
    p.grad = torch.ones(3)
    opt.step()
    sd = opt.state_dict()
    assert 'count' not in sd['param_groups'][0]
    assert set(sd['state'][0]) == {'nu'}
    # rules with bias correction count, whatever the schedule
    opt = topt.make_optimizer([('p', p)], 'adam', 1e-3)
    opt.step()
    assert opt.state_dict()['param_groups'][0]['count'] == 1


def test_schedule_without_decay_steps_and_unknown_names_raise():
    with pytest.raises(ValueError, match='lr-decay-steps'):
        topt.make_lr_schedule('cosine', 1e-3)
    with pytest.raises(ValueError, match='unknown lr schedule'):
        topt.make_lr_schedule('exponential', 1e-3, decay_steps=3)
    with pytest.raises(ValueError, match='unknown optimizer'):
        topt.make_optimizer([('p', torch.nn.Parameter(torch.ones(1)))], 'lion', 1e-3)


def test_wrap_freeze_follows_optax_and_keeps_frozen_parameters_bitwise():
    params, grads = _problem(5)
    # the JAX package matches '/'-joined flax paths, the port its own names
    jax_params = {'layers_0': {'weight': params['layers.0.weight'],
                               'bias': params['layers.0.bias']},
                  'head': {'weight': params['head.weight']}}
    tx = jopt.wrap_freeze(jopt.make_optimizer('adam', 1e-2, grad_clip_norm=0.5),
                          ['^layers_0'])
    jp = {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in jax_params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = topt.wrap_freeze(
        topt.make_optimizer(list(tp.items()), 'adam', 1e-2, grad_clip_norm=0.5),
        [r'^layers\.0'])
    for g in grads:
        jg = {'layers_0': {'weight': jnp.asarray(g['layers.0.weight']),
                           'bias': jnp.asarray(g['layers.0.bias'])},
              'head': {'weight': jnp.asarray(g['head.weight'])}}
        updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    assert np.array_equal(tp['layers.0.weight'].detach().numpy(), params['layers.0.weight'])
    assert np.array_equal(tp['layers.0.bias'].detach().numpy(), params['layers.0.bias'])
    # the frozen gradients still count in the clipped norm, as in optax
    np.testing.assert_allclose(tp['head.weight'].detach().numpy(),
                               np.asarray(jp['head']['weight']), **TOL)
    with pytest.raises(ValueError, match='match no parameter'):
        topt.wrap_freeze(opt, ['nothing_like_this'])


def test_optimizer_state_round_trips_bitwise():
    params, grads = _problem(3, steps=4)

    def fresh():
        tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
        return tp, topt.make_optimizer(list(tp.items()), 'adam', 1e-2,
                                       lr_schedule='linear', lr_decay_steps=10)

    def steps(tp, opt, gs):
        for g in gs:
            for k, p in tp.items():
                p.grad = torch.from_numpy(g[k].copy())
            opt.step()

    tp, opt = fresh()
    steps(tp, opt, grads)
    tp2, opt2 = fresh()
    steps(tp2, opt2, grads[:2])
    tp3, opt3 = fresh()
    for k in tp3:
        tp3[k].data.copy_(tp2[k].data)
    opt3.load_state_dict(opt2.state_dict())
    steps(tp3, opt3, grads[2:])
    for k in SHAPES:
        assert torch.equal(tp[k], tp3[k]), k
