"""The port's loss helpers and loss engine (inferbiomechanics_tpu_torch/
ops/losses.py, loss/evaluator.py) against the JAX package's
(inferbiomechanics_tpu/ops/losses.py, loss/evaluator.py) on the same numpy
inputs. Both compute in float32: rtol 1e-5 (atol 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.loss import evaluator as jev
from inferbiomechanics_tpu.ops import losses as jl
from inferbiomechanics_tpu_torch.data.keys import OutputDataKeys as K
from inferbiomechanics_tpu_torch.loss import evaluator as tev
from inferbiomechanics_tpu_torch.ops import losses as tl

TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=shape) * scale).astype(np.float32),
            (rng.normal(size=shape) * scale).astype(np.float32))


def _both(name, *arrays, **kw):
    want = np.asarray(getattr(jl, name)(*(jnp.asarray(a) for a in arrays), **kw))
    got = getattr(tl, name)(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    return got


@pytest.mark.parametrize('shape', [(5, 1, 6), (4, 10, 12), (1, 3, 3)])
def test_squared_diff_mean_vector(shape):
    out = _both('squared_diff_mean_vector', *_pair(0, shape))
    assert out.shape == (shape[-1],)


@pytest.mark.parametrize('threshold', [0.0, 1.5, 10.0])
def test_mask_by_threes(threshold):
    x, _ = _pair(1, (6, 4, 9), scale=4.0)
    x[0, 0, :3] = 0.0                           # a zero vector is never above 0
    mask = _both('mask_by_threes', x, threshold=threshold)
    assert set(np.unique(mask)) <= {0.0, 1.0} and mask.shape == x.shape
    assert (mask.reshape(6, 4, 3, 3).std(-1) == 0).all()      # whole 3-vectors
    t = torch.from_numpy(x).requires_grad_(True)
    assert not tl.mask_by_threes(t, threshold).requires_grad   # no gradient


@pytest.mark.parametrize('vec_size', [3, 6])
def test_mean_norm_error_is_of_the_last_frame(vec_size):
    a, b = _pair(2, (5, 7, 12))
    out = _both('mean_norm_error', a, b, vec_size=vec_size)
    a2 = a.copy()
    a2[:, :-1] += 100.0                          # earlier frames do not count
    assert tl.mean_norm_error(torch.from_numpy(a2), torch.from_numpy(b),
                              vec_size).item() == pytest.approx(float(out))


def test_com_acc_error():
    _both('com_acc_error', *_pair(3, (5, 4, 6)))


@pytest.mark.parametrize('fn,args,match', [
    ('squared_diff_mean_vector', [(2, 3, 4), (2, 3, 5)], 'same shape'),
    ('squared_diff_mean_vector', [(2, 3), (2, 3)], '3-dimensional'),
    ('squared_diff_mean_vector', [(0, 3, 4), (0, 3, 4)], 'must not be empty'),
    ('mask_by_threes', [(2, 3)], '3-dimensional'),
    ('mask_by_threes', [(0, 3, 3)], 'must not be empty'),
    ('mask_by_threes', [(2, 3, 4)], 'divisible by 3'),
    ('mean_norm_error', [(2, 3, 4), (2, 3, 4)], 'divisible by vec_size=3'),
    ('com_acc_error', [(2, 3, 3), (2, 3, 3)], '6 dimensional'),
])
def test_shape_errors_are_the_jax_packages(fn, args, match):
    for mod, make in ((tl, torch.zeros), (jl, jnp.zeros)):
        with pytest.raises(ValueError, match=match):
            getattr(mod, fn)(*(make(s) for s in args))


def _batch(seed, b=9, frames=1, nb=2, dofs=23):
    rng = np.random.default_rng(seed)
    widths = {K.GROUND_CONTACT_COPS_IN_ROOT_FRAME: 3 * nb,
              K.GROUND_CONTACT_FORCES_IN_ROOT_FRAME: 3 * nb,
              K.GROUND_CONTACT_TORQUES_IN_ROOT_FRAME: 3 * nb,
              K.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME: 6 * nb,
              K.TAU: dofs, K.COM_ACC_IN_ROOT_FRAME: 3, K.CONTACT: nb}
    outputs = {k: rng.normal(size=(b, frames, w)).astype(np.float32) for k, w in widths.items()}
    labels = {k: rng.normal(size=(b, frames, w)).astype(np.float32) for k, w in widths.items()}
    # forces on both sides of the 10 N CoP threshold; contact labels in {0, 1}
    labels[K.GROUND_CONTACT_FORCES_IN_ROOT_FRAME] *= 12.0
    labels[K.CONTACT] = (labels[K.CONTACT] > 0).astype(np.float32)
    return outputs, labels


LOSS_CONFIGS = {
    'defaults': {},
    'every component list': dict(predict_grf_components=(1, 4),
                                 predict_cop_components=(0, 1, 2, 3, 4, 5),
                                 predict_moment_components=(2, 5),
                                 predict_wrench_components=tuple(range(12))),
    'no component at all': dict(predict_grf_components=()),
    'another CoP threshold': dict(predict_cop_components=(1,),
                                  cop_force_threshold_newtons=3.0),
    'aux tau': dict(aux_tau_weight=0.5),
    'aux com acc': dict(aux_com_acc_weight=0.25),
    'aux contact': dict(aux_contact_weight=2.0),
    'all three aux': dict(aux_tau_weight=0.1, aux_com_acc_weight=0.2,
                          aux_contact_weight=0.3),
}


@pytest.mark.parametrize('frames', [1, 10])
@pytest.mark.parametrize('name', list(LOSS_CONFIGS))
def test_loss_and_metrics_matches_jax(name, frames):
    fields = LOSS_CONFIGS[name]
    assert ({f.name for f in dataclasses.fields(tev.LossConfig)}
            == {f.name for f in dataclasses.fields(jev.LossConfig)})
    outputs, labels = _batch(len(name), frames=frames)
    jloss, jm = jev.loss_and_metrics({k: jnp.asarray(v) for k, v in outputs.items()},
                                     {k: jnp.asarray(v) for k, v in labels.items()},
                                     jev.LossConfig(**fields))
    tloss, tm = tev.loss_and_metrics({k: torch.from_numpy(v) for k, v in outputs.items()},
                                     {k: torch.from_numpy(v) for k, v in labels.items()},
                                     tev.LossConfig(**fields))
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
    assert set(tm) == set(jm) and len(tm) == 11
    for k in jm:
        assert not tm[k].requires_grad
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), err_msg=k, **TOL)


def test_aux_losses_need_the_models_head():
    outputs, labels = _batch(1)
    for k in (K.TAU, K.COM_ACC_IN_ROOT_FRAME, K.CONTACT):
        outputs.pop(k)
    cfg = dict(aux_tau_weight=1.0, aux_com_acc_weight=1.0, aux_contact_weight=1.0)
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}   # noqa: E731
    with_aux, _ = tev.loss_and_metrics(t(outputs), t(labels), tev.LossConfig(**cfg))
    without, _ = tev.loss_and_metrics(t(outputs), t(labels), tev.LossConfig())
    assert with_aux.item() == without.item()


def test_loss_gradient_matches_jax():
    outputs, labels = _batch(4, frames=10)
    cfg = dict(predict_cop_components=(0, 3), aux_tau_weight=0.3, aux_contact_weight=0.7)
    jgrad = jax.grad(lambda o: jev.loss_and_metrics(
        o, {k: jnp.asarray(v) for k, v in labels.items()}, jev.LossConfig(**cfg))[0])(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    touts = {k: torch.from_numpy(v).requires_grad_(True) for k, v in outputs.items()}
    loss, _ = tev.loss_and_metrics(touts, {k: torch.from_numpy(v) for k, v in labels.items()},
                                   tev.LossConfig(**cfg))
    loss.backward()
    for k in outputs:
        got = np.zeros_like(outputs[k]) if touts[k].grad is None else touts[k].grad.numpy()
        np.testing.assert_allclose(got, np.asarray(jgrad[k]), err_msg=k, **TOL)


def test_evaluator_accumulates_and_reports_like_jax(capsys):
    tevl = tev.RegressionLossEvaluator('dev', tev.LossConfig())
    jevl = jev.RegressionLossEvaluator('dev', jev.LossConfig())
    for seed in range(3):
        outputs, labels = _batch(seed)
        tevl(None, {k: torch.from_numpy(v) for k, v in outputs.items()},
             {k: torch.from_numpy(v) for k, v in labels.items()})
        jevl(None, {k: jnp.asarray(v) for k, v in outputs.items()},
             {k: jnp.asarray(v) for k, v in labels.items()})
    assert tevl.mean_metric('loss') == pytest.approx(jevl.mean_metric('loss'), rel=1e-5)
    tsum, jsum = tevl.print_report(), jevl.print_report()
    assert set(tsum) == set(jsum)
    for k in jsum:
        assert tsum[k] == pytest.approx(jsum[k], rel=1e-5), k
    assert 'Force Avg Err' in capsys.readouterr().out
    assert tevl.metric_history == {} and tevl.print_report() == {}


def test_report_logs_the_jax_wandb_keys(capsys):
    """``print_report(log_to_wandb=True)`` hands the logger the JAX
    package's keys and values, per selected component; ``reset=False`` keeps
    the history."""
    class Log:
        def __init__(self):
            self.records = []

        def log(self, record):
            self.records.append(record)

    cfg = dict(predict_grf_components=(1,), predict_cop_components=(0, 2),
               predict_moment_components=(3,), predict_wrench_components=(5, 11))
    tlog, jlog = Log(), Log()
    tevl = tev.RegressionLossEvaluator('dev', tev.LossConfig(**cfg), wandb_logger=tlog)
    jevl = jev.RegressionLossEvaluator('dev', jev.LossConfig(**cfg), wandb_logger=jlog)
    for seed in range(2):
        outputs, labels = _batch(seed)
        tevl(None, {k: torch.from_numpy(v) for k, v in outputs.items()},
             {k: torch.from_numpy(v) for k, v in labels.items()})
        jevl(None, {k: jnp.asarray(v) for k, v in outputs.items()},
             {k: jnp.asarray(v) for k, v in labels.items()})
    for _ in range(2):
        tsum = tevl.print_report(reset=False, log_to_wandb=True)
        jsum = jevl.print_report(reset=False, log_to_wandb=True)
        assert tsum == pytest.approx(jsum, rel=1e-5)
    assert len(tlog.records) == len(jlog.records) == 2
    for got, want in zip(tlog.records, jlog.records):
        assert set(got) == set(want) and 'dev/wrench_loss/right-force-z' in got
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5), k
    tevl.print_report()
    assert tevl.metric_history == {} and len(tlog.records) == 2
    assert 'Force Avg Err' in capsys.readouterr().out


def test_precomputed_metrics_are_taken_as_they_are():
    ev = tev.RegressionLossEvaluator('train')
    ev(None, None, None, precomputed_metrics={
        k: torch.tensor(2.0) for k in ('force_avg_err', 'com_acc_avg_err', 'cop_avg_err',
                                       'moment_avg_err', 'wrench_avg_err',
                                       'wrench_moment_avg_err', 'loss')})
    assert ev.print_report()['loss'] == 2.0


def test_the_torque_report_is_computed_when_asked(capsys):
    """A batch accounted with ``compute_report`` calls ``tau_fn`` with its
    inputs, outputs, labels and subject indices; the report's mean is
    ``tau_avg_err``, printed and logged in the JAX package's words (the
    values against the JAX package: tests/test_torch_analytical.py)."""
    calls, logged = [], []
    values = iter([0.5, 1.5])

    def tau_fn(inputs, outputs, labels, subject_indices):
        calls.append((inputs, outputs, labels, subject_indices))
        return next(values)

    ev = tev.RegressionLossEvaluator(
        'dev', tau_fn=tau_fn, wandb_logger=type('L', (), {'log': lambda self, d: logged.append(d)})())
    metrics = {k: torch.tensor(2.0) for k in (
        'force_avg_err', 'com_acc_avg_err', 'cop_avg_err', 'moment_avg_err', 'wrench_avg_err',
        'wrench_moment_avg_err', 'loss')}
    metrics.update({k: torch.full((n,), 4.0) for k, n in (
        ('force_loss', 6), ('cop_loss', 6), ('moment_loss', 6), ('wrench_loss', 12))})
    ev('x', 'o', 'l', 's', precomputed_metrics=metrics)          # no report asked
    assert calls == [] and ev.tau_reported_metrics == []
    for k in range(2):
        ev('x', 'o', 'l', [k], compute_report=True, precomputed_metrics=metrics)
    assert calls == [('x', 'o', 'l', [0]), ('x', 'o', 'l', [1])]
    assert ev.tau_reported_metrics == [0.5, 1.5]
    summary = ev.print_report(log_to_wandb=True)
    assert summary['tau_avg_err'] == 1.0 and ev.tau_reported_metrics == []
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == '\tNon-root Joint Torques (Inverse Dynamics) Avg Err: 1.0 Nm / kg'
    assert logged[0]['dev/reports/Non-root Joint Torques (Inverse Dynamics) Avg Err '
                     '(Nm per kg)'] == 1.0
    # without a tau_fn, compute_report only accounts the metrics
    ev = tev.RegressionLossEvaluator('dev')
    ev(None, None, None, compute_report=True, precomputed_metrics=metrics)
    assert 'tau_avg_err' not in ev.print_report()
