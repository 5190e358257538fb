"""The port's analytical baseline, torque report and ``--compute-report``
(inferbiomechanics_tpu_torch/{models/analytical,loss/tau_report,
loss/evaluator,cli/analyze_cmd}.py) against the JAX package's on the same
data.

Data: two synthetic subjects of one 56-frame trial each (5 windows at window
50 / stride 5), each with its own scaled standard skeleton (masses, COMs,
inertias and joint offsets scaled 1.0 and 1.3) and mass (70 and 91 kg), so
that both packages batch the per-subject parameter stack and per-item
masses. Batches of 5 windows, one shape, so that the JAX side compiles the
analytical forward and the torque report once each (the report ~25 s here).

Tolerances: the contact bodies' COM positions (CoPs) at rtol 1e-5 / atol
1e-6 x max|.|, everything derived from the COM acceleration or inverse
dynamics at 1e-4 x max|.|; each side also held to the port's float64
evaluation. Contact flags are exact except in frames whose contact height
lies within 1e-6 of 0.1 m, which are counted and left out.
"""

import contextlib
import copy
import csv
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.loss.evaluator import LossConfig as JaxLossConfig
from inferbiomechanics_tpu.loss.evaluator import RegressionLossEvaluator as JaxEvaluator
from inferbiomechanics_tpu.loss.tau_report import make_tau_report_fn as jax_tau_report_fn
from inferbiomechanics_tpu.models.analytical import make_analytical_fn as jax_analytical_fn
from inferbiomechanics_tpu.ops.skeleton import compile_skeleton as jax_compile_skeleton
from inferbiomechanics_tpu_torch.__main__ import build_parser, main
from inferbiomechanics_tpu_torch.cli.analyze_cmd import analyze
from inferbiomechanics_tpu_torch.config import config_from_args
from inferbiomechanics_tpu_torch.data import keys as K
from inferbiomechanics_tpu_torch.data.b3d import write_subject
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.synthetic import (
    CONTACT_BODIES, standard_skeleton, synthetic_trial,
)
from inferbiomechanics_tpu_torch.loss.evaluator import LossConfig, RegressionLossEvaluator
from inferbiomechanics_tpu_torch.loss.tau_report import make_tau_report_fn
from inferbiomechanics_tpu_torch.models import get_model
from inferbiomechanics_tpu_torch.models.analytical import (
    CONTACT_HEIGHT_THRESHOLD, analytical_forward, kinematics, make_analytical_fn,
)
from inferbiomechanics_tpu_torch.ops.skeleton import compile_skeleton
from inferbiomechanics_tpu_torch.train.checkpoint import save_checkpoint
from inferbiomechanics_tpu_torch.train.loop import build_model_for_dataset

B = 5
SCALES = (1.0, 1.3)
F32 = dict(rtol=1e-5, atol=1e-6)
DYN = dict(rtol=0.0, atol=1e-4)
WRENCH = K.OutputDataKeys.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME
COPS = K.OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME
LC = dict(predict_grf_components=(1,))      # analyze's default loss


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scaled_skeleton(k: float):
    sk = standard_skeleton()
    for b in sk.bodies:
        b.mass *= k
        b.com = [c * k for c in b.com]
        b.inertia = [i * k ** 3 for i in b.inertia]
    for j in sk.joints:
        j.translation = [c * k for c in j.translation]
    return sk


@pytest.fixture(scope='module')
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_analytical')
    dev = root / 'data' / 'dev'
    os.makedirs(dev)
    os.makedirs(root / 'data' / 'train')          # no windows: skipped
    for i, k in enumerate(SCALES):
        write_subject(str(dev / f's{i}.b3d'), num_dofs=23,
                      ground_force_bodies=list(CONTACT_BODIES), root_history_len=10,
                      trials=[synthetic_trial('walk', 56, rng=np.random.default_rng(i))],
                      skeleton=_scaled_skeleton(k), mass_kg=70.0 * k)
    kw = dict(window_size=50, stride=5)
    ds, jds = WindowDataset(str(dev), **kw), JaxWindowDataset(str(dev), **kw)
    assert len(ds) == 2 * B and len(jds.skeletons) == 2
    return {'root': root, 'data': str(root / 'data'), 'ds': ds, 'jds': jds,
            'jax_predict': jax_analytical_fn(jds), 'jax_tau': jax_tau_report_fn(jds),
            'batches': [ds.gather(np.arange(k * B, (k + 1) * B)) for k in range(2)],
            # both subjects in one batch: per-item masses and skeletons
            'mixed': ds.gather(np.array([0, 5, 1, 6, 2]))}


def held(name, port, jax_value, f64, rtol, atol, keep=None):
    """``port`` and ``jax_value`` agree, and each agrees with the port's
    float64 evaluation ``f64`` (atol relative to max|f64|), on the frames
    ``keep`` (all when None)."""
    arrays = [np.asarray(a, np.float64) for a in (port, jax_value, f64)]
    if keep is not None:
        arrays = [a[keep] for a in arrays]
    port, jax_value, f64 = arrays
    tol = dict(rtol=rtol, atol=atol * max(float(np.abs(f64).max()), 1e-30))
    for side, v in (('port', port), ('jax', jax_value)):
        np.testing.assert_allclose(v, f64, **tol, err_msg=f'{name}: {side} against float64')
    np.testing.assert_allclose(port, jax_value, **tol, err_msg=f'{name}: port against jax')


def test_analytical_fn_matches_jax(ws):
    ds, jds = ws['ds'], ws['jds']
    ports = {dt: make_analytical_fn(ds, 'cpu', dt) for dt in (torch.float32, torch.float64)}
    assert ports[torch.float32].skeletons.param_stack is not None
    near = contact = frames = 0
    for b in ws['batches'] + [ws['mixed']]:
        want = ws['jax_predict'](b.inputs, b.subject_indices)
        got, f64 = (ports[dt](torch.from_numpy(b.inputs), b.subject_indices)
                    for dt in (torch.float32, torch.float64))
        # contact flags from each side's own FK heights, each subject's skeleton
        jsk = [jax_compile_skeleton(s) for s in jds.skeletons]
        tsk = [compile_skeleton(s) for s in ds.skeletons]
        o, w = ds.in_offsets[K.InputDataKeys.POS]
        cbi = [tsk[0].body_index[c] for c in ds.contact_bodies]
        h_jax = np.concatenate([
            np.asarray(jax.vmap(jsk[s].fk)(jnp.asarray(b.inputs[i, :, o:o + w]))[1])[:, cbi, 1]
            for i, s in enumerate(b.subject_indices)])
        h_port = np.stack([tsk[s].fk(torch.from_numpy(b.inputs[i, :, o:o + w]))[1][:, cbi, 1]
                           .numpy() for i, s in enumerate(b.subject_indices)]).reshape(-1, 2)
        close = (np.abs(h_port - CONTACT_HEIGHT_THRESHOLD) < 1e-6).any(-1)
        near += int(close.sum())
        contact, frames = contact + int((h_port < 0.1).sum()), frames + h_port.size
        np.testing.assert_array_equal((h_port < 0.1)[~close], (h_jax < 0.1)[~close])
        keep = ~close.reshape(B, 10)
        for key, v in want.items():
            assert got[key].shape == v.shape, key
            held(key, got[key].numpy(), np.asarray(v), f64[key].numpy(),
                 **(F32 if key == COPS else DYN), keep=keep)
    print(f'frames within 1e-6 m of the contact threshold, left out: {near}')
    assert 0 < contact < frames       # both sides of the threshold are held


def test_per_subject_rows_match_each_subjects_own_skeleton(ws):
    """The stack's row a window gives what the window's subject's own
    skeleton gives through ``analytical_forward``."""
    ds = ws['ds']
    predict = make_analytical_fn(ds, 'cpu')
    b = ws['mixed']
    got = predict(torch.from_numpy(b.inputs), b.subject_indices)
    x = torch.from_numpy(b.inputs)
    for i, s in enumerate(b.subject_indices):
        sk = compile_skeleton(ds.skeletons[s])
        want = analytical_forward(sk, [sk.body_index[c] for c in ds.contact_bodies],
                                  *kinematics(ds, x[i]))
        for key, v in want.items():
            np.testing.assert_allclose(got[key][i].numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-6 * float(v.abs().max()), err_msg=key)
    # the two subjects' skeletons give other answers for the same window
    same = np.repeat(b.inputs[:1], 2, axis=0)
    two = predict(torch.from_numpy(same), np.array([0, 1]))
    assert any(not torch.allclose(v[0], v[1]) for v in two.values())


def test_tau_report_matches_jax_with_per_item_masses(ws):
    ds = ws['ds']
    b = ws['mixed']
    jout = ws['jax_predict'](b.inputs, b.subject_indices)
    wrenches = np.asarray(jout[WRENCH])[:, -1:]
    labels = ds.unpack_labels(b.labels)
    outputs = {WRENCH: wrenches}
    ports = {dt: make_tau_report_fn(ds, 'cpu', dt) for dt in (torch.float32, torch.float64)}
    for sidx in (b.subject_indices, None):
        want = ws['jax_tau'](b.inputs, {WRENCH: jnp.asarray(wrenches)},
                             {k: jnp.asarray(v) for k, v in labels.items()}, sidx)
        got, f64 = (ports[dt](b.inputs, outputs, labels, sidx) for dt in ports)
        held(f'tau report, subject indices {sidx}', got, want, f64, **DYN)
    # per-item masses and skeletons: the same windows scored as other subjects differ
    assert ports[torch.float32](b.inputs, outputs, labels, np.zeros(B, np.int32)) != got
    errors = []
    for fn in (ports[torch.float32], ws['jax_tau']):
        with pytest.raises(IndexError) as e:
            fn(b.inputs, outputs, labels, np.array([0, 1, 2, 0, 1]))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


class _Recorder:
    def __init__(self):
        self.logged = []

    def log(self, d):
        self.logged.append(d)


def test_evaluator_reports_the_torque_term_like_jax(ws):
    ds = ws['ds']
    port_predict = make_analytical_fn(ds, 'cpu')
    sides = {}
    for side in ('jax', 'port'):
        rec = _Recorder()
        if side == 'jax':
            ev = JaxEvaluator('dev', JaxLossConfig(**LC), tau_fn=ws['jax_tau'], wandb_logger=rec)
        else:
            ev = RegressionLossEvaluator('dev', LossConfig(**LC),
                                         tau_fn=make_tau_report_fn(ds, 'cpu'), wandb_logger=rec)
        for b in ws['batches']:
            if side == 'jax':
                out = {k: v[:, -1:] for k, v in ws['jax_predict'](b.inputs,
                                                                  b.subject_indices).items()}
                lab = {k: jnp.asarray(v) for k, v in ds.unpack_labels(b.labels).items()}
                x = jnp.asarray(b.inputs)
            else:
                x = torch.from_numpy(b.inputs)
                out = {k: v[:, -1:] for k, v in port_predict(x, b.subject_indices).items()}
                lab = ds.unpack_labels(torch.from_numpy(b.labels))
            ev(x, out, lab, b.subject_indices, compute_report=True)
        assert len(ev.tau_reported_metrics) == 2
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            summary = ev.print_report(log_to_wandb=True)
        sides[side] = (summary, printed.getvalue().splitlines(), rec.logged[0])
        assert ev.tau_reported_metrics == []
    (js, jlines, jlog), (ts, tlines, tlog) = sides['jax'], sides['port']
    assert list(ts) == list(js) and 'tau_avg_err' in ts
    assert [ln.split(':')[0] for ln in tlines] == [ln.split(':')[0] for ln in jlines]
    assert tlines[-1].startswith('\tNon-root Joint Torques (Inverse Dynamics) Avg Err: ')
    assert tlines[-1].endswith(' Nm / kg')
    assert list(tlog) == list(jlog)
    key = 'dev/reports/Non-root Joint Torques (Inverse Dynamics) Avg Err (Nm per kg)'
    assert tlog[key] == ts['tau_avg_err']
    for k in js:
        assert ts[k] == pytest.approx(js[k], rel=1e-4, abs=1e-6), k


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _port_feedforward_checkpoint(ws, ds):
    cfg = config_from_args(build_parser().parse_args(['train']))
    model = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(3))
    d = ws['root'] / 'ff' / 'feedforward'
    if not d.exists():
        save_checkpoint(str(d), model, 0, 0)
    return model.eval()


@pytest.mark.parametrize('case', ['analytical', 'analytical-report', 'feedforward-report'])
def test_analyze_rows_and_reports_match_jax(ws, case, capsys):
    """``analyze`` of the port, its rows and report against the JAX
    package's ``make_analytical_fn`` / ``make_tau_report_fn`` and evaluator
    on the same batches (for feedforward, on the port model's outputs)."""
    ds, jds = ws['ds'], ws['jds']
    model_type = case.split('-')[0]
    report = case.endswith('report')
    ckpt = ws['root'] / ('ff' if model_type == 'feedforward' else case)
    model = _port_feedforward_checkpoint(ws, ds) if model_type == 'feedforward' else None
    argv = ['analyze', '--dataset-home', ws['data'], '--checkpoint-dir', str(ckpt),
            '--no-wandb', '--model-type', model_type, '--batch-size', str(B),
            '--device', 'cpu'] + (['--compute-report'] if report else [])
    results = analyze(build_parser().parse_args(argv))
    assert 'train' not in results and results['dev']['windows'] == 2 * B
    summary = results['dev']['summary']
    assert ('tau_avg_err' in summary) == report
    jev = JaxEvaluator('dev', JaxLossConfig(**LC), tau_fn=ws['jax_tau'])
    rows = []
    for b in ds.batches(B, shuffle=False, drop_last=False):
        if model is None:
            out = {k: np.asarray(v)[:, -1:]
                   for k, v in ws['jax_predict'](b.inputs, b.subject_indices).items()}
        else:
            with torch.no_grad():
                out = {k: v.numpy() for k, v in model(torch.from_numpy(b.inputs)).items()}
        lab = {k: jnp.asarray(v) for k, v in jds.unpack_labels(b.labels).items()}
        out = {k: jnp.asarray(v) for k, v in out.items()}
        m = jev.compute_metrics(out, lab)
        jev(jnp.asarray(b.inputs), out, lab, b.subject_indices, compute_report=report,
            precomputed_metrics=m)
        rows += [[float(m['loss']), float(m['force_avg_err']), float(m['com_acc_avg_err'])]] * B
    want = jev.print_report()
    for k, v in want.items():
        assert summary[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    got = np.asarray([r[2:] for r in _rows(str(ckpt / model_type / 'dev_analysis.csv'))],
                     np.float64)
    want_rows = np.asarray(rows)
    np.testing.assert_allclose(got, want_rows, rtol=0,
                               atol=1e-4 * float(np.abs(want_rows).max()))
    if report:
        assert 'Non-root Joint Torques (Inverse Dynamics) Avg Err' in capsys.readouterr().out


def test_analytical_has_no_model_and_refuses_what_jax_refuses(ws, tmp_path):
    """``get_model('analytical')`` raises as the JAX ``get_model`` does; the
    analytical baseline has no ensemble and no test-time mirroring."""
    from inferbiomechanics_tpu.models import get_model as jax_get_model
    kw = dict(num_dofs=23, num_contact_bodies=2, history_len=50, stride=5,
              root_history_len=10)
    errors = []
    for fn in (get_model, jax_get_model):
        with pytest.raises(ValueError) as e:
            fn('analytical', **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    base = ['analyze', '--dataset-home', ws['data'], '--checkpoint-dir', str(tmp_path),
            '--no-wandb', '--device', 'cpu', '--model-type', 'analytical']
    with pytest.raises(SystemExit, match='--tta-mirror supports the learned-model eval paths'):
        main(base + ['--tta-mirror'])
    with pytest.raises(SystemExit, match='analyze --ensemble supports learned regression'):
        main(base + ['--ensemble', str(tmp_path)])


def test_skeleton_approximations_are_logged_once_a_split(ws, tmp_path, caplog):
    """A fidelity warning of a subject's skeleton is logged, in the JAX
    command's words, when the analytical baseline or the report reads it."""
    ds = ws['ds']
    noted = copy.deepcopy(ds.skeletons)
    noted[0].fidelity_warnings.append('knee: an approximation')
    orig = WindowDataset.__init__

    def with_warning(self, *a, **k):
        orig(self, *a, **k)
        if self.skeletons:
            self.skeletons = copy.deepcopy(noted)

    import logging
    caplog.set_level(logging.WARNING)
    mp = pytest.MonkeyPatch()
    mp.setattr(WindowDataset, '__init__', with_warning)
    try:
        argv = ['analyze', '--dataset-home', ws['data'], '--checkpoint-dir', str(tmp_path),
                '--no-wandb', '--device', 'cpu', '--model-type', 'analytical',
                '--batch-size', str(2 * B)]
        analyze(build_parser().parse_args(argv))
    finally:
        mp.undo()
    assert [r.getMessage() for r in caplog.records if 'skeleton approximation' in r.getMessage()
            ] == ['skeleton approximation (may bias the tau report / analytical baseline): '
                  'knee: an approximation']
