"""The port's ``Predictor`` (inferbiomechanics_tpu_torch/inference.py) and
``save-prediction-csv`` command against the JAX package's
(inferbiomechanics_tpu/inference.py, cli/save_prediction_csv_cmd.py), in this
process on the CPU.

One synthetic subject (two 120-frame trials at window 20 / stride 5) and,
for each case, seeded flax weights (biases moved off zero) in one checkpoint
directory: the JAX package's ``.ckpt`` and the port's ``.torch.pt`` of the
same weights converted by ``weights.py``. Cases: feedforward (K1's plain
version here), feedforward with ``--tta-mirror``, GroundLink with
``--tta-mirror`` (K4's) and the ``vpu`` transformer with
``--fused-inference`` (d_model 128: K2's, where the JAX package runs its
plain layer on the CPU).

- ``predict_trial`` (in batches of 7, so that a trial spans several) and
  ``predict_windows``: outputs and labels within 2e-2 x the output's largest
  value (bf16 compute on both sides; GroundLink 5e-2 x the largest value of
  its head vector, the JAX suite's own GroundLink tolerance), the labels
  exactly;
- per-window losses: the port's are the JAX package's per-window loss of
  the port's own outputs (``vmap`` of ``loss_and_metrics`` over single
  windows) within rtol 1e-4 / atol 1e-5, and the JAX Predictor's within the
  output tolerance;
- ``save-prediction-csv``: the CSV rows against the JAX command's, as
  numbers. The forces and CoPs before the force-share rule are held at the
  output tolerance, and the rule's decision wherever no share lies within
  that tolerance of 0.3; a row with a share that near 0.3 is held on its CoP
  columns only (0 of the 99 rows of the feedforward case, 19 of 99 of the
  GroundLink case, whose band is 5e-2 wide).
"""

import argparse
import contextlib
import csv
import io
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.cli.save_prediction_csv_cmd import SavePredictionCsvCommand
from inferbiomechanics_tpu.config import add_config_flags as jax_add_config_flags
from inferbiomechanics_tpu.config import config_from_args as jax_config_from_args
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu.inference import Predictor as JaxPredictor
from inferbiomechanics_tpu.loss import loss_and_metrics as jax_loss_and_metrics
from inferbiomechanics_tpu.train import create_train_state, make_optimizer
from inferbiomechanics_tpu.train.checkpoint import save_checkpoint as jax_save
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu.train.loop import loss_config_from as jax_loss_config_from
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.__main__ import build_parser, main
from inferbiomechanics_tpu_torch.config import config_from_args
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.inference import Predictor
from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg
from inferbiomechanics_tpu_torch.ops import fused_mlp as fm
from inferbiomechanics_tpu_torch.train.checkpoint import save_checkpoint
from inferbiomechanics_tpu_torch.train.loop import build_model_for_dataset

BASE = ['--history-len', '20', '--hidden-dims', '32', '48']
# case -> (flags, --tta-mirror, converter, tolerance on the head vector)
CASES = {
    'feedforward': ([], False, weights.feedforward_state_dict_from_jax, 2e-2),
    'feedforward tta': ([], True, weights.feedforward_state_dict_from_jax, 2e-2),
    'groundlink tta': (['--model-type', 'groundlink'], True,
                       weights.groundlink_state_dict_from_jax, 5e-2),
    'vpu fused': (['--model-type', 'transformer', '--d-model', '128', '--num-layers', '1',
                   '--num-heads', '4', '--fused-inference'], False,
                  weights.transformer_state_dict_from_jax, 2e-2),
}
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
BATCH = 7


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_inference')
    path = str(root / 's0.b3d')
    write_synthetic_subject(path, num_trials=2, trial_length=120, seed=0)
    kw = dict(window_size=20, stride=5, skip_loading_skeletons=True)
    return dict(root=root, file=path, ds=WindowDataset(path, **kw),
                jds=JaxWindowDataset(path, **kw))


def _configs(flags):
    parser = argparse.ArgumentParser(allow_abbrev=False)
    jax_add_config_flags(parser)
    jcfg = jax_config_from_args(parser.parse_args([*BASE, *flags]))
    return jcfg, config_from_args(build_parser().parse_args(['train', *BASE, *flags]))


@pytest.fixture(scope='module')
def pairs(data):
    """case -> (JAX config, port config, checkpoint dir holding both files)."""
    out = {}
    for case, (flags, _, converter, _) in CASES.items():
        jcfg, cfg = _configs(flags)
        jmodel = jax_build(jcfg, data['jds'])
        state = create_train_state(jmodel, jax.random.PRNGKey(0),
                                   jnp.asarray(data['jds'].gather(np.arange(4)).inputs),
                                   make_optimizer(jcfg.opt_type, jcfg.learning_rate))
        rng = np.random.default_rng(1)
        params = jax.tree_util.tree_map(
            lambda p: (np.asarray(p) + (0.1 * rng.normal(size=p.shape) if p.ndim == 1 else 0)
                       ).astype(np.float32), jax.device_get(state.params))
        root = data['root'] / case.replace(' ', '_')
        ckpt = str(root / jcfg.model_type)
        jax_save(ckpt, state.replace(params=params), 4, 2)
        model = build_model_for_dataset(cfg, data['ds'])
        model.load_state_dict(converter(params))
        save_checkpoint(ckpt, model, 4, 2)
        out[case] = (jcfg, cfg, ckpt, root)
    return out


def _limit(rel, want, k):
    """The tolerance on output ``k``: ``rel`` x its largest value, or, at
    GroundLink's 5e-2, x the largest value of the whole head vector."""
    values = want.values() if rel > 2e-2 else [want[k]]
    return rel * max(max(float(np.abs(np.asarray(v)).max()) for v in values), 1e-6)


def _close(got, want, rel, what):
    assert set(got) == set(want), what
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, (what, k)
        err = float(np.abs(got[k] - np.asarray(want[k])).max())
        assert err <= _limit(rel, want, k), (what, k, err)


def _jax_per_window_loss(jcfg, outputs, labels):
    lc = jax_loss_config_from(jcfg)

    def one(o, lab):
        return jax_loss_and_metrics({k: v[None] for k, v in o.items()},
                                    {k: v[None] for k, v in lab.items()}, lc)[0]
    return np.asarray(jax.jit(jax.vmap(one))(
        {k: jnp.asarray(v) for k, v in outputs.items()},
        {k: jnp.asarray(v) for k, v in labels.items()}))


@pytest.mark.parametrize('case', list(CASES))
def test_predictor_matches_the_jax_predictor(data, pairs, case):
    _, tta, _, rel = CASES[case]
    jcfg, cfg, ckpt, _ = pairs[case]
    jp = JaxPredictor(jcfg, ckpt, data['jds'], tta_mirror=tta)
    counts = (fm.launches, fe.launches, fg.launches)
    p = Predictor(cfg, ckpt, data['ds'], tta_mirror=tta, device='cpu')
    assert (p.epoch, p.batch) == (jp.epoch, jp.batch) == (4, 2)
    for trial in (0, 1):
        got = p.predict_trial(0, trial, batch_size=BATCH)
        want = jp.predict_trial(0, trial, batch_size=BATCH)
        assert got.window_starts.size > BATCH
        np.testing.assert_array_equal(got.window_starts, want.window_starts)
        np.testing.assert_array_equal(got.last_frame, want.last_frame)
        _close(got.outputs, want.outputs, rel, f'{case} trial {trial} outputs')
        assert set(got.labels) == set(want.labels)
        for k in want.labels:
            np.testing.assert_array_equal(got.labels[k], np.asarray(want.labels[k]), err_msg=k)
        np.testing.assert_allclose(
            got.per_window_loss, _jax_per_window_loss(jcfg, got.outputs, got.labels),
            err_msg=case, **LOSS_TOL)
        scale = float(np.abs(want.per_window_loss).max())
        assert np.abs(got.per_window_loss - want.per_window_loss).max() <= 5 * rel * scale
    idx = np.array([3, 40, 11])
    (o, lab, pw), (jo, jlab, jpw) = p.predict_windows(idx), jp.predict_windows(idx)
    _close(o, jo, rel, f'{case} predict_windows')
    assert all(np.array_equal(lab[k], np.asarray(jlab[k])) for k in jlab)
    np.testing.assert_allclose(pw, _jax_per_window_loss(jcfg, o, lab), **LOSS_TOL)
    assert p.predict_trial(0, 7) is None and jp.predict_trial(0, 7) is None
    assert (fm.launches, fe.launches, fg.launches) == counts     # plain versions on the CPU


def test_fused_inference_ignored_in_the_jax_words(data, pairs, caplog):
    _, cfg, ckpt, _ = pairs['feedforward']
    cfg.fused_inference = True
    try:
        with caplog.at_level(logging.WARNING):
            Predictor(cfg, ckpt, data['ds'], device='cpu')
    finally:
        cfg.fused_inference = False
    assert ('--fused-inference ignored: needs a vpu transformer with d_model a '
            'multiple of 128') in caplog.text


def _csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], float)


@pytest.mark.parametrize('case', ['feedforward', 'groundlink tta'])
def test_save_prediction_csv_matches_the_jax_command(data, pairs, case, tmp_path):
    flags, tta, _, rel = CASES[case]
    jcfg, cfg, ckpt, root = pairs[case]
    argv = ['save-prediction-csv', '--file', data['file'], '--trial', '1',
            '--checkpoint-dir', str(root), *BASE, *flags, *(['--tta-mirror'] if tta else [])]
    parser = argparse.ArgumentParser()
    SavePredictionCsvCommand().register_subcommand(parser.add_subparsers(dest='command'))
    with contextlib.redirect_stdout(io.StringIO()):
        assert SavePredictionCsvCommand().run(parser.parse_args(
            argv + ['--out', str(tmp_path / 'jax.csv')]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv + ['--out', str(tmp_path / 'port.csv'), '--device', 'cpu']) == 0
    header, got = _csv(tmp_path / 'port.csv')
    jheader, want = _csv(tmp_path / 'jax.csv')
    assert header == jheader and got.shape == want.shape and got.shape[0] > 0
    assert f'({got.shape[0]} rows)' in out.getvalue()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])

    # the forces and CoPs before the rule, and the rule's decisions
    pred = Predictor(cfg, ckpt, data['ds'], tta_mirror=tta, device='cpu').predict_trial(0, 1)
    jpred = JaxPredictor(jcfg, ckpt, data['jds'], tta_mirror=tta).predict_trial(0, 1)
    key_f, key_c = 'groundContactForceInRootFrame', 'groundContactCenterOfPressureInRootFrame'
    _close({k: pred.outputs[k] for k in (key_f, key_c)},
           {k: jpred.outputs[k] for k in (key_f, key_c)}, rel, case)

    def shares(outputs):
        f = np.asarray(outputs[key_f])[:, -1, :].reshape(-1, 2, 3)
        mags = np.linalg.norm(f, axis=-1)
        return mags / (mags.sum(axis=1, keepdims=True) + 1e-9)

    s, js = shares(pred.outputs), shares(jpred.outputs)
    near = (np.abs(s - 0.3) <= rel).any(1) | (np.abs(js - 0.3) <= rel).any(1)
    np.testing.assert_array_equal((s > 0.3)[~near], (js > 0.3)[~near])
    # each body's CoP columns within the CoPs' tolerance, its arrow tip
    # (CoP + 0.001 F mass) within that plus 0.001 mass x the forces'; the
    # rows near a tie on their CoP columns only
    mass = data['ds'].subjects[0].getMassKg()
    lim_c, lim_f = (_limit(rel, jpred.outputs, k) for k in (key_c, key_f))
    limit = np.tile([lim_c] * 3 + [lim_c + 1e-3 * mass * lim_f] * 3, 2) + 1e-6
    err = np.abs(got[:, 1:] - want[:, 1:])
    assert (err[~near] <= limit).all(), err.max(axis=0) / limit
    cop_cols = np.tile([True] * 3 + [False] * 3, 2)
    assert (err[near][:, cop_cols] <= limit[cop_cols]).all()
    print(f'{case}: {int(near.sum())} of {near.size} rows near the 0.3 tie')
