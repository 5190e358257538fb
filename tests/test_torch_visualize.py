"""The port's viewer commands (``visualize-file``, ``visualize``,
``review-file``) and their model-side layer (``viz/live_model.py``) against
the JAX package's, in this process on the CPU.

One synthetic subject with the standard skeleton (two 120-frame trials at
window 20 / stride 5: 99 windows a trial), a temporary Geometry folder with
small OBJ meshes for the pelvis, femurs, tibias and calcanei (so that FK
poses bodies), and for each model (feedforward; GroundLink; the ``pallas``
transformer, whose layers run their plain versions on both sides here)
seeded flax weights with the biases moved off zero, saved as the JAX
package's ``.ckpt`` and, converted by ``weights.py``, as the port's
``.torch.pt``.

Tolerances:
- the trial's data (joints, label forces, root velocity and history,
  missing flags) exactly: both sides read the same file;
- FK-posed bodies, which both sides round to 4 decimals: as numbers, within
  atol 1.5e-4 (a float32 value that differs in its last bits may round to
  the neighbouring 4th decimal);
- predictions: 2e-2 x the largest value of that output over the trial
  (bf16 compute on both sides); GroundLink 5e-2 x the largest force or CoP,
  the JAX suite's own GroundLink tolerance;
- the static payload's 0.3 rule: where a body's force share lies within the
  prediction tolerance of 0.3 on either side, the frame is held on its CoPs
  only (the count is printed), as for ``save-prediction-csv``;
- the live viewer's predicted CoP, averaged with the foot's FK position:
  the prediction tolerance plus 1e-5; its running loss within 2e-2 x the
  largest per-window loss;
- ``review-file``: every window's loss within 2e-2 relative (5e-2 for
  GroundLink) of the JAX Predictor's; a window whose loss lies within that
  tolerance of ``threshold_ratio`` x the trial mean may be suspicious on
  one side only, so the rows are compared as the segments of the windows
  away from that band (their count is printed); the mean losses of the
  segments both sides found within the same tolerance.

No test reaches ``urlretrieve``: it is replaced by one that raises.
"""

import argparse
import contextlib
import csv
import io
import json
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.cli import review_file_cmd as jax_review
from inferbiomechanics_tpu.cli import visualize_file_cmd as jax_vf
from inferbiomechanics_tpu.config import add_config_flags as jax_add_config_flags
from inferbiomechanics_tpu.config import config_from_args as jax_config_from_args
from inferbiomechanics_tpu.data.b3d import write_subject as jax_write_subject
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.data.synthetic import CONTACT_BODIES as JAX_CONTACT_BODIES
from inferbiomechanics_tpu.data.synthetic import standard_skeleton as jax_standard_skeleton
from inferbiomechanics_tpu.data.synthetic import synthetic_trial as jax_synthetic_trial
from inferbiomechanics_tpu.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu import inference as jax_inference
from inferbiomechanics_tpu.inference import Predictor as JaxPredictor
from inferbiomechanics_tpu.loss.evaluator import RegressionLossEvaluator as JaxEvaluator
from inferbiomechanics_tpu.train.checkpoint import save_checkpoint as jax_save
from inferbiomechanics_tpu.train.loop import loss_config_from as jax_loss_config_from
from inferbiomechanics_tpu.viz import live_model as jax_live_model
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.__main__ import build_parser, main
from inferbiomechanics_tpu_torch.cli import review_file_cmd, visualize_file_cmd
from inferbiomechanics_tpu_torch.config import config_from_args
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.inference import Predictor
from inferbiomechanics_tpu_torch.loss.evaluator import RegressionLossEvaluator
from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg
from inferbiomechanics_tpu_torch.ops import fused_mlp as fm
from inferbiomechanics_tpu_torch.train.checkpoint import save_checkpoint
from inferbiomechanics_tpu_torch.train.loop import build_model_for_dataset
from inferbiomechanics_tpu_torch.train.loop import loss_config_from
from inferbiomechanics_tpu_torch.utils import geometry
from inferbiomechanics_tpu_torch.viz import live, live_model

BASE = ['--history-len', '20', '--hidden-dims', '32', '48']
# case -> (flags, converter, tolerance on the predictions)
CASES = {
    'feedforward': ([], weights.feedforward_state_dict_from_jax, 2e-2),
    'groundlink': (['--model-type', 'groundlink'], weights.groundlink_state_dict_from_jax,
                   5e-2),
    'pallas': (['--model-type', 'transformer', '--attn-impl', 'pallas', '--d-model', '128',
                '--num-layers', '1', '--num-heads', '4'],
               weights.transformer_pallas_state_dict_from_jax, 2e-2),
}
FK_ATOL = 1.5e-4
TICKS = 6
OBJ = """v 0 0 0
v 0.1 0 0
v 0 0.1 0
v 0 0 0.1
f 1 2 3
f 1 2 4
f 1/1 3/2 4/3
f 2 3 4
"""


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module', autouse=True)
def _jitted_jax_init():
    """The JAX Predictor's flax init (a seeded draw that the weights start
    from) as one compiled program instead of op by op."""
    original = jax_inference.create_train_state

    def create(model, rng, sample, tx):
        init = jax.jit(lambda variables, x: model.init(variables, x, train=False))
        proxy = SimpleNamespace(init=lambda variables, x, train: init(variables, x),
                                apply=model.apply)
        return original(proxy, rng, sample, tx)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_inference, 'create_train_state', create)
        yield


@pytest.fixture(autouse=True)
def _no_download(monkeypatch):
    def refuse(*a, **kw):
        raise OSError('no network in tests')
    monkeypatch.setattr(urllib.request, 'urlretrieve', refuse)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_visualize')
    path = str(root / 's0.b3d')
    write_synthetic_subject(path, num_trials=2, trial_length=120, seed=0)
    geom = root / 'Geometry'
    geom.mkdir()
    for name in ('pelvis', 'femur', 'tibia', 'calcn'):
        (geom / f'{name}.obj').write_text(OBJ)
    kw = dict(window_size=20, stride=5, skip_loading_skeletons=True)
    return dict(root=root, file=path, geom=str(geom), ds=WindowDataset(path, **kw),
                jds=JaxWindowDataset(path, **kw))


def _configs(flags):
    parser = argparse.ArgumentParser(allow_abbrev=False)
    jax_add_config_flags(parser)
    jcfg = jax_config_from_args(parser.parse_args([*BASE, *flags]))
    return jcfg, config_from_args(build_parser().parse_args(['train', *BASE, *flags]))


@pytest.fixture(scope='module')
def pairs(data):
    """case -> dict of both configs, the checkpoint root, and one Predictor a
    side (each JAX Predictor compiles once a batch shape). The JAX
    Predictor's own seeded init, biases moved off zero, is the weights."""
    out = {}
    for case, (flags, converter, _) in CASES.items():
        jcfg, cfg = _configs(flags)
        root = data['root'] / case
        ckpt = str(root / jcfg.model_type)
        jp = JaxPredictor(jcfg, ckpt, data['jds'])       # no checkpoint yet: its init
        rng = np.random.default_rng(1)
        params = jax.tree_util.tree_map(
            lambda p: (np.asarray(p) + (0.1 * rng.normal(size=p.shape) if p.ndim == 1 else 0)
                       ).astype(np.float32), jax.device_get(jp.state.params))
        jp.state = jp.state.replace(params=params)
        jax_save(ckpt, jp.state, 4, 2)
        model = build_model_for_dataset(cfg, data['ds'])
        model.load_state_dict(converter(params))
        save_checkpoint(ckpt, model, 4, 2)
        out[case] = dict(jcfg=jcfg, cfg=cfg, root=root, ckpt=ckpt, jp=jp,
                         p=Predictor(cfg, ckpt, data['ds'], device='cpu'))
    return out


def _counts():
    return (fm.launches, fe.launches, fg.launches)


def _bodies_close(got, want, what):
    assert set(got) == set(want) and got, what
    for name in want:
        for k in ('R', 'p'):
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=0, atol=FK_ATOL,
                                       err_msg=f'{what} {name} {k}')


def _shares(forces):
    f = np.asarray(forces).reshape(len(forces), -1, 3)
    mags = np.linalg.norm(f, axis=-1)
    return mags / (mags.sum(axis=1, keepdims=True) + 1e-9)


def _limits(rel, frames, key):
    """(CoP, force) tolerance: ``rel`` x each one's largest value over the
    trial; at GroundLink's 5e-2 x the larger of the two."""
    cops = np.array([[c for c, _ in fr[key]] for fr in frames if key in fr])
    forces = np.array([[f for _, f in fr[key]] for fr in frames if key in fr])
    lim = [rel * max(float(np.abs(a).max()), 1e-6) for a in (cops, forces)]
    return [max(lim)] * 2 if rel > 2e-2 else lim


def _hold_payload(got, want, rel, shares, what):
    """Hold the port's viewer payload to the JAX package's (see the module
    docstring); returns the number of frames near the 0.3 rule's tie."""
    assert got['dt'] == want['dt'] and len(got['frames']) == len(want['frames'])
    assert got['meshes'] == want['meshes'] and set(got['meshes']) == {
        'pelvis', 'femur_r', 'femur_l', 'tibia_r', 'tibia_l', 'calcn_r', 'calcn_l'}
    lim_c, lim_f = _limits(rel, want['frames'], 'pred_forces')
    near_frames = {int(fr) for fr, s, js in zip(*shares)
                   if (np.abs(s - 0.3) <= rel).any() or (np.abs(js - 0.3) <= rel).any()}
    n_pred = 0
    for i, (g, w) in enumerate(zip(got['frames'], want['frames'])):
        for k in ('joints', 'bones', 'label_forces', 'missing_grf', 'root_vel',
                  'root_history'):
            assert g[k] == w[k], (what, i, k)
        _bodies_close(g['bodies'], w['bodies'], f'{what} frame {i}')
        assert ('pred_forces' in g) == ('pred_forces' in w), (what, i)
        if 'pred_forces' not in w:
            continue
        n_pred += 1
        gc, gf = (np.array([x[j] for x in g['pred_forces']]) for j in (0, 1))
        wc, wf = (np.array([x[j] for x in w['pred_forces']]) for j in (0, 1))
        assert np.abs(gc - wc).max() <= lim_c, (what, i, gc, wc)
        if i not in near_frames:
            assert ((gf == 0) == (wf == 0)).all(), (what, i, gf, wf)
            assert np.abs(gf - wf).max() <= lim_f, (what, i, gf, wf)
    assert n_pred == len(shares[0]) > 0
    return len(near_frames)


@pytest.mark.parametrize('case', list(CASES))
def test_viz_payload_matches_the_jax_payload(data, pairs, case):
    rel = CASES[case][2]
    pr = pairs[case]
    before = _counts()
    got = visualize_file_cmd.build_viz_payload(data['ds'], 0, 1, pr['p'],
                                               geometry_folder=data['geom'])
    want = jax_vf.build_viz_payload(data['jds'], 0, 1, pr['jp'], geometry_folder=data['geom'])
    assert _counts() == before          # plain versions on the CPU
    pred, jpred = pr['p'].predict_trial(0, 1), pr['jp'].predict_trial(0, 1)
    key = 'groundContactForceInRootFrame'
    shares = (pred.last_frame, _shares(pred.outputs[key][:, -1]),
              _shares(np.asarray(jpred.outputs[key])[:, -1]))
    near = _hold_payload(got, want, rel, shares, case)
    print(f'{case}: {near} of {len(pred.last_frame)} predicted frames near the 0.3 tie')


def test_visualize_file_command_writes_the_payload(data, pairs, tmp_path, capsys):
    """The command's HTML carries ``build_viz_payload``'s frames; with
    ``--no-model`` none is predicted; ``--geometry-folder`` finds the
    meshes."""
    pr = pairs['feedforward']
    out = tmp_path / 'v.html'
    argv = ['visualize-file', '--file', data['file'], '--trial', '1', '--checkpoint-dir',
            str(pr['root']), '--geometry-folder', data['geom'], *BASE, '--device', 'cpu']
    assert main(argv + ['--out', str(out)]) == 0
    assert f'wrote viewer: {out}' in capsys.readouterr().out
    html = out.read_text()
    assert 'function P(v)' in html and 'DATA.meshes' in html
    payload = json.loads(html.split('const DATA = ', 1)[1].split(';\nconst cv', 1)[0])
    want = visualize_file_cmd.build_viz_payload(data['ds'], 0, 1, pr['p'],
                                                geometry_folder=data['geom'] + '/')
    assert payload == json.loads(json.dumps(want))
    assert main(argv + ['--out', str(out), '--no-model']) == 0
    frames = json.loads(out.read_text().split('const DATA = ', 1)[1].split(';\nconst cv')[0])
    assert not any('pred_forces' in f for f in frames['frames'])
    assert all('bodies' in f for f in frames['frames'])


def _ticks(session, n):
    out = []
    with contextlib.redirect_stdout(io.StringIO()):
        for _ in range(n):
            out.append(session.tick())
    return out


@pytest.mark.parametrize('case', list(CASES))
def test_live_session_packets_match_the_jax_session(data, pairs, case):
    """``visualize``'s live session (predictor and loss evaluator) a tick at a
    time: the same frames, data, bodies, predicted forces and running loss."""
    rel = CASES[case][2]
    pr = pairs[case]
    win = np.nonzero(data['ds'].win_trial == 1)[0]
    ev = RegressionLossEvaluator('dev', loss_config_from(pr['cfg']))
    jev = JaxEvaluator('dev', jax_loss_config_from(pr['jcfg']))
    before = _counts()
    session, init = live_model.build_live_session(
        data['ds'], pr['p'], ev, window_indices=win, geometry_folder=data['geom'],
        report_every=4)
    jsession, jinit = jax_live_model.build_live_session(
        data['jds'], pr['jp'], jev, window_indices=win, geometry_folder=data['geom'],
        report_every=4)
    assert init == jinit and session.num_frames == jsession.num_frames == win.size
    for s in (session, jsession):
        s.frame = 40
        s.key('e')
    got, want = _ticks(session, TICKS), _ticks(jsession, TICKS)
    assert _counts() == before
    assert [p['frame'] for p in got] == [p['frame'] for p in want] == list(range(41, 41 + TICKS))
    losses = pr['p'].predict_trial(0, 1).per_window_loss
    lim_c, lim_f = _limits(rel, want, 'pred_forces')
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ('joints', 'root_vel', 'root_history', 'subject', 'label_forces', 'type',
                  'total'):
            assert g[k] == w[k], (case, k)
        _bodies_close(g['bodies'], w['bodies'], case)
        gc, gf = (np.array([x[j] for x in g['pred_forces']]) for j in (0, 1))
        wc, wf = (np.array([x[j] for x in w['pred_forces']]) for j in (0, 1))
        assert np.abs(gc - wc).max() <= lim_c + 1e-5, (case, gc, wc)
        assert np.abs(gf - wf).max() <= lim_f, (case, gf, wf)
        loss, jloss = (float(p['hud'].split(': ')[1]) for p in (g, w))
        assert abs(loss - jloss) <= rel * float(np.abs(losses).max()) + 1e-4, (loss, jloss)


def _multi_subject_dir(root, skeletons):
    root.mkdir()
    for i, sk in enumerate(skeletons):
        rng = np.random.default_rng(i)
        jax_write_subject(str(root / f's{i}.b3d'), num_dofs=23,
                          ground_force_bodies=list(JAX_CONTACT_BODIES), root_history_len=10,
                          trials=[jax_synthetic_trial('t', 60, rng=rng)], skeleton=sk,
                          mass_kg=70.0)
    return str(root)


def test_live_session_multi_subject_skeletons(data, tmp_path, caplog):
    """Each window poses with its own subject's scaled skeleton (the
    per-subject parameter stack); a subject without a skeleton makes every
    window pose with subject 0's, with the JAX warning."""
    skeletons = []
    for leg_scale in (1.0, 1.3):
        sk = jax_standard_skeleton()
        for j in sk.joints:          # scale segment offsets -> FK differs
            j.translation = [t * leg_scale for t in j.translation]
        skeletons.append(sk)
    home = _multi_subject_dir(tmp_path / 'scaled', skeletons)
    kw = dict(window_size=20, stride=5, skip_loading_skeletons=True)
    ds, jds = WindowDataset(home, **kw), JaxWindowDataset(home, **kw)
    session, init = live_model.build_live_session(ds, geometry_folder=data['geom'],
                                                  device='cpu')
    jsession, jinit = jax_live_model.build_live_session(jds, geometry_folder=data['geom'])
    assert init == jinit and session.jump_points == jsession.jump_points
    frames = [0, session.jump_points[1], session.jump_points[1] + 3]
    got = [session.packet_for_frame(f) for f in frames]
    want = [jsession.packet_for_frame(f) for f in frames]
    for g, w in zip(got, want):
        assert g['subject'] == w['subject'] and g['joints'] == w['joints']
        assert 'pred_forces' not in g and 'pred_forces' not in w
        _bodies_close(g['bodies'], w['bodies'], f'subject {w["subject"]}')
    f0, f1 = (np.asarray(p['bodies']['femur_r']['p']) for p in got[:2])
    np.testing.assert_allclose(f1, f0 * 1.3, rtol=1e-3)

    home = _multi_subject_dir(tmp_path / 'one_without', [skeletons[1], None])
    ds, jds = WindowDataset(home, **kw), JaxWindowDataset(home, **kw)
    with caplog.at_level('WARNING'):
        session, _ = live_model.build_live_session(ds, geometry_folder=data['geom'],
                                                   device='cpu')
    assert ("per-subject skeleton posing unavailable (missing or structurally different "
            "skeletons); all windows pose with subject 0's skeleton") in caplog.text
    jsession, _ = jax_live_model.build_live_session(jds, geometry_folder=data['geom'])
    last = session.num_frames - 1
    g, w = session.packet_for_frame(last), jsession.packet_for_frame(last)
    assert g['subject'] == w['subject'] == 1
    _bodies_close(g['bodies'], w['bodies'], 'fallback to subject 0')


def _jax_run(command, argv):
    parser = argparse.ArgumentParser()
    command.register_subcommand(parser.add_subparsers(dest='command'))
    with contextlib.redirect_stdout(io.StringIO()):
        assert command.run(parser.parse_args(argv))


def _rows(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [(int(r[0]), int(r[1]), int(r[2]), r[3], float(r[4])) for r in rows[1:]]


@pytest.mark.parametrize('case', list(CASES))
def test_review_file_rows_match_the_jax_command(data, pairs, case, tmp_path):
    rel = CASES[case][2]
    pr = pairs[case]
    ratio = 1.25
    argv = ['review-file', '--file', data['file'], '--checkpoint-dir', str(pr['root']),
            '--threshold-ratio', str(ratio), *BASE, *CASES[case][0]]
    _jax_run(jax_review.ReviewFileCommand(), argv + ['--out-csv', str(tmp_path / 'jax.csv')])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv + ['--out-csv', str(tmp_path / 'port.csv'), '--device', 'cpu']) == 0
    assert f'wrote {tmp_path / "port.csv"}' in out.getvalue()
    header, got = _rows(tmp_path / 'port.csv')
    jheader, want = _rows(tmp_path / 'jax.csv')
    assert header == jheader == ['trial', 'segment_start', 'segment_end', 'state', 'mean_loss']
    assert want, 'no suspicious segment on the JAX side'

    # the segments of the windows away from the ratio x mean band
    expected, n_near = [], 0
    for trial in (0, 1):
        loss = pr['p'].predict_trial(0, trial).per_window_loss
        jpred = pr['jp'].predict_trial(0, trial)
        jloss = np.asarray(jpred.per_window_loss)
        np.testing.assert_allclose(loss, jloss, rtol=rel, atol=1e-6)
        near = ((np.abs(loss - ratio * loss.mean()) <= rel * ratio * loss.mean())
                | (np.abs(jloss - ratio * jloss.mean()) <= rel * ratio * jloss.mean()))
        n_near += int(near.sum())
        kept = ~near
        for rows, pw in ((got, loss), (want, jloss)):
            flags = np.zeros(pw.size, bool)
            for t, fs, fe_, _, _ in rows:
                if t == trial:
                    flags |= (jpred.last_frame >= fs) & (jpred.last_frame < fe_)
            expected.append(flags[kept])
        assert np.array_equal(expected[-2], expected[-1]), (case, trial)
    assert {r[3] for r in got} == {'WIP'}
    same = {r[:3] for r in got} & {r[:3] for r in want}
    assert same or n_near
    for key in same:
        g = next(r[4] for r in got if r[:3] == key)
        w = next(r[4] for r in want if r[:3] == key)
        assert abs(g - w) <= rel * abs(w) + 1e-6, (key, g, w)
    print(f'{case}: {len(got)} / {len(want)} segments, {n_near} windows near the '
          f'{ratio} x mean threshold')


def test_review_file_keeps_earlier_states(data, pairs, tmp_path):
    pr = pairs['feedforward']
    path = tmp_path / 'r.csv'
    argv = ['review-file', '--file', data['file'], '--checkpoint-dir', str(pr['root']),
            '--threshold-ratio', '1.25', '--out-csv', str(path), *BASE, '--device', 'cpu']
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(argv) == 0
    _, rows = _rows(path)
    assert rows
    lines = path.read_text().splitlines()
    first = lines[1].split(',')
    lines[1] = ','.join(first[:3] + ['BAD'] + first[4:])
    path.write_text('\n'.join(lines + ['not,a,row']) + '\n')
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(argv) == 0
    _, again = _rows(path)
    assert again[0][:4] == rows[0][:3] + ('BAD',) and again[1:] == rows[1:]


def test_segment_packets_match_the_jax_packets(data):
    """The segment loop's world-frame packets: joints, raw plate forces at
    1 / mass, missing flags, bodies posed from the last pass."""
    kw = dict(window_size=20, stride=5, geometry_folder=data['geom'])
    ds, jds = WindowDataset(data['file'], **kw), JaxWindowDataset(data['file'], **kw)
    packet, meshes = review_file_cmd.build_segment_packet_fn(ds, device='cpu')
    jpacket, jmeshes = jax_review.build_segment_packet_fn(jds)
    assert set(meshes) == set(jmeshes) and len(meshes) == 7
    for trial, frame in ((0, 0), (0, 57), (1, 119)):
        g, w = packet(trial, frame), jpacket(trial, frame)
        assert set(g) == set(w)
        for k in ('joints', 'label_forces', 'missing'):
            assert g[k] == w[k], k
        _bodies_close(g['bodies'], w['bodies'], f'trial {trial} frame {frame}')
    session = review_file_cmd.SegmentReviewSession([(1, 30, 33, 'WIP')], packet)
    assert [session.tick()['frame'] for _ in range(4)] == [30, 31, 32, 30]


def test_visualize_serves_the_live_viewer_and_exports(data, pairs, tmp_path, monkeypatch):
    """``visualize`` (live, the default) starts the server with the
    evaluator; ``--static`` exports the dev subject's trial."""
    pr = pairs['feedforward']
    home = tmp_path / 'home'
    (home / 'dev').mkdir(parents=True)
    (home / 'dev' / 's0.b3d').write_bytes(open(data['file'], 'rb').read())
    served = []

    def stop(self):
        served.append((self.session, self.port))
        self.stop()
    monkeypatch.setattr(live.LiveViewerServer, 'block', stop)
    argv = ['visualize', '--dataset-home', str(home), '--checkpoint-dir', str(pr['root']),
            '--geometry-folder', data['geom'], *BASE, '--device', 'cpu', '--port', '0']
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    assert 'live viewer serving on http://127.0.0.1:' in out.getvalue()
    session, port = served[0]
    assert port > 0 and session.num_frames == len(data['ds'])
    with contextlib.redirect_stdout(io.StringIO()):
        packet = session.tick()
    assert packet['hud'].startswith('running loss: ') and 'pred_forces' in packet
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(argv + ['--static', '--trial', '1', '--out', str(tmp_path / 's.html')]) == 0
    payload = json.loads((tmp_path / 's.html').read_text().split('const DATA = ', 1)[1]
                         .split(';\nconst cv')[0])
    assert len(payload['frames']) == 120 and 'meshes' in payload
    # visualize-file --live plays one trial's windows
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(['visualize-file', '--file', data['file'], '--trial', '1', '--live',
                     '--port', '0', '--checkpoint-dir', str(pr['root']), '--geometry-folder',
                     data['geom'], *BASE, '--device', 'cpu']) == 0
    assert served[1][0].num_frames == int((data['ds'].win_trial == 1).sum())


@pytest.mark.parametrize('command', ['visualize-file', 'review-file', 'visualize'])
def test_cuda_without_a_gpu_raises(data, pairs, command, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args = build_parser().parse_args([command, '--file', data['file']]
                                     if command != 'visualize' else [command])
    assert args.device == 'cuda'
    argv = ([command] + (['--file', data['file']] if command != 'visualize' else [])
            + ['--checkpoint-dir', str(pairs['feedforward']['root']), *BASE])
    with pytest.raises(RuntimeError, match=r'is_available\(\) is False'):
        main(argv)


def test_ensure_geometry_offline_fallback_matches_the_jax_one(tmp_path, monkeypatch):
    """No ``./Geometry``: the fetch fails (no network here) and both sides
    fall back to an empty ``./Geometry``; a named folder is returned as an
    absolute path ending in '/'."""
    from inferbiomechanics_tpu.utils import geometry as jax_geometry
    for name, module in (('port', geometry), ('jax', jax_geometry)):
        where = tmp_path / name
        where.mkdir()
        monkeypatch.chdir(where)
        assert module.ensure_geometry('') == str(where / 'Geometry') + '/'
        assert (where / 'Geometry').is_dir() and not (where / 'Geometry.zip').exists()
        assert module.ensure_geometry('Geometry') == str(where / 'Geometry') + '/'
