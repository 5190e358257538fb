"""The port's int8 path (inferbiomechanics_tpu_torch/ops/quant.py, ``serve
--quantize int8``, ``analyze --quantize int8``) against the JAX package's
(inferbiomechanics_tpu/ops/quant.py and its service and command), in this
process on the CPU.

- ``quantize_weight``: ``w_q`` (int8) and ``s_w`` (f32) bitwise JAX's as the
  JAX package runs it, eagerly, at load (under ``jax.jit`` XLA divides by 127
  as a product with 1/127, which moves some scales by one ulp: ROADMAP.md
  Queue 3), an all-zero column guarded to scale 1; ``qdense``: within rtol
  1e-5 / atol 1e-6 of JAX's jitted one (both float32 around an exact int32
  sum; the jitted activation scales are such products too).
- ``quantized_feedforward_forward`` on weights converted from a JAX tree by
  ``weights.py``: every layer's ``w_q`` and ``s_w`` bitwise, the outputs at
  the same tolerance; batchnorm models refused in JAX's words.
- ``InferenceService(..., quantize='int8', device='cpu')`` over HTTP against
  the JAX quantized forward; /schema says ``quantize``; no K1 launch; every
  refusal in the JAX service's words.
- ``analyze --quantize int8 --device cpu`` rows and report against the JAX
  command's on the same checkpoint.

Small sizes: window 20 / stride 5 (4 frames x 177 channels), hidden widths
32 and 48, one synthetic subject.
"""

import argparse
import contextlib
import csv
import io
import json
import os
import re
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.cli.analyze_cmd import AnalyzeCommand
from inferbiomechanics_tpu.config import Config as JaxConfig
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu.ops import quant as jq
from inferbiomechanics_tpu.serve import InferenceService as JaxService
from inferbiomechanics_tpu.train import create_train_state, make_optimizer
from inferbiomechanics_tpu.train.checkpoint import save_checkpoint as jax_save
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu_torch.__main__ import main
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.ops import fused_mlp as fm
from inferbiomechanics_tpu_torch.ops import quant as pq
from inferbiomechanics_tpu_torch.serve import InferenceService, serve
from inferbiomechanics_tpu_torch.train.checkpoint import save_checkpoint
from inferbiomechanics_tpu_torch.train.loop import build_model_for_dataset
from inferbiomechanics_tpu_torch.weights import feedforward_state_dict_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)
HIDDEN = [32, 48]


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(activation='sigmoid', batchnorm=False):
    out = []
    for cls in (JaxConfig, Config):
        cfg = cls()
        cfg.window_size, cfg.stride = 20, 5
        cfg.hidden_dims, cfg.activation, cfg.batchnorm = list(HIDDEN), activation, batchnorm
        out.append(cfg)
    return out


def _pair(ds, jds, activation='sigmoid', seed=0, batchnorm=False):
    """JAX params (biases moved off zero) and the port's model holding the
    same weights through ``weights.py``."""
    jcfg, cfg = _configs(activation, batchnorm)
    jmodel = jax_build(jcfg, jds)
    state = create_train_state(jmodel, jax.random.PRNGKey(seed),
                               jnp.asarray(jds.gather(np.arange(4)).inputs),
                               make_optimizer('adam', 1e-3))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.1 * rng.normal(size=p.shape) if p.ndim == 1 else 0)
                   ).astype(np.float32), jax.device_get(state.params))
    model = build_model_for_dataset(cfg, ds).eval()
    model.load_state_dict(feedforward_state_dict_from_jax(
        params, jax.device_get(state.batch_stats) if batchnorm else None))
    return jmodel, state.replace(params=params), model


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_quant')
    for split, trials, length in (('dev', 2, 120), ('train', 1, 60)):
        os.makedirs(root / 'data' / split)
        write_synthetic_subject(str(root / 'data' / split / 's0.b3d'), num_trials=trials,
                                trial_length=length, seed=0)
    kw = dict(window_size=20, stride=5, skip_loading_skeletons=True)
    ds = WindowDataset(str(root / 'data' / 'dev'), **kw)
    jds = JaxWindowDataset(str(root / 'data' / 'dev'), **kw)
    jmodel, state, model = _pair(ds, jds)
    ckpt = str(root / 'ckpt' / 'feedforward')
    jax_save(ckpt, state, 2, 5)
    save_checkpoint(ckpt, model, 2, 5)
    return dict(root=root, data=str(root / 'data'), ds=ds, jds=jds, jmodel=jmodel,
                state=state, model=model, ckpt=ckpt)


def _x(b, width, seed):
    return np.random.default_rng(seed).normal(size=(b, width)).astype(np.float32)


@pytest.mark.parametrize('shape', [(50, 30), (708, 32), (48, 30)])
def test_quantize_weight_and_qdense_match_jax(shape):
    rng = np.random.default_rng(shape[0])
    w = (rng.normal(size=shape) * rng.uniform(0.01, 3.0, size=shape[1])).astype(np.float32)
    w[:, 3] = 0.0                                   # an all-zero column
    b = rng.normal(size=shape[1]).astype(np.float32)
    x = _x(5, shape[0], shape[1])
    x[2] = 0.0                                      # an all-zero row
    jw, js = jq.quantize_weight(w)
    pw, ps = pq.quantize_weight(torch.from_numpy(w))
    assert pw.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    want = np.asarray(jax.jit(jq.qdense)(x, jw, js, b))
    got = pq.qdense(torch.from_numpy(x), pw, ps, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[2], b)       # a zero row: the bias alone


def test_zero_column_guard():
    w = torch.zeros(16, 8)
    w[:, 1] = torch.linspace(-2.0, 2.0, 16)
    w_q, s_w = pq.quantize_weight(w)
    assert torch.equal(s_w[[0, 2, 3, 4, 5, 6, 7]], torch.ones(7))
    assert s_w[1] == pytest.approx(2.0 / 127.0)
    assert torch.equal(w_q[:, 0], torch.zeros(16, dtype=torch.int8))
    assert int(w_q[:, 1].abs().max()) == 127
    out = pq.qdense(torch.randn(3, 16), w_q, s_w, torch.arange(8.0))
    assert torch.equal(out[:, 0], torch.zeros(3))


@pytest.mark.parametrize('activation', ['sigmoid', 'relu'])
def test_quantized_forward_matches_jax(setup, activation):
    jmodel, state, model = _pair(setup['ds'], setup['jds'], activation, seed=3)
    jlayers = jq.quantize_feedforward_params(state.params)
    players = pq.quantize_feedforward_params(model.layer_params())
    assert len(players) == len(jlayers) == len(HIDDEN) + 1
    for i, layer in enumerate(players):
        jl = jlayers[f'Dense_{i}']
        np.testing.assert_array_equal(layer.w_q.numpy(), np.asarray(jl['w_q']))
        np.testing.assert_array_equal(layer.s_w.numpy(), np.asarray(jl['s_w']))
        np.testing.assert_array_equal(layer.b.numpy(), np.asarray(jl['b']))
    x = setup['ds'].gather(np.arange(37)).inputs
    want = jax.jit(jq.quantized_feedforward_forward(jmodel, state.params))(jnp.asarray(x))
    before = fm.launches
    got = pq.quantized_feedforward_forward(model)(torch.from_numpy(x))
    assert fm.launches == before
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


def test_batchnorm_models_are_refused(setup):
    jmodel, state, model = _pair(setup['ds'], setup['jds'], batchnorm=True)
    match = 'does not support batchnorm checkpoints'
    with pytest.raises(ValueError, match=match):
        jq.quantized_feedforward_forward(jmodel, state.params)
    with pytest.raises(ValueError, match=match):
        pq.quantized_feedforward_forward(model)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_int8_service_answers_like_the_jax_quantized_forward(setup):
    _, cfg = _configs()
    svc = InferenceService(cfg, setup['ckpt'], setup['ds'], max_batch=64, device='cpu',
                           quantize='int8')
    server = serve(svc, host='127.0.0.1', port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f'http://127.0.0.1:{server.server_address[1]}'
    try:
        with urllib.request.urlopen(url + '/schema', timeout=60) as r:
            schema = json.loads(r.read())
        assert schema['quantize'] == 'int8' and schema['checkpoint'] == {'epoch': 2,
                                                                        'batch': 5}
        qfwd = jax.jit(jq.quantized_feedforward_forward(setup['jmodel'],
                                                        setup['state'].params))
        before = fm.launches
        for b in (1, 5, 64):
            x = setup['ds'].gather(np.arange(b)).inputs
            got = _post(url + '/predict', {'inputs': x.tolist()})['outputs']
            want = qfwd(jnp.asarray(x))
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                           np.asarray(want[k]), err_msg=f'B={b} {k}', **TOL)
        assert fm.launches == before                # the int8 forward runs no K1
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


@pytest.mark.parametrize('case', ['int4', 'ensemble', 'groundlink', 'tta_mirror', 'diffusion',
                                  'reload', 'poller'])
def test_int8_service_refusals_in_the_jax_words(setup, case):
    jcfg, cfg = _configs()
    kw = {'quantize': 'int4' if case == 'int4' else 'int8'}
    if case == 'ensemble':
        kw['ensemble'] = [setup['ckpt'], setup['ckpt']]
    if case == 'tta_mirror':
        kw['tta_mirror'] = True
    for c in (jcfg, cfg):
        if case == 'groundlink':
            c.model_type = 'groundlink'
        if case == 'diffusion':
            c.model_type, c.output_data_format = 'diffusion', 'all_frames'
            c.d_model, c.num_layers, c.num_heads, c.diffusion_timesteps = 32, 1, 4, 16
    match = {'int4': "unknown --quantize 'int4'; expected int8",
             'ensemble': r'--quantize int8 serves a single feedforward checkpoint \(not '
                         r'diffusion or ensembles\)',
             'diffusion': r'--quantize int8 serves a single feedforward checkpoint',
             'groundlink': '--quantize int8 currently supports the feedforward family only',
             'tta_mirror': r'--tta-mirror serves the learned-model paths \(single model or '
                           r'ensemble; not diffusion or int8\)',
             'reload': r'reload is not supported with --quantize \(weights are baked into '
                       r'the compiled program\); restart the server',
             'poller': '--reload-poll-sec cannot work here: reload is unsupported for '
                       '--quantize services'}[case]
    jds = setup['jds']
    if case in ('reload', 'poller'):
        port_svc = InferenceService(cfg, setup['ckpt'], setup['ds'], device='cpu', **kw)
        for svc in (JaxService(jcfg, setup['ckpt'], jds, **kw), port_svc):
            with pytest.raises(ValueError, match=match):
                svc.reload() if case == 'reload' else svc.start_reload_poller(1.0)
        port_svc.close()
        return
    if case == 'diffusion':
        jds = JaxWindowDataset(os.path.join(setup['data'], 'dev'), window_size=20, stride=5,
                               output_data_format='all_frames', skip_loading_skeletons=True)
    # another model family: no checkpoint of it (the JAX service loads first)
    ckpt = setup['ckpt'] if cfg.model_type == 'feedforward' else str(setup['root'] / 'none')
    with pytest.raises(ValueError, match=match):
        JaxService(jcfg, ckpt, jds, **kw)
    with pytest.raises(ValueError, match=match):
        InferenceService(cfg, ckpt, setup['ds'], device='cpu', **kw)


def _run_jax_analyze(argv):
    parser = argparse.ArgumentParser()
    AnalyzeCommand().register_subcommand(parser.add_subparsers(dest='command'))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert AnalyzeCommand().run(parser.parse_args(argv))
    return out.getvalue()


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_analyze_int8_rows_match_the_jax_command(setup, tmp_path):
    """The port reads the JAX package's own checkpoint file."""
    jckpt = os.path.join(setup['ckpt'], 'epoch_2_batch_5.ckpt')
    outs = {}
    for side in ('jax', 'port'):
        argv = ['analyze', '--dataset-home', setup['data'], '--checkpoint-dir',
                str(tmp_path / side), '--no-wandb', '--history-len', '20',
                '--hidden-dims', *map(str, HIDDEN), '--batch-size', '4',
                '--checkpoint-file', jckpt, '--quantize', 'int8']
        if side == 'jax':
            outs[side] = _run_jax_analyze(argv)
        else:
            out = io.StringIO()
            before = fm.launches
            with contextlib.redirect_stdout(out):
                assert main(argv + ['--device', 'cpu']) == 0
            assert fm.launches == before
            outs[side] = out.getvalue()
        assert 'evaluating int8-quantized forward' in outs[side]
    for split in ('dev', 'train'):
        got, want = (_rows(str(tmp_path / side / 'feedforward' / f'{split}_analysis.csv'))
                     for side in ('port', 'jax'))
        assert len(got) == len(want) > 0 and [r[:2] for r in got] == [r[:2] for r in want]
        g, w = (np.asarray([r[2:] for r in rows], float) for rows in (got, want))
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=split)
        reports = [float(re.search(r'\tForce Avg Err: (\S+)',
                                   outs[side].split(f'[{split}] final report:')[1]).group(1))
                   for side in ('port', 'jax')]
        assert reports[0] == pytest.approx(reports[1], rel=1e-4), split
