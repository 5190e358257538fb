"""The port's serving slice (inferbiomechanics_tpu_torch/serve.py, its
checkpoints and its ``serve`` command) against the JAX package's
(inferbiomechanics_tpu/serve.py).

One synthetic dataset (window 20, stride 5) and one set of weights: the JAX
service serves a JAX checkpoint, the port's service (on the CPU) serves the
same weights converted into a port checkpoint in the same directory, and
both answer the same HTTP requests. The feedforward model first, then the
transformer (d_model 128, 2 layers, 4 heads) with ``--fused-inference``, then
GroundLink (its full widths on 4 frames), then the options that apply to
every served model: ensembles, ``tta_mirror`` and checkpoint polling.
"""

import base64
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.config import Config
from inferbiomechanics_tpu.data.dataset import WindowDataset
from inferbiomechanics_tpu.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu.serve import InferenceService as JaxService
from inferbiomechanics_tpu.train import (
    create_train_state, make_optimizer, save_checkpoint as jax_save,
)
from inferbiomechanics_tpu.train import checkpoint as jax_ckpt
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu.train.run_config import load_run_config, save_run_config
from inferbiomechanics_tpu.train.augment import (
    mirror_outputs as jax_mirror_outputs, spec_from_dataset as jax_spec_from_dataset,
)
from inferbiomechanics_tpu_torch.cli.serve_cmd import build_parser, start
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset as PortWindowDataset
from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
from inferbiomechanics_tpu_torch.serve import InferenceService, serve
from inferbiomechanics_tpu_torch.train import checkpoint as port_ckpt
from inferbiomechanics_tpu_torch.train.loop import build_model_for_dataset
from inferbiomechanics_tpu_torch.weights import (
    feedforward_state_dict_from_jax, groundlink_state_dict_from_jax,
    transformer_state_dict_from_jax,
)

REPO = Path(__file__).resolve().parents[1]
# The JAX service runs flax Dense layers (bf16 matmul output, bf16 bias
# add); the port runs the fused-kernel math (f32 accumulate and bias). They
# agree to 5.9e-3 at full width; 2e-2 leaves room at these widths.
ATOL = 2e-2
SHARED_SCHEMA_KEYS = ('model_type', 'checkpoint', 'window_size', 'stride',
                      'num_model_frames', 'num_dofs', 'contact_bodies',
                      'num_input_channels', 'input_layout', 'label_layout',
                      'output_data_format', 'max_batch', 'run_config')


def _config():
    cfg = Config()
    cfg.model_type = 'feedforward'
    cfg.window_size, cfg.stride = 20, 5
    cfg.hidden_dims = [64, 64]
    return cfg


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    data = tmp_path_factory.mktemp('torchserve_data')
    write_synthetic_subject(str(data / 's.b3d'), num_trials=2,
                            trial_length=120, seed=0)
    cfg = _config()
    ds = WindowDataset(str(data), window_size=20, stride=5,
                       skip_loading_skeletons=True)
    ckpt_root = tmp_path_factory.mktemp('torchserve_ckpt')
    ckpt = str(ckpt_root / 'feedforward')
    state = create_train_state(jax_build(cfg, ds), jax.random.PRNGKey(0),
                               jnp.asarray(ds.gather(np.arange(4)).inputs),
                               make_optimizer('adam', 1e-3))
    jax_save(ckpt, state, 3, 7)
    model = build_model_for_dataset(cfg, ds)
    model.load_state_dict(feedforward_state_dict_from_jax(
        jax.device_get(state.params)))
    port_ckpt.save_checkpoint(ckpt, model, 3, 7)
    return {'cfg': cfg, 'ds': ds, 'data': data, 'ckpt_root': ckpt_root,
            'ckpt': ckpt, 'file': str(data / 's.b3d')}


def _start(service):
    server = serve(service, host='127.0.0.1', port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f'http://127.0.0.1:{server.server_address[1]}'


@pytest.fixture(scope='module')
def urls(setup):
    jax_svc = JaxService(setup['cfg'], setup['ckpt'], setup['ds'], max_batch=64)
    port_svc = InferenceService(setup['cfg'], setup['ckpt'], setup['ds'],
                                max_batch=64, device='cpu')
    servers = [_start(jax_svc), _start(port_svc)]
    yield servers[0][1], servers[1][1]
    for server, _ in servers:
        server.shutdown()
        server.server_close()


def _post(url, payload, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _decoded(outputs):
    out = {}
    for k, v in outputs.items():
        if isinstance(v, dict):
            v = np.frombuffer(base64.b64decode(v['b64']), '<f4').reshape(v['shape'])
        out[k] = np.asarray(v, np.float32)
    return out


def _assert_outputs_close(got, want):
    got, want = _decoded(got), _decoded(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)


def test_health_and_schema_match_jax(urls):
    jax_url, port_url = urls
    hj, hp = _get(jax_url + '/health'), _get(port_url + '/health')
    assert hp == hj == {'status': 'ok', 'model': 'feedforward', 'epoch': 3,
                        'batch': 7, 'ensemble_size': 0}
    sj, sp = _get(jax_url + '/schema'), _get(port_url + '/schema')
    for key in SHARED_SCHEMA_KEYS:
        assert sp[key] == sj[key], key
    assert sp['device'] == 'cpu' and sp['run_config'] is None


@pytest.mark.parametrize('encoding,rows', [('json', 1), ('json', 5), ('b64', 7)])
def test_predict_matches_jax(urls, setup, encoding, rows):
    x = np.asarray(setup['ds'].gather(np.arange(3, 3 + rows)).inputs, '<f4')
    if encoding == 'b64':
        payload = {'inputs_b64': base64.b64encode(x.tobytes()).decode(),
                   'shape': list(x.shape), 'encoding': 'b64'}
    else:
        payload = {'inputs': x.tolist()}
    rj, rp = (_post(u + '/predict', payload) for u in urls)
    assert rp['batch'] == rj['batch'] == rows
    _assert_outputs_close(rp['outputs'], rj['outputs'])


def test_predict_file_matches_jax(urls, setup):
    payload = {'file': setup['file'], 'trial': 1, 'max_windows': 40}
    rj, rp = (_post(u + '/predict_file', payload) for u in urls)
    assert rp['window_starts'] == rj['window_starts']
    assert rp['last_frame'] == rj['last_frame'] and len(rp['window_starts']) == 40
    _assert_outputs_close(rp['outputs'], rj['outputs'])


def test_bad_requests_are_refused_like_jax(urls, setup):
    x = np.asarray(setup['ds'].gather(np.arange(65)).inputs)
    for payload in ({'inputs': x.tolist()},                # over max_batch
                    {'inputs': x[:2, :, :10].tolist()},     # wrong width
                    {'nothing': 1}):
        codes = []
        for u in urls:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(u + '/predict', payload)
            codes.append(e.value.code)
        assert codes == [400, 400]


def test_metrics_have_the_jax_fields(urls, setup):
    x = np.asarray(setup['ds'].gather(np.arange(2)).inputs)
    for u in urls:
        _post(u + '/predict', {'inputs': x.tolist()})
    mj, mp = (_get(u + '/metrics') for u in urls)
    assert set(mp) == set(mj)
    assert set(mp['latency_ms']) == set(mj['latency_ms']) == {'p50', 'p90', 'p99', 'max'}
    assert mp['requests'] >= 1 and mp['rows'] >= 2 and mp['device_forwards'] >= 1


def test_dynamic_batcher_matches_jax(urls, setup):
    """Concurrent clients through the port's DynamicBatcher in front of its
    service give the JAX service's answers."""
    svc = InferenceService(setup['cfg'], setup['ckpt'], setup['ds'],
                           max_batch=64, batch_wait_ms=30, device='cpu')
    server, url = _start(svc)
    try:
        ds = setup['ds']
        xs = [np.asarray(ds.gather(np.arange(i, i + 1 + i % 4)).inputs)
              for i in range(8)]
        got = [None] * len(xs)

        def client(i):
            got[i] = _post(url + '/predict', {'inputs': xs[i].tolist()})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for x, r in zip(xs, got):
            assert r['batch'] == len(x)
            _assert_outputs_close(r['outputs'],
                                  _post(urls[0] + '/predict', {'inputs': x.tolist()})['outputs'])
        m = _get(url + '/metrics')
        assert m['requests'] == 8 and m['errors'] == 0
        assert m['device_forwards'] == svc.batcher.forwards <= 8
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_reload_swaps_to_a_newer_checkpoint(setup, tmp_path):
    ckpt = str(tmp_path / 'feedforward')
    ds, cfg = setup['ds'], setup['cfg']
    first = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(1))
    port_ckpt.save_checkpoint(ckpt, first, 0, 5)
    svc = InferenceService(cfg, ckpt, ds, max_batch=8, device='cpu')
    x = np.asarray(ds.gather(np.arange(2)).inputs)
    before = svc.predict_packed(x)
    assert svc.reload() == {'reloaded': False, 'epoch': 0, 'batch': 5}
    second = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(2))
    port_ckpt.save_checkpoint(ckpt, second, 1, 0)
    assert svc.reload() == {'reloaded': True, 'epoch': 1, 'batch': 0}
    after = svc.predict_packed(x)
    with torch.no_grad():
        want = second.eval()(torch.from_numpy(x))
    for k in after:
        assert not np.allclose(after[k], before[k])
        np.testing.assert_array_equal(after[k], want[k].numpy())
    svc.warmup()
    assert svc.stats['device_forwards'] == 4     # 2 predicts + B=1 and B=max_batch


def test_schema_reads_the_run_config_sidecar(setup, tmp_path):
    ckpt = str(tmp_path / 'feedforward')
    cfg = setup['cfg']
    port_ckpt.save_checkpoint(ckpt, build_model_for_dataset(cfg, setup['ds']), 0, 0)
    save_run_config(ckpt, cfg)
    svc = InferenceService(cfg, ckpt, setup['ds'], max_batch=8, device='cpu')
    assert svc.schema()['run_config'] == load_run_config(ckpt)
    assert svc.schema()['run_config']['hidden_dims'] == [64, 64]


def test_untrained_model_when_no_checkpoint(setup, tmp_path):
    svc = InferenceService(setup['cfg'], str(tmp_path / 'empty'), setup['ds'],
                           max_batch=8, device='cpu')
    assert (svc.epoch, svc.batch) == (-1, 0)


@pytest.mark.parametrize('option', [
    {'quantize': 'int8', 'tta_mirror': True}, {'use_ema': True},
    {'diffusion_samples': 4}, {'diffusion_partial': 0.3},
    {'init_checkpoint': 'x'}, {'config': {'model_type': 'diffusion'}},
])
def test_unported_serving_options_raise(setup, option):
    """The serving options refuse what the JAX service refuses, in its
    words: ``--quantize int8`` with ``--tta-mirror``, EMA weights the
    checkpoint does not carry, the diffusion options on a feedforward model,
    a diffusion model that does not predict all frames."""
    cfg = _config()
    for k, v in option.pop('config', {}).items():
        setattr(cfg, k, v)
    match = {'quantize': r'--tta-mirror serves the learned-model paths \(single model or '
                         r'ensemble; not diffusion or int8\)',
             'use_ema': '--use-ema: checkpoint .* carries no ema_params',
             'diffusion_samples': '--diffusion-samples applies to --model-type diffusion',
             'diffusion_partial': '--diffusion-partial applies to --model-type diffusion',
             'init_checkpoint': '--init-checkpoint only does something with '
                                '--diffusion-partial'}.get(
        next(iter(option), None),
        'serve --model-type diffusion requires --output-data-format all_frames')
    with pytest.raises(ValueError, match=match):
        JaxService(cfg, setup['ckpt'], setup['ds'], **option)
    with pytest.raises(ValueError, match=match):
        InferenceService(cfg, setup['ckpt'], setup['ds'], device='cpu', **option)


def test_checkpoint_names_do_not_cross_packages(setup):
    """The JAX pattern would flax-decode a ``.pt``; the port's names avoid it."""
    name = port_ckpt.checkpoint_name(3, 7)
    assert name == 'epoch_3_batch_7.torch.pt'
    assert jax_ckpt._CKPT_RE.match(name) is None
    assert port_ckpt._CKPT_RE.match(jax_ckpt.checkpoint_name(3, 7)) is None
    assert [os.path.basename(p) for *_, p in jax_ckpt.list_checkpoints(setup['ckpt'])] \
        == ['epoch_3_batch_7.ckpt']
    assert [os.path.basename(p) for *_, p in port_ckpt.list_checkpoints(setup['ckpt'])] \
        == ['epoch_3_batch_7.torch.pt']


def test_serve_command_answers_health(setup):
    """``python -m inferbiomechanics_tpu_torch serve --device cpu --port 0``."""
    cmd = [sys.executable, '-m', 'inferbiomechanics_tpu_torch', 'serve',
           '--device', 'cpu', '--port', '0',
           '--dataset-home', str(setup['data']),
           '--checkpoint-dir', str(setup['ckpt_root']),
           '--history-len', '20', '--stride', '5', '--hidden-dims', '64', '64']
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert 'serving feedforward (epoch 3, batch 7) on cpu at http://' in line, line
        url = line.split(' at ')[1].split()[0]
        assert _get(url + '/health')['epoch'] == 3
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_serve_command_refuses_reload_polling(setup):
    """``--reload-poll-sec`` is a flag of the command (0 = off), and the
    command refuses it for an ensemble, whose members it cannot reload, as
    the JAX command does."""
    parser = build_parser()
    assert parser.parse_args(['serve']).reload_poll_sec == 0.0
    args = parser.parse_args([
        'serve', '--device', 'cpu', '--port', '0', '--reload-poll-sec', '5',
        '--dataset-home', str(setup['data']), '--checkpoint-dir', str(setup['ckpt_root']),
        '--history-len', '20', '--stride', '5', '--hidden-dims', '64', '64',
        '--ensemble', setup['ckpt'], setup['ckpt']])
    with pytest.raises(ValueError, match='reload is unsupported for ensembles'):
        start(args)


# -- the transformer, with --fused-inference ----------------------------------

# Both services run the fused forward: the JAX one its reference layer (on
# the CPU), the port its plain layer. Held per head at 2e-2 x max|JAX
# answer|, inside the JAX suite's 3e-2 for the same forward
# (tests/test_pallas_encoder.py).
REL = 2e-2


def _transformer_config(fused=True):
    cfg = _config()
    cfg.model_type = 'transformer'
    cfg.d_model, cfg.num_layers, cfg.num_heads = 128, 2, 4
    cfg.fused_inference = fused
    return cfg


@pytest.fixture(scope='module')
def tsetup(setup):
    cfg, ds = _transformer_config(), setup['ds']
    ckpt = str(setup['ckpt_root'] / 'transformer')
    state = create_train_state(jax_build(cfg, ds), jax.random.PRNGKey(1),
                               jnp.asarray(ds.gather(np.arange(4)).inputs),
                               make_optimizer('adam', 1e-3))
    rng = np.random.default_rng(1)      # biases and LayerNorm rows off their init
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.normal(size=p.shape)).astype(np.float32)
        if p.ndim == 1 else np.asarray(p), jax.device_get(state.params))
    jax_save(ckpt, state.replace(params=params), 2, 9)
    model = build_model_for_dataset(cfg, ds)
    model.load_state_dict(transformer_state_dict_from_jax(params))
    port_ckpt.save_checkpoint(ckpt, model, 2, 9)
    return dict(setup, cfg=cfg, ckpt=ckpt)


@pytest.fixture(scope='module')
def turls(tsetup):
    jax_svc = JaxService(tsetup['cfg'], tsetup['ckpt'], tsetup['ds'], max_batch=16)
    port_svc = InferenceService(tsetup['cfg'], tsetup['ckpt'], tsetup['ds'],
                                max_batch=16, device='cpu')
    servers = [_start(jax_svc), _start(port_svc)]
    yield servers[0][1], servers[1][1]
    for server, _ in servers:
        server.shutdown()
        server.server_close()


def _assert_heads_close(got, want):
    got, want = _decoded(got), _decoded(want)
    assert set(got) == set(want) and len(want) == 7
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=REL * (np.abs(want[k]).max() + 1e-6))


def test_transformer_health_and_schema_match_jax(turls):
    jax_url, port_url = turls
    hj, hp = _get(jax_url + '/health'), _get(port_url + '/health')
    assert hp == hj == {'status': 'ok', 'model': 'transformer', 'epoch': 2,
                        'batch': 9, 'ensemble_size': 0}
    sj, sp = _get(jax_url + '/schema'), _get(port_url + '/schema')
    for key in SHARED_SCHEMA_KEYS + ('fused_inference',):
        assert sp[key] == sj[key], key
    assert sp['fused_inference'] is True


@pytest.mark.parametrize('encoding,rows', [('json', 1), ('json', 5), ('b64', 7)])
def test_transformer_predict_matches_jax(turls, tsetup, encoding, rows):
    x = np.asarray(tsetup['ds'].gather(np.arange(2, 2 + rows)).inputs, '<f4')
    if encoding == 'b64':
        payload = {'inputs_b64': base64.b64encode(x.tobytes()).decode(),
                   'shape': list(x.shape), 'encoding': 'b64'}
    else:
        payload = {'inputs': x.tolist()}
    rj, rp = (_post(u + '/predict', payload) for u in turls)
    assert rp['batch'] == rj['batch'] == rows
    _assert_heads_close(rp['outputs'], rj['outputs'])


def test_transformer_predict_file_matches_jax(turls, tsetup):
    payload = {'file': tsetup['file'], 'trial': 0, 'max_windows': 12}
    rj, rp = (_post(u + '/predict_file', payload) for u in turls)
    assert rp['window_starts'] == rj['window_starts'] and len(rp['window_starts']) == 12
    _assert_heads_close(rp['outputs'], rj['outputs'])


def test_transformer_without_the_flag_serves_the_vpu_forward(turls, tsetup):
    svc = InferenceService(_transformer_config(fused=False), tsetup['ckpt'],
                           tsetup['ds'], max_batch=16, device='cpu')
    assert svc.schema()['fused_inference'] is False
    x = np.asarray(tsetup['ds'].gather(np.arange(4)).inputs)
    got = svc.predict_packed(x)
    with torch.no_grad():
        want = svc.model(torch.from_numpy(x))
    fused = _decoded(_post(turls[1] + '/predict', {'inputs': x.tolist()})['outputs'])
    for k in got:
        np.testing.assert_array_equal(got[k], want[k].numpy())
    assert any(not np.array_equal(got[k], fused[k]) for k in got)


def test_transformer_reload_swaps_the_packed_weights(tsetup, tmp_path):
    ckpt, cfg, ds = str(tmp_path / 'transformer'), tsetup['cfg'], tsetup['ds']
    first = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(1))
    port_ckpt.save_checkpoint(ckpt, first, 0, 1)
    svc = InferenceService(cfg, ckpt, ds, max_batch=8, device='cpu')
    x = np.asarray(ds.gather(np.arange(2)).inputs)
    before, packed = svc.predict_packed(x), svc.model.packed()
    second = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(2))
    port_ckpt.save_checkpoint(ckpt, second, 0, 2)
    assert svc.reload() == {'reloaded': True, 'epoch': 0, 'batch': 2}
    assert svc.model.packed() is not packed
    after = svc.predict_packed(x)
    for k in after:
        assert not np.allclose(after[k], before[k]), k


@pytest.mark.parametrize('change', [
    {'model_type': 'feedforward'}, {'d_model': 64, 'num_heads': 2},
    {'model_type': 'groundlink'}])
def test_fused_inference_the_model_cannot_honour_is_ignored_with_a_warning(
        tsetup, tmp_path, caplog, change):
    """As the JAX service does: the same warning, then the plain forward."""
    cfg = _transformer_config()
    for k, v in change.items():
        setattr(cfg, k, v)
    with caplog.at_level('WARNING', logger='inferbiomechanics_tpu_torch.serve'):
        svc = InferenceService(cfg, str(tmp_path / cfg.model_type), tsetup['ds'],
                               max_batch=8, device='cpu')
    assert '--fused-inference ignored: needs a vpu transformer' in caplog.text
    assert svc.schema()['fused_inference'] is False
    out = svc.predict_packed(np.asarray(tsetup['ds'].gather(np.arange(2)).inputs))
    assert all(np.isfinite(v).all() for v in out.values())


def test_serve_command_serves_the_transformer_with_fused_inference(tsetup):
    cmd = [sys.executable, '-m', 'inferbiomechanics_tpu_torch', 'serve',
           '--device', 'cpu', '--port', '0', '--model-type', 'transformer',
           '--fused-inference', '--dataset-home', str(tsetup['data']),
           '--checkpoint-dir', str(tsetup['ckpt_root']),
           '--history-len', '20', '--stride', '5', '--d-model', '128',
           '--num-layers', '2', '--num-heads', '4']
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert 'serving transformer (epoch 2, batch 9) on cpu at http://' in line, line
        url = line.split(' at ')[1].split()[0]
        assert _get(url + '/schema')['fused_inference'] is True
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# -- GroundLink ------------------------------------------------------------------

# The JAX service runs the flax model in bf16 (every conv and Dense output
# and every bias add rounded to bf16); the port runs the fused-kernel math
# (f32 sums, bias and ELU, one rounding a layer). Held per head at the
# tolerance the JAX suite has for this very comparison, its own fused
# forward against that model: 5e-2 x max|JAX answer|
# (tests/test_pallas_groundlink.py). Seen here: up to 4.0e-2 x max
# (all_frames), so a tighter 2e-2 does not hold.
GL_REL = 5e-2


def _groundlink_config():
    cfg = _config()
    cfg.model_type = 'groundlink'
    return cfg


def _jax_state(cfg, ds, seed, bias_seed=None):
    state = create_train_state(jax_build(cfg, ds), jax.random.PRNGKey(seed),
                               jnp.asarray(ds.gather(np.arange(4)).inputs),
                               make_optimizer('adam', 1e-3))
    if bias_seed is not None:        # biases off their zero init
        rng = np.random.default_rng(bias_seed)
        state = state.replace(params=jax.tree_util.tree_map(
            lambda p: (np.asarray(p) + 0.1 * rng.normal(size=p.shape)).astype(np.float32)
            if p.ndim == 1 else np.asarray(p), jax.device_get(state.params)))
    return state


def _save_both(cfg, ds, ckpt, state, convert, epoch, batch):
    """One set of weights as a JAX checkpoint and as a port checkpoint."""
    jax_save(ckpt, state, epoch, batch)
    model = build_model_for_dataset(cfg, ds)
    model.load_state_dict(convert(jax.device_get(state.params)))
    port_ckpt.save_checkpoint(ckpt, model, epoch, batch)


@pytest.fixture(scope='module')
def gsetup(setup):
    cfg, ds = _groundlink_config(), setup['ds']
    ckpt = str(setup['ckpt_root'] / 'groundlink')
    _save_both(cfg, ds, ckpt, _jax_state(cfg, ds, 2, bias_seed=2),
               groundlink_state_dict_from_jax, 4, 1)
    return dict(setup, cfg=cfg, ckpt=ckpt)


@pytest.fixture(scope='module')
def gurls(gsetup):
    jax_svc = JaxService(gsetup['cfg'], gsetup['ckpt'], gsetup['ds'], max_batch=16)
    port_svc = InferenceService(gsetup['cfg'], gsetup['ckpt'], gsetup['ds'],
                                max_batch=16, device='cpu')
    servers = [_start(jax_svc), _start(port_svc)]
    yield servers[0][1], servers[1][1]
    for server, _ in servers:
        server.shutdown()
        server.server_close()


def _assert_rel_close(got, want, rel=GL_REL):
    got, want = _decoded(got), _decoded(want)
    assert set(got) == set(want) and len(want) == 4
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=rel * (np.abs(want[k]).max() + 1e-6))


def test_groundlink_health_and_schema_match_jax(gurls):
    jax_url, port_url = gurls
    hj, hp = _get(jax_url + '/health'), _get(port_url + '/health')
    assert hp == hj == {'status': 'ok', 'model': 'groundlink', 'epoch': 4,
                        'batch': 1, 'ensemble_size': 0}
    sj, sp = _get(jax_url + '/schema'), _get(port_url + '/schema')
    for key in SHARED_SCHEMA_KEYS + ('fused_inference', 'ensemble'):
        assert sp[key] == sj[key], key
    assert sp['fused_inference'] is False and sp['ensemble'] is None


@pytest.mark.parametrize('encoding,rows', [('json', 1), ('json', 5), ('b64', 7)])
def test_groundlink_predict_matches_jax(gurls, gsetup, encoding, rows):
    x = np.asarray(gsetup['ds'].gather(np.arange(1, 1 + rows)).inputs, '<f4')
    if encoding == 'b64':
        payload = {'inputs_b64': base64.b64encode(x.tobytes()).decode(),
                   'shape': list(x.shape), 'encoding': 'b64'}
    else:
        payload = {'inputs': x.tolist()}
    rj, rp = (_post(u + '/predict', payload) for u in gurls)
    assert rp['batch'] == rj['batch'] == rows
    _assert_rel_close(rp['outputs'], rj['outputs'])


def test_groundlink_predict_file_matches_jax(gurls, gsetup):
    payload = {'file': gsetup['file'], 'trial': 1, 'max_windows': 12}
    rj, rp = (_post(u + '/predict_file', payload) for u in gurls)
    assert rp['window_starts'] == rj['window_starts'] and len(rp['window_starts']) == 12
    _assert_rel_close(rp['outputs'], rj['outputs'])


def test_groundlink_all_frames_matches_jax(gsetup, tmp_path):
    cfg = _groundlink_config()
    cfg.output_data_format = 'all_frames'
    ds = WindowDataset(str(gsetup['data']), window_size=20, stride=5,
                       output_data_format='all_frames', skip_loading_skeletons=True)
    ckpt = str(tmp_path / 'groundlink')
    _save_both(cfg, ds, ckpt, _jax_state(cfg, ds, 3, bias_seed=3),
               groundlink_state_dict_from_jax, 0, 0)
    x = np.asarray(ds.gather(np.arange(6)).inputs)
    want = JaxService(cfg, ckpt, ds, max_batch=8).predict_packed(x)
    got = InferenceService(cfg, ckpt, ds, max_batch=8, device='cpu').predict_packed(x)
    assert got[next(iter(got))].shape[:2] == (6, 4)
    _assert_rel_close(got, want)


def test_groundlink_reload_swaps_the_packed_weights(gsetup, tmp_path):
    ckpt, cfg, ds = str(tmp_path / 'groundlink'), gsetup['cfg'], gsetup['ds']
    first = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(1))
    port_ckpt.save_checkpoint(ckpt, first, 0, 1)
    svc = InferenceService(cfg, ckpt, ds, max_batch=8, device='cpu')
    x = np.asarray(ds.gather(np.arange(2)).inputs)
    before, packed = svc.predict_packed(x), svc.model.packed()
    second = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(2))
    port_ckpt.save_checkpoint(ckpt, second, 0, 2)
    assert svc.reload() == {'reloaded': True, 'epoch': 0, 'batch': 2}
    assert svc.model.packed() is not packed
    after = svc.predict_packed(x)
    with torch.no_grad():
        want = second.eval()(torch.from_numpy(x))
    for k in after:
        assert not np.allclose(after[k], before[k]), k
        np.testing.assert_array_equal(after[k], want[k].numpy())


def test_serve_command_serves_groundlink(gsetup):
    cmd = [sys.executable, '-m', 'inferbiomechanics_tpu_torch', 'serve',
           '--device', 'cpu', '--port', '0', '--model-type', 'groundlink',
           '--dataset-home', str(gsetup['data']),
           '--checkpoint-dir', str(gsetup['ckpt_root']),
           '--history-len', '20', '--stride', '5']
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert 'serving groundlink (epoch 4, batch 1) on cpu at http://' in line, line
        url = line.split(' at ')[1].split()[0]
        assert _get(url + '/health')['model'] == 'groundlink'
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# -- ensembles, mirror TTA, checkpoint polling --------------------------------------

FORCES = 'groundContactForceInRootFrame'


@pytest.fixture(scope='module')
def esetup(setup, tmp_path_factory):
    """Two feedforward members with different weights, each dir holding the
    JAX checkpoint and the port's; one single-model service a member and
    side."""
    cfg, ds = setup['cfg'], setup['ds']
    dirs = []
    for seed in (0, 1):
        d = str(tmp_path_factory.mktemp(f'torchserve_ens{seed}'))
        _save_both(cfg, ds, d, _jax_state(cfg, ds, seed),
                   feedforward_state_dict_from_jax, seed, 0)
        dirs.append(d)
    return dict(setup, dirs=dirs,
                jax=JaxService(cfg, dirs[0], ds, max_batch=64, ensemble=dirs),
                port=InferenceService(cfg, dirs[0], ds, max_batch=64,
                                      ensemble=dirs, device='cpu'))


def test_ensemble_mean_and_spread_match_jax(esetup):
    ds, cfg = esetup['ds'], esetup['cfg']
    x = np.asarray(ds.gather(np.arange(4)).inputs)
    out, spread = esetup['port'].predict_packed(x, with_spread=True)
    want, want_spread = esetup['jax'].predict_packed(x, with_spread=True)
    _assert_outputs_close(out, want)
    _assert_outputs_close(spread, want_spread)
    # the mean of the members' own answers, and their population std
    singles = [InferenceService(cfg, d, ds, max_batch=64, device='cpu').predict_packed(x)
               for d in esetup['dirs']]
    for k in out:
        np.testing.assert_allclose(out[k], (singles[0][k] + singles[1][k]) / 2,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(spread[k], np.abs(singles[0][k] - singles[1][k]) / 2,
                                   rtol=1e-5, atol=1e-6)
    assert float(spread[FORCES].max()) > 0             # the members differ
    assert esetup['port'].stats['device_forwards'] >= 1
    assert (esetup['port'].epoch, esetup['port'].batch) == \
        (esetup['jax'].epoch, esetup['jax'].batch) == (1, 0)


def test_ensemble_http_matches_jax(esetup):
    servers = [_start(esetup['jax']), _start(esetup['port'])]
    try:
        jax_url, port_url = (u for _, u in servers)
        assert _get(port_url + '/health') == _get(jax_url + '/health')
        assert _get(port_url + '/health')['ensemble_size'] == 2
        sj, sp = _get(jax_url + '/schema'), _get(port_url + '/schema')
        assert sp['ensemble'] == sj['ensemble']
        assert sp['ensemble']['size'] == 2 and len(sp['ensemble']['members']) == 2
        x = np.asarray(esetup['ds'].gather(np.arange(3)).inputs)
        payload = {'inputs': x.tolist(), 'spread': True}
        rj, rp = (_post(u + '/predict', payload) for u in (jax_url, port_url))
        assert np.asarray(rp['spread'][FORCES]).shape == (3, 1, 6)
        _assert_outputs_close(rp['outputs'], rj['outputs'])
        _assert_outputs_close(rp['spread'], rj['spread'])
        # spread is optional and off by default
        assert 'spread' not in _post(port_url + '/predict', {'inputs': x.tolist()})
    finally:
        for server, _ in servers:
            server.shutdown()
            server.server_close()


def test_single_model_spread_is_null(urls, setup):
    x = np.asarray(setup['ds'].gather(np.arange(2)).inputs)
    for u in urls:
        assert _post(u + '/predict', {'inputs': x.tolist(), 'spread': True})['spread'] is None


def test_ensemble_members_may_be_files(esetup):
    files = [os.path.join(d, port_ckpt.checkpoint_name(seed, 0))
             for seed, d in enumerate(esetup['dirs'])]
    svc = InferenceService(esetup['cfg'], esetup['dirs'][0], esetup['ds'],
                           max_batch=64, ensemble=files, device='cpu')
    assert [m['path'] for m in svc.members] == files
    x = np.asarray(esetup['ds'].gather(np.arange(3)).inputs)
    want = esetup['port'].predict_packed(x)
    for k, v in svc.predict_packed(x).items():
        np.testing.assert_array_equal(v, want[k])


def test_ensemble_bad_member_rejected(esetup, tmp_path):
    """The JAX service's errors for the same members."""
    cfg, ds = esetup['cfg'], esetup['ds']
    empty = str(tmp_path / 'empty')
    os.makedirs(empty)
    missing = str(tmp_path / 'nope.ckpt')
    for make in (lambda **kw: JaxService(cfg, empty, ds, **kw),
                 lambda **kw: InferenceService(cfg, empty, ds, device='cpu', **kw)):
        with pytest.raises(ValueError, match='no\\s+checkpoints'):
            make(ensemble=[empty])
        with pytest.raises(FileNotFoundError):
            make(ensemble=[missing])


def test_ensemble_with_dynamic_batching(esetup):
    """The batcher coalesces mixed spread/no-spread ensemble requests and
    hands each client its own rows."""
    import concurrent.futures
    ds = esetup['ds']
    svc = InferenceService(esetup['cfg'], esetup['dirs'][0], ds, max_batch=64,
                           ensemble=esetup['dirs'], batch_wait_ms=25.0, device='cpu')
    try:
        x = np.asarray(ds.gather(np.arange(8)).inputs)
        want, want_spread = esetup['port'].predict_packed(x, with_spread=True)

        def one(i):
            rows = x[i:i + 2]
            if i % 2:
                out, spread = svc.predict(rows, with_spread=True)
                return i, out[FORCES], spread[FORCES]
            return i, svc.predict(rows)[FORCES], None

        with concurrent.futures.ThreadPoolExecutor(max_workers=6) as ex:
            results = list(ex.map(one, range(6)))
        for i, got, spread in results:
            np.testing.assert_allclose(got, want[FORCES][i:i + 2], rtol=1e-5, atol=1e-5)
            if spread is not None:
                np.testing.assert_allclose(spread, want_spread[FORCES][i:i + 2],
                                           rtol=1e-4, atol=1e-5)
        assert svc.batcher.forwards < 6
    finally:
        svc.close()


def test_reload_rejected_for_ensembles(esetup):
    for svc in (esetup['jax'], esetup['port']):
        with pytest.raises(ValueError, match='ensemble'):
            svc.reload()
        with pytest.raises(ValueError, match='reload is unsupported for ensembles'):
            svc.start_reload_poller(0.1)


def test_fused_inference_is_ignored_for_ensembles(tsetup, caplog):
    """As the JAX service: a warning, then every member's plain forward."""
    with caplog.at_level('WARNING', logger='inferbiomechanics_tpu_torch.serve'):
        svc = InferenceService(tsetup['cfg'], tsetup['ckpt'], tsetup['ds'], max_batch=8,
                               ensemble=[tsetup['ckpt'], tsetup['ckpt']], device='cpu')
    assert '--fused-inference ignored for ensembles' in caplog.text
    assert svc.schema()['fused_inference'] is False
    x = np.asarray(tsetup['ds'].gather(np.arange(3)).inputs)
    out, spread = svc.predict_packed(x, with_spread=True)
    with torch.no_grad():
        want = svc.model(torch.from_numpy(x))
    for k in out:       # two copies of one member: its own answer, no spread
        np.testing.assert_allclose(out[k], want[k].float().numpy(), rtol=1e-6, atol=1e-6)
        assert not spread[k].any()


def _symmetrized(svc_plain, ds, x):
    """(f(x) + unmirror(f(mirror(x)))) / 2 from a service without TTA, with
    the JAX package's mirror spec."""
    spec = jax_spec_from_dataset(ds)
    o1 = svc_plain.predict_packed(x)
    o2 = svc_plain.predict_packed(np.asarray(spec.mirror_inputs(x)))
    o2 = jax_mirror_outputs(spec, ds.lab_offsets, {k: jnp.asarray(v) for k, v in o2.items()})
    return {k: 0.5 * (np.asarray(o1[k]) + np.asarray(o2[k])) for k in o1}


@pytest.mark.parametrize('which', ['feedforward', 'groundlink', 'transformer'])
def test_tta_mirror_service_matches_jax(setup, gsetup, tsetup, which):
    """``tta_mirror``: the JAX TTA service's answer, and exactly the
    half-sum of the port's own plain and mirror-unmirrored forwards."""
    s = {'feedforward': setup, 'groundlink': gsetup, 'transformer': tsetup}[which]
    cfg, ckpt, ds = s['cfg'], s['ckpt'], s['ds']
    x = np.asarray(ds.gather(np.arange(8)).inputs, np.float32)
    got = InferenceService(cfg, ckpt, ds, max_batch=64, tta_mirror=True,
                           device='cpu').predict_packed(x)
    plain = InferenceService(cfg, ckpt, ds, max_batch=64, device='cpu')
    own = _symmetrized(plain, ds, x)
    want = JaxService(cfg, ckpt, ds, max_batch=64, tta_mirror=True).predict_packed(x)
    assert set(got) == set(want) == set(own)
    for k in got:
        np.testing.assert_allclose(got[k], own[k], rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=max(ATOL, GL_REL * np.abs(want[k]).max()))
    assert any(not np.allclose(got[k], plain.predict_packed(x)[k]) for k in got)
    assert plain.stats['device_forwards'] == 3       # one count a predict_packed


def test_tta_mirror_composes_with_ensemble(esetup):
    """Each member is symmetrized before the across-member mean and std."""
    cfg, ds, dirs = esetup['cfg'], esetup['ds'], esetup['dirs']
    x = np.asarray(ds.gather(np.arange(4)).inputs, np.float32)
    out, spread = InferenceService(cfg, dirs[0], ds, max_batch=64, ensemble=dirs,
                                   tta_mirror=True, device='cpu'
                                   ).predict_packed(x, with_spread=True)
    singles = [InferenceService(cfg, d, ds, max_batch=64, tta_mirror=True,
                                device='cpu').predict_packed(x) for d in dirs]
    want, want_spread = JaxService(cfg, dirs[0], ds, max_batch=64, ensemble=dirs,
                                   tta_mirror=True).predict_packed(x, with_spread=True)
    for k in out:
        np.testing.assert_allclose(out[k], (singles[0][k] + singles[1][k]) / 2,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(spread[k], np.abs(singles[0][k] - singles[1][k]) / 2,
                                   rtol=1e-5, atol=1e-6)
    _assert_outputs_close(out, want)
    _assert_outputs_close(spread, want_spread)


def test_tta_mirror_reads_the_lateral_axis_from_the_config(setup):
    cfg = _config()
    cfg.mirror_lateral_axis = 0
    x = np.asarray(setup['ds'].gather(np.arange(4)).inputs, np.float32)
    got = InferenceService(cfg, setup['ckpt'], setup['ds'], max_batch=8,
                           tta_mirror=True, device='cpu').predict_packed(x)
    want = JaxService(cfg, setup['ckpt'], setup['ds'], max_batch=8,
                      tta_mirror=True).predict_packed(x)
    z_axis = InferenceService(setup['cfg'], setup['ckpt'], setup['ds'], max_batch=8,
                              tta_mirror=True, device='cpu').predict_packed(x)
    _assert_outputs_close(got, want)
    assert any(not np.allclose(got[k], z_axis[k]) for k in got)


def test_reload_poller_picks_up_new_checkpoint(setup, tmp_path):
    ckpt, cfg, ds = str(tmp_path / 'feedforward'), setup['cfg'], setup['ds']
    first = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(1))
    port_ckpt.save_checkpoint(ckpt, first, 0, 0)
    svc = InferenceService(cfg, ckpt, ds, max_batch=16, device='cpu')
    svc.start_reload_poller(0.0)                       # 0 = off
    assert svc._poller is None
    svc.start_reload_poller(0.1)
    try:
        second = build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(2))
        port_ckpt.save_checkpoint(ckpt, second, 2, 0)
        deadline = time.time() + 20.0
        while time.time() < deadline and svc.epoch != 2:
            time.sleep(0.05)
        assert (svc.epoch, svc.batch) == (2, 0)
        x = np.asarray(ds.gather(np.arange(2)).inputs)
        with torch.no_grad():
            want = second.eval()(torch.from_numpy(x))
        for k, v in svc.predict_packed(x).items():
            np.testing.assert_array_equal(v, want[k].numpy())
    finally:
        svc.close()
    assert not svc._poller.is_alive()                  # close() stops the poller


def test_serve_command_polls_for_checkpoints(setup, tmp_path):
    """``--reload-poll-sec`` through the command's wiring, with the port's
    own dataset class."""
    root = tmp_path / 'ckpts'
    cfg = setup['cfg']
    pds = PortWindowDataset(str(setup['data']), window_size=20, stride=5,
                            skip_loading_skeletons=True)
    port_ckpt.save_checkpoint(str(root / 'feedforward'),
                              build_model_for_dataset(cfg, pds), 0, 0)
    args = build_parser().parse_args([
        'serve', '--device', 'cpu', '--port', '0', '--reload-poll-sec', '0.1',
        '--dataset-home', str(setup['data']), '--checkpoint-dir', str(root),
        '--history-len', '20', '--stride', '5', '--hidden-dims', '64', '64'])
    service, server = start(args)
    try:
        assert service._poller.is_alive() and service.epoch == 0
        port_ckpt.save_checkpoint(str(root / 'feedforward'),
                                  build_model_for_dataset(cfg, pds), 1, 3)
        deadline = time.time() + 20.0
        while time.time() < deadline and service.epoch != 1:
            time.sleep(0.05)
        assert (service.epoch, service.batch) == (1, 3)
    finally:
        server.server_close()
        service.close()


# -- the diffusion denoiser ---------------------------------------------------------

# Sampled answers, relative to the JAX answer's largest value per head: a
# chain that starts part way down the schedule (--diffusion-partial) at
# 5e-2, the JAX suite's limit for its fused forward against model.apply; a
# chain from the top of the schedule, where x0 is 8 x sign(x_t - eps) at the
# first step and near-ties flip on bf16-level differences, at 5e-2 on 90% of
# each head's elements (tests/test_torch_diffusion.py measures the JAX
# sampler's own f32 and bf16 chains apart by more on up to 5.7%).
DIFF_REL = 5e-2
SAMPLE_STEPS = 6


def _diffusion_config():
    cfg = _transformer_config()
    cfg.model_type, cfg.output_data_format = 'diffusion', 'all_frames'
    cfg.diffusion_timesteps = 64
    return cfg


def _chain_noise(seed, samples):
    """``models.diffusion.chain_noise`` fed with the JAX service's draws:
    ``PRNGKey(seed)``, or its ``samples`` splits stacked sample-major."""
    keys = ([jax.random.PRNGKey(seed)] if samples == 1
            else list(jax.random.split(jax.random.PRNGKey(seed), samples)))
    cache = {}

    def noise(i, shape, device):
        if shape not in cache:
            per = (shape[0] // samples,) + tuple(shape[1:])
            chains = []
            for key in keys:
                rng, rng0 = jax.random.split(key)
                draws = [jax.random.normal(rng0, per, jnp.float32)]
                for _ in range(SAMPLE_STEPS):
                    rng, rng_z = jax.random.split(rng)
                    draws.append(jax.random.normal(rng_z, per, jnp.float32))
                chains.append([np.asarray(d) for d in draws])
            cache[shape] = [np.concatenate([c[j] for c in chains])
                            for j in range(SAMPLE_STEPS + 1)]
        return torch.from_numpy(cache[shape][i].copy()).to(device)

    return noise


def _denoiser_weights(ds, seed):
    """A seeded flax init of the denoiser with biases moved off zero, and an
    EMA tree that differs from it."""
    from inferbiomechanics_tpu.models.diffusion import DiffusionDenoiser as JaxDenoiser
    jm = JaxDenoiser(num_dofs=ds.num_dofs, num_contact_bodies=ds.num_contact_bodies,
                     history_len=20, stride=5, d_model=128, num_layers=2,
                     num_heads=4, timesteps=64)
    params = jax.device_get(jm.init({'params': jax.random.PRNGKey(seed)},
                                    jnp.zeros((2, 4, 30)), jnp.zeros((2,), jnp.int32),
                                    jnp.zeros((2, 4, ds.num_input_channels)))['params'])
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.1 * rng.normal(size=p.shape) if p.ndim == 1 else 0)
                   ).astype(np.float32), params)
    ema = jax.tree_util.tree_map(
        lambda p: (p * (1 + 0.05 * rng.normal(size=p.shape))).astype(np.float32), params)
    return jm, params, ema


def _write_denoiser(ckpt, ds, seed, epoch):
    """The same denoiser (and EMA) as a JAX and as a port checkpoint in
    ``ckpt``, with the run_config sidecar (normalized target space)."""
    from inferbiomechanics_tpu.train.state import TrainState
    from inferbiomechanics_tpu_torch.weights import diffusion_state_dict_from_jax
    jm, params, ema = _denoiser_weights(ds, seed)
    tx = make_optimizer('adam', 1e-3)
    jax_save(ckpt, TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                              opt_state=tx.init(params), batch_stats={}, tx=tx,
                              apply_fn=jm.apply), epoch, 0, ema_params=ema)
    model = build_model_for_dataset(_diffusion_config(), ds)
    model.load_state_dict(diffusion_state_dict_from_jax(params))
    port_ckpt.save_checkpoint(ckpt, model, epoch, 0,
                              ema_params=diffusion_state_dict_from_jax(ema))
    save_run_config(ckpt, _diffusion_config())
    return model


@pytest.fixture(scope='module')
def dsetup(setup, tmp_path_factory):
    root = tmp_path_factory.mktemp('torchserve_diffusion')
    ds = WindowDataset(str(setup['data']), window_size=20, stride=5,
                       output_data_format='all_frames', skip_loading_skeletons=True)
    ckpt = str(root / 'diffusion')
    _write_denoiser(ckpt, ds, 5, 1)
    # the --diffusion-partial proposal: a feedforward all-frames model, no
    # sidecar (both services build it from the config's flags)
    pcfg = _config()
    pcfg.output_data_format = 'all_frames'
    pstate = create_train_state(jax_build(pcfg, ds), jax.random.PRNGKey(6),
                                jnp.asarray(ds.gather(np.arange(4)).inputs),
                                make_optimizer('adam', 1e-3))
    proposal = str(root / 'proposal')
    jax_save(proposal, pstate, 0, 0)
    pmodel = build_model_for_dataset(pcfg, ds)
    pmodel.load_state_dict(feedforward_state_dict_from_jax(jax.device_get(pstate.params)))
    port_ckpt.save_checkpoint(proposal, pmodel, 0, 0)
    return dict(setup, ds=ds, ckpt=ckpt, proposal=proposal,
                x=np.asarray(ds.gather(np.arange(4)).inputs))


def _assert_chains_close(got, want, partial, what=''):
    assert set(got) == set(want) and len(want) == 4
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert b.shape == a.shape and np.isfinite(b).all(), (what, k)
        close = np.abs(b - a) <= DIFF_REL * np.abs(a).max()
        assert close.all() if partial else close.mean() >= 0.9, (what, k, close.mean())


# case -> service options besides max_batch and sample_steps
DIFF_SERVICES = {
    'single': {},
    'samples3': {'diffusion_samples': 3},
    'partial': {'diffusion_partial': 0.3},
    'partial_samples3_ema': {'diffusion_partial': 0.3, 'diffusion_samples': 3,
                             'use_ema': True},
}


@pytest.mark.parametrize('case', list(DIFF_SERVICES))
def test_diffusion_service_matches_jax(dsetup, monkeypatch, case):
    from inferbiomechanics_tpu_torch.models import diffusion as port_diffusion
    monkeypatch.setattr(port_diffusion, 'chain_noise', _chain_noise)
    opts = dict(DIFF_SERVICES[case], max_batch=8, sample_steps=SAMPLE_STEPS)
    if 'diffusion_partial' in opts:
        opts['init_checkpoint'] = dsetup['proposal']
    cfg, x = _diffusion_config(), dsetup['x']
    jax_svc = JaxService(cfg, dsetup['ckpt'], dsetup['ds'], **opts)
    port_svc = InferenceService(cfg, dsetup['ckpt'], dsetup['ds'], device='cpu', **opts)
    want, want_spread = jax_svc.predict_packed(x, with_spread=True)
    got, spread = port_svc.predict_packed(x, with_spread=True)
    partial = 'diffusion_partial' in opts
    _assert_chains_close(got, want, partial, case)
    if opts.get('diffusion_samples', 1) == 1:
        assert spread is None and want_spread is None
    else:
        _assert_chains_close(spread, want_spread, partial, f'{case} spread')
    schema, jschema = port_svc.schema(), jax_svc.schema()
    for key in ('diffusion_sample_steps', 'diffusion_samples', 'use_ema',
                'fused_inference', *SHARED_SCHEMA_KEYS):
        assert schema[key] == jschema[key], key
    assert schema['diffusion_sample_steps'] == SAMPLE_STEPS


def test_diffusion_samples_are_stacked_chains_with_the_population_std(dsetup, monkeypatch):
    """K chains in one batch of K x B rows: their mean, and the std with
    ddof 0 (as jnp.std), of the chains that K services of one chain each
    answer with the draws of the K keys."""
    from inferbiomechanics_tpu_torch.models import diffusion as port_diffusion
    cfg, x, k = _diffusion_config(), dsetup['x'], 3
    monkeypatch.setattr(port_diffusion, 'chain_noise', _chain_noise)
    svc = InferenceService(cfg, dsetup['ckpt'], dsetup['ds'], max_batch=8,
                           sample_steps=SAMPLE_STEPS, diffusion_samples=k, device='cpu')
    launches = fe.launches
    mean, spread = svc.predict_packed(x, with_spread=True)
    assert fe.launches == launches           # the plain layer on the CPU
    keys = jax.random.split(jax.random.PRNGKey(0), k)
    chains = []
    for key in keys:
        monkeypatch.setattr(port_diffusion, 'chain_noise',
                            lambda seed, samples, key=key: _single_key_noise(key))
        one = InferenceService(cfg, dsetup['ckpt'], dsetup['ds'], max_batch=8,
                               sample_steps=SAMPLE_STEPS, device='cpu')
        chains.append(one.predict_packed(x))
    for name in mean:
        stack = np.stack([c[name] for c in chains])
        np.testing.assert_allclose(mean[name], stack.mean(0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(spread[name], stack.std(0), rtol=1e-4, atol=1e-5)
        assert not np.allclose(spread[name], stack.std(0, ddof=1))


def _single_key_noise(key):
    def noise(i, shape, device):
        rng, rng0 = jax.random.split(key)
        draw = jax.random.normal(rng0, shape, jnp.float32)
        for _ in range(i):
            rng, rng_z = jax.random.split(rng)
            draw = jax.random.normal(rng_z, shape, jnp.float32)
        return torch.from_numpy(np.array(draw)).to(device)
    return noise


def test_diffusion_reload_swaps_the_denoiser_only(dsetup, tmp_path):
    """/reload and the poller load the newer checkpoint's EMA weights with
    ``use_ema``; the partial chains' proposal stays as loaded."""
    from inferbiomechanics_tpu_torch.models import diffusion as port_diffusion
    ckpt = str(tmp_path / 'diffusion')
    _write_denoiser(ckpt, dsetup['ds'], 5, 1)
    cfg, x = _diffusion_config(), dsetup['x']
    svc = InferenceService(cfg, ckpt, dsetup['ds'], max_batch=8, sample_steps=SAMPLE_STEPS,
                           use_ema=True, diffusion_partial=0.3,
                           init_checkpoint=dsetup['proposal'], device='cpu')
    before = svc.predict_packed(x)
    assert svc.reload()['reloaded'] is False
    _write_denoiser(ckpt, dsetup['ds'], 7, 2)
    svc.start_reload_poller(0.1)
    try:
        deadline = time.time() + 20.0
        while time.time() < deadline and svc.epoch != 2:
            time.sleep(0.05)
        assert (svc.epoch, svc.batch) == (2, 0)
    finally:
        svc.close()
    after = svc.predict_packed(x)
    # the same chain by hand: the new EMA weights, the proposal's start
    model = build_model_for_dataset(cfg, dsetup['ds'])
    model.load_state_dict(port_ckpt.require_ema_params(
        port_ckpt.resolve_checkpoint_path(ckpt)))
    model.eval()
    propose = port_diffusion.make_partial_proposal_fn(
        cfg, dsetup['ds'], dsetup['proposal'])
    xt = torch.from_numpy(x)
    sampler = port_diffusion.make_sampler(model, num_steps=SAMPLE_STEPS,
                                          fused_inference=True, partial_frac=0.3)
    want = sampler(model, xt, torch.Generator().manual_seed(0), init=propose(xt))
    for k in after:
        np.testing.assert_array_equal(after[k], want[k].numpy())
        assert not np.allclose(after[k], before[k])


def test_serve_command_serves_diffusion(dsetup):
    """The command's diffusion flags reach the service."""
    args = build_parser().parse_args([
        'serve', '--device', 'cpu', '--port', '0', '--dataset-home', str(dsetup['data']),
        '--checkpoint-dir', str(Path(dsetup['ckpt']).parent), '--model-type', 'diffusion',
        '--output-data-format', 'all_frames', '--history-len', '20', '--stride', '5',
        '--d-model', '128', '--num-layers', '2', '--num-heads', '4',
        '--diffusion-timesteps', '64', '--fused-inference', '--sample-steps', '3',
        '--hidden-dims', '64', '64',
        '--diffusion-samples', '2', '--use-ema', '--diffusion-partial', '0.5',
        '--init-checkpoint', dsetup['proposal']])
    assert build_parser().parse_args(['serve']).sample_steps == 50
    svc, server = start(args)
    try:
        s = svc.schema()
        assert (s['diffusion_sample_steps'], s['diffusion_samples'], s['use_ema'],
                s['fused_inference']) == (3, 2, True, True)
        url = f'http://127.0.0.1:{server.server_address[1]}'
        threading.Thread(target=server.serve_forever, daemon=True).start()
        r = _post(url + '/predict', {'inputs': dsetup['x'].tolist(), 'spread': True})
        assert r['batch'] == 4 and set(r['spread']) == set(r['outputs'])
        assert all(np.asarray(v).shape == (4, 4, 6 if 'Wrench' not in k else 12)
                   for k, v in r['outputs'].items())
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


@pytest.mark.parametrize('option,match', [
    ({'ensemble': ['a', 'b']}, 'ensembles are not supported for diffusion serving'),
    ({'quantize': 'int8'}, r'--quantize int8 serves a single feedforward checkpoint'),
    ({'tta_mirror': True}, r'--tta-mirror serves the learned-model paths'),
    ({'diffusion_samples': 0}, '--diffusion-samples must be >= 1'),
])
def test_diffusion_service_refusals_are_the_jax_refusals(dsetup, option, match):
    for make in (lambda: JaxService(_diffusion_config(), dsetup['ckpt'], dsetup['ds'],
                                    **option),
                 lambda: InferenceService(_diffusion_config(), dsetup['ckpt'], dsetup['ds'],
                                          device='cpu', **option)):
        with pytest.raises(ValueError, match=match):
            make()
