"""The port's trainer (inferbiomechanics_tpu_torch/train/, cli/train_cmd.py,
data/loader.py) on the CPU, against the JAX package's where the two can be
compared, on one synthetic subject at small sizes (window 50 / stride 5,
a d_model 128 / 2 layer / 4 head ``pallas`` transformer and the default
1770 -> 512 -> 512 -> 30 feedforward model).

On the CPU the ``pallas`` transformer's layers run the plain versions of
the encoder layer kernel and of its backward kernels; the JAX model runs its
reference layer and ``jax.vjp`` of it. Tolerances for three train steps from
the same converted weights on the same batches: each step's loss within 2e-2
relative, the first step's gradients within 5e-2 x the tensor's largest
value (bf16 operands rounded at different places by XLA and PyTorch).
"""

import dataclasses
import json
import os
import shutil
import signal
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.config import Config as JaxConfig
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.data.dataset import unpack as jax_unpack
from inferbiomechanics_tpu.loss.evaluator import loss_and_metrics as jax_loss_and_metrics
from inferbiomechanics_tpu.train import run_config as jax_run_config
from inferbiomechanics_tpu.train.device_data import (
    DeviceResidentData as JaxDeviceResidentData,
    make_device_eval_runner as jax_make_device_eval_runner,
    make_device_train_step as jax_make_device_train_step,
)
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu.train.loop import loss_config_from as jax_loss_config_from
from inferbiomechanics_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from inferbiomechanics_tpu.train.state import create_train_state as jax_create_train_state
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.__main__ import build_parser, main
from inferbiomechanics_tpu_torch.cli.train_cmd import run_training
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset, unpack
from inferbiomechanics_tpu_torch.data.loader import PrefetchLoader
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.loss.evaluator import loss_and_metrics
from inferbiomechanics_tpu_torch.serve import InferenceService, serve
from inferbiomechanics_tpu_torch.train import checkpoint as ckpt
from inferbiomechanics_tpu_torch.train import run_config
from inferbiomechanics_tpu_torch.train.device_data import (
    DeviceResidentData, make_device_eval_runner, make_device_train_step,
)
from inferbiomechanics_tpu_torch.train.diffusion_loop import train_diffusion
from inferbiomechanics_tpu_torch.train.loop import (
    build_model_for_dataset, loss_config_from, train,
)
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
from inferbiomechanics_tpu_torch.train.state import create_train_state, num_params
from inferbiomechanics_tpu_torch.train.step import make_eval_step, make_train_step

LOSS_REL = 2e-2
GRAD_REL = 5e-2
BATCH = 32
SMALL = dict(d_model=128, num_layers=2, num_heads=4)


def _config(cls, model_type, **fields):
    cfg = cls()
    cfg.model_type = model_type
    cfg.batch_size = BATCH
    cfg.aux_tau_weight = 0.1 if model_type == 'transformer' else 0.0
    if model_type == 'transformer':
        cfg.attn_impl = 'pallas'
        for k, v in SMALL.items():
            setattr(cfg, k, v)
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def _refuse_download(*a, **kw):
    raise OSError('no network in tests')


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """These models are small: beside other test processes, PyTorch's
    thread pool only fights them for the cores. One thread throughout also
    keeps every run of this module summing in the same order."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp('torchtrain_data')
    for split, length, seed in (('train', 260, 0), ('dev', 120, 1)):
        os.makedirs(root / split)
        write_synthetic_subject(str(root / split / 's.b3d'), num_trials=2,
                                trial_length=length, seed=seed)
    kw = dict(window_size=50, stride=5, skip_loading_skeletons=True)
    return {'root': root,
            'train': WindowDataset(str(root / 'train'), **kw),
            'dev': WindowDataset(str(root / 'dev'), **kw),
            'jax_train': JaxWindowDataset(str(root / 'train'), **kw),
            'jax_dev': JaxWindowDataset(str(root / 'dev'), **kw)}


def _pair(data, model_type):
    """The JAX model with flax-initialised parameters (biases moved off
    zero) and the port's model holding the same weights."""
    jcfg, cfg = _config(JaxConfig, model_type), _config(Config, model_type)
    jmodel = jax_build(jcfg, data['jax_train'])
    sample = jnp.asarray(data['jax_train'].gather(np.arange(4)).inputs)
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.05 * rng.normal(size=p.shape) if p.ndim == 1 else 0)
                   ).astype(np.float32),
        jax.device_get(jmodel.init(jax.random.PRNGKey(0), sample, train=False)['params']))
    model = build_model_for_dataset(cfg, data['train'])
    to_sd, to_jax = {
        'transformer': (weights.transformer_pallas_state_dict_from_jax,
                        weights.transformer_pallas_params_to_jax),
        'feedforward': (weights.feedforward_state_dict_from_jax,
                        weights.feedforward_params_to_jax)}[model_type]
    model.load_state_dict(to_sd(params))
    return jcfg, cfg, jmodel, params, model, to_jax


@pytest.mark.parametrize('model_type', ['transformer', 'feedforward'])
def test_three_device_train_steps_track_the_jax_package(data, model_type):
    jcfg, cfg, jmodel, params, model, to_jax = _pair(data, model_type)
    jlc, lc = jax_loss_config_from(jcfg), loss_config_from(cfg)
    jdata = JaxDeviceResidentData(data['jax_train'])
    ddata = DeviceResidentData(data['train'], 'cpu')
    perm = np.random.default_rng((0, 0)).permutation(len(data['train']))
    batches = [perm[k * BATCH:(k + 1) * BATCH] for k in range(3)]
    key = jax.random.PRNGKey(0)

    # the first step's gradients, parameter by parameter
    def jloss(p, idx):
        inputs, labels = jdata.gather_in_jit(idx)
        out = jmodel.apply({'params': p}, inputs, train=True, rngs={'dropout': key})
        return jax_loss_and_metrics(out, jax_unpack(labels, jdata.lab_offsets), jlc)[0]

    jgrads = jax.jit(jax.grad(jloss))(params, jnp.asarray(batches[0], jnp.int32))
    model.train()
    inputs, labels = ddata.gather(torch.from_numpy(batches[0]))
    loss, _ = loss_and_metrics(model(inputs), unpack(labels, ddata.lab_offsets), lc)
    loss.backward()
    grads = to_jax({n: (p.grad if p.grad is not None else torch.zeros_like(p))
                    for n, p in model.named_parameters()})
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    assert set(flat_j) == set(flat_t)
    if model_type == 'transformer':
        # XLA on the CPU sums the input projection's bf16 bias gradient over
        # the B * T rows less exactly than it sums the same cotangent for the
        # temporal embedding (its two results differ by 8e-2 x max here; the
        # port's differ by 3e-3 x max). Hold the port to the exacter of the
        # JAX package's two sums of that cotangent.
        path = next(p for p in flat_j if jax.tree_util.keystr(p) == "['Dense_0']['bias']")
        flat_j[path] = np.asarray(jgrads['temporal_embedding']).sum(0)
    for path, want in flat_j.items():
        want = np.asarray(want)
        np.testing.assert_allclose(flat_t[path], want, rtol=0,
                                   atol=GRAD_REL * np.abs(want).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))

    # three steps of RMSprop at 1e-4, loss by loss
    jstate = jax_create_train_state(jmodel, key, jnp.asarray(
        data['jax_train'].gather(np.arange(4)).inputs), jax_make_optimizer('rmsprop', 1e-4))
    jstate = jstate.replace(params=params)
    jstep = jax_make_device_train_step(jmodel, jdata, jlc, donate=False)
    state = create_train_state(model, make_optimizer(model.named_parameters(),
                                                     'rmsprop', 1e-4))
    step = make_device_train_step(model, ddata, lc)
    for k, idx in enumerate(batches):
        jstate, jm = jstep(jstate, jnp.asarray(idx, jnp.int32), key)
        m = step(state, torch.from_numpy(idx))
        assert set(m) == set(jm)
        assert float(m['loss']) == pytest.approx(float(jm['loss']), rel=LOSS_REL), k
        np.testing.assert_allclose(m['force_loss'].numpy(), np.asarray(jm['force_loss']),
                                   rtol=LOSS_REL, err_msg=f'step {k}')
    assert state.step == 3 == int(jstate.step)

    # the dev split through both eval runners after those steps
    jdev = jax_make_device_eval_runner(
        jmodel, JaxDeviceResidentData(data['jax_dev']), jlc, BATCH)(jstate)
    dev = make_device_eval_runner(model, DeviceResidentData(data['dev'], 'cpu'), lc,
                                  BATCH)(state)
    assert float(dev['loss']) == pytest.approx(float(jdev['loss']), rel=LOSS_REL)


@pytest.mark.parametrize('fmt,pack', [('last_frame', False), ('last_frame', True),
                                      ('all_frames', False), ('all_frames', True)])
def test_device_gather_is_the_host_gather_in_bf16(data, fmt, pack):
    kw = dict(window_size=50, stride=5, skip_loading_skeletons=True,
              output_data_format=fmt)
    ds = WindowDataset(str(data['root'] / 'train'), **kw)
    jds = JaxWindowDataset(str(data['root'] / 'train'), **kw)
    ddata = DeviceResidentData(ds, 'cpu', pack_windows=pack)
    jdata = JaxDeviceResidentData(jds, pack_windows=pack)
    idx = np.random.default_rng(1).permutation(len(ds))[:17]
    inputs, labels = ddata.gather(torch.from_numpy(idx))
    host = ds.gather(idx)
    assert inputs.dtype == torch.bfloat16 and labels.dtype == torch.float32
    assert torch.equal(inputs, torch.from_numpy(host.inputs).to(torch.bfloat16))
    assert np.array_equal(labels.numpy(), host.labels)
    jin, jlab = jdata.gather_in_jit(jnp.asarray(idx, jnp.int32))
    assert np.array_equal(np.asarray(jin.astype(jnp.float32)), inputs.float().numpy())
    assert np.array_equal(np.asarray(jlab), labels.numpy())
    assert (ddata.features_packed is not None) == pack
    held = [ddata.features_all, ddata.labels_all, ddata.win_base]
    held += [a for a in (ddata.features_packed, ddata.labels_packed) if a is not None]
    assert ddata.device_bytes == sum(a.numel() * a.element_size() for a in held)
    assert DeviceResidentData.packed_bytes_estimate(ds) == \
        JaxDeviceResidentData.packed_bytes_estimate(jds)


def test_grad_accumulation_averages_equal_microbatches(data):
    cfg = _config(Config, 'feedforward', hidden_dims=[64])
    lc = loss_config_from(cfg)
    ddata = DeviceResidentData(data['train'], 'cpu')
    idx = torch.arange(BATCH)
    after = []
    for accum in (1, 4):
        model = build_model_for_dataset(cfg, data['train'],
                                        generator=torch.Generator().manual_seed(1))
        before = [p.detach().clone() for p in model.parameters()]
        state = create_train_state(model, make_optimizer(model.named_parameters(),
                                                         'sgd', 1e-2))
        m = make_device_train_step(model, ddata, lc, grad_accum=accum)(state, idx)
        after.append((float(m['loss']), [p.detach().clone() for p in model.parameters()]))
    assert after[0][0] == pytest.approx(after[1][0], rel=1e-5)
    # the weight gradients pass through the forward's bf16 casts, so each
    # microbatch's share is rounded to bf16 (2^-9) before they are added
    for a, b, p0 in zip(after[0][1], after[1][1], before):
        assert float((a - p0).abs().max()) > 0
        torch.testing.assert_close(a - p0, b - p0, rtol=0,
                                   atol=1e-2 * float((a - p0).abs().max()))
    with pytest.raises(ValueError, match='not divisible'):
        make_device_train_step(model, ddata, lc, grad_accum=5)(state, idx)


def test_host_steps_match_device_steps_on_the_same_batch(data):
    """The host tier's step on a gathered batch is the device tier's step on
    its indices, up to the bf16 rounding of the resident features (the
    feedforward model rounds its input to bf16 anyway: equal)."""
    cfg = _config(Config, 'feedforward', hidden_dims=[64])
    lc = loss_config_from(cfg)
    idx = np.arange(BATCH)
    host = data['train'].gather(idx)
    losses = []
    for tier in ('host', 'device'):
        model = build_model_for_dataset(cfg, data['train'],
                                        generator=torch.Generator().manual_seed(2))
        state = create_train_state(model, make_optimizer(model.named_parameters(),
                                                         'rmsprop', 1e-4))
        if tier == 'host':
            m = make_train_step(model, data['train'].lab_offsets, lc)(
                state, torch.from_numpy(host.inputs), torch.from_numpy(host.labels))
            out, em = make_eval_step(model, data['train'].lab_offsets, lc)(
                state, torch.from_numpy(host.inputs), torch.from_numpy(host.labels))
            assert not model.training and set(em) == set(m) and len(out) == 4
        else:
            m = make_device_train_step(model, DeviceResidentData(data['train'], 'cpu'),
                                       lc)(state, torch.from_numpy(idx))
        losses.append(float(m['loss']))
    assert losses[0] == losses[1]


def test_prefetch_loader_yields_the_datasets_batches(data):
    loader = PrefetchLoader(data['train'], BATCH, device='cpu')
    got = list(loader.epoch(seed=5))
    want = list(data['train'].batches(BATCH, seed=5))
    assert len(got) == len(want) == len(loader) > 3
    for a, b in zip(got, want):
        assert isinstance(a.inputs, torch.Tensor) and a.inputs.dtype == torch.float32
        assert np.array_equal(a.inputs.numpy(), b.inputs)
        assert np.array_equal(a.labels.numpy(), b.labels)
    # an abandoned epoch stops its producer
    it = loader.epoch(seed=5)
    next(it)
    it.close()


def _run(data, ckpt_dir, model_type='transformer', **fields):
    cfg = _config(Config, model_type, checkpoint_dir=str(ckpt_dir), epochs=2, **fields)
    return cfg, train(cfg, data['train'], data['dev'], device='cpu')


def _final(ckpt_dir):
    return torch.load(os.path.join(ckpt_dir, 'epoch_1_batch_0.torch.pt'),
                      map_location='cpu', weights_only=True)


@pytest.fixture(scope='module')
def trained(data, tmp_path_factory):
    """One uninterrupted 2-epoch run of the small ``pallas`` transformer."""
    ckpt_dir = tmp_path_factory.mktemp('torchtrain_ckpt') / 'transformer'
    cfg, result = _run(data, ckpt_dir)
    return {'cfg': cfg, 'result': result, 'dir': str(ckpt_dir)}


def test_train_end_to_end_on_the_cpu(data, trained):
    result, d = trained['result'], trained['dir']
    steps = len(data['train']) // BATCH
    assert result.epochs_run == 2 and result.windows_seen == 2 * steps * BATCH
    assert result.windows_per_sec > 0 and not result.preempted
    assert [c[:2] for c in ckpt.list_checkpoints(d)] == [(0, 0), (1, 0)]
    # dev evaluation ran before each epoch; the loss falls
    assert set(result.final_dev_metrics) >= {'loss', 'force_avg_err', 'cop_avg_err'}
    assert np.isfinite(result.final_dev_metrics['loss'])
    assert result.final_train_metrics['loss'] > 0
    sidecar = run_config.load_run_config(d)
    assert (sidecar['model_type'], sidecar['attn_impl'], sidecar['d_model']) == (
        'transformer', 'pallas', 128)
    payload = _final(d)
    assert payload['step'] == 2 * steps and payload['opt_type'] == 'rmsprop'
    assert set(payload['optimizer_state_dict']['state'][0]) == {'nu'}
    assert 'enc1_wmlp2' in payload['model_state_dict']
    # a finished run started again runs nothing and changes nothing
    again = train(trained['cfg'], data['train'], data['dev'], device='cpu')
    assert again.epochs_run == 0 and again.windows_seen == 0


def test_sigterm_checkpoints_and_the_resumed_run_equals_the_uninterrupted(
        data, trained, tmp_path):
    """SIGTERM mid-epoch under per-step dispatch (``--device-chunk-steps
    1``): a checkpoint at the next step boundary and a clean exit; the same
    call then resumes inside the epoch and ends with bitwise the parameters
    and optimizer state of the uninterrupted run, which ran chunked
    (tests/test_torch_chunked_step.py has SIGTERM at chunk granularity)."""
    class Killer:
        def log(self, record):
            if record.get('epoch') == 0 and record.get('batch') == 2:
                os.kill(os.getpid(), signal.SIGTERM)

    d = tmp_path / 'transformer'
    cfg = _config(Config, 'transformer', checkpoint_dir=str(d), epochs=2,
                  log_every_batches=1, device_chunk_steps=1)
    first = train(cfg, data['train'], data['dev'], metric_logger=Killer(), device='cpu')
    assert first.preempted and first.epochs_run == 0
    assert [c[:2] for c in ckpt.list_checkpoints(str(d))] == [(0, 3)]
    resumed = train(cfg, data['train'], data['dev'], device='cpu')
    steps = len(data['train']) // BATCH
    assert not resumed.preempted and resumed.epochs_run == 2
    assert first.windows_seen + resumed.windows_seen == 2 * steps * BATCH
    want, got = _final(trained['dir']), _final(str(d))
    for k, v in want['model_state_dict'].items():
        assert torch.equal(v, got['model_state_dict'][k]), k
    for i, st in want['optimizer_state_dict']['state'].items():
        assert torch.equal(st['nu'], got['optimizer_state_dict']['state'][i]['nu'])
    assert want['step'] == got['step']


def test_groundlink_trains_at_the_jax_defaults_and_resumes_exactly(data, tmp_path):
    """``train --model-type groundlink`` with the JAX defaults (fc_dropout
    0.2): the loss is finite, the dev eval runs, checkpoints land, and a run
    stopped after epoch 0 and resumed ends with bitwise the parameters of the
    uninterrupted run (the dropout masks are seeded by the step)."""
    def run(d, epochs):
        return run_training(build_parser().parse_args([
            'train', '--dataset-home', str(data['root']), '--checkpoint-dir', str(d),
            '--model-type', 'groundlink', '--batch-size', str(BATCH), '--epochs',
            str(epochs), '--device', 'cpu']))

    whole = run(tmp_path / 'a', 2)
    assert whole.epochs_run == 2 and np.isfinite(whole.final_train_metrics['loss'])
    assert np.isfinite(whole.final_dev_metrics['loss'])
    run(tmp_path / 'b', 1)
    assert run(tmp_path / 'b', 2).epochs_run == 1
    want, got = (_final(str(tmp_path / d / 'groundlink')) for d in ('a', 'b'))
    assert want['step'] == got['step'] == 2 * (len(data['train']) // BATCH)
    for k, v in want['model_state_dict'].items():
        assert torch.equal(v, got['model_state_dict'][k]), k


def test_the_trained_pallas_checkpoint_is_served(data, trained):
    cfg = trained['cfg']
    svc = InferenceService(cfg, trained['dir'], data['dev'], max_batch=64, device='cpu')
    assert svc.epoch == 1 and svc.model.attn_impl == 'pallas'
    server = serve(svc, host='127.0.0.1', port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        x = data['dev'].gather(np.arange(5)).inputs
        req = urllib.request.Request(
            f'http://127.0.0.1:{server.server_address[1]}/predict',
            data=json.dumps({'inputs': x.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())['outputs']
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    model = build_model_for_dataset(cfg, data['dev'])
    assert ckpt.load_latest_checkpoint(model, trained['dir']) == (1, 0)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(x))
    assert len(out) == 7
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(out[k], np.float32), v.numpy(), atol=1e-6)


def test_feedforward_and_vpu_train_through_plain_autograd(data, tmp_path):
    for model_type, fields in (('feedforward', dict(hidden_dims=[64, 64])),
                               ('transformer', dict(attn_impl='vpu'))):
        d = tmp_path / model_type
        cfg = _config(Config, model_type, checkpoint_dir=str(d), epochs=1,
                      device_data='off', keep_best=True, **fields)
        result = train(cfg, data['train'], data['dev'], device='cpu')
        assert result.epochs_run == 1 and np.isfinite(result.final_train_metrics['loss'])
        # --keep-best scored the last state too and kept a named checkpoint
        assert os.path.exists(d / ckpt.BEST_NAME)
        assert [c[:2] for c in ckpt.list_checkpoints(str(d))] == [(0, 0)]


def test_checkpoint_cadence_pruning_and_early_stop(data, tmp_path):
    # per-step dispatch: a checkpoint at every third batch (chunked, the
    # cadence fires once a chunk; tests/test_torch_chunked_step.py)
    d = tmp_path / 'feedforward'
    cfg = _config(Config, 'feedforward', hidden_dims=[32], checkpoint_dir=str(d),
                  epochs=3, checkpoint_every_batches=3, keep_checkpoints=2,
                  learning_rate=0.0, early_stop_patience=1, device_chunk_steps=1)
    result = train(cfg, data['train'], data['dev'], device='cpu', max_batches_per_epoch=7)
    # lr 0: the dev loss cannot improve after the first eval, so patience 1
    # stops before epoch 1; of epoch 0's checkpoints (3, 6, end) two are kept
    assert result.epochs_run == 1 and result.windows_seen == 7 * BATCH
    assert [c[:2] for c in ckpt.list_checkpoints(str(d))] == [(0, 3), (0, 6)]


def test_checkpoint_payloads_old_and_new(data, tmp_path):
    cfg = _config(Config, 'feedforward', hidden_dims=[32])
    model = build_model_for_dataset(cfg, data['train'])
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'adam', 1e-3))
    assert num_params(state) == sum(p.numel() for p in model.parameters())
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    state.apply_gradients()
    old = ckpt.save_checkpoint(str(tmp_path / 'old'), model, 2, 0)      # model only
    new = ckpt.save_checkpoint(str(tmp_path / 'new'), state, 2, 5)
    assert set(torch.load(old, weights_only=True)) == {'epoch', 'batch', 'model_state_dict'}
    # a bare model reads both; a train state reads both, the old one with a
    # fresh optimizer
    for path, where in ((old, (2, 0)), (new, (2, 5))):
        fresh = build_model_for_dataset(cfg, data['train'],
                                        generator=torch.Generator().manual_seed(9))
        assert ckpt.load_checkpoint_file(fresh, path) == where
        assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(), model.parameters()))
        st = create_train_state(fresh, make_optimizer(fresh.named_parameters(), 'adam', 1e-3))
        assert ckpt.load_checkpoint_file(st, path) == where
        assert st.step == (1 if path == new else 0)
    # another optimizer than the one that wrote the file starts fresh
    st = create_train_state(fresh, make_optimizer(fresh.named_parameters(), 'sgd', 1e-3))
    ckpt.load_checkpoint_file(st, new)
    assert st.step == 0 and not st.optimizer.state
    ckpt.warm_start_from(st, new)
    assert st.step == 0
    assert ckpt.load_latest_checkpoint(model, str(tmp_path / 'none')) == (-1, 0)
    assert ckpt.prune_checkpoints(str(tmp_path / 'new'), 0) == []
    # a checkpoint of another architecture names the likely flags
    other = build_model_for_dataset(_config(Config, 'feedforward', hidden_dims=[16]),
                                    data['train'])
    with pytest.raises(ValueError, match='--hidden-dims'):
        ckpt.load_checkpoint_file(other, new)


def test_resume_refuses_another_architecture_and_warm_start_yields_to_resume(
        data, trained, tmp_path):
    cfg = dataclasses.replace(trained['cfg'], attn_impl='vpu')
    with pytest.raises(ValueError, match='attn_impl'):
        train(cfg, data['train'], data['dev'], device='cpu')
    d = tmp_path / 'transformer'
    cfg = dataclasses.replace(
        trained['cfg'], checkpoint_dir=str(d), epochs=1, learning_rate=0.0,
        init_from_checkpoint=os.path.join(trained['dir'], 'epoch_1_batch_0.torch.pt'))
    train(cfg, data['train'], None, device='cpu', max_batches_per_epoch=1)
    got = torch.load(str(d / 'epoch_0_batch_0.torch.pt'), weights_only=True)
    want = _final(trained['dir'])
    # lr 0: the warm-started parameters come through untouched, on a fresh optimizer
    assert all(torch.equal(v, got['model_state_dict'][k])
               for k, v in want['model_state_dict'].items())
    assert got['step'] == 1


def test_compute_report_scores_the_dev_batches(data, tmp_path, capsys):
    """``train --compute-report`` (refused until the analytical and physics
    slice): the dev report carries ``tau_avg_err``, the mean of the torque
    report over the dev batches the host loader gives the eval step (not the
    device-resident dev eval), with the dev subject's skeleton read from its
    file; the report function itself is held to the JAX package in
    tests/test_torch_analytical.py."""
    from inferbiomechanics_tpu_torch.loss.tau_report import make_tau_report_fn
    argv = ['train', '--dataset-home', str(data['root']), '--checkpoint-dir', str(tmp_path),
            '--batch-size', str(BATCH), '--epochs', '1', '--compute-report', '--no-wandb',
            '--device', 'cpu']
    args = build_parser().parse_args(argv)
    result = run_training(args)
    assert 'Non-root Joint Torques (Inverse Dynamics) Avg Err' in capsys.readouterr().out
    cfg = _config(Config, 'feedforward', compute_report=True)
    dev = WindowDataset(str(data['root'] / 'dev'), window_size=50, stride=5)
    assert dev.skeletons and dev.skeletons[0] is not None
    tau_fn = make_tau_report_fn(dev, 'cpu')
    model = build_model_for_dataset(cfg, data['train'],
                                    generator=torch.Generator().manual_seed(cfg.seed))
    step = make_eval_step(model, dev.lab_offsets, loss_config_from(cfg))
    values = []
    for b in PrefetchLoader(dev, BATCH, shuffle=False).epoch(seed=cfg.seed * 1_000_003):
        outputs, _ = step(None, b.inputs, b.labels)
        values.append(tau_fn(b.inputs, outputs, unpack(b.labels, dev.lab_offsets),
                             b.subject_indices))
    assert len(values) == len(dev) // BATCH
    assert result.final_dev_metrics['tau_avg_err'] == pytest.approx(float(np.mean(values)),
                                                                   rel=1e-6)


@pytest.mark.parametrize('fields,flag', [
    # ported (parallel/pipeline.py; tests/test_torch_pipeline.py trains it on
    # gloo ranks): one process is a world of one device, which
    # --pipeline-parallel 2 does not divide (the JAX make_pipeline_mesh
    # refusal, before any file); the pallas tree keeps the JAX loop's refusal
    (dict(model_type='transformer', attn_impl='vpu', pipeline_parallel=2),
     '--pipeline-parallel'),
    # ported: one process is a world of one device, which --model-parallel 2
    # does not divide (the JAX package's make_mesh refusal, before any file)
    (dict(model_parallel=2), '--model-parallel'),
    # ported: the case holds the flag working (one process: a single data
    # shard, so ignored as the JAX package ignores it; the f32 run's checkpoints)
    (dict(grad_allreduce_dtype='bf16'), None),
    # ported: the case holds the flag working (the JAX diffusion loop never
    # reads it: the same checkpoint as the run without it)
    (dict(model_type='diffusion', compute_report=True), None),
    # ported: the case holds the flag working (the same checkpoints as the
    # synchronous writer's)
    (dict(async_checkpoint=True), None),
    # ported: the case holds the flag working (a trace of the first epoch,
    # the checkpoints bitwise the unprofiled run's)
    (dict(profile=True), None),
    # ported: the case holds the flag working (the sharded tier of one rank:
    # one checkpoint an epoch)
    (dict(device_data='sharded'), None),
    # ported: the case holds the flag working (two segments, streamed in
    # chunks and step by step, the same checkpoints)
    (dict(device_data='stream'), None),
], ids=[  # each case keeps the id it is known by
    'fields0---pipeline-parallel', 'fields1---model-parallel',
    'fields2---grad-allreduce-dtype bf16', 'fields5---compute-report',
    'fields6---async-checkpoint', 'fields7---profile', 'fields9---device-data sharded',
    'fields10---device-data stream'])
def test_unported_training_flags_raise_by_name(data, tmp_path, fields, flag):
    fields = {'model_type': 'feedforward', **fields}
    cfg = _config(Config, fields.pop('model_type'), checkpoint_dir=str(tmp_path / 'c'),
                  **fields)
    run = train_diffusion if cfg.model_type == 'diffusion' else train
    if cfg.pipeline_parallel > 1:
        with pytest.raises(ValueError, match='1 devices not divisible by pipe=2'):
            run(cfg, data['train'], data['dev'], device='cpu')
        with pytest.raises(ValueError, match="--pipeline-parallel supports attn_impl "
                                             "'vpu'/'flax' only"):
            run(dataclasses.replace(cfg, attn_impl='pallas'), data['train'], data['dev'],
                device='cpu')
        assert not os.path.exists(tmp_path / 'c')
        return
    if cfg.compute_report:
        ds = WindowDataset(str(data['root'] / 'train'), window_size=50, stride=5,
                           output_data_format='all_frames', skip_loading_skeletons=True)
        files = []
        for d, report in (('r', True), ('n', False)):
            small = dataclasses.replace(
                cfg, checkpoint_dir=str(tmp_path / d), output_data_format='all_frames',
                d_model=64, num_layers=1, num_heads=4, diffusion_timesteps=64, epochs=1,
                compute_report=report)
            assert run(small, ds, None, device='cpu').epochs_run == 1
            files.append(ckpt.list_checkpoints(small.checkpoint_dir))
        assert [f[:2] for f in files[0]] == [f[:2] for f in files[1]] == [(0, 0)]
        for (_, _, a), (_, _, b) in zip(*files):
            with open(a, 'rb') as fa, open(b, 'rb') as fb:
                assert fa.read() == fb.read(), a
        return
    if cfg.device_data == 'stream':
        ds = data['train']
        files = []
        for d, k in (('c', 2), ('s', 1)):
            small = dataclasses.replace(
                cfg, checkpoint_dir=str(tmp_path / d), hidden_dims=[32], epochs=2,
                device_chunk_steps=k, device_data_max_bytes=260 * 4 * (
                    ds.num_input_channels + ds.num_label_channels))
            result = run(small, ds, data['dev'], device='cpu')
            assert result.epochs_run == 2
            files.append(ckpt.list_checkpoints(small.checkpoint_dir))
        assert [f[:2] for f in files[0]] == [f[:2] for f in files[1]] == [(0, 0), (1, 0)]
        for (_, _, a), (_, _, b) in zip(*files):
            pa, pb = (torch.load(p, weights_only=True)['model_state_dict'] for p in (a, b))
            assert all(torch.equal(v, pb[k]) for k, v in pa.items()), a
        return
    if cfg.device_data == 'sharded':
        small = dataclasses.replace(cfg, hidden_dims=[32], epochs=2)
        assert run(small, data['train'], data['dev'], device='cpu').epochs_run == 2
        assert [f[:2] for f in ckpt.list_checkpoints(small.checkpoint_dir)] == [(0, 0), (1, 0)]
        return
    if cfg.grad_allreduce_dtype == 'bf16':
        files = []
        for d, dtype in (('b', 'bf16'), ('f', 'f32')):
            small = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / d), hidden_dims=[32],
                                        epochs=1, grad_allreduce_dtype=dtype)
            run(small, data['train'], None, device='cpu')
            files.append(ckpt.list_checkpoints(small.checkpoint_dir))
        assert [f[:2] for f in files[0]] == [f[:2] for f in files[1]] and files[0]
        for (_, _, a), (_, _, b) in zip(*files):
            pa, pb = (torch.load(p, weights_only=True)['model_state_dict'] for p in (a, b))
            assert all(torch.equal(v, pb[k]) for k, v in pa.items()), a
        return
    if cfg.profile:
        files = []
        for d, profile in (('p', True), ('u', False)):
            small = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / d), hidden_dims=[32],
                                        epochs=2, profile=profile,
                                        profile_dir=str(tmp_path / 'trace'))
            run(small, data['train'], data['dev'], device='cpu')
            files.append(ckpt.list_checkpoints(small.checkpoint_dir))
        assert [f[:2] for f in files[0]] == [f[:2] for f in files[1]] == [(0, 0), (1, 0)]
        for (_, _, a), (_, _, b) in zip(*files):
            with open(a, 'rb') as fa, open(b, 'rb') as fb:
                assert fa.read() == fb.read(), a
        traces = os.listdir(tmp_path / 'trace')
        assert len(traces) == 1 and traces[0].startswith('rank0.')
        with open(tmp_path / 'trace' / traces[0]) as f:
            assert json.load(f)['traceEvents']
        return
    if flag is None:
        files = []
        for d, async_checkpoint in (('c', True), ('s', False)):
            small = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / d), hidden_dims=[32],
                                        epochs=2, checkpoint_every_batches=2,
                                        device_chunk_steps=1,
                                        async_checkpoint=async_checkpoint)
            run(small, data['train'], None, device='cpu')
            files.append(ckpt.list_checkpoints(small.checkpoint_dir))
        assert [f[:2] for f in files[0]] == [f[:2] for f in files[1]] and len(files[0]) >= 4
        for (_, _, a), (_, _, b) in zip(*files):
            with open(a, 'rb') as fa, open(b, 'rb') as fb:
                assert fa.read() == fb.read(), a
        return
    if cfg.model_parallel > 1:
        with pytest.raises(ValueError, match='1 devices not divisible by model_parallel=2'):
            run(cfg, data['train'], data['dev'], device='cpu')
        assert not os.path.exists(tmp_path / 'c')
        return
    with pytest.raises(NotImplementedError, match=f'{flag} is not yet ported'):
        run(cfg, data['train'], data['dev'], device='cpu')
    assert not os.path.exists(tmp_path / 'c')


@pytest.mark.parametrize('argv,error,match', [
    # ported: the case holds the flag working (pickle-data's blocks train
    # bitwise as the .b3d files)
    (['--use-pickled'], None, None),
    # ported: the case holds the flag working (the banded lowering trains;
    # its checkpoint is the direct conv's tree and evaluates the same)
    (['--model-type', 'groundlink', '--conv-impl', 'banded'], None, 'banded'),
    (['--model-type', 'transformer', '--attn-impl', 'pallas', '--dropout',
      '--dropout-prob', '0.1'], ValueError, 'does not support dropout'),
    ([], RuntimeError, r'is_available\(\) is False'),        # --device cuda is the default
], ids=[  # each case keeps the id it is known by
    'argv0-NotImplementedError---use-pickled is not yet ported', 'argv3-ValueError-not ported',
    'argv4-ValueError-does not support dropout',
    'argv5-RuntimeError-is_available\\(\\) is False'])
def test_train_command_refusals(data, tmp_path, argv, error, match, monkeypatch):
    monkeypatch.setattr(urllib.request, 'urlretrieve', _refuse_download)
    args = ['train', '--dataset-home', str(data['root']), '--checkpoint-dir',
            str(tmp_path), '--batch-size', str(BATCH), '--no-wandb', '--geometry-folder',
            str(tmp_path), *argv]
    if '--device' not in argv and argv:
        args += ['--device', 'cpu']
    if match == 'banded':
        assert main([*args, '--epochs', '1']) == 0
        with open(tmp_path / 'groundlink' / 'run_config.json') as f:
            assert json.load(f)['conv_impl'] == 'banded'
        sd = torch.load(tmp_path / 'groundlink' / 'epoch_0_batch_0.torch.pt',
                        weights_only=True)['model_state_dict']
        x = next(iter(PrefetchLoader(data['dev'], 4, shuffle=False).epoch(seed=0))).inputs
        outs = []
        for impl in ('banded', 'xla'):
            model = build_model_for_dataset(_config(Config, 'groundlink', conv_impl=impl),
                                            data['train'])
            model.load_state_dict(sd)
            with torch.no_grad():
                outs.append(model.eval()(x))
        for k, v in outs[0].items():
            assert torch.equal(v, outs[1][k]), k
        return
    if error is None:
        home = tmp_path / 'home'
        shutil.copytree(data['root'], home)
        assert main(['pickle-data', '--dataset-home', str(home)]) == 0
        more = ['--dataset-home', str(home), '--hidden-dims', '32', '--epochs', '1']
        assert main([*args, *more]) == 0
        b3d = [a for a in args if a != '--use-pickled']
        assert main([*b3d, *more, '--checkpoint-dir', str(tmp_path / 'b3d')]) == 0
        a, b = (tmp_path / d / 'feedforward' / 'epoch_0_batch_0.torch.pt'
                for d in ('.', 'b3d'))
        with open(a, 'rb') as fa, open(b, 'rb') as fb:
            assert fa.read() == fb.read()
        return
    with pytest.raises(error, match=match):
        main(args)


def test_train_command_trains_and_serves_from_the_sidecar(data, tmp_path):
    parser = build_parser()
    args = parser.parse_args([
        'train', '--dataset-home', str(data['root']), '--checkpoint-dir', str(tmp_path),
        '--model-type', 'transformer', '--attn-impl', 'pallas', '--d-model', '128',
        '--num-layers', '1', '--num-heads', '4', '--batch-size', str(BATCH),
        '--epochs', '1', '--device', 'cpu', '--device-chunk-steps', '8'])
    assert parser.parse_args(['train']).device == 'cuda'
    result = run_training(args)
    assert result.epochs_run == 1
    assert os.path.exists(tmp_path / 'transformer' / 'epoch_0_batch_0.torch.pt')
    # serve takes the architecture from the sidecar the trainer wrote
    from inferbiomechanics_tpu_torch.cli.serve_cmd import start
    svc, server = start(parser.parse_args([
        'serve', '--dataset-home', str(data['root']), '--checkpoint-dir', str(tmp_path),
        '--model-type', 'transformer', '--use-run-config', '--port', '0',
        '--device', 'cpu']))
    try:
        assert (svc.config.attn_impl, svc.config.d_model, svc.config.num_layers) == (
            'pallas', 128, 1)
        assert svc.epoch == 0
        out = svc.predict(data['dev'].gather(np.arange(3)).inputs)
        assert len(out) == 7 and all(np.isfinite(v).all() for v in out.values())
    finally:
        server.server_close()
        svc.close()
    assert main(['train', '--model-type', 'analytical']) == 0


def test_run_config_copy_is_the_jax_packages(tmp_path):
    for name in ('RUN_CONFIG_NAME', 'SCHEMA_VERSION', 'ARCHITECTURE_FIELDS',
                 'SHAPE_CRITICAL_FIELDS'):
        assert getattr(run_config, name) == getattr(jax_run_config, name), name
    cfg, jcfg = _config(Config, 'transformer'), _config(JaxConfig, 'transformer')
    run_config.save_run_config(str(tmp_path / 'a'), cfg)
    jax_run_config.save_run_config(str(tmp_path / 'b'), jcfg)
    ours, theirs = (json.load(open(tmp_path / d / 'run_config.json')) for d in 'ab')
    assert ours == theirs
    # each package reads the other's sidecar
    assert run_config.architecture_mismatches(cfg, theirs) == []
    drifted = dataclasses.replace(cfg, d_model=256, activation='relu')
    assert run_config.architecture_mismatches(drifted, theirs) == \
        jax_run_config.architecture_mismatches(
            dataclasses.replace(jcfg, d_model=256, activation='relu'), ours)
    with pytest.raises(ValueError, match='d_model'):
        run_config.check_resume_architecture(drifted, str(tmp_path / 'b'))
    assert len(run_config.warn_on_architecture_mismatch(drifted, str(tmp_path / 'b'))) == 2
    assert run_config.apply_architecture(drifted, theirs).d_model == 128
    assert run_config.load_run_config(str(tmp_path / 'none')) is None
