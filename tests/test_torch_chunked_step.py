"""The port's chunked train step (inferbiomechanics_tpu_torch/train/step.py
``ChunkedStep``, ``make_chunked_train_step``; train/device_data.py
``make_device_chunked_step``; the chunked epoch in train/loop.py) on the CPU,
at small sizes (window 50 / stride 5, a d_model 128 / 2 layer / 4 head
``pallas`` transformer, narrow ``vpu`` and feedforward models, GroundLink at
its defaults).

On a CUDA device a chunk replays a step captured as a CUDA graph; on the CPU
it runs the same steps eagerly. Held here:

- a chunk of K steps is bitwise K calls of the per-step function, for every
  trained model, GroundLink's dropout and ``--grad-accum-steps 2`` included;
- the chunked ``train`` (both data tiers, ``--host-upload-dtype bf16`` on
  the host tier) tracks the JAX package's chunked ``train`` from the same
  weights on the same batches, step by step, at the tolerance
  tests/test_torch_train.py holds the per-step path to (each step's loss
  within 2e-2 relative), and logs and checkpoints at the same batches;
- chunked equals per-step through ``train``, and a run resumed from a
  checkpoint written inside a chunk (every trained model), or at a chunk
  boundary after SIGTERM, ends bitwise where the uninterrupted run ends.

The graph capture itself runs only on the card (``chip_smoke.py``, and
tests/test_torch_cuda_kernels.py).
"""

import os
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.config import Config as JaxConfig
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.train import loop as jax_loop
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.models.common import generator_masks
from inferbiomechanics_tpu_torch.train import checkpoint as ckpt
from inferbiomechanics_tpu_torch.train import loop
from inferbiomechanics_tpu_torch.train.device_data import (
    DeviceResidentData, make_device_chunked_step, make_device_train_step,
)
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
from inferbiomechanics_tpu_torch.train.state import create_train_state
from inferbiomechanics_tpu_torch.train.step import (
    RowLayout, make_chunked_train_step, make_train_step,
)

LOSS_REL = 2e-2          # tests/test_torch_train.py's, for each step's loss
BATCH = 32
SMALL = dict(d_model=128, num_layers=2, num_heads=4)
MODELS = {
    'feedforward': dict(hidden_dims=[64]),
    'vpu': dict(model_type='transformer', attn_impl='vpu', d_model=64, num_layers=1,
                num_heads=4),
    'pallas': dict(model_type='transformer', attn_impl='pallas', aux_tau_weight=0.1,
                   **SMALL),
    'groundlink': dict(model_type='groundlink'),
}


def _config(cls, name, **fields):
    cfg = cls()
    cfg.model_type = 'feedforward'
    cfg.batch_size = BATCH
    for k, v in {**MODELS[name], **fields}.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """Small models: one thread keeps the sums in one order and does not
    fight the other test processes for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp('chunked_data')
    os.makedirs(root / 'train')
    write_synthetic_subject(str(root / 'train' / 's.b3d'), num_trials=2,
                            trial_length=260, seed=0)
    kw = dict(window_size=50, stride=5, skip_loading_skeletons=True)
    return {'root': root, 'train': WindowDataset(str(root / 'train'), **kw),
            'jax_train': JaxWindowDataset(str(root / 'train'), **kw)}


def _state(data, name, seed=0):
    """A fresh model of ``name`` and its train state: adam on a warm-up
    cosine schedule (step-dependent learning rate and bias corrections), and
    GroundLink's dropout generator as the train loop sets it."""
    cfg = _config(Config, name)
    model = loop.build_model_for_dataset(cfg, data['train'],
                                         generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, make_optimizer(
        model.named_parameters(), 'adam', 1e-3, lr_schedule='warmup_cosine',
        lr_decay_steps=8, lr_warmup_steps=2))
    if hasattr(model, 'dropout_masks'):
        state.dropout_gen, state.dropout_seed = torch.Generator(), 7
        model.dropout_masks = generator_masks(state.dropout_gen)
    return cfg, model, state


def _assert_states_equal(a, b):
    assert a.step == b.step
    assert a.optimizer.param_groups[0].get('count') == b.optimizer.param_groups[0].get('count')
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        for k, v in a.optimizer.state[p].items():
            assert torch.equal(v, b.optimizer.state[q][k]), k


@pytest.mark.parametrize('name,accum', [('feedforward', 1), ('vpu', 1), ('pallas', 1),
                                        ('groundlink', 1), ('feedforward', 2),
                                        ('pallas', 2), ('groundlink', 2)])
def test_a_device_chunk_is_k_per_step_calls_bitwise(data, name, accum):
    """Two chunks (3 steps, then a remainder of 2) against 5 per-step calls
    from the same weights: every step's metrics, the parameters, the
    optimizer state and the counts bitwise equal."""
    ddata = DeviceResidentData(data['train'], 'cpu')
    idx = np.random.default_rng(1).permutation(len(data['train']))[:5 * BATCH]
    idx = idx.reshape(5, BATCH)
    cfg, _, per = _state(data, name)
    lc = loop.loss_config_from(cfg)
    step = make_device_train_step(per.model, ddata, lc, grad_accum=accum)
    want = [step(per, torch.from_numpy(i)) for i in idx]
    _, _, chunked = _state(data, name)
    chunk = make_device_chunked_step(chunked.model, ddata, lc, grad_accum=accum)
    got = chunk(chunked, idx[:3]).rows() + chunk(chunked, idx[3:]).rows()
    assert len(got) == len(want) == chunked.step == 5
    for k, (w, g) in enumerate(zip(want, got)):
        assert set(w) == set(g)
        for key in w:
            assert np.array_equal(w[key].numpy(), g[key]), (k, key)
    _assert_states_equal(per, chunked)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_a_host_chunk_is_k_per_step_calls_bitwise(data, dtype):
    """The host tier: K host batches through the chunk against the per-step
    step on the same batches uploaded in ``dtype`` (bf16: rounded on the
    host, as ``--host-upload-dtype bf16`` does)."""
    batches = list(data['train'].batches(BATCH, seed=3))[:4]
    cfg, _, per = _state(data, 'pallas')
    lc = loop.loss_config_from(cfg)
    step = make_train_step(per.model, data['train'].lab_offsets, lc)
    want = [step(per, torch.from_numpy(b.inputs).to(dtype), torch.from_numpy(b.labels))
            for b in batches]
    _, _, chunked = _state(data, 'pallas')
    chunk = make_chunked_train_step(chunked.model, data['train'].lab_offsets, lc,
                                    input_dtype=dtype, device='cpu')
    got = chunk(chunked, [b.inputs for b in batches], [b.labels for b in batches]).rows()
    assert [float(w['loss']) for w in want] == [float(g['loss']) for g in got]
    _assert_states_equal(per, chunked)
    if dtype == torch.bfloat16:     # the rounding is not a no-op on these inputs
        x = torch.from_numpy(batches[0].inputs)
        assert not torch.equal(x.to(dtype).float(), x)


def test_the_loader_rounds_inputs_to_bf16_on_the_host(data):
    """``--host-upload-dtype bf16`` step by step: the loader's batches hold
    the inputs rounded to bf16 and the labels in float32, otherwise the
    dataset's batches."""
    from inferbiomechanics_tpu_torch.data.loader import PrefetchLoader
    loader = PrefetchLoader(data['train'], BATCH, device='cpu', input_dtype=torch.bfloat16)
    got = list(loader.epoch(seed=4))
    want = list(data['train'].batches(BATCH, seed=4))
    assert len(got) == len(want) > 3
    for a, b in zip(got, want):
        assert a.inputs.dtype == torch.bfloat16 and a.labels.dtype == torch.float32
        assert torch.equal(a.inputs, torch.from_numpy(b.inputs).to(torch.bfloat16))
        assert np.array_equal(a.labels.numpy(), b.labels)


def test_row_layout_puts_each_tensor_on_16_bytes():
    specs = [((3,), torch.int64), ((5, 3), torch.bfloat16), ((7,), torch.float32),
             ((3,), torch.float32)]
    layout = RowLayout(specs)
    assert all(at % 16 == 0 for at in layout.offsets) and layout.nbytes % 16 == 0
    rows = torch.zeros((4, layout.nbytes), dtype=torch.uint8)
    values = [torch.arange(int(np.prod(s)) * 4).reshape(4, *s).to(dt) for s, dt in specs]
    for col, v in zip(layout.views(rows), values):
        col.copy_(v)
    for j in range(4):                  # each row holds its step's tensors
        for view, v in zip(layout.views(rows[j]), values):
            assert torch.equal(view, v[j])


@pytest.mark.parametrize('opt_type,schedule', [('adam', 'warmup_cosine'), ('adamax', 'linear'),
                                               ('rmsprop', 'constant'), ('sgd', 'cosine')])
def test_next_scalars_are_the_updates_own(opt_type, schedule):
    """The scalars a chunk uploads for its j-th step are those the update
    computes when its turn comes: the schedule's learning rate and optax's
    float32 bias corrections."""
    from inferbiomechanics_tpu_torch.train.optimizers import _bias_correction, make_lr_schedule
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([('p', p)], opt_type, 1e-2, lr_schedule=schedule,
                         lr_decay_steps=6, lr_warmup_steps=2)
    lr = make_lr_schedule(schedule, 1e-2, 6, 2)
    ahead = [opt.next_scalars(ahead=j) for j in range(5)]
    for j in range(5):
        now = opt.next_scalars()
        assert np.array_equal(now, ahead[j]), j
        assert now.dtype == np.float32
        assert now[0] == np.float32(lr(j) if callable(lr) else lr)
        if opt_type in ('adam', 'adamax'):
            assert now[1:].tolist() == [np.float32(_bias_correction(0.9, j + 1)),
                                        np.float32(_bias_correction(0.999, j + 1))]
        p.grad = torch.full((3,), 0.5)
        opt.step()
        assert torch.equal(opt.scalars, torch.from_numpy(now))


class _Logged:
    """A metric logger that keeps the train loop's loss records."""

    def __init__(self):
        self.records = []

    def log(self, record):
        if 'train/loss' in record and 'batch' in record:
            self.records.append((record['epoch'], record['batch'], record['train/loss']))


def _recording(cls, sink):
    """``cls`` (either package's RegressionLossEvaluator) noting the loss
    of every train step it accounts, in order."""
    class Recording(cls):
        def __call__(self, *args, **kw):
            if self.split == 'train':
                sink.append(float(kw['precomputed_metrics']['loss']))
            return super().__call__(*args, **kw)
    return Recording


@pytest.mark.parametrize('tier', ['device', 'host'])
def test_chunked_train_tracks_the_jax_package(data, tmp_path, monkeypatch, tier):
    """Both packages' ``train`` with chunks of 4 over one epoch of 13 steps
    (three chunks and a remainder of 1), a checkpoint every 3 batches, from
    the same weights: each step's loss within LOSS_REL, the loss logged and
    a checkpoint written at the same batches (once a chunk that crosses
    the cadence, labelled with its last batch). ``host``: the host-loader
    tier with ``--host-chunk-steps 4 --host-upload-dtype bf16``."""
    fields = dict(epochs=1, checkpoint_every_batches=3, log_every_batches=5)
    fields.update(dict(device_chunk_steps=4) if tier == 'device' else
                  dict(device_data='off', host_chunk_steps=4, host_upload_dtype='bf16'))
    jcfg = _config(JaxConfig, 'pallas', checkpoint_dir=str(tmp_path / 'jax'), **fields)
    cfg = _config(Config, 'pallas', checkpoint_dir=str(tmp_path / 'port'), **fields)
    start = {}
    make_state = jax_loop.create_train_state

    def capture(*args, **kw):
        state = make_state(*args, **kw)
        start['params'] = jax.device_get(state.params)
        return state

    losses = {'jax': [], 'port': []}
    logged = {'jax': _Logged(), 'port': _Logged()}
    monkeypatch.setattr(jax_loop, 'create_train_state', capture)
    monkeypatch.setattr(jax_loop, 'RegressionLossEvaluator',
                        _recording(jax_loop.RegressionLossEvaluator, losses['jax']))
    jax_loop.train(jcfg, data['jax_train'], None, metric_logger=logged['jax'])

    build = loop.build_model_for_dataset

    def with_jax_weights(*args, **kw):
        model = build(*args, **kw)
        model.load_state_dict(weights.transformer_pallas_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, start['params'])))
        return model

    monkeypatch.setattr(loop, 'build_model_for_dataset', with_jax_weights)
    monkeypatch.setattr(loop, 'RegressionLossEvaluator',
                        _recording(loop.RegressionLossEvaluator, losses['port']))
    result = loop.train(cfg, data['train'], None, metric_logger=logged['port'], device='cpu')
    steps = len(data['train']) // BATCH
    assert steps == 13 and result.windows_seen == steps * BATCH
    assert len(losses['port']) == len(losses['jax']) == steps
    np.testing.assert_allclose(losses['port'], losses['jax'], rtol=LOSS_REL)
    assert [r[:2] for r in logged['port'].records] == [r[:2] for r in logged['jax'].records] \
        == [(0, 3), (0, 7), (0, 11)]
    jax_ckpts = [c[:2] for c in jax_loop.list_checkpoints(str(tmp_path / 'jax'))]
    assert [c[:2] for c in ckpt.list_checkpoints(str(tmp_path / 'port'))] == jax_ckpts \
        == [(0, 0), (0, 3), (0, 7), (0, 11), (0, 12)]


def _run(data, d, logger=None, name='groundlink', **fields):
    cfg = _config(Config, name, checkpoint_dir=str(d), epochs=2, **fields)
    return loop.train(cfg, data['train'], None, metric_logger=logger, device='cpu')


def _final(d, epoch=1):
    return torch.load(os.path.join(d, f'epoch_{epoch}_batch_0.torch.pt'),
                      map_location='cpu', weights_only=True)


def _assert_same_final(a, b):
    want, got = _final(str(a)), _final(str(b))
    assert want['step'] == got['step']
    for k, v in want['model_state_dict'].items():
        assert torch.equal(v, got['model_state_dict'][k]), k
    for i, st in want['optimizer_state_dict']['state'].items():
        for k, v in st.items():
            assert torch.equal(v, got['optimizer_state_dict']['state'][i][k]), (i, k)


@pytest.fixture(scope='module')
def chunked_run(data, tmp_path_factory):
    """Two epochs of GroundLink (dropout 0.2) with chunks of 4 and a
    checkpoint every 3 batches."""
    d = tmp_path_factory.mktemp('chunked_run')
    result = _run(data, d, device_chunk_steps=4, checkpoint_every_batches=3)
    return d, result


def test_chunked_train_is_per_step_train_bitwise(data, chunked_run, tmp_path):
    d, result = chunked_run
    assert result.epochs_run == 2 and not result.preempted
    assert [c[:2] for c in ckpt.list_checkpoints(str(d))] == [
        (0, 0), (0, 3), (0, 7), (0, 11), (0, 12), (1, 0), (1, 3), (1, 7), (1, 11), (1, 12)]
    _run(data, tmp_path, device_chunk_steps=1, checkpoint_every_batches=1000)
    _assert_same_final(d, tmp_path)


def test_a_resume_from_inside_a_chunk_is_the_uninterrupted_run(data, chunked_run, tmp_path):
    """Epoch 0's checkpoint at batch 7 (chunk 4..7 crossed the cadence at 6)
    holds the state after batch 7: resumed from it alone, the run ends
    bitwise where the uninterrupted one ends."""
    d, _ = chunked_run
    shutil.copy(os.path.join(d, 'epoch_0_batch_7.torch.pt'), tmp_path)
    resumed = _run(data, tmp_path, device_chunk_steps=4, checkpoint_every_batches=3)
    assert resumed.windows_seen == (2 * 13 - 8) * BATCH
    _assert_same_final(d, tmp_path)


@pytest.mark.parametrize('name', ['feedforward', 'vpu', 'pallas'])
def test_each_model_resumed_inside_a_chunk_is_the_uninterrupted_run(data, tmp_path, name):
    """The other trained models (GroundLink: the test above): resumed from
    the checkpoint written inside a chunk, bitwise the uninterrupted run."""
    fields = dict(name=name, device_chunk_steps=4, checkpoint_every_batches=3)
    _run(data, tmp_path / 'a', **fields)
    (tmp_path / 'b').mkdir()
    shutil.copy(tmp_path / 'a' / 'epoch_0_batch_7.torch.pt', tmp_path / 'b')
    resumed = _run(data, tmp_path / 'b', **fields)
    assert resumed.windows_seen == (2 * 13 - 8) * BATCH
    _assert_same_final(tmp_path / 'a', tmp_path / 'b')


def test_sigterm_stops_at_a_chunk_boundary_and_resumes_bitwise(data, chunked_run, tmp_path):
    class Killer:
        def log(self, record):
            if record.get('epoch') == 0 and record.get('batch') == 3:
                os.kill(os.getpid(), signal.SIGTERM)

    # the loss of chunk 0..3 is read after chunk 4..7 went out: the stop
    # comes at batch 7, a chunk boundary
    first = _run(data, tmp_path, device_chunk_steps=4, checkpoint_every_batches=1000,
                 log_every_batches=1, logger=Killer())
    assert first.preempted and first.epochs_run == 0 and first.windows_seen == 8 * BATCH
    assert [c[:2] for c in ckpt.list_checkpoints(str(tmp_path))] == [(0, 7)]
    resumed = _run(data, tmp_path, device_chunk_steps=4, checkpoint_every_batches=1000)
    assert not resumed.preempted and resumed.epochs_run == 2
    assert first.windows_seen + resumed.windows_seen == 2 * 13 * BATCH
    _assert_same_final(chunked_run[0], tmp_path)
