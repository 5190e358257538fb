"""``AsyncCheckpointer`` and ``--async-checkpoint`` held against the port's
synchronous writer, as ``tests/test_train.py`` holds the JAX package's:

- the asynchronous and the synchronous file of one state load to bitwise
  equal payloads, and are the same bytes (``torch.save`` of one payload
  structure under one temporary name writes the same archive);
- back-to-back saves land in order, pruning runs after each commit, no
  ``.tmp`` file is left; a failed write re-raises at ``wait()``, once;
- ``train --async-checkpoint`` writes the checkpoints ``train`` writes, step
  by step and chunked, with ``--keep-checkpoints``;
- a SIGTERM that reaches ``train`` (a subprocess, its writes slowed by a
  patched serialiser) while a write is in flight: the process exits 0, its
  newest checkpoint loads, and the same command resumes to the parameters
  and optimizer state of the uninterrupted run, bitwise.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.train import checkpoint as ckpt
from inferbiomechanics_tpu_torch.train.loop import train
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
from inferbiomechanics_tpu_torch.train.state import ParamEMA, create_train_state

REPO = Path(__file__).resolve().parents[1]
BATCH = 8


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp('async_ckpt_data')
    os.makedirs(root / 'train')
    write_synthetic_subject(str(root / 'train' / 's.b3d'), num_trials=2,
                            trial_length=120, seed=0)
    return {'root': root, 'train': WindowDataset(str(root / 'train'), window_size=20, stride=5,
                                                 skip_loading_skeletons=True)}


def _config(ckpt_dir, **fields):
    cfg = Config()
    cfg.model_type, cfg.window_size, cfg.stride = 'feedforward', 20, 5
    cfg.hidden_dims, cfg.batch_size, cfg.epochs = [32], BATCH, 2
    cfg.opt_type, cfg.learning_rate, cfg.checkpoint_every_batches = 'adam', 1e-3, 3
    cfg.checkpoint_dir = str(ckpt_dir)
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def _state(data):
    """A train state after one update, with an EMA."""
    model = build_model_for_dataset(_config('unused'), data['train'],
                                    generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'adam', 1e-3))
    state.ema = ParamEMA(model, 0.9)
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.5)
    state.apply_gradients()
    return state


def _assert_payloads_equal(a, b, where=''):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_payloads_equal(a[k], b[k], f'{where}/{k}')
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def _load(path):
    return torch.load(path, map_location='cpu', weights_only=True)


def test_async_writes_the_synchronous_file(data, tmp_path):
    state = _state(data)
    sync = ckpt.save_checkpoint(str(tmp_path / 'sync'), state, 3, 7)
    writer = ckpt.AsyncCheckpointer()
    writer.save(str(tmp_path / 'async'), state, 3, 7)
    writer.wait()
    assert writer.last_path.endswith('epoch_3_batch_7.torch.pt')
    _assert_payloads_equal(_load(writer.last_path), _load(sync))
    assert set(_load(sync)) == {'epoch', 'batch', 'model_state_dict', 'optimizer_state_dict',
                                'opt_type', 'step', 'ema_params'}
    with open(sync, 'rb') as f, open(writer.last_path, 'rb') as g:
        assert f.read() == g.read()


def test_saves_land_in_order_and_prune_after_the_commit(data, tmp_path):
    state = _state(data)
    d = str(tmp_path / 'async')
    writer = ckpt.AsyncCheckpointer()
    for e in range(4, 9):
        writer.save(d, state, e, 0, prune_keep=3)
    writer.save(d, state, 9, 0, filename=ckpt.BEST_NAME)
    # the snapshot is taken at save(): an update after it is not in the file
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    writer.wait()
    assert [(e, b) for e, b, _ in ckpt.list_checkpoints(d)] == [(6, 0), (7, 0), (8, 0)]
    assert sorted(os.listdir(d)) == sorted([ckpt.BEST_NAME] + [
        f'epoch_{e}_batch_0.torch.pt' for e in (6, 7, 8)])
    best = _load(os.path.join(d, ckpt.BEST_NAME))['model_state_dict']
    assert all(not torch.equal(best[k], v) for k, v in state.model.state_dict().items())


def test_a_failed_write_reraises_at_wait_once(data, tmp_path):
    state = _state(data)
    blocker = tmp_path / 'not_a_dir'
    blocker.write_text('a file where the checkpoint directory should be')
    writer = ckpt.AsyncCheckpointer()
    writer.save(str(blocker), state, 0, 0)
    with pytest.raises(OSError):
        writer.wait()
    writer.wait()
    writer.save(str(blocker), state, 0, 1)
    with pytest.raises(OSError):          # the next save surfaces it too
        writer.save(str(tmp_path / 'ok'), state, 0, 2)
    writer.wait()


def _checkpoints(d):
    return {(e, b): _load(p) for e, b, p in ckpt.list_checkpoints(str(d))}


@pytest.mark.parametrize('chunk', [1, 4])
def test_train_async_checkpoint_writes_the_synchronous_checkpoints(data, tmp_path, chunk):
    runs = {}
    for flag in (False, True):
        d = tmp_path / str(flag)
        cfg = _config(d, async_checkpoint=flag, device_chunk_steps=chunk, keep_checkpoints=3,
                      keep_best=False)
        result = train(cfg, data['train'], None, device='cpu')
        assert result.epochs_run == 2
        assert not [f for f in os.listdir(d) if f.endswith('.tmp')]
        runs[flag] = _checkpoints(d)
    assert list(runs[True]) == list(runs[False]) and len(runs[True]) == 3
    for k in runs[False]:
        _assert_payloads_equal(runs[True][k], runs[False][k], str(k))


_SLOW_TRAIN = """
import os, sys, time
import torch
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.train import checkpoint as ckpt
from inferbiomechanics_tpu_torch.train.loop import train

marker, root, ckpt_dir = sys.argv[1:4]
write = ckpt._write_payload

def slow_write(payload, path):
    with open(marker, 'a') as f:
        f.write(os.path.basename(path) + '\\n')
    time.sleep(1.5)
    return write(payload, path)

ckpt._write_payload = slow_write
torch.set_num_threads(1)
cfg = Config()
FIELDS
cfg.checkpoint_dir = ckpt_dir
ds = WindowDataset(os.path.join(root, 'train'), window_size=20, stride=5,
                   skip_loading_skeletons=True)
result = train(cfg, ds, None, device='cpu')
print('preempted', result.preempted)
"""


def test_sigterm_during_a_write_exits_cleanly_and_resumes_exactly(data, tmp_path):
    fields = dict(async_checkpoint=True, device_chunk_steps=1, epochs=3)
    base = _config('unused', **fields)
    script = textwrap.dedent(_SLOW_TRAIN).replace('FIELDS', '\n'.join(
        f'cfg.{k} = {getattr(base, k)!r}' for k in (
            'model_type', 'window_size', 'stride', 'hidden_dims', 'batch_size', 'epochs',
            'opt_type', 'learning_rate', 'checkpoint_every_batches', 'async_checkpoint',
            'device_chunk_steps')))
    marker, cut = tmp_path / 'writes', tmp_path / 'cut'
    proc = subprocess.Popen(
        [sys.executable, '-c', script, str(marker), str(data['root']), str(cut)],
        env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 120
    while not marker.exists() and time.time() < deadline and proc.poll() is None:
        time.sleep(0.05)
    assert marker.exists(), proc.communicate()[0]
    proc.send_signal(signal.SIGTERM)             # the first write is in flight
    out, _ = proc.communicate(timeout=180)
    assert proc.returncode == 0, out
    assert 'preempted True' in out and 'SIGTERM received' in out, out
    newest = ckpt.resolve_checkpoint_path(str(cut))
    assert newest is not None and not [f for f in os.listdir(cut) if f.endswith('.tmp')]
    epoch, batch = ckpt.load_checkpoint_file(
        build_model_for_dataset(base, data['train']), newest)
    assert (epoch, batch) != (2, 0), out           # stopped before the end
    # the same run (no slow writer) resumes; it ends where an uninterrupted
    # run ends, bitwise
    resumed = train(_config(cut, **fields), data['train'], None, device='cpu')
    assert not resumed.preempted
    train(_config(tmp_path / 'whole', **fields), data['train'], None, device='cpu')
    _assert_payloads_equal(_load(cut / 'epoch_2_batch_0.torch.pt'),
                           _load(tmp_path / 'whole' / 'epoch_2_batch_0.torch.pt'))
