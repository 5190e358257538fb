"""The port's small commands and lifted flags against the JAX package's, in
this process on the CPU: ``create-splits``, ``sanity-check``,
``RegressionLossEvaluator.plot_errors`` and ``analyze --plot-errors``,
``--profile`` in both training loops, and ``train``'s run log.

- ``create-splits``: the same tree, byte for byte, and the same lines.
- ``sanity-check``: the same text (both are numpy over the same matrices).
- ``plot_errors``: the arrays each package hands ``plt.plot`` within the
  f32 tolerance (rtol 1e-6 / atol 1e-7: the same squared differences), and
  the same file names; without matplotlib, the same arrays drawn by
  ``utils/png_plot.py`` into PNGs that decode.
- ``analyze --plot-errors``: the CSV rows equal those of the run without
  the flag (its splits go batch by batch, the others in chunks), and one
  PNG a selected component and split.
- ``--profile``: a trace is written on the CPU, the checkpoints are bitwise
  the unprofiled run's, and the trace also closes after zero epochs, after
  a SIGTERM and on an exception.
- The run log: the keys of every record, in order, those of the JAX
  ``TrainCommand`` under the same recording stand-in for ``wandb``, and a
  ``git_hash`` in the run's config.

No test reaches ``urlretrieve``: it is replaced by one that raises.
"""

import argparse
import contextlib
import csv
import dataclasses
import io
import json
import os
import signal
import struct
import sys
import types
import urllib.request
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.cli.create_splits_cmd import CreateSplitsCommand
from inferbiomechanics_tpu.cli.sanity_check_cmd import SanityCheckCommand
from inferbiomechanics_tpu.cli.train_cmd import TrainCommand
from inferbiomechanics_tpu.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu.loss.evaluator import LossConfig as JaxLossConfig
from inferbiomechanics_tpu.loss.evaluator import RegressionLossEvaluator as JaxEvaluator
from inferbiomechanics_tpu_torch.__main__ import COMMANDS, main
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.keys import OutputDataKeys
from inferbiomechanics_tpu_torch.loss.evaluator import (
    COMPONENTS, LossConfig, RegressionLossEvaluator,
)
from inferbiomechanics_tpu_torch.train import checkpoint as ckpt
from inferbiomechanics_tpu_torch.train import loop as port_loop
from inferbiomechanics_tpu_torch.train.checkpoint import save_checkpoint
from inferbiomechanics_tpu_torch.train.diffusion_loop import train_diffusion
from inferbiomechanics_tpu_torch.train.loop import build_model_for_dataset, train
from inferbiomechanics_tpu_torch.utils import png_plot

FORCES = OutputDataKeys.GROUND_CONTACT_FORCES_IN_ROOT_FRAME
SMALL = ['--history-len', '20', '--stride', '5', '--hidden-dims', '32']


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_download(monkeypatch):
    def refuse(*a, **kw):
        raise OSError('no network in tests')
    monkeypatch.setattr(urllib.request, 'urlretrieve', refuse)


@pytest.fixture(scope='module')
def home(tmp_path_factory):
    """Two train subjects of one 150-frame trial each, and one dev subject."""
    root = tmp_path_factory.mktemp('cli_extras')
    for split, n, seed in (('train', 2, 0), ('dev', 1, 5)):
        os.makedirs(root / split)
        for s in range(n):
            write_synthetic_subject(str(root / split / f's{s}.b3d'), num_trials=1,
                                    trial_length=150, seed=seed + s)
    return root


def _jax(command, argv: list) -> str:
    parser = argparse.ArgumentParser()
    command.register_subcommand(parser.add_subparsers(dest='command'))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert command.run(parser.parse_args(argv))
    return out.getvalue()


def _port(argv: list) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def test_commands_registered():
    assert len(COMMANDS) == 13
    assert {'pickle-data', 'create-splits', 'sanity-check'} <= set(COMMANDS)


def _tree(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), 'rb') as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_create_splits_makes_the_jax_tree(tmp_path):
    """Two datasets (four files and two), an empty file and a file that is
    not a ``.b3d``: the first two sorted files of a dataset of three or more
    go to dev, the rest to train, each renamed ``{dataset}_{file}``."""
    for package in ('jax', 'port'):
        processed = tmp_path / package / 'processed'
        for dataset, n in (('Alpha2020', 4), ('Beta2021', 2)):
            for i in range(n):
                d = processed / dataset / f'subject{i}'
                d.mkdir(parents=True)
                write_synthetic_subject(str(d / f'subject{i}.b3d'), num_trials=1,
                                        trial_length=40, seed=i)
        (processed / 'Alpha2020' / 'subject0' / 'empty.b3d').write_bytes(b'')
        (processed / 'Beta2021' / 'subject0' / 'notes.txt').write_text('x')
    jax_out = _jax(CreateSplitsCommand(), ['create-splits', '--data-path',
                                           str(tmp_path / 'jax')])
    port_out = _port(['create-splits', '--data-folder', str(tmp_path / 'port')])
    assert port_out == jax_out and port_out.count('<-') == 6
    jt, pt = (_tree(tmp_path / p) for p in ('jax', 'port'))
    assert pt == jt
    assert sorted(k for k in pt if k.startswith('dev')) == [
        'dev/Alpha2020_subject0.b3d', 'dev/Alpha2020_subject1.b3d']


@pytest.mark.parametrize('short', [False, True])
def test_sanity_check_prints_the_jax_text(home, short):
    argv = ['sanity-check', '--dataset-home', str(home)] + (['--short'] if short else [])
    want = _jax(SanityCheckCommand(), argv)
    assert _port(argv) == want
    n = len(WindowDataset(str(home / 'train'), window_size=1, stride=1,
                          testing_with_short_dataset=short, skip_loading_skeletons=True))
    assert want.startswith(f'{n} windows over {1 if short else 2} subjects')
    assert '--- labels ---' in want and 'WARNING' not in want


def _plotted(monkeypatch, plt):
    """Record each array ``plt.plot`` is given."""
    seen = []
    plot = plt.plot
    monkeypatch.setattr(plt, 'plot', lambda y, *a, **kw: (seen.append(np.asarray(y)),
                                                         plot(y, *a, **kw))[1])
    return seen


def _png(path) -> tuple:
    """(width, height, title, ink pixels) of a grayscale PNG written by
    ``utils/png_plot.py``."""
    data = open(path, 'rb').read()
    assert data[:8] == b'\x89PNG\r\n\x1a\n'
    at, chunks = 8, {}
    while at < len(data):
        n, kind = struct.unpack('>I4s', data[at:at + 8])
        body = data[at + 8:at + 8 + n]
        assert struct.unpack('>I', data[at + 8 + n:at + 12 + n])[0] == zlib.crc32(kind + body)
        chunks[kind] = chunks.get(kind, b'') + body
        at += 12 + n
    w, h, depth, color = struct.unpack('>IIBB', chunks[b'IHDR'][:10])
    assert (depth, color) == (8, 0)
    rows = np.frombuffer(zlib.decompress(chunks[b'IDAT']), np.uint8).reshape(h, w + 1)
    assert (rows[:, 0] == 0).all()
    return w, h, chunks[b'tEXt'].split(b'\x00')[1].decode(), int((rows[:, 1:] == 0).sum())


@pytest.mark.parametrize('renderer', ['matplotlib', 'builtin'])
@pytest.mark.parametrize('components', [(1,), (0, 1, 2, 3, 4, 5)])
@pytest.mark.parametrize('frames', [1, 4])
def test_plot_errors_plots_the_jax_arrays(tmp_path, monkeypatch, components, frames, renderer):
    """The arrays the port's ``plot_errors`` draws are those the JAX one
    hands ``plt.plot``, in the same files; without matplotlib the port draws
    them with ``utils/png_plot.py``."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(len(components) + frames)
    out, lab = (rng.normal(size=(9, frames, 6)).astype(np.float32) for _ in range(2))
    seen = _plotted(monkeypatch, plt)
    jax_paths = JaxEvaluator('dev', JaxLossConfig(predict_grf_components=components)).plot_errors(
        {FORCES: jnp.asarray(out)}, {FORCES: jnp.asarray(lab)}, str(tmp_path / 'jax'), tag='dev')
    jax_seen = list(seen)
    seen.clear()
    if renderer == 'builtin':
        monkeypatch.setitem(sys.modules, 'matplotlib', None)      # not installed
        write = png_plot.write_line_png
        monkeypatch.setattr(png_plot, 'write_line_png', lambda path, y, label: (
            seen.append(np.asarray(y)), write(path, y, label))[1])
    paths = RegressionLossEvaluator('dev', LossConfig(predict_grf_components=components)
                                    ).plot_errors({FORCES: torch.from_numpy(out)},
                                                  {FORCES: torch.from_numpy(lab)},
                                                  str(tmp_path / 'port'), tag='dev')
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jax_paths]
    assert all(os.path.getsize(p) > 0 for p in paths)
    assert len(seen) == len(jax_seen) == len(components)
    for got, want in zip(seen, jax_seen):
        assert got.shape == want.shape == (9,)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if renderer == 'builtin':
        for path, i in zip(paths, components):
            w, h, title, ink = _png(path)
            assert (w, h) == (640, 480) and title == f'squared error {COMPONENTS[i]}'
            assert ink > 2 * (w + h)          # the frame and the line


def test_png_line_image_draws_its_points():
    """Every point of the series is inked at its scaled place; a constant,
    a single value and non-finite values draw."""
    y = np.array([0.0, 1.0, 0.5, 2.0])
    img = png_plot.line_image(y, width=100, height=60, margin=10)
    xs = np.rint(10 + np.arange(4) * 79 / 3).astype(int)
    ys = np.rint(49 - y * 39 / 2).astype(int)
    assert (img[ys, xs] == 0).all()
    for special in ([3.0, 3.0, 3.0], [1.0], [np.nan, 1.0, np.inf], []):
        assert png_plot.line_image(special).shape == (480, 640)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize('model', ['feedforward', 'groundlink', 'analytical'])
def test_analyze_plot_errors_keeps_the_rows(home, tmp_path, model):
    """``analyze --plot-errors`` (batch by batch) writes the rows of the
    chunked run without the flag, and its PNGs; ``--batch-size 32`` leaves a
    short last batch in each split (one subject each, ``--short``)."""
    flags = ['--model-type', model, *SMALL, '--batch-size', '32', '--device', 'cpu',
             '--no-wandb', '--dataset-home', str(home), '--short']
    if model != 'analytical':
        cfg = Config()
        cfg.model_type, cfg.window_size, cfg.stride, cfg.hidden_dims = model, 20, 5, [32]
        ds = WindowDataset(str(home / 'dev'), window_size=20, stride=5,
                           skip_loading_skeletons=True)
        for d in ('plain', 'plot'):
            save_checkpoint(str(tmp_path / d / model), build_model_for_dataset(
                cfg, ds, generator=torch.Generator().manual_seed(3)), 0, 0)
    _port(['analyze', *flags, '--checkpoint-dir', str(tmp_path / 'plain')])
    out = _port(['analyze', *flags, '--checkpoint-dir', str(tmp_path / 'plot'),
                 '--plot-errors', '--plot-path-root', str(tmp_path / 'plots')])
    for split in ('dev', 'train'):
        got = _rows(tmp_path / 'plot' / model / f'{split}_analysis.csv')
        assert got == _rows(tmp_path / 'plain' / model / f'{split}_analysis.csv')
        assert len(got) == len(WindowDataset(str(home / split), window_size=20, stride=5,
                                             testing_with_short_dataset=True,
                                             skip_loading_skeletons=True))
        assert f'wrote {tmp_path / "plots"}/{split}_grferrorleft-y.png' in out
    assert sorted(os.listdir(tmp_path / 'plots')) == ['dev_grferrorleft-y.png',
                                                      'train_grferrorleft-y.png']


def _loop_config(home, ckpt_dir, **fields):
    cfg = Config()
    cfg.dataset_home, cfg.checkpoint_dir = str(home), str(ckpt_dir)
    cfg.window_size, cfg.stride, cfg.hidden_dims = 20, 5, [32]
    cfg.batch_size, cfg.epochs, cfg.device_chunk_steps = 16, 2, 4
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def _datasets(home, fmt='last_frame'):
    return [WindowDataset(str(home / s), window_size=20, stride=5, output_data_format=fmt,
                          skip_loading_skeletons=True) for s in ('train', 'dev')]


def _trace(profile_dir) -> dict:
    files = os.listdir(profile_dir)
    assert len(files) == 1 and files[0].startswith('rank0.') and files[0].endswith(
        '.pt.trace.json'), files
    with open(os.path.join(profile_dir, files[0])) as f:
        return json.load(f)


def _same_checkpoints(a, b):
    fa, fb = ckpt.list_checkpoints(str(a)), ckpt.list_checkpoints(str(b))
    assert [f[:2] for f in fa] == [f[:2] for f in fb] and fa
    for (_, _, x), (_, _, y) in zip(fa, fb):
        pa, pb = (torch.load(p, weights_only=True)['model_state_dict'] for p in (x, y))
        assert all(torch.equal(v, pb[k]) for k, v in pa.items()), x


def _matmuls(profile_dir) -> int:
    names = [e.get('name', '') for e in _trace(profile_dir)['traceEvents']]
    return names.count('aten::mm') + names.count('aten::addmm') + names.count('aten::bmm')


@pytest.mark.parametrize('loop', ['train', 'diffusion'])
def test_profile_traces_the_first_epoch(home, tmp_path, loop):
    """A profiled run's checkpoints are bitwise the unprofiled run's; its
    trace, one file for rank 0, holds the first epoch and its dev
    evaluation: as many products as the trace of a one-epoch run."""
    fields = {} if loop == 'train' else dict(
        model_type='diffusion', output_data_format='all_frames', d_model=64, num_layers=1,
        num_heads=4, diffusion_timesteps=64, batch_size=64)
    run = train if loop == 'train' else train_diffusion
    train_ds, dev_ds = _datasets(home, fields.get('output_data_format', 'last_frame'))
    for name, profile, epochs in (('plain', False, 2), ('profiled', True, 2),
                                  ('one', True, 1)):
        cfg = _loop_config(home, tmp_path / name, profile=profile, epochs=epochs,
                           profile_dir=str(tmp_path / f'trace_{name}'), **fields)
        assert run(cfg, train_ds, dev_ds, device='cpu').epochs_run == epochs
    _same_checkpoints(tmp_path / 'plain', tmp_path / 'profiled')
    assert not os.path.exists(tmp_path / 'trace_plain')
    assert _matmuls(tmp_path / 'trace_profiled') == _matmuls(tmp_path / 'trace_one') > 0


def test_profile_closes_after_zero_epochs_sigterm_and_an_exception(home, tmp_path,
                                                                   monkeypatch):
    train_ds, dev_ds = _datasets(home)
    cfg = _loop_config(home, tmp_path / 'c', epochs=1)
    train(cfg, train_ds, dev_ds, device='cpu')
    resumed = dataclasses.replace(cfg, profile=True, profile_dir=str(tmp_path / 'zero'))
    assert train(resumed, train_ds, dev_ds, device='cpu').epochs_run == 0
    _trace(tmp_path / 'zero')
    assert not torch.autograd._profiler_enabled()

    class Killer:
        """SIGTERM at the first logged loss: a checkpoint and a clean exit
        inside the first epoch."""
        def log(self, record):
            if 'batch' in record:
                os.kill(os.getpid(), signal.SIGTERM)

    stopped = _loop_config(home, tmp_path / 's', profile=True, log_every_batches=1,
                           device_chunk_steps=1, profile_dir=str(tmp_path / 'sigterm'))
    result = train(stopped, train_ds, dev_ds, metric_logger=Killer(), device='cpu')
    assert result.preempted and result.epochs_run == 0
    _trace(tmp_path / 'sigterm')
    assert not torch.autograd._profiler_enabled()

    def broken(*a, **kw):
        raise RuntimeError('a step that fails')

    monkeypatch.setattr(port_loop, 'run_chunks', broken)
    failing = _loop_config(home, tmp_path / 'f', profile=True,
                           profile_dir=str(tmp_path / 'failed'))
    with pytest.raises(RuntimeError, match='a step that fails'):
        train(failing, train_ds, dev_ds, device='cpu')
    _trace(tmp_path / 'failed')
    assert not torch.autograd._profiler_enabled()


class _Wandb(types.ModuleType):
    """A recording stand-in for the ``wandb`` module."""

    def __init__(self):
        super().__init__('wandb')
        self.inits, self.records, self.finished = [], [], 0

    def init(self, **kw):
        self.inits.append(kw)

    def log(self, record):
        self.records.append(dict(record))

    def finish(self):
        self.finished += 1


def test_run_log_has_the_jax_keys(home, tmp_path, monkeypatch):
    """Both packages' ``train`` (two epochs in chunks of 4 steps, a dev split) under
    the stand-in: one run each, the same keys in every record in the same
    order (the logged losses, the dev and train reports), a ``git_hash`` in
    the config, and the run finished."""
    flags = ['--dataset-home', str(home), *SMALL, '--batch-size', '16', '--epochs', '2',
             '--geometry-folder', str(tmp_path), '--device-chunk-steps', '4']
    logs = {}
    for name in ('jax', 'port'):
        stand_in = _Wandb()
        monkeypatch.setitem(sys.modules, 'wandb', stand_in)
        argv = ['train', *flags, '--checkpoint-dir', str(tmp_path / name)]
        if name == 'jax':
            _jax(TrainCommand(), argv)
        else:
            _port(argv + ['--device', 'cpu'])
        logs[name] = stand_in
    jax_log, port_log = logs['jax'], logs['port']
    assert [list(r) for r in port_log.records] == [list(r) for r in jax_log.records]
    # an epoch: the dev report before it, its logged loss, its train report
    keys = [list(r) for r in port_log.records]
    assert len(keys) == 6 and keys[1] == keys[4] == ['train/loss', 'epoch', 'batch']
    assert keys[0] == keys[3] and keys[0][0] == 'dev/force_rmse/left-x'
    assert keys[2] == keys[5] and keys[2][0] == 'train/force_rmse/left-x'
    assert len(port_log.inits) == len(jax_log.inits) == 1
    config = port_log.inits[0]['config']
    assert set(jax_log.inits[0]['config']) - set(config) == set()
    assert config['git_hash'] and config['logger'] == 'wandb'
    assert port_log.inits[0]['project'] == 'addbiomechanics-baseline'
    assert port_log.finished == jax_log.finished == 1
