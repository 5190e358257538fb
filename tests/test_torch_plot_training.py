"""``plot-training`` of the port against the JAX package's on the same JSONL
files: ``read_metrics`` (a torn last line, the ``_config`` record, booleans
and strings skipped), ``group_key``, ``ema`` and ``newest_log`` equal; the
finals of ``plot_training`` and ``plot_training_compare`` equal the JAX
functions' and the last value of each key; the command on a file the port's
own ``MetricLogger`` wrote; ``--compare`` and its refusals in the JAX words;
the figure drawn by matplotlib, and by ``utils/png_plot.py`` with matplotlib
hidden (the same file name, a PNG that decodes, the run's title in it).
"""

import argparse
import contextlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest

from inferbiomechanics_tpu.cli import plot_training_cmd as jax_pt
from inferbiomechanics_tpu_torch.__main__ import build_parser, main
from inferbiomechanics_tpu_torch.cli import plot_training_cmd as port_pt
from inferbiomechanics_tpu_torch.utils import wandb_compat


def _write(path, records, config=None, torn=None):
    with open(path, 'w') as f:
        if config is not None:
            f.write(json.dumps({'_config': config}) + '\n')
        for r in records:
            f.write(json.dumps(r) + '\n')
        if torn:
            f.write(torn)
    return str(path)


def _run_records(n, scale=1.0):
    rng = np.random.default_rng(int(scale * 10))
    return [{'train/loss': float(scale / (i + 1)), 'epoch': i // 4, 'batch': i,
             'dev/force_rmse/left-x': float(rng.normal()),
             'dev/force_rmse/left-y': float(rng.normal()),
             'note': 'text', 'flag': True, 'lr': 1e-3} for i in range(n)]


def png_chunks(path) -> dict:
    data = open(path, 'rb').read()
    assert data[:8] == b'\x89PNG\r\n\x1a\n'
    at, chunks = 8, {}
    while at < len(data):
        n, kind = struct.unpack('>I4s', data[at:at + 8])
        body = data[at + 8:at + 8 + n]
        assert struct.unpack('>I', data[at + 8 + n:at + 12 + n])[0] == zlib.crc32(kind + body)
        chunks.setdefault(kind, []).append(body)
        at += 12 + n
    w, h, depth, color = struct.unpack('>IIBB', chunks[b'IHDR'][0][:10])
    raw = zlib.decompress(b''.join(chunks[b'IDAT']))
    assert (depth, color) == (8, 2) and len(raw) == h * (3 * w + 1)
    chunks['text'] = dict(t.split(b'\x00', 1) for t in chunks.get(b'tEXt', []))
    return chunks


def test_read_metrics_group_key_ema_agree(tmp_path):
    path = _write(tmp_path / 'metrics_1.jsonl', _run_records(9), config={'model_type': 'ff'},
                  torn='{"train/loss": 0.5')
    got, want = port_pt.read_metrics(path), jax_pt.read_metrics(path)
    assert got == want and got[0] == {'model_type': 'ff'}
    assert 'note' not in got[1] and 'flag' not in got[1] and len(got[1]['train/loss']) == 9
    for key in ('dev/force_rmse/left-x', 'train/loss', 'a/b/c/d', 'lr', ''):
        assert port_pt.group_key(key) == jax_pt.group_key(key)
    values = [v for _, v in got[1]['dev/force_rmse/left-x']]
    for alpha in (0.0, 0.5, 0.9):
        assert port_pt.ema(values, alpha) == jax_pt.ema(values, alpha)


def test_newest_log_agrees(tmp_path):
    for i, stamp in enumerate((100, 300, 200)):
        p = _write(tmp_path / f'metrics_{i}.jsonl', [{'x': 1.0}])
        os.utime(p, (stamp, stamp))
    assert port_pt.newest_log(str(tmp_path)) == jax_pt.newest_log(str(tmp_path))
    assert port_pt.newest_log(str(tmp_path)).endswith('metrics_1.jsonl')
    errors = []
    for module in (port_pt, jax_pt):
        with pytest.raises(FileNotFoundError) as e:
            module.newest_log(str(tmp_path / 'none'))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize('renderer', ['matplotlib', 'png_plot'])
@pytest.mark.parametrize('smooth', [0, 4])
def test_plot_training_finals_and_file(tmp_path, monkeypatch, renderer, smooth):
    path = _write(tmp_path / 'metrics_2.jsonl', _run_records(12), config={'model_type': 'ff'})
    want = jax_pt.plot_training(path, str(tmp_path / 'jax' / 'c.png'), smooth=smooth)
    by_keys = {tuple(keys): jax_pt.plot_training(path, str(tmp_path / 'jax' / 'k.png'),
                                                 keys=keys)
               for keys in (['lr'], ['train/loss', 'lr'])}
    with pytest.raises(ValueError) as jax_error:
        jax_pt.plot_training(path, str(tmp_path / 'jax' / 'k.png'), keys=['missing'])
    if renderer == 'png_plot':
        monkeypatch.setitem(sys.modules, 'matplotlib', None)      # not installed
    out = tmp_path / 'port' / 'c.png'
    got = port_pt.plot_training(path, str(out), smooth=smooth)
    assert got == want and set(got) == {'train/loss', 'dev/force_rmse/left-x',
                                        'dev/force_rmse/left-y', 'lr'}
    assert got['train/loss'] == pytest.approx(1 / 12)
    assert out.stat().st_size > 1000
    if renderer == 'png_plot':
        assert png_chunks(out)['text'][b'Title'] == 'training curves — ff'.encode('latin-1', 'replace')
    for keys, finals in by_keys.items():
        assert port_pt.plot_training(path, str(out), keys=list(keys)) == finals
    with pytest.raises(ValueError) as port_error:
        port_pt.plot_training(path, str(out), keys=['missing'])
    assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize('renderer', ['matplotlib', 'png_plot'])
def test_command_on_the_ports_metric_logger(tmp_path, monkeypatch, renderer):
    """A run log written by the port's ``MetricLogger`` (JSONL, with its
    leading ``_config`` record): the finals printed are the last value of
    each key in the file."""
    monkeypatch.setitem(sys.modules, 'wandb', None)               # JSONL fallback
    logger = wandb_compat.MetricLogger(config={'model_type': 'transformer', 'lr': 1e-4},
                                       log_dir=str(tmp_path / 'logs'))
    assert logger.backend == 'jsonl'
    for r in _run_records(7):
        logger.log({k: v for k, v in r.items() if k != 'note'})
    logger.finish()
    if renderer == 'png_plot':
        monkeypatch.setitem(sys.modules, 'matplotlib', None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(['plot-training', '--log-dir', str(tmp_path / 'logs'), '--out',
                   str(tmp_path / 'plots' / 'curves.png')])
    lines = out.getvalue().splitlines()
    assert rc == 0 and lines[0].startswith('plotted 4 series from ')
    path = lines[0].split(' from ')[1].split(' -> ')[0]
    _, series = jax_pt.read_metrics(path)
    finals = {line.split()[0]: float(line.split()[-1]) for line in lines[1:]}
    assert finals == {k: pytest.approx(v[-1][1], rel=1e-5) for k, v in series.items()
                      if k not in ('epoch', 'batch')}
    assert (tmp_path / 'plots' / 'curves.png').stat().st_size > 1000
    if renderer == 'png_plot':
        assert png_chunks(tmp_path / 'plots' / 'curves.png')['text'][b'Title'].endswith(
            b'transformer')


@pytest.mark.parametrize('renderer', ['matplotlib', 'png_plot'])
def test_compare_and_its_refusals(tmp_path, monkeypatch, renderer):
    a = _write(tmp_path / 'metrics_a.jsonl', _run_records(6, 1.0))
    b = _write(tmp_path / 'metrics_b.jsonl', _run_records(9, 2.0))
    want = jax_pt.plot_training_compare([a, b], str(tmp_path / 'jax.png'), smooth=3)
    # labels, disjoint keys, a key not in every run: the JAX words
    c = _write(tmp_path / 'metrics_c.jsonl', [{'other': 1.0}])
    refused = [([a, b], dict(labels=['only one'])), ([a, c], {}), ([a, b], dict(keys=['nope']))]
    jax_errors = []
    for args, kw in refused:
        with pytest.raises(ValueError) as e:
            jax_pt.plot_training_compare(args, str(tmp_path / 'x.png'), **kw)
        jax_errors.append(str(e.value))
    if renderer == 'png_plot':
        monkeypatch.setitem(sys.modules, 'matplotlib', None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(['plot-training', '--compare', a, b, '--smooth', '3', '--out',
                   str(tmp_path / 'cmp.png')])
    assert rc == 0 and (tmp_path / 'cmp.png').stat().st_size > 1000
    assert port_pt.plot_training_compare([a, b], str(tmp_path / 'p.png'), smooth=3) == want
    printed = {tuple(line.split()[:2]): float(line.split()[-1])
               for line in out.getvalue().splitlines()[1:]}
    assert printed == {(label, k): pytest.approx(v, rel=1e-5)
                       for label, fin in want.items() for k, v in fin.items()}
    assert set(want) == {'metrics_a', 'metrics_b'}
    assert want['metrics_b']['train/loss'] == pytest.approx(2 / 9)
    for (args, kw), error in zip(refused, jax_errors):
        with pytest.raises(ValueError) as e:
            port_pt.plot_training_compare(args, str(tmp_path / 'x.png'), **kw)
        assert str(e.value) == error
    got = port_pt.plot_training_compare([a, b], str(tmp_path / 'l.png'), labels=['x', 'y'])
    assert set(got) == {'x', 'y'}


def test_flags_agree():
    jax_parser = argparse.ArgumentParser()
    jax_sub = jax_parser.add_subparsers(dest='command')
    jax_pt.PlotTrainingCommand().register_subcommand(jax_sub)
    port_sub = next(a for a in build_parser()._actions
                    if isinstance(a, argparse._SubParsersAction))

    def flags(p):
        return {tuple(a.option_strings): (a.dest, a.default, a.nargs, type(a).__name__)
                for a in p._actions if not isinstance(a, argparse._HelpAction)}

    assert flags(port_sub.choices['plot-training']) == flags(jax_sub.choices['plot-training'])
