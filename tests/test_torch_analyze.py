"""The port's ``analyze`` command (inferbiomechanics_tpu_torch/cli/analyze_cmd.py)
against the JAX package's (inferbiomechanics_tpu/cli/analyze_cmd.py), both run
in this process on the CPU.

One synthetic subject a split: two 100-frame trials in dev (98 windows at
window 50 / stride 5), one of 61 frames in train (10 windows). Reports and
rows at batch 2. Each model's weights come from a seeded flax
init with the biases moved off zero; the JAX package reads them from its own
checkpoint, the port from a ``.torch.pt`` of the same weights converted by
``weights.py``. Tolerances on report numbers, bootstrap CIs and group
summaries (relative) and on CSV rows (relative to the column's largest
value): 2e-2 for the bf16 models (feedforward; transformer
``vpu``; transformer ``pallas``, whose layers run their plain versions on
both sides here) and 5e-2 for GroundLink, the JAX suite's own GroundLink
tolerance. What the port computes from its own rows (bootstrap CIs, group
summaries) is held exactly to the JAX package's arithmetic on those rows.
"""

import argparse
import contextlib
import csv
import io
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.cli.analyze_cmd import AnalyzeCommand
from inferbiomechanics_tpu.config import add_config_flags as jax_add_config_flags
from inferbiomechanics_tpu.config import config_from_args as jax_config_from_args
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu.train import create_train_state as jax_create_train_state
from inferbiomechanics_tpu.train import make_optimizer as jax_make_optimizer
from inferbiomechanics_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.__main__ import build_parser, main
from inferbiomechanics_tpu_torch.cli.analyze_cmd import ROW_KEYS, analyze
from inferbiomechanics_tpu_torch.config import config_from_args
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg
from inferbiomechanics_tpu_torch.ops import fused_mlp as fm
from inferbiomechanics_tpu_torch.train.checkpoint import save_checkpoint
from inferbiomechanics_tpu_torch.train.loop import build_model_for_dataset

SMALL_TF = ['--d-model', '128', '--num-layers', '2', '--num-heads', '4']
# case -> (model type, architecture flags, converter, tolerance, --group-by)
CASES = {
    'feedforward': ('feedforward', [], weights.feedforward_state_dict_from_jax,
                    2e-2, 'trial'),
    'vpu': ('transformer', SMALL_TF, weights.transformer_state_dict_from_jax,
            2e-2, 'subject'),
    'pallas': ('transformer', SMALL_TF + ['--attn-impl', 'pallas'],
               weights.transformer_pallas_state_dict_from_jax, 2e-2, 'trial'),
    'groundlink': ('groundlink', [], weights.groundlink_state_dict_from_jax,
                   5e-2, 'activity'),
}
BATCH = 2       # of every run held against the JAX command: 98 and 10 windows, no short batch
REPORT = ('Force Avg Err', 'COM Acc Avg Err', 'CoP Avg Err', 'Moment Avg Err',
          'Wrench Avg Err', 'Wrench Moment Avg Err')


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """Small models beside other test processes: one thread throughout."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _argv(case: str) -> list:
    model_type, arch = CASES[case][:2]
    return ['--model-type', model_type, *arch]


def _configs(case: str):
    """The JAX package's and the port's Config for the case's flags."""
    jparser = argparse.ArgumentParser()
    jax_add_config_flags(jparser)
    return (jax_config_from_args(jparser.parse_args(_argv(case))),
            config_from_args(build_parser().parse_args(['train', *_argv(case)])))


def _write_pair(ws, case: str, seed: int, jax_root, port_root) -> None:
    """Seeded flax weights (biases moved off zero) as a JAX checkpoint under
    ``jax_root`` and as the port's checkpoint under ``port_root``."""
    jcfg, cfg = _configs(case)
    jmodel = jax_build(jcfg, ws['jax_ds'])
    # op by op at the batch of every JAX run below, as the JAX command inits
    # its model: the runs reuse the ops compiled here
    sample = jnp.asarray(ws['jax_ds'].gather(np.arange(BATCH)).inputs)
    state = jax_create_train_state(jmodel, jax.random.PRNGKey(seed), sample,
                                   jax_make_optimizer(jcfg.opt_type, jcfg.learning_rate))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.1 * rng.normal(size=p.shape) if p.ndim == 1 else 0)
                   ).astype(np.float32), jax.device_get(state.params))
    jax_save_checkpoint(str(jax_root / jcfg.model_type), state.replace(params=params), 0, 0)
    model = build_model_for_dataset(cfg, ws['ds'])
    model.load_state_dict(CASES[case][2](params))
    save_checkpoint(str(port_root / cfg.model_type), model, 0, 0)


@pytest.fixture(scope='module')
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_analyze')
    data = root / 'data'
    for split, trials, length in (('dev', 2, 100), ('train', 1, 61)):
        os.makedirs(data / split)
        write_synthetic_subject(str(data / split / 's0.b3d'), num_trials=trials,
                                trial_length=length, seed=0)
    kw = dict(window_size=50, stride=5, skip_loading_skeletons=True)
    ws = {'root': root, 'data': str(data),
          'ds': WindowDataset(str(data / 'dev'), **kw),
          'jax_ds': JaxWindowDataset(str(data / 'dev'), **kw)}
    assert len(ws['ds']) == 98
    for case in CASES:
        _write_pair(ws, case, 0, root / 'jax' / case, root / 'port' / case)
    _write_pair(ws, 'feedforward', 1, root / 'jax' / 'member', root / 'port' / 'member')
    return ws


def _base(ws, side: str, case: str) -> list:
    return ['analyze', '--dataset-home', ws['data'], '--checkpoint-dir',
            str(ws['root'] / side / case), '--no-wandb', *_argv(case)]


def _run_jax(argv: list) -> str:
    parser = argparse.ArgumentParser()
    AnalyzeCommand().register_subcommand(parser.add_subparsers(dest='command'))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert AnalyzeCommand().run(parser.parse_args(argv))
    return out.getvalue()


def _run_port(argv: list) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _report(text: str, split: str) -> dict:
    block = text.split(f'[{split}] final report:')[1]
    got = {name: float(re.search(rf'\t{name}: (\S+)', block).group(1)) for name in REPORT}
    ci = re.search(rf'\[{split}\] bootstrap 95% CIs \((\d+) windows, (\d+) resamples\):\n'
                   r'((?:  .*\n){3})', text)
    if ci:
        got['bootstrap'] = [float(v) for v in re.findall(r'-?\d+\.\d+', ci.group(3))]
    return got


def _rows(path: str) -> list:
    with open(path) as f:
        return list(csv.reader(f))


def _fresh(*paths) -> None:
    for p in paths:
        if os.path.exists(p):
            os.remove(p)


def _assert_rows_close(got: list, want: list, tol: float, what: str) -> None:
    """Same windows in the same order; each value within ``tol`` x the
    largest value of its column (a window's loss can be near 0, where bf16
    rounding of the prediction moves it by more than ``tol`` of itself)."""
    assert len(got) == len(want) > 0, what
    assert [r[:2] for r in got] == [r[:2] for r in want], what
    g, w = (np.asarray([r[2:] for r in rows], float) for rows in (got, want))
    assert (np.abs(g - w) <= tol * np.abs(w).max(axis=0) + 1e-6).all(), (
        what, np.abs(g - w).max(axis=0) / np.abs(w).max(axis=0))


def _jax_bootstrap(rows: np.ndarray, n_boot: int) -> list:
    """The JAX command's bootstrap on the given rows (analyze_cmd.py:512-535)."""
    rng = np.random.default_rng(0)
    w = rows.shape[0]
    chunk = max(1, min(n_boot, 64_000_000 // max(w, 1)))
    means = np.concatenate([rows[rng.integers(0, w, (min(chunk, n_boot - lo), w))]
                            .mean(axis=1) for lo in range(0, n_boot, chunk)])
    lo, hi = np.percentile(means, 2.5, axis=0), np.percentile(means, 97.5, axis=0)
    return [float(f'{v:.4f}') for j in range(3)
            for v in (rows.mean(axis=0)[j], lo[j], hi[j])]


@pytest.mark.parametrize('case', list(CASES))
def test_report_rows_bootstrap_and_groups_match_the_jax_command(ws, case):
    model_type, _, _, tol, group_by = CASES[case]
    extra = ['--bootstrap', '50', '--group-by', group_by, '--batch-size', str(BATCH)]
    jdir, pdir = (ws['root'] / side / case / model_type for side in ('jax', 'port'))
    _fresh(*(d / f'{s}_analysis.csv' for d in (jdir, pdir) for s in ('dev', 'train')))
    jout = _run_jax(_base(ws, 'jax', case) + extra + ['--eval-chunk-steps', '1'])
    counts = (fm.launches, fe.launches, fg.launches)
    pout = _run_port(_base(ws, 'port', case) + extra + ['--device', 'cpu'])
    assert (fm.launches, fe.launches, fg.launches) == counts     # plain versions on the CPU
    assert 'WARNING: no checkpoint' not in jout + pout
    for split in ('dev', 'train'):
        want, got = _report(jout, split), _report(pout, split)
        assert set(got) == set(want) and 'bootstrap' in got, split
        for k in REPORT:
            assert got[k] == pytest.approx(want[k], rel=tol), (split, k)
        np.testing.assert_allclose(got['bootstrap'], want['bootstrap'], rtol=tol, atol=1e-4,
                                   err_msg=split)
        rows = _rows(str(pdir / f'{split}_analysis.csv'))
        _assert_rows_close(rows, _rows(str(jdir / f'{split}_analysis.csv')), tol, split)
        # the port's CIs are the JAX package's arithmetic on the port's rows
        values = np.asarray([r[2:] for r in rows], float)
        assert got['bootstrap'] == _jax_bootstrap(values, 50), split

        summary, jsummary = (_rows(str(d / f'{split}_summary_{group_by}.csv'))
                             for d in (pdir, jdir))
        assert summary[0] == jsummary[0] == [group_by, 'windows', 'loss', 'force_avg_err',
                                             'com_acc_avg_err']
        assert sorted(r[:2] for r in summary[1:]) == sorted(r[:2] for r in jsummary[1:])
        by_key = {r[0]: r for r in jsummary[1:]}
        np.testing.assert_allclose([[float(v) for v in r[2:]] for r in summary[1:]],
                                   [[float(v) for v in by_key[r[0]][2:]] for r in summary[1:]],
                                   rtol=tol, err_msg=split)
        # and exactly the JAX package's sums over the port's own rows, worst first
        trial_of = {'trial': lambda r: f'{r[0]}/{r[1]}', 'subject': lambda r: r[0],
                    'activity': lambda r: 'other'}[group_by]
        sums = {}
        for r in rows:
            g = sums.setdefault(trial_of(r), [0, 0.0, 0.0, 0.0])
            g[0] += 1
            for j, v in enumerate(r[2:]):
                g[1 + j] += float(v)
        want_rows = [[k, str(n), *(str(s / n) for s in g)] for k, (n, *g) in
                     sorted(sums.items(), key=lambda kv: kv[1][2] / kv[1][0], reverse=True)]
        assert summary[1:] == want_rows, split


@pytest.mark.parametrize('case', list(CASES))
def test_chunked_rows_equal_per_batch_rows(ws, case):
    """K=3 against 1 at batch 4: 98 windows make 24 batches of 4 and a
    trailing batch of 2, which runs as its own chunk."""
    pdir = ws['root'] / 'port' / case / CASES[case][0]
    base = _base(ws, 'port', case) + ['--batch-size', '4', '--device', 'cpu']
    runs = []
    for k in ('1', '3'):
        _fresh(*(pdir / f'{s}_analysis.csv' for s in ('dev', 'train')))
        _run_port(base + ['--eval-chunk-steps', k])
        runs.append(_rows(str(pdir / 'dev_analysis.csv')))
    per_batch, chunked = runs
    assert len(per_batch) == 98 and per_batch[-1] == per_batch[-2] != per_batch[-3]
    _assert_rows_close(chunked, per_batch, 1e-5, 'chunked vs per batch')


@pytest.mark.parametrize('case', ['analytical', 'feedforward', 'groundlink'])
def test_analytical_and_compute_report_run(ws, case):
    """``--model-type analytical --compute-report`` and a learned model's
    ``--compute-report`` run (they were refused until the analytical and
    physics slice): the analytical rows in chunks of 3 batches equal, as
    numbers, its rows batch by batch, and its report too; a learned model's
    report adds the torque term and leaves its rows as they were. Each is
    held to the JAX package in tests/test_torch_analytical.py."""
    model_type = 'analytical' if case == 'analytical' else CASES[case][0]
    pdir = ws['root'] / 'port' / case / model_type
    base = (_base(ws, 'port', case) if case != 'analytical' else
            ['analyze', '--dataset-home', ws['data'], '--checkpoint-dir',
             str(ws['root'] / 'port' / case), '--no-wandb', '--model-type', 'analytical'])
    base += ['--batch-size', '49', '--device', 'cpu']
    runs = []
    flags = ([['--compute-report', '--eval-chunk-steps', k] for k in ('1', '3')]
             if case == 'analytical' else [['--compute-report'], []])
    for extra in flags:
        _fresh(*(pdir / f'{s}_analysis.csv' for s in ('dev', 'train')))
        out = _run_port(base + extra)
        report = out.split('[dev] final report:')[1].split('wrote')[0].splitlines()
        runs.append((_rows(str(pdir / 'dev_analysis.csv')), report))
    (rows_a, rep_a), (rows_b, rep_b) = runs
    tau = [ln for ln in rep_a if 'Non-root Joint Torques (Inverse Dynamics) Avg Err' in ln]
    assert len(rows_a) == 98 and len(tau) == 1 and np.isfinite(float(tau[0].split()[-4]))
    assert [[float(v) for v in r[2:]] for r in rows_a] == [[float(v) for v in r[2:]]
                                                            for r in rows_b]
    assert rep_b == (rep_a if case == 'analytical' else [ln for ln in rep_a if ln not in tau])


def test_eval_chunk_runner_feeds_aligned_batches_and_drains_once():
    """K batches of an odd size (1 x 10 x 177 floats, 7080 bytes) each start
    on a 16-byte boundary, as the kernels require, and their metrics come
    back as host arrays [K, ...] equal to the per-batch ones."""
    from inferbiomechanics_tpu_torch.train.step import make_eval_chunk_runner
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(5, 1, 10, 177)).astype(np.float32)
    ys = rng.normal(size=(5, 1, 1, 3)).astype(np.float32)
    seen = []

    def step(_state, x, y):
        seen.append(x.data_ptr() % 16)
        assert x.is_contiguous() and x.shape == (1, 10, 177)
        return None, {'loss': (x.sum() + y.sum()).reshape(()), 'vec': x[0, 0, :6] * y.sum()}

    got = make_eval_chunk_runner(step, 'cpu')(None, xs, ys)
    assert seen == [0] * 5
    assert set(got) == {'loss', 'vec'} and isinstance(got['loss'], np.ndarray)
    assert got['loss'].shape == (5,) and got['vec'].shape == (5, 6)
    for k in range(5):
        _, want = step(None, torch.from_numpy(xs[k]), torch.from_numpy(ys[k]))
        np.testing.assert_allclose(got['loss'][k], want['loss'].numpy(), rtol=1e-6)
        np.testing.assert_allclose(got['vec'][k], want['vec'].numpy(), rtol=1e-6)


@pytest.mark.parametrize('case', ['feedforward', 'pallas', 'groundlink'])
def test_eval_steps_keep_the_packed_weights(ws, case):
    """The eval step calls ``model.eval()`` every batch; that keeps the
    kernel's packed weights, and only ``train()`` drops them."""
    from inferbiomechanics_tpu_torch.train.loop import loss_config_from
    from inferbiomechanics_tpu_torch.train.step import make_eval_step
    cfg = _configs(case)[1]
    model = build_model_for_dataset(cfg, ws['ds'])
    step = make_eval_step(model, ws['ds'].lab_offsets, loss_config_from(cfg))
    batch = ws['ds'].gather(np.arange(BATCH))
    x, y = torch.from_numpy(batch.inputs), torch.from_numpy(batch.labels)
    pack = (lambda: model.packed_layers(False)) if case == 'pallas' else model.packed
    step(None, x, y)
    first = pack()
    step(None, x, y)
    assert pack() is first
    model.train()
    assert pack() is not first


@pytest.mark.parametrize('mode', ['ensemble', 'tta_mirror'])
def test_ensemble_and_tta_mirror_match_the_jax_command(ws, mode):
    """``--ensemble`` of two feedforward members, ``--tta-mirror`` on
    GroundLink."""
    if mode == 'ensemble':
        case, tol = 'feedforward', 2e-2
        extra = {side: ['--ensemble', *(str(ws['root'] / side / d / 'feedforward')
                                        for d in ('feedforward', 'member'))]
                 for side in ('jax', 'port')}
    else:
        case, tol = 'groundlink', 5e-2
        extra = {side: ['--tta-mirror'] for side in ('jax', 'port')}
    dirs = {side: ws['root'] / side / case / CASES[case][0] for side in ('jax', 'port')}
    _fresh(*(d / f'{s}_analysis.csv' for d in dirs.values() for s in ('dev', 'train')))
    jout = _run_jax(_base(ws, 'jax', case) + extra['jax']
                    + ['--batch-size', str(BATCH), '--eval-chunk-steps', '1'])
    launches = fg.launches
    pout = _run_port(_base(ws, 'port', case) + extra['port']
                     + ['--batch-size', str(BATCH), '--device', 'cpu'])
    assert fg.launches == launches
    assert ('ensemble of 2' in pout) == (mode == 'ensemble')
    assert ('mirror test-time augmentation enabled' in pout) == (mode == 'tta_mirror')
    plain = _run_port(_base(ws, 'port', case) + ['--batch-size', str(BATCH), '--device', 'cpu'])
    for split in ('dev', 'train'):
        want, got = _report(jout, split), _report(pout, split)
        for k in REPORT:
            assert got[k] == pytest.approx(want[k], rel=tol), (split, k)
        assert got != _report(plain, split)
    # rows of the mode's runs only: the plain run appended after them
    rows, jrows = (_rows(str(d / 'dev_analysis.csv')) for d in (dirs['port'], dirs['jax']))
    _assert_rows_close(rows[:len(jrows)], jrows, tol, mode)


_ALL_FRAMES = ['--model-type', 'diffusion', '--output-data-format', 'all_frames']


@pytest.mark.parametrize('argv,flag,item', [
    # --quantize int8 is ported: with --tta-mirror it is refused in the JAX
    # command's words
    (['--quantize', 'int8', '--tta-mirror'], None,
     '--tta-mirror supports the learned-model eval paths (not analytical/diffusion/quantized)'),
    # the diffusion options are ported: a bad use of them is refused
    # in the JAX command's words, which the JAX command is held to here too
    (_ALL_FRAMES + ['--use-ema'], None,
     '--use-ema: checkpoint None carries no ema_params'),
    (_ALL_FRAMES + ['--diffusion-partial', '0.3'], None,
     '--diffusion-partial needs --init-checkpoint'),
    (_ALL_FRAMES + ['--diffusion-partial', '0.3', '--init-checkpoint', 'c'], None,
     '--init-checkpoint: no checkpoint in c'),
    (['--model-type', 'diffusion'], None,
     'analyze --model-type diffusion requires --output-data-format all_frames'),
    # ported: both commands write the same PNGs, and the port's rows are those
    # of its run without the flag
    (['--plot-errors'], None, 'grferror'),
    (['--model-type', 'analytical', '--tta-mirror'], None,
     '--tta-mirror supports the learned-model eval paths'),
], ids=[  # each case keeps the id it is known by
    'argv0---quantize-item 4', 'argv1-None---use-ema: checkpoint None carries no ema_params',
    'argv2-None---diffusion-partial needs --init-checkpoint',
    'argv3-None---init-checkpoint: no checkpoint in c',
    'argv4-None-analyze --model-type diffusion requires --output-data-format all_frames',
    'argv7---plot-errors-item 9', 'analytical --tta-mirror'])
def test_unported_analyze_flags_raise_by_name(ws, tmp_path, monkeypatch, argv, flag, item):
    """The ported diffusion, analytical and int8 options refuse a bad
    invocation as the JAX command does; ``--plot-errors`` writes the JAX
    command's PNGs and leaves the rows as they are."""
    base = ['analyze', '--dataset-home', ws['data'], '--checkpoint-dir', str(tmp_path),
            '--no-wandb', *argv]
    if '--plot-errors' in argv:
        plots, rows = {}, {}
        for side, extra in (('jax', argv), ('port', argv), ('plain', [])):
            d = tmp_path / side
            shutil.copytree(ws['root'] / ('port' if side == 'plain' else side) / 'feedforward',
                            d)
            for f in d.glob('feedforward/*_analysis.csv'):
                f.unlink()
            cmd = ['analyze', '--dataset-home', ws['data'], '--checkpoint-dir', str(d),
                   '--no-wandb', '--batch-size', str(BATCH), '--plot-path-root',
                   str(tmp_path / f'plots_{side}'), *extra]
            _run_jax(cmd) if side == 'jax' else _run_port(cmd + ['--device', 'cpu'])
            plots[side] = sorted(os.listdir(tmp_path / f'plots_{side}')) if extra else []
            rows[side] = [_rows(str(d / 'feedforward' / f'{s}_analysis.csv'))
                          for s in ('dev', 'train')]
        assert plots['port'] == plots['jax'] == [f'{s}_{item}left-y.png'
                                                  for s in ('dev', 'train')]
        assert rows['port'] == rows['plain'] and len(rows['port'][0]) == 98
        return
    monkeypatch.chdir(tmp_path)       # a relative --init-checkpoint names nothing
    errors = []
    for run in (lambda: _run_jax(base), lambda: main(base + ['--device', 'cpu'])):
        with pytest.raises((SystemExit, ValueError)) as e:
            run()
        errors.append((e.type, str(e.value)))
    assert errors[0] == errors[1] and item in errors[1][1], errors


@pytest.mark.parametrize('argv,error,match', [
    (['--use-ema'], SystemExit, 'applies to diffusion checkpoints'),
    (['--model-type', 'groundlink', '--quantize', 'int8'], SystemExit,
     'feedforward family only'),
    (['--diffusion-partial', '0.3'], SystemExit, 'applies to --model-type diffusion'),
    (['--init-checkpoint', 'c'], SystemExit, 'only does something with --diffusion-partial'),
    (['--model-type', 'analytical', '--ensemble', 'a', 'b'], SystemExit,
     'supports learned regression models'),
    ([], RuntimeError, r'is_available\(\) is False'),        # --device cuda is the default
])
def test_analyze_refusals(ws, tmp_path, monkeypatch, argv, error, match):
    """The JAX command's own refusals, in its words; the GPU default."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert build_parser().parse_args(['analyze']).device == 'cuda'
    with pytest.raises(error, match=match):
        analyze(build_parser().parse_args([
            'analyze', '--dataset-home', ws['data'], '--checkpoint-dir', str(tmp_path),
            '--no-wandb', *argv]))


def test_fresh_model_and_empty_split(ws, tmp_path):
    """No checkpoint: the JAX command's warning, and a fresh model is scored;
    an empty split is skipped with its message."""
    data = tmp_path / 'data'
    (data / 'train').mkdir(parents=True)
    os.symlink(os.path.join(ws['data'], 'dev'), data / 'dev')
    out = _run_port(['analyze', '--dataset-home', str(data), '--checkpoint-dir',
                     str(tmp_path / 'c'), '--no-wandb', '--device', 'cpu',
                     '--batch-size', '16'])
    assert f'WARNING: no checkpoint found in {tmp_path / "c" / "feedforward"}' in out
    assert 'train: no windows, skipping' in out
    assert len(_rows(str(tmp_path / 'c' / 'feedforward' / 'dev_analysis.csv'))) == 98
    assert not os.path.exists(tmp_path / 'c' / 'feedforward' / 'train_analysis.csv')


# -- the diffusion denoiser --------------------------------------------------------

DIFF_ARCH = ['--model-type', 'diffusion', '--output-data-format', 'all_frames',
             '--d-model', '128', '--num-layers', '2', '--num-heads', '4',
             '--diffusion-timesteps', '64']


def _jax_chain_draws(key, shape, steps):
    """The JAX sampler's draws for ``key``: the initial noise from
    ``split(key)[1]``, then one z a step from the carried key's splits."""
    rng, rng0 = jax.random.split(key)
    draws = [jax.random.normal(rng0, shape, jnp.float32)]
    for _ in range(steps):
        rng, rng_z = jax.random.split(rng)
        draws.append(jax.random.normal(rng_z, shape, jnp.float32))
    return [np.asarray(d) for d in draws]


def _jax_chain_noise(seed, samples, steps=50):
    """``models.diffusion.chain_noise`` fed with the JAX command's draws: the
    same key (``PRNGKey(seed)``) at every batch."""
    assert samples == 1
    cache = {}

    def noise(i, shape, device):
        if shape not in cache:
            cache[shape] = _jax_chain_draws(jax.random.PRNGKey(seed), shape, steps)
        return torch.from_numpy(cache[shape][i].copy()).to(device)

    return noise


@pytest.fixture(scope='module')
def dws(ws):
    """A diffusion checkpoint (seeded flax init, biases moved off zero, an EMA
    tree that differs) for both packages with the run_config sidecar, and a
    feedforward all-frames proposal for --diffusion-partial."""
    from inferbiomechanics_tpu.models.diffusion import DiffusionDenoiser as JaxDenoiser
    from inferbiomechanics_tpu.train.run_config import save_run_config as jax_save_run_config
    from inferbiomechanics_tpu.train.state import TrainState
    root = ws['root'] / 'diffusion'
    jparser = argparse.ArgumentParser()
    jax_add_config_flags(jparser)
    jcfg = jax_config_from_args(jparser.parse_args(DIFF_ARCH))
    jm = JaxDenoiser(num_dofs=23, num_contact_bodies=2, history_len=50, stride=5,
                     d_model=128, num_layers=2, num_heads=4, timesteps=64)
    params = jax.device_get(jm.init({'params': jax.random.PRNGKey(3)},
                                    jnp.zeros((BATCH, 10, 30)),
                                    jnp.zeros((BATCH,), jnp.int32),
                                    jnp.zeros((BATCH, 10, 177)))['params'])
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.1 * rng.normal(size=p.shape) if p.ndim == 1 else 0)
                   ).astype(np.float32), params)
    ema = jax.tree_util.tree_map(
        lambda p: (p * (1 + 0.05 * rng.normal(size=p.shape))).astype(np.float32), params)
    tx = jax_make_optimizer(jcfg.opt_type, jcfg.learning_rate)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       opt_state=tx.init(params), batch_stats={}, tx=tx, apply_fn=jm.apply)
    cfg = config_from_args(build_parser().parse_args(['train', *DIFF_ARCH]))
    for side in ('jax', 'port'):
        d = root / side / 'diffusion'
        if side == 'jax':
            jax_save_checkpoint(str(d), state, 0, 0, ema_params=ema)
        else:
            model = build_model_for_dataset(cfg, ws['ds'])
            model.load_state_dict(weights.diffusion_state_dict_from_jax(params))
            save_checkpoint(str(d), model, 0, 0,
                            ema_params=weights.diffusion_state_dict_from_jax(ema))
        jax_save_run_config(str(d), jcfg)
    # the proposal: a feedforward all-frames model, no sidecar (built from the
    # command's flags on both sides)
    pcfg = jax_config_from_args(jparser.parse_args(['--output-data-format', 'all_frames']))
    pds = JaxWindowDataset(os.path.join(ws['data'], 'dev'), window_size=50, stride=5,
                           output_data_format='all_frames', skip_loading_skeletons=True)
    pstate = jax_create_train_state(jax_build(pcfg, pds), jax.random.PRNGKey(4),
                                    jnp.asarray(pds.gather(np.arange(BATCH)).inputs),
                                    jax_make_optimizer(pcfg.opt_type, pcfg.learning_rate))
    jax_save_checkpoint(str(root / 'jax_proposal'), pstate, 0, 0)
    pmodel = build_model_for_dataset(
        config_from_args(build_parser().parse_args(['train', '--output-data-format',
                                                    'all_frames'])), ws['ds'])
    pmodel.load_state_dict(weights.feedforward_state_dict_from_jax(
        jax.device_get(pstate.params)))
    save_checkpoint(str(root / 'port_proposal'), pmodel, 0, 0)
    return root


# case -> extra flags of both runs (the proposal's dir is filled in by side)
DIFF_CASES = {
    'plain': [],
    'fused_ema': ['--fused-inference', '--use-ema'],
    'partial': ['--diffusion-partial', '0.3'],
    'partial_cfg_ema': ['--diffusion-partial', '0.3', '--guidance-scale', '2.0',
                        '--use-ema', '--fused-inference'],
}


@pytest.mark.parametrize('case', list(DIFF_CASES))
def test_diffusion_matches_the_jax_command(ws, dws, monkeypatch, case):
    from inferbiomechanics_tpu_torch.models import diffusion as port_diffusion
    monkeypatch.setattr(port_diffusion, 'chain_noise', _jax_chain_noise)
    flags = {side: list(DIFF_CASES[case]) for side in ('jax', 'port')}
    if '--diffusion-partial' in DIFF_CASES[case]:
        for side in flags:
            flags[side] += ['--init-checkpoint', str(dws / f'{side}_proposal')]
    out = {}
    for side, run in (('jax', _run_jax), ('port', _run_port)):
        d = dws / side / 'diffusion'
        _fresh(*(d / f'{s}_analysis.csv' for s in ('dev', 'train')))
        argv = ['analyze', '--dataset-home', ws['data'], '--checkpoint-dir',
                str(dws / side), '--no-wandb', *DIFF_ARCH, '--batch-size', str(BATCH),
                *flags[side]]
        launches = fe.launches
        out[side] = run(argv + (['--device', 'cpu'] if side == 'port' else []))
        assert fe.launches == launches
    for side in ('jax', 'port'):
        assert ('evaluating EMA parameters' in out[side]) == ('--use-ema' in flags[side])
        assert ('partial denoising from' in out[side]) == ('--diffusion-partial' in flags[side])
        assert ('classifier-free guidance scale 2.0' in out[side]) == (case == 'partial_cfg_ema')
    partial = '--diffusion-partial' in flags['port']
    for split in ('dev', 'train'):
        want, got = _report(out['jax'], split), _report(out['port'], split)
        for k in REPORT:
            assert got[k] == pytest.approx(want[k], rel=2e-2 if partial else 5e-2), (split, k)
        rows, jrows = (_rows(str(dws / side / 'diffusion' / f'{split}_analysis.csv'))
                       for side in ('port', 'jax'))
        if partial:
            _assert_rows_close(rows, jrows, 2e-2, split)
            continue
        # a chain from the top of the schedule: x0 = 8 sign(x_t - eps) at its
        # first step, and near-ties flip on bf16-level differences (see
        # tests/test_torch_diffusion.py); 90% of each column's rows hold 5e-2
        assert [r[:2] for r in rows] == [r[:2] for r in jrows] and len(rows) > 0
        g, w = (np.asarray([r[2:] for r in x], float) for x in (rows, jrows))
        close = np.abs(g - w) <= 5e-2 * np.abs(w).max(axis=0)
        assert (close.mean(axis=0) >= 0.9).all(), (split, close.mean(axis=0))


def test_diffusion_rows_are_equal_run_to_run_and_draw_from_seed_7(ws, dws):
    """Two runs write the same rows, and each batch's row is the sampler's
    answer with a generator seeded 7 for that batch."""
    from inferbiomechanics_tpu_torch.loss.evaluator import loss_and_metrics
    from inferbiomechanics_tpu_torch.models import diffusion as port_diffusion
    from inferbiomechanics_tpu_torch.data.dataset import unpack
    from inferbiomechanics_tpu_torch.train.checkpoint import load_latest_checkpoint
    from inferbiomechanics_tpu_torch.train.loop import loss_config_from
    assert port_diffusion.chain_noise(7, 1) is None
    d = dws / 'port' / 'diffusion'
    runs = []
    for _ in range(2):
        _fresh(*(d / f'{s}_analysis.csv' for s in ('dev', 'train')))
        _run_port(['analyze', '--dataset-home', ws['data'], '--checkpoint-dir',
                   str(dws / 'port'), '--no-wandb', *DIFF_ARCH, '--device', 'cpu',
                   '--batch-size', str(BATCH)])
        runs.append(_rows(str(d / 'dev_analysis.csv')))
    assert runs[0] == runs[1] and len(runs[0]) == 98
    cfg = config_from_args(build_parser().parse_args(['analyze', *DIFF_ARCH]))
    ds = WindowDataset(os.path.join(ws['data'], 'dev'), window_size=50, stride=5,
                       output_data_format='all_frames', skip_loading_skeletons=True)
    model = build_model_for_dataset(cfg, ds)
    load_latest_checkpoint(model, str(d))
    sampler = port_diffusion.make_sampler(model.eval(), num_steps=50)
    for i in (0, 28):
        batch = ds.gather(np.arange(i * BATCH, (i + 1) * BATCH))
        out = sampler(model, torch.from_numpy(batch.inputs), torch.Generator().manual_seed(7))
        m = loss_and_metrics(out, unpack(torch.from_numpy(batch.labels), ds.lab_offsets),
                             loss_config_from(cfg))[1]
        assert [float(r) for r in runs[0][i * BATCH][2:]] == pytest.approx(
            [float(m[k]) for k in ROW_KEYS], rel=1e-6), i


