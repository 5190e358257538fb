"""``make-plots`` of the port against the JAX package's on the same subjects,
in this process: ``collect_stats`` equal to the JAX function's, every array
and number exactly (the same numpy and scipy code), on B3D-TPU and legacy
subjects, with ``--raw``, ``--short``, ``--downsample-size``,
``--scatter-random``, the split-dataset dedup, the demographic overrides
and the reference's classification rules (rule tables and ``.npy`` class
dicts); the figure files ``render_plots`` writes equal to the JAX list for
the same statistics, through matplotlib and through ``utils/png_plot.py``
with matplotlib hidden (the full scatter set); caches crossing between the
JAX command, the port and ``make_plots_from_cache.py``; the same flags.

The JAX side's full figure lists are taken with ``matplotlib.pyplot``
replaced by a stand-in whose calls draw nothing: which files the JAX code
names does not depend on the raster, and drawing its 23-panel scatter
matrices takes ~40 s (``tests/test_analytics.py`` marks that test slow).
Both packages draw with the real matplotlib in
``test_figures_through_matplotlib_are_the_jax_files``.
"""

import argparse
import contextlib
import csv
import importlib.util
import io
import os
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from inferbiomechanics_tpu.cli import make_plots_cmd as jax_mp
from inferbiomechanics_tpu.data.b3d import write_subject
from inferbiomechanics_tpu.data.synthetic import (
    CONTACT_BODIES, standard_skeleton, synthetic_trial, write_synthetic_legacy_subject,
    write_synthetic_subject,
)
from inferbiomechanics_tpu_torch.__main__ import build_parser, main
from inferbiomechanics_tpu_torch.cli import make_plots_cmd as port_mp

REPO = Path(__file__).resolve().parents[1]
PNG = b'\x89PNG\r\n\x1a\n'


def _subject(path, names, seed, sex='unknown', age=30, mass=70.0, height=1.75,
             missing_frac=0.0):
    rng = np.random.default_rng(seed)
    write_subject(str(path), num_dofs=23, ground_force_bodies=CONTACT_BODIES,
                  root_history_len=10, skeleton=standard_skeleton(),
                  trials=[synthetic_trial(n, 100 + 20 * i, mass_kg=mass, gait_hz=0.8 + 0.3 * i,
                                          missing_frac=missing_frac, rng=rng)
                          for i, n in enumerate(names)],
                  mass_kg=mass, height_m=height, age_years=age, biological_sex=sex)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """Subjects of several datasets: split files (Carter2023, with a
    demographics CSV), rule-table trial names (Han2023), keyword names,
    Fregly's sex in the file name, a subject with a class dict, a legacy
    protobuf subject and one the scan leaves out ('vander')."""
    root = tmp_path_factory.mktemp('make_plots') / 'data'
    for d in ('Carter2023', 'Han2023', 'MyLab2020', 'Fregly2012', 'Hamner2013', 'Legacy'):
        (root / d).mkdir(parents=True)
    _subject(root / 'Carter2023' / 'x_no_arm_P01_split0.b3d', ['static_1', 'walk_2'], 1)
    _subject(root / 'Carter2023' / 'x_no_arm_P01_split1.b3d', ['run_3'], 2)
    _subject(root / 'Carter2023' / 'x_no_arm_P02_split0.b3d', ['run_4'], 3, missing_frac=0.2)
    with open(root / 'Carter2023' / 'demographics.csv', 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(['Participant_code', 'Age (years)', 'Sex'])
        w.writerows([['P01', '41', 'female'], ['P02', '23.0', 'male']])
    _subject(root / 'Han2023' / 'h_no_arm_h01.b3d', ['s_walk_1', 'a_hop_2', 'chair_3',
                                                     'b_step_4'], 4, sex='male', age=28)
    _subject(root / 'MyLab2020' / 'S1.b3d', ['walk_01', 'run fast', 'stair up', 'sts'], 5,
             sex='female', age=52, mass=61.0, height=1.62)
    _subject(root / 'Fregly2012' / 'subj_3GC.b3d', ['gait_1'], 6, sex='male', age=70)
    write_synthetic_subject(str(root / 'Hamner2013' / 'split0_no_arm_P001.b3d'), num_trials=3,
                            trial_length=100, seed=7)
    write_synthetic_legacy_subject(str(root / 'Legacy' / 'L1.b3d'), num_trials=2,
                                   trial_length=120, missing_frac=0.1, seed=8)
    write_synthetic_subject(str(root / 'Legacy' / 'vanderZee.b3d'), num_trials=1,
                            trial_length=60, seed=9)
    classes = root.parent / 'classes' / 'Hamner2013' / 'P001'
    classes.mkdir(parents=True)
    np.save(str(classes / 'P001.npy'), np.array(
        [{'trial_name': 'trial_0', 'motion_class': 'walking_ramp'},
         {'trial_name': 'trial_1', 'motion_class': 'bad'},
         {'trial_name': 'trial_2', 'motion_class': 'transition_sit'}], dtype=object))
    return root


@pytest.fixture()
def copies(tree, tmp_path):
    """A copy of the tree for each package: each converts the legacy subject
    itself (beside the source)."""
    return {name: Path(shutil.copytree(tree.parent, tmp_path / name)) / 'data'
            for name in ('jax', 'port')}


def _paths(root):
    return [os.path.join(d, f) for d, _, files in sorted(os.walk(root))
            for f in sorted(files) if f.endswith('.b3d') and 'vander' not in f.lower()]


def _stats(module, root, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = module.collect_stats(_paths(root), demo_csv=module.load_demographics_csv(
            str(root)), **kw)
    return stats, out.getvalue().replace(str(root), '<root>')


CASES = {
    'default': {},
    'raw': dict(raw=True),
    'short': dict(short=True),
    'downsample 3': dict(downsample=3),
    'scatter random': dict(scatter_random=True),
    'class dicts': dict(class_dir='classes', class_datasets=['Hamner2013', 'none']),
}


@pytest.mark.parametrize('case', list(CASES))
def test_collect_stats_equal_to_jax(copies, case):
    kw = dict(CASES[case])
    results = {}
    for name, module in (('jax', jax_mp), ('port', port_mp)):
        if 'class_dir' in kw:
            kw['class_dir'] = str(copies[name].parent / 'classes')
        results[name] = _stats(module, copies[name], **kw)
    (want, jax_out), (got, port_out) = results['jax'], results['port']
    np.testing.assert_equal(got, want)
    assert list(got) == list(want) and port_out == jax_out
    assert got['num_trials'] > 0 and got['scatter_frames']['totgrf_y']
    if case == 'default':
        # the split files of P01 counted once; the CSV's and the file name's
        # demographics; the rule tables and the keyword classes side by side
        assert got['dataset_n']['Carter2023'] == 2 and got['num_subjects'] == 8
        assert {'running_treadmill', 'standing', 'walking_treadmill', 'jump', 'squat',
                'walking_overground', 'stairs', 'walking', 'running', 'other'} <= {
            k for k, v in got['motion_class_hours'].items() if v > 0}
        assert 41 in got['ages'] and 23 in got['ages']
        assert got['sexes'].count(1) >= 2      # P01 from the CSV, Fregly's 3GC
    if case == 'class dicts':
        assert got['motion_class_hours'].get('walking_overground', 0) > 0
        assert 'SKIPPING TRIAL 2 (trial_1)' in port_out


class _Nothing:
    """Accepts every attribute, call and item, and draws nothing."""

    def __getattr__(self, name):
        if name.startswith('__'):       # numpy's array protocol probes
            raise AttributeError(name)
        return self

    def __call__(self, *args, **kwargs):
        return self

    def __getitem__(self, key):
        return self


class _StandInPyplot(_Nothing):
    def subplots(self, nrows=1, ncols=1, squeeze=True, **kwargs):
        if nrows * ncols == 1 and squeeze:
            return _Nothing(), _Nothing()
        axes = np.empty((nrows, ncols), object)
        for i in range(axes.size):
            axes.flat[i] = _Nothing()
        return _Nothing(), axes


def _stand_in_pyplot(monkeypatch):
    """``matplotlib.pyplot`` replaced by :class:`_StandInPyplot`."""
    import matplotlib
    plt = _StandInPyplot()
    monkeypatch.setattr(matplotlib, 'pyplot', plt, raising=False)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', plt)


def _names(paths):
    return [os.path.basename(p) for p in paths]


def test_figures_through_matplotlib_are_the_jax_files(copies, tmp_path):
    """Both drawn by matplotlib: the error-vs-frequency curves (lines,
    markers, bands, a legend) and the 4-pair scatter; the same files in the
    same order, each a PNG. ``test_every_mark_draws_both_ways`` draws the
    other marks (histograms, pies, box plots, bars) through matplotlib."""
    stats, _ = _stats(port_mp, copies['port'])
    groups = {'errvfreq', 'scatterplots'}
    want = jax_mp.render_plots(stats, str(tmp_path / 'jax'), False, groups)
    got = port_mp.render_plots(stats, str(tmp_path / 'port'), False, groups)
    assert _names(got) == _names(want) == ['scatter_matrix.png', 'err_vs_frequency.png',
                                           'err_vs_freq_by_motion.png']
    assert all(open(p, 'rb').read(8) == PNG for p in got)


def test_every_mark_draws_both_ways(tmp_path, monkeypatch):
    """One figure of every mark ``render_plots`` and ``plot-training`` use,
    written by matplotlib and by ``utils/png_plot.py``: both PNGs; the PNG's
    text chunks hold the figure's title and its panels' titles; bars of a
    pie's shares and of a box plot's five numbers land inside the frame."""
    from inferbiomechanics_tpu_torch.utils import png_plot
    rng = np.random.default_rng(0)
    fig = png_plot.Figure(2, 4, figsize=(12, 6), title='every mark', grid='#e4e3df')
    fig[0].hist(rng.normal(size=50), bins=8, colors=('#346beb',))
    fig[1].hist([rng.normal(size=9), rng.normal(size=4), np.zeros(0)], bins=6,
                colors=['#006BA4', '#FF800E', '#ABABAB'], labels=['a', 'b', 'c'])
    fig[1].legend = True
    fig[2].pie([3, 1, 0], labels=['x', 'y', 'z'])
    fig[3].box([rng.normal(size=7), np.zeros(0)], labels=['m', 'f'])
    fig[4].bars(range(3), [1.0, 0.0, 2.5], color='#52b06d')
    fig[4].xticks, fig[4].xtick_rotation = ['p', 'q', 'r'], 30
    fig[5].points(rng.normal(size=40), rng.normal(size=40), color='#e0544f', label='cls')
    fig[6].line([0, 3, 6], [2.0, 1.0, np.nan], color='#1f77b4', marker=True, label='l')
    fig[6].band([0, 3, 6], [1.5, 0.5, 0.5], [2.5, 1.5, 1.0], color='#1f77b4')
    for i, panel in enumerate(fig.panels[:7]):
        panel.title, panel.xlabel = f'panel {i}', 'x'
    fig.save(str(tmp_path / 'mpl.png'), png_plot.pyplot())
    fig.save(str(tmp_path / 'png.png'))
    for name in ('mpl.png', 'png.png'):
        assert (tmp_path / name).read_bytes()[:8] == PNG
    data = (tmp_path / 'png.png').read_bytes()
    assert b'Title\x00every mark' in data and b'panel 6 | x: x' in data
    img = fig.image()
    assert img.shape == (480, 960, 3) and (img != 255).any(axis=2).sum() > 2000
    assert len(fig[2].marks[0].as_bars()[0].y) == 3
    np.testing.assert_allclose(fig[2].marks[0].as_bars()[0].y, [0.75, 0.25, 0.0])
    five = fig[3].marks[0].as_bars()
    assert [len(b.x) for b in five] == [5, 5] and (np.diff(five[0].y) >= 0).all()


@pytest.mark.parametrize('raw', [False, True])
def test_full_figure_set_through_png_plot(copies, tmp_path, monkeypatch, raw):
    """With matplotlib hidden the port writes every figure of the JAX list,
    the scatter matrices included, as PNGs that decode."""
    stats, _ = _stats(port_mp, copies['port'], raw=raw)
    with monkeypatch.context() as m:
        _stand_in_pyplot(m)
        want = jax_mp.render_plots(stats, str(tmp_path / 'jax'))
    monkeypatch.setitem(sys.modules, 'matplotlib', None)          # not installed
    got = port_mp.render_plots(stats, str(tmp_path / 'port'))
    assert _names(got) == _names(want)
    assert len(got) == (35 if raw else 42)
    assert any(n.startswith('scatter_jointtau') for n in _names(got)) is not raw
    for p in got:
        data = open(p, 'rb').read()
        assert data[:8] == PNG and b'IDAT' in data and b'IEND' in data


def _jax_command(argv):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest='command')
    jax_mp.MakePlotsCommand().register_subcommand(sub)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_mp.MakePlotsCommand().run(parser.parse_args(['make-plots', *argv]))
    return out.getvalue()


def _port_command(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(['make-plots', *argv]) == 0
    return out.getvalue()


def _written(out, root):
    return [os.path.relpath(line[len('wrote '):], root) for line in out.splitlines()
            if line.startswith('wrote ') and not line.startswith('wrote cache ')]


def test_caches_cross_between_the_packages(copies, tmp_path, monkeypatch):
    """The JAX command's cache replayed by the port, and the port's replayed
    by the JAX command and by ``make_plots_from_cache.py``: the same figure
    files; the two caches hold equal statistics and no class of either
    package."""
    jax_cache, port_cache = tmp_path / 'jax.pkl', tmp_path / 'port.pkl'
    with monkeypatch.context() as m:
        _stand_in_pyplot(m)
        jax_out = _jax_command(['--data-path', str(copies['jax']), '--out-dir',
                                str(tmp_path / 'j'), '--cache', str(jax_cache),
                                '--datasets', 'Carter2023', 'Legacy'])
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    port_out = _port_command(['--data-path', str(copies['port']), '--out-dir',
                              str(tmp_path / 'p'), '--cache', str(port_cache),
                              '--datasets', 'Carter2023', 'Legacy'])
    summary = [line for line in port_out.splitlines() if line.startswith('subjects=')]
    assert summary == [line for line in jax_out.splitlines() if line.startswith('subjects=')]
    assert summary[0].startswith('subjects=4 ')
    figures = _written(jax_out, tmp_path / 'j')
    assert _written(port_out, tmp_path / 'p') == figures and len(figures) == 42
    for cache in (jax_cache, port_cache):
        assert b'inferbiomechanics' not in cache.read_bytes()
    with open(jax_cache, 'rb') as a, open(port_cache, 'rb') as b:
        np.testing.assert_equal(pickle.load(b), pickle.load(a))

    # the JAX command's cache, replayed by the port (no matplotlib)
    replayed = _port_command(['--use-cache', '--cache', str(jax_cache), '--out-dir',
                              str(tmp_path / 'pr')])
    assert f'loaded cache {jax_cache}' in replayed
    assert _written(replayed, tmp_path / 'pr') == figures
    monkeypatch.delitem(sys.modules, 'matplotlib')
    # the port's cache, replayed by the JAX command and the root script
    with monkeypatch.context() as m:
        _stand_in_pyplot(m)
        out = _jax_command(['--use-cache', '--cache', str(port_cache), '--out-dir',
                            str(tmp_path / 'jr')])
        assert _written(out, tmp_path / 'jr') == figures
        spec = importlib.util.spec_from_file_location('make_plots_from_cache',
                                                      REPO / 'make_plots_from_cache.py')
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        m.setattr(sys, 'argv', ['make_plots_from_cache.py', '--cache', str(port_cache),
                                '--out-dir', str(tmp_path / 'sr')])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert script.main() == 0
        assert _written(buf.getvalue(), tmp_path / 'sr') == figures


def test_toggles_and_printed_metrics_agree(copies, tmp_path, monkeypatch):
    argv = ['--output-histograms', '--output-subjmetrics', '--output-trialmetrics',
            '--downsample-size', '5', '--no-scatter', '--short']
    jax_out = _jax_command(['--data-path', str(copies['jax']), '--out-dir', str(tmp_path / 'j'),
                            '--cache', str(tmp_path / 'j.pkl'), *argv])
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    port_out = _port_command(['--data-path', str(copies['port']), '--out-dir',
                              str(tmp_path / 'p'), '--cache', str(tmp_path / 'p.pkl'), *argv])
    strip = [line for line in port_out.splitlines()
             if not line.startswith(('wrote ', 'scanning'))]
    assert strip == [line for line in jax_out.splitlines()
                     if not line.startswith(('wrote ', 'scanning'))]
    assert _written(port_out, tmp_path / 'p') == _written(jax_out, tmp_path / 'j')
    assert not any(n.startswith('scatter') or n.startswith('err_')
                   for n in _written(port_out, tmp_path / 'p'))


def test_flags_agree():
    jax_parser = argparse.ArgumentParser()
    jax_sub = jax_parser.add_subparsers(dest='command')
    jax_mp.MakePlotsCommand().register_subcommand(jax_sub)
    port_sub = next(a for a in build_parser()._actions
                    if isinstance(a, argparse._SubParsersAction))

    def flags(p):
        return {tuple(a.option_strings): (a.dest, a.default, a.nargs, type(a).__name__)
                for a in p._actions if not isinstance(a, argparse._HelpAction)}

    assert flags(port_sub.choices['make-plots']) == flags(jax_sub.choices['make-plots'])
    assert port_mp.CLASS_COLORS == jax_mp.CLASS_COLORS
    assert port_mp.PER_DOF_MATRICES == jax_mp.PER_DOF_MATRICES
    assert port_mp.SINGLE_PLOTS == jax_mp.SINGLE_PLOTS
    assert port_mp.FREQ_CUTOFFS == jax_mp.FREQ_CUTOFFS
