"""``convert-b3d`` of the port against the JAX ``ConvertB3dCommand``, both in
this process on the same legacy trees (written by the JAX package's writer):
the converted ``.b3dtpu`` files byte for byte equal, beside the sources and
mirrored under ``--out-dir``; the up-to-date skip and ``--force``; the
``--verify`` and ``--infer-schema`` reports and exit codes, on files that
pass and on files that fail; the same flags. Printed lines are compared with
the tree's root and the seconds of each conversion taken out.
"""

import argparse
import contextlib
import io
import os
import re
import shutil

import pytest

from inferbiomechanics_tpu.cli.convert_b3d_cmd import ConvertB3dCommand
from inferbiomechanics_tpu.data import b3d_legacy as jax_legacy
from inferbiomechanics_tpu.data.synthetic import (
    write_synthetic_legacy_subject, write_synthetic_subject,
)
from inferbiomechanics_tpu_torch.__main__ import build_parser, main


def _flags(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.nargs, a.type, type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def _jax_parser():
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest='command')
    ConvertB3dCommand().register_subcommand(sub)
    return parser, sub


def jax_cmd(argv):
    parser, _ = _jax_parser()
    args = parser.parse_args(['convert-b3d', *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            ConvertB3dCommand().run(args)
            rc = 0
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


def port_cmd(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(['convert-b3d', *argv])
    return rc, out.getvalue()


def _norm(text, *roots):
    for i, root in enumerate(roots):
        text = text.replace(str(root), f'<root{i}>')
    return re.sub(r', [0-9.]+s\)', ', Ts)', text)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """Two legacy subjects in nested folders and one B3D-TPU subject."""
    root = tmp_path_factory.mktemp('convert') / 'tree'
    (root / 'a').mkdir(parents=True)
    (root / 'b' / 'c').mkdir(parents=True)
    write_synthetic_legacy_subject(str(root / 'a' / 's1.b3d'), num_trials=2, trial_length=60,
                                   missing_frac=0.1, seed=1)
    write_synthetic_legacy_subject(str(root / 'b' / 'c' / 's2.b3d'), num_trials=1,
                                   trial_length=90, seed=2)
    write_synthetic_subject(str(root / 'b' / 'tpu.b3d'), num_trials=1, trial_length=50, seed=3)
    return root


def _copy(tree, where):
    shutil.copytree(tree, where)
    return where


def _outputs(root, suffix='.b3dtpu'):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), 'rb').read()
            for d, _, files in os.walk(root) for f in files if f.endswith(suffix)}


def test_flags_agree():
    _, jax_sub = _jax_parser()
    port_sub = next(a for a in build_parser()._actions
                    if isinstance(a, argparse._SubParsersAction))
    assert _flags(port_sub.choices['convert-b3d']) == _flags(jax_sub.choices['convert-b3d'])


def test_converted_files_are_byte_for_byte_the_jax_files(tree, tmp_path):
    j, p = _copy(tree, tmp_path / 'jax'), _copy(tree, tmp_path / 'port')
    jrc, jout = jax_cmd([str(j)])
    prc, pout = port_cmd([str(p)])
    assert prc == jrc == 0
    assert _norm(pout, p) == _norm(jout, j)
    assert '2 converted, 1 skipped' in pout and 'skip (already B3D-TPU)' in pout
    want, got = _outputs(j), _outputs(p)
    assert sorted(got) == sorted(want) == ['a/s1.b3dtpu', 'b/c/s2.b3dtpu']
    for name in want:
        assert got[name] == want[name], name


def test_out_dir_mirrors_the_tree(tree, tmp_path):
    jrc, jout = jax_cmd([str(tree), '--out-dir', str(tmp_path / 'jax_out')])
    prc, pout = port_cmd([str(tree), '--out-dir', str(tmp_path / 'port_out')])
    assert prc == jrc == 0
    assert (_norm(pout, tree, tmp_path / 'port_out')
            == _norm(jout, tree, tmp_path / 'jax_out'))
    want, got = (_outputs(tmp_path / name, '.b3d') for name in ('jax_out', 'port_out'))
    assert got == want and sorted(got) == ['a/s1.b3d', 'b/c/s2.b3d']
    # one file: its base name under --out-dir
    src = str(tree / 'a' / 's1.b3d')
    jax_cmd([src, '--out-dir', str(tmp_path / 'jax_one')])
    port_cmd([src, '--out-dir', str(tmp_path / 'port_one')])
    assert os.listdir(tmp_path / 'port_one') == os.listdir(tmp_path / 'jax_one') == ['s1.b3d']
    assert ((tmp_path / 'port_one' / 's1.b3d').read_bytes()
            == (tmp_path / 'jax_one' / 's1.b3d').read_bytes())


def test_up_to_date_skip_and_force(tree, tmp_path):
    runs = {}
    for name, cmd in (('jax', jax_cmd), ('port', port_cmd)):
        root = _copy(tree, tmp_path / name)
        runs[name] = [_norm(cmd([str(root), *flags])[1], root)
                      for flags in ([], [], ['--force'])]
    assert runs['port'] == runs['jax']
    first, again, forced = runs['port']
    assert '2 converted, 1 skipped' in first
    assert again.count('skip (up to date)') == 2 and '0 converted, 3 skipped' in again
    assert '2 converted, 1 skipped' in forced


def test_verify_reports_agree(tree, tmp_path):
    for argv in ([str(tree), '--verify'], [str(tree / 'a' / 's1.b3d'), '--verify',
                                           '--verify-frames', '5']):
        jrc, jout = jax_cmd(argv)
        prc, pout = port_cmd(argv)
        assert prc == jrc == 0 and pout == jout
    # a file with trailing bytes beyond its last frame record fails
    bad = tmp_path / 'bad.b3d'
    bad.write_bytes((tree / 'a' / 's1.b3d').read_bytes() + b'\x01\x02\x03')
    jrc, jout = jax_cmd([str(bad), '--verify'])
    prc, pout = port_cmd([str(bad), '--verify'])
    assert prc == jrc == 1 and pout == jout
    assert 'VERIFY FAILED for 1 of 1 files' in pout


def test_infer_schema_reports_agree(tree, tmp_path, monkeypatch):
    jrc, jout = jax_cmd([str(tree), '--infer-schema'])
    prc, pout = port_cmd([str(tree), '--infer-schema'])
    assert prc == jrc == 0 and pout == jout
    assert pout.count('CONSISTENT') == 2 and 'skip (already B3D-TPU)' in pout
    # a file whose header numbering the built-in tables do not know
    h = dict(jax_legacy._H)
    h['mass_kg'], h['height_m'] = h['height_m'], h['mass_kg']
    monkeypatch.setattr(jax_legacy, '_H', h)
    moved = str(tmp_path / 'moved.b3d')
    write_synthetic_legacy_subject(moved, num_trials=1, trial_length=30, seed=0)
    monkeypatch.undo()
    jrc, jout = jax_cmd([moved, '--infer-schema'])
    prc, pout = port_cmd([moved, '--infer-schema'])
    assert prc == jrc == 1 and pout == jout
    assert 'SCHEMA DISAGREEMENT in 1 of 1 files' in pout and '_H[mass_kg]' in pout
