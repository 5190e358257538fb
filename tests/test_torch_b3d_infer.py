"""The port's ``data/b3d_infer.py`` against the JAX package's on the same
legacy ``.b3d`` files: ``walk_framing`` and ``infer_legacy_schema`` give equal
results and ``format_infer_report`` the same text, on a file written with
the built-in tables, on files written under moved header and pass-frame
field numbers and under shuffled pass-frame tables (monkeypatched in both
packages' ``b3d_legacy`` while writing), and with the built-in tables
themselves moved in both packages while inferring (the port reads them when
it is called). Exact equality: both are the same numpy and wire code.
"""

import numpy as np
import pytest

from inferbiomechanics_tpu.data import b3d_infer as jax_infer
from inferbiomechanics_tpu.data import b3d_legacy as jax_legacy
from inferbiomechanics_tpu.data.synthetic import write_synthetic_legacy_subject
from inferbiomechanics_tpu_torch.data import b3d_infer as port_infer
from inferbiomechanics_tpu_torch.data import b3d_legacy as port_legacy
from inferbiomechanics_tpu_torch.data import synthetic as port_synthetic


def _both_tables(monkeypatch, **tables):
    """Set ``tables`` (name -> dict) in both packages' ``b3d_legacy``."""
    for module in (jax_legacy, port_legacy):
        for name, table in tables.items():
            monkeypatch.setattr(module, name, dict(table) if isinstance(table, dict)
                                else table)


def _write(path, monkeypatch=None, **tables):
    """A legacy subject written by the JAX writer, under ``tables`` when
    given; the port's writer gives the same bytes."""
    if tables:
        _both_tables(monkeypatch, **tables)
    write_synthetic_legacy_subject(str(path), num_trials=2, trial_length=40,
                                   missing_frac=0.1, seed=3)
    port_path = str(path) + '.port'
    port_synthetic.write_synthetic_legacy_subject(port_path, num_trials=2, trial_length=40,
                                                  missing_frac=0.1, seed=3)
    if tables:
        monkeypatch.undo()
    with open(path, 'rb') as a, open(port_path, 'rb') as b:
        assert a.read() == b.read()
    return str(path)


def _same(path):
    want = jax_infer.infer_legacy_schema(path)
    got = port_infer.infer_legacy_schema(path)
    assert got == want
    assert port_infer.format_infer_report(got) == jax_infer.format_infer_report(want)
    return got


def _moved_header():
    h = dict(jax_legacy._H)
    h['num_dofs'], h['version'] = 15, 1
    h['mass_kg'], h['height_m'] = 8, 7
    return h


def _moved_pass_field():
    pf = dict(jax_legacy._PF)
    pf['jointCentersInRootFrame'], pf['rootLinearVelInRootFrame'] = (
        pf['rootLinearVelInRootFrame'], pf['jointCentersInRootFrame'])
    return pf


@pytest.mark.parametrize('max_records', [None, 1, 7])
def test_walk_framing_agrees(tmp_path, max_records):
    path = _write(tmp_path / 's.b3d')
    jh, js = jax_infer.walk_framing(path, max_records)
    ph, ps = port_infer.walk_framing(path, max_records)
    assert ph == jh and ps == js
    assert len(ps) == (80 if max_records is None else max_records)


def test_builtin_tables_agree(tmp_path):
    r = _same(_write(tmp_path / 's.b3d'))
    assert r['builtin_diff'] == [] and r['num_dofs'] == 23
    assert 'CONSISTENT' in port_infer.format_infer_report(r)


def test_moved_header_fields_agree(tmp_path, monkeypatch):
    r = _same(_write(tmp_path / 'moved.b3d', monkeypatch, _H=_moved_header()))
    msgs = '\n'.join(r['builtin_diff'])
    assert '_H[num_dofs]: file says field 15' in msgs
    assert '_H[mass_kg]: file says field 8' in msgs


def test_moved_pass_field_agrees(tmp_path, monkeypatch):
    pf = _moved_pass_field()
    r = _same(_write(tmp_path / 'movedpf.b3d', monkeypatch, _PF=pf))
    assert (f'_PF[jointCentersInRootFrame]: file says field '
            f'{pf["jointCentersInRootFrame"]}') in '\n'.join(r['builtin_diff'])


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_shuffled_pass_tables_agree(tmp_path, monkeypatch, seed):
    names = list(jax_legacy._PF)
    nums = np.random.default_rng(seed).permutation(np.arange(1, len(names) + 1)).tolist()
    pf = dict(zip(names, nums))
    r = _same(_write(tmp_path / f'shuf{seed}.b3d', monkeypatch, _PF=pf,
                     _PF_CONTACT_FIELD=pf['contact']))
    contact = [e for e in r['proposed']['PF_width_classes'] if e['candidates'] == ['contact']]
    assert contact and contact[0]['field'] == pf['contact']


@pytest.mark.parametrize('moved', ['header', 'pass'])
def test_tables_are_read_when_called(tmp_path, monkeypatch, moved):
    """A file written with the built-in tables, inferred while the tables
    are moved: the diff is against the moved tables in both packages (the
    JAX module bound its tables at import, so they are set there too)."""
    path = _write(tmp_path / 's.b3d')
    name, table = ('_H', _moved_header()) if moved == 'header' else ('_PF', _moved_pass_field())
    _both_tables(monkeypatch, **{name: table})
    monkeypatch.setattr(jax_infer, name, dict(table))
    r = _same(path)
    assert r['builtin_diff'], 'the moved table should disagree with the file'
    assert all(d.startswith(name) for d in r['builtin_diff'])


def test_non_framed_files_are_refused_alike(tmp_path):
    path = tmp_path / 'junk.b3d'
    path.write_bytes(b'\xff' * 64)
    errors = []
    for module in (jax_infer, port_infer):
        with pytest.raises(ValueError) as e:
            module.infer_legacy_schema(str(path))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
