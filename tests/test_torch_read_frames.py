"""``readFrames`` of the port's two readers (``data/b3d.py::SubjectOnDisk`` and
``data/b3d_legacy.py::LegacySubjectOnDisk``): ``contactThreshold`` recomputes
the contact flags as nimble does, the default returns the stored flags
(bitwise the JAX package's readers), and ``includeSensorData=True`` is
refused by name. One synthetic trial a format, every frame and pass."""

import numpy as np
import pytest

from inferbiomechanics_tpu.data.b3d import SubjectOnDisk as JaxSubjectOnDisk
from inferbiomechanics_tpu.data.b3d_legacy import LegacySubjectOnDisk as JaxLegacySubjectOnDisk
from inferbiomechanics_tpu_torch.data.b3d import SubjectOnDisk
from inferbiomechanics_tpu_torch.data.b3d_legacy import LegacySubjectOnDisk
from inferbiomechanics_tpu_torch.data.synthetic import (
    write_synthetic_legacy_subject, write_synthetic_subject,
)

FORMATS = {
    'b3d': (write_synthetic_subject, SubjectOnDisk, JaxSubjectOnDisk),
    'legacy': (write_synthetic_legacy_subject, LegacySubjectOnDisk, JaxLegacySubjectOnDisk),
}
T = 80


@pytest.fixture(scope='module', params=list(FORMATS))
def subject(request, tmp_path_factory):
    write, reader, jax_reader = FORMATS[request.param]
    path = str(tmp_path_factory.mktemp(f'read_frames_{request.param}') / 's.b3d')
    write(path, num_trials=1, trial_length=T, seed=3)
    return reader(path), jax_reader(path)


def _passes(frames):
    return [p for f in frames for p in f.processingPasses]


def _norms(p):
    return np.linalg.norm(np.asarray(p.groundContactForce, np.float64).reshape(-1, 3), axis=1)


@pytest.mark.parametrize('threshold', [20.0, 400.0])
def test_contact_threshold_recomputes_the_flags(subject, threshold):
    s, _ = subject
    stored = _passes(s.readFrames(0, 0, T))
    got = _passes(s.readFrames(0, 0, T, contactThreshold=threshold))
    assert len(got) == len(stored) >= T
    for p, q in zip(got, stored):
        assert np.array_equal(np.asarray(p.contact), (_norms(p) > threshold).astype(np.float64))
        assert np.array_equal(np.asarray(p.groundContactForce), np.asarray(q.groundContactForce))
        assert p.type == q.type
    moved = sum(int((np.asarray(p.contact) != np.asarray(q.contact)).sum())
                for p, q in zip(got, stored))
    # at 400 N a foot in light contact is no longer in contact
    assert (moved > 0) == (threshold == 400.0), moved


def test_default_threshold_returns_the_stored_flags(subject):
    s, js = subject
    for args in ((0, 0, T), (0, 5, 9, 3), (0, T - 2, 10)):
        got, want = s.readFrames(*args), js.readFrames(*args)
        assert [f.index for f in got] == [f.index for f in want]
        for p, q in zip(_passes(got), _passes(want)):
            for name in ('contact', 'groundContactForce', 'pos'):
                a, b = np.asarray(getattr(p, name)), np.asarray(getattr(q, name))
                assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert _passes(s.readFrames(0, 0, 4, contactThreshold=1.0))[0].contact.tolist() == \
        _passes(js.readFrames(0, 0, 4))[0].contact.tolist()


def test_include_sensor_data_is_refused_by_name(subject):
    s, _ = subject
    with pytest.raises(ValueError, match='includeSensorData'):
        s.readFrames(0, 0, 4, includeSensorData=True)
