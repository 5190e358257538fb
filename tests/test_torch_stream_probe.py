"""The streaming probe of the port (inferbiomechanics_tpu_torch/ops/
stream_probe.py) needs nvcc and a card; here, where there is neither, its
source must be where the runner and the packaging look for it, and the
runner must fail by name instead of running something else."""

import re
from pathlib import Path

import pytest

from inferbiomechanics_tpu_torch.ops import _build, stream_probe


def test_probe_source_is_packaged_and_kept_out_of_the_library():
    assert stream_probe.SOURCE.is_file()
    # the kernel library is built from csrc/*.cu alone: the probe has a main()
    assert stream_probe.SOURCE not in _build._sources()
    pyproject = (Path(__file__).resolve().parents[1] / 'pyproject.toml').read_text()
    listed = re.search(r'"inferbiomechanics_tpu_torch\.ops" = \[(.*?)\]', pyproject).group(1)
    assert '"csrc/probe/*.cu"' in listed


def test_probe_includes_the_kernels_own_helpers():
    text = stream_probe.SOURCE.read_text()
    assert '#include "../mma.cuh"' in text
    for helper in ('mbar_wait', 'mbar_arrive_expect_tx', 'bulk_copy_g2s'):
        assert helper in text and f'void {helper}(' in (_build.CSRC_DIR / 'mma.cuh').read_text()


def test_probe_fails_by_name_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        stream_probe.main()
