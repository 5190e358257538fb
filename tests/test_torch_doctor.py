"""``doctor`` of the port on the CPU, against the JAX ``DoctorCommand`` where
the two share their parts: ``classify_backend_health`` on a grid of inputs,
the ``--json`` report's keys and its ``datasets`` entry, the flags. The
port's own probes: K1's plain version at B=1 and 4096 within its tolerance
on ``--device cpu``; without a GPU and without ``--device cpu``, exit 1 that
names the missing device; ``--skip-device``; each degraded state by name
(a capability other than 9.0, no nvcc, a failed build, a failed launch, a
K1 result out of tolerance, a slow first call, a slow copy). No timing
threshold is asserted.
"""

import argparse
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.cli import doctor_cmd as jax_doctor
from inferbiomechanics_tpu.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.__main__ import build_parser, main
from inferbiomechanics_tpu_torch.cli import doctor_cmd
from inferbiomechanics_tpu_torch.ops import _build
from inferbiomechanics_tpu_torch.ops import fused_mlp as fm


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def home(tmp_path_factory):
    root = tmp_path_factory.mktemp('doctor')
    for split, seed in (('train', 0), ('dev', 1)):
        (root / split).mkdir()
        write_synthetic_subject(str(root / split / 's.b3d'), num_trials=2, trial_length=120,
                                seed=seed)
    return root


def _jax_parser():
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest='command')
    jax_doctor.DoctorCommand().register_subcommand(sub)
    return parser, sub


def jax_cmd(argv):
    args = _jax_parser()[0].parse_args(['doctor', *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            jax_doctor.DoctorCommand().run(args)
            rc = 0
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


def port_cmd(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(['doctor', *argv])
    return rc, out.getvalue()


def _report(out: str) -> dict:
    return json.loads(next(line for line in out.splitlines() if line.startswith('{')))


@pytest.mark.parametrize('compile_s', [None, 0.0, 1.5, 179.9, 180.0, 1e4])
@pytest.mark.parametrize('mbps', [None, 0.0, 0.499, 0.5, 12.0, 5e4])
def test_classify_backend_health_agrees(compile_s, mbps):
    assert (doctor_cmd.classify_backend_health(compile_s, mbps)
            == jax_doctor.classify_backend_health(compile_s, mbps))
    assert (doctor_cmd.COMPILE_DEGRADED_S, doctor_cmd.TRANSFER_DEGRADED_MBPS) == (
        jax_doctor.COMPILE_DEGRADED_S, jax_doctor.TRANSFER_DEGRADED_MBPS)


def test_flags_are_the_jax_flags_and_device():
    port_sub = next(a for a in build_parser()._actions
                    if isinstance(a, argparse._SubParsersAction))

    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default, type(a).__name__)
                for a in p._actions if not isinstance(a, argparse._HelpAction)}

    got, want = flags(port_sub.choices['doctor']), flags(_jax_parser()[1].choices['doctor'])
    assert got.pop('device') == (('--device',), 'cuda', '_StoreAction')
    assert got == want


def test_cpu_report_keys_datasets_and_k1(home):
    jrc, jout = jax_cmd(['--dataset-home', str(home), '--transfer-mb', '0.5', '--json'])
    rc, out = port_cmd(['--device', 'cpu', '--dataset-home', str(home), '--transfer-mb', '0.5',
                        '--json'])
    want, got = _report(jout), _report(out)
    assert rc == 0 and got['healthy'] is True and got['degraded'] == []
    assert 'DOCTOR: healthy' in out and 'skipped' in out
    assert set(want) <= set(got) and set(want['probes']) <= set(got['probes'])
    assert got['datasets'] == want['datasets'] and len(got['datasets']) == 2
    for root in got['datasets']:
        assert f'{root}: 1 subjects' in out
    assert [(k['batch'], k['kernel'], k['ok']) for k in got['k1']] == [
        (1, 'plain', True), (4096, 'plain', True)]
    assert all(k['max_abs_err'] <= doctor_cmd.K1_ATOL for k in got['k1'])
    assert got['skipped'] == ['build', 'k1 launches', 'pinned copy']
    assert got['probes']['pinned_gbps'] is None and got['probes']['pageable_gbps'] > 0
    assert got['probes']['step_ms'] > 0 and got['backend'] == 'healthy'
    assert jrc in (0, 1)    # the JAX probes' health depends on the load


def test_cpu_k1_probe_is_the_plain_chain():
    """On the CPU K1's wrapper is ``mlp_reference``: the probe's outputs are
    that chain's on the seeded weights, within the tolerance of float64."""
    report, degraded = {}, []
    seen = []
    forward = fm.fused_mlp_forward

    def recording(x, packed, activation='sigmoid'):
        out = forward(x, packed, activation)
        seen.append((x, packed, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fm, 'fused_mlp_forward', recording)
        doctor_cmd.k1_probe(report, degraded, torch.device('cpu'))
    assert degraded == [] and [x.shape[0] for x, _, _ in seen] == [1, 4096]
    for x, packed, out in seen:
        h = x.to(torch.bfloat16).double()
        for i, (w, b) in enumerate(packed.layers):
            h = h @ w.double() + b.double()
            h = (torch.sigmoid(h) if i < len(packed.layers) - 1 else h)
            h = h.to(torch.bfloat16).double()
        np.testing.assert_allclose(out.numpy(), h.numpy(), rtol=2e-2, atol=2e-2)


def test_without_a_gpu_exits_1_naming_the_device(home, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc, out = port_cmd(['--dataset-home', str(home), '--json'])
    report = _report(out)
    assert rc == 1 and report['healthy'] is False
    assert report['degraded'][0].startswith('no CUDA device: torch.cuda.is_available() is False')
    assert report['probes'] == {} and 'k1' not in report   # nothing ran on the CPU
    assert report['skipped'] == ['build', 'k1', 'copy', 'matmul']
    assert 'DOCTOR: DEGRADED' in out and len(report['datasets']) == 2


def test_skip_device(home, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc, out = port_cmd(['--skip-device', '--dataset-home', str(home), '--json'])
    report = _report(out)
    assert rc == 0 and report['healthy'] and report['probes'] == {}
    assert 'device probes skipped (--skip-device)' in out
    jrc, jout = jax_cmd(['--skip-device', '--dataset-home', str(home), '--json'])
    assert jrc == 0 and report['datasets'] == _report(jout)['datasets']


def _fake_card(monkeypatch, capability):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda i=0: 'A card')
    monkeypatch.setattr(torch.cuda, 'get_device_capability', lambda i=0: capability)


def test_other_capability_is_named(monkeypatch):
    _fake_card(monkeypatch, (8, 0))
    monkeypatch.setattr(_build, '_nvcc', lambda: '/bin/true')
    rc, out = port_cmd(['--json'])
    report = _report(out)
    assert rc == 1 and report['device']['devices'][0]['capability'] == [8, 0]
    assert report['degraded'] == ['compute capability 8.0 on A card: the kernels are built '
                                  'for sm_90a and need 9.0 (an H100)']


def test_toolchain_and_build_failures_are_named(monkeypatch):
    def no_nvcc():
        raise RuntimeError('nvcc not found')

    monkeypatch.setattr(_build, '_nvcc', no_nvcc)
    report, degraded = {}, []
    assert doctor_cmd.toolchain(report, degraded, True) is False
    assert degraded == ['no nvcc: nvcc not found'] and report['toolchain']['nvcc'] is None
    assert doctor_cmd.toolchain(report, [], False) is False     # not needed on the CPU

    def failed():
        raise RuntimeError('nvcc failed (2):\nerror: something')

    monkeypatch.setattr(_build, 'ensure_built', failed)
    report, degraded = {}, []
    assert doctor_cmd.build_probe(report, degraded) is False
    assert report['build']['status'] == 'failed'
    assert degraded == ['kernel build failed: nvcc failed (2):']


def test_failed_launch_and_wrong_result_are_named(monkeypatch):
    def raises(x, packed, activation='sigmoid'):
        raise RuntimeError('fused_mlp_forward launch: CUDA error 700')

    monkeypatch.setattr(fm, 'fused_mlp_forward', raises)
    report, degraded = {}, []
    assert doctor_cmd.k1_probe(report, degraded, torch.device('cpu')) is None
    assert [d.split(':')[0] for d in degraded] == ['K1 launch failed at B=1 (plain)',
                                                   'K1 launch failed at B=4096 (plain)']

    monkeypatch.setattr(fm, 'fused_mlp_forward', lambda x, packed, activation='sigmoid':
                        fm.mlp_reference(x, packed.layers, activation) + 0.5)
    report, degraded = {}, []
    doctor_cmd.k1_probe(report, degraded, torch.device('cpu'))
    assert [k['ok'] for k in report['k1']] == [False, False]
    assert all(d.startswith('K1 out of tolerance at B=') and '0.5 > 0.01' in d
               for d in degraded) and len(degraded) == 2


def test_thresholds_name_a_slow_first_call_and_copy(monkeypatch):
    monkeypatch.setattr(doctor_cmd, 'k1_probe', lambda report, degraded, device: 200.0)
    monkeypatch.setattr(doctor_cmd, 'copy_probe', lambda report, mb, device: 0.1)
    rc, out = port_cmd(['--device', 'cpu', '--json'])
    report = _report(out)
    assert rc == 1 and report['backend'] == 'degraded-both'
    assert [d.split(' (')[0].split(':')[0] for d in report['degraded']] == [
        'first K1 call took 200 s', 'host->device at 0.100 MB/s']
