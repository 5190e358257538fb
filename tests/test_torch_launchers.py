"""The port's launchers (``inferbiomechanics_tpu_torch/scripts/*.sh``) against
the JAX package's (``scripts/tpu_train.sh``, ``scripts/tpu_multihost_train.sh``,
``scripts/tpu_sweep.sh``, ``update_dataset.sh``).

Each pair runs with stub ``python``, ``torchrun`` and ``nvidia-smi`` first on
``PATH``; the stubs log their argv (and ``IB_MULTIHOST``, and the program a
``python -`` reads), and the port's argv is held to the original's with
``main.py`` read as ``-m inferbiomechanics_tpu_torch``. Then both dataset
scripts run for real with ``addb`` absent and ``PYTHONHASHSEED=0`` (the
synthetic subjects are seeded with ``hash((ds_name, i))``): the trees they
write, ``processed/``, ``train/`` and ``dev/``, are equal byte for byte.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_SCRIPTS = REPO / 'inferbiomechanics_tpu_torch' / 'scripts'
PAIRS = {
    'gpu_train.sh': REPO / 'scripts' / 'tpu_train.sh',
    'gpu_multihost_train.sh': REPO / 'scripts' / 'tpu_multihost_train.sh',
    'gpu_sweep.sh': REPO / 'scripts' / 'tpu_sweep.sh',
    'update_dataset.sh': REPO / 'update_dataset.sh',
}
MAIN, MODULE = ['main.py'], ['-m', 'inferbiomechanics_tpu_torch']

_STUB = r"""#!/usr/bin/env bash
{ printf '%s' "$(basename "$0")"; printf '\t%s' "$@"
  printf '\tIB_MULTIHOST=%s\n' "${IB_MULTIHOST:-}"; } >> "$STUB_LOG"
if [[ "$(basename "$0")" == nvidia-smi && "${1:-}" == -L ]]; then
  for ((i = 0; i < ${STUB_GPUS:-1}; i++)); do
    echo "GPU $i: NVIDIA H100 80GB HBM3 (UUID: GPU-$i)"
  done
fi
if [[ "${1:-}" == - ]]; then sed 's/^/  | /' >> "$STUB_LOG"; fi
for a in "$@"; do [[ "$a" == doctor ]] && exit "${STUB_DOCTOR_RC:-0}"; done
exit 0
"""


@pytest.fixture
def stubs(tmp_path):
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    for name in ('python', 'torchrun', 'nvidia-smi'):
        (bin_dir / name).write_text(_STUB)
        (bin_dir / name).chmod(0o755)
    return bin_dir


def _launch(script, stubs, log, args=(), **env):
    """``bash script args`` from the repo root with the stubs first on PATH;
    (exit code, stdout, the stubs' log lines)."""
    log.unlink(missing_ok=True)
    full = dict(os.environ, PATH=f'{stubs}:{os.environ["PATH"]}', STUB_LOG=str(log), **env)
    for k in ('IB_MULTIHOST', 'DATASET_HOME', 'CHECKPOINT_DIR', 'CHECKPOINT_ROOT', 'MODEL',
              'BATCH_SIZE', 'EPOCHS', 'OPT', 'LR', 'DOCTOR', 'DATA'):
        if k not in env:
            full.pop(k, None)
    proc = subprocess.run(['bash', str(script), *args], cwd=str(REPO), env=full,
                          capture_output=True, text=True, timeout=60)
    lines = log.read_text().splitlines() if log.exists() else []
    return proc.returncode, proc.stdout, lines


def _argv(line):
    return line.split('\t')


def test_every_launcher_parses():
    for port, original in PAIRS.items():
        for script in (PORT_SCRIPTS / port, original):
            proc = subprocess.run(['bash', '-n', str(script)], capture_output=True, text=True)
            assert proc.returncode == 0, (script, proc.stderr)
        assert os.access(PORT_SCRIPTS / port, os.X_OK), port


SETTINGS = [
    {},
    dict(DATASET_HOME='/d/home', CHECKPOINT_DIR='/c/dir', CHECKPOINT_ROOT='/s/root',
         MODEL='transformer', BATCH_SIZE='64', EPOCHS='2', OPT='adam', LR='3e-4'),
]


@pytest.mark.parametrize('doctor', ['', '1'])
@pytest.mark.parametrize('setting', range(len(SETTINGS)))
@pytest.mark.parametrize('port', ['gpu_train.sh', 'gpu_sweep.sh'])
def test_single_process_launchers_run_the_original_command(stubs, tmp_path, port, setting,
                                                             doctor):
    env = dict(SETTINGS[setting], **({'DOCTOR': doctor} if doctor else {}))
    args = ('--seed', '3', '--no-wandb')
    rc_o, out_o, orig = _launch(PAIRS[port], stubs, tmp_path / 'o.log', args, **env)
    rc_p, out_p, mine = _launch(PORT_SCRIPTS / port, stubs, tmp_path / 'p.log', args, **env)
    assert rc_o == rc_p == 0 and out_o == out_p
    assert len(orig) == len(mine) == (2 if doctor and port == 'gpu_train.sh' else 1)
    for o, p in zip(orig, mine):
        o, p = _argv(o), _argv(p)
        assert o[0] == p[0] == 'python'
        assert o[1:2] == MAIN and p[1:3] == MODULE
        assert p[3:] == o[2:]
    assert _argv(mine[-1])[3] == ('train' if port == 'gpu_train.sh' else 'sweep')
    assert _argv(mine[-1])[-4:] == ['--seed', '3', '--no-wandb', 'IB_MULTIHOST=']


def test_a_degraded_doctor_stops_the_launch(stubs, tmp_path):
    outs = []
    for script in (PAIRS['gpu_train.sh'], PORT_SCRIPTS / 'gpu_train.sh'):
        rc, out, lines = _launch(script, stubs, tmp_path / 'log', DOCTOR='1',
                                 STUB_DOCTOR_RC='1')
        assert rc == 1 and len(lines) == 1 and 'doctor' in lines[0]
        outs.append(out)
    assert outs[0] == outs[1] == 'backend degraded — not launching\n'


@pytest.mark.parametrize('gpus', ['1', '4'])
@pytest.mark.parametrize('setting', range(len(SETTINGS)))
def test_multihost_launcher_runs_the_original_command_under_torchrun(stubs, tmp_path, setting,
                                                                     gpus):
    env = dict(SETTINGS[setting], STUB_GPUS=gpus)
    rc_o, _, orig = _launch(PAIRS['gpu_multihost_train.sh'], stubs, tmp_path / 'o.log',
                            ('--epochs', '1'), **env)
    rc_p, _, mine = _launch(PORT_SCRIPTS / 'gpu_multihost_train.sh', stubs,
                            tmp_path / 'p.log', ('--epochs', '1'), **env)
    assert rc_o == rc_p == 0
    (o,) = orig
    nvidia, run = mine
    assert _argv(nvidia)[:2] == ['nvidia-smi', '-L']
    o, p = _argv(o), _argv(run)
    assert o[0] == 'python' and o[1:2] == MAIN and o[-1] == 'IB_MULTIHOST=1'
    assert p[0] == 'torchrun' and p[-1] == 'IB_MULTIHOST=1'
    at = p.index('-m')
    assert p[at:at + 2] == MODULE and p[at + 2:] == o[2:]
    assert p[1:at] == ['--nnodes', '1', '--node-rank', '0', '--master-addr', 'localhost',
                       '--master-port', '29500', '--nproc-per-node', gpus]
    # several nodes: the rendezvous passes through; NPROC_PER_NODE overrides the count
    _, _, mine = _launch(PORT_SCRIPTS / 'gpu_multihost_train.sh', stubs, tmp_path / 'n.log',
                         NNODES='2', NODE_RANK='1', MASTER_ADDR='10.0.0.1',
                         MASTER_PORT='6000', NPROC_PER_NODE='8')
    p = _argv(mine[-1])
    assert len(mine) == 1 and p[1:p.index('-m')] == [
        '--nnodes', '2', '--node-rank', '1', '--master-addr', '10.0.0.1', '--master-port',
        '6000', '--nproc-per-node', '8']


def test_dataset_launcher_runs_the_original_commands(stubs, tmp_path):
    rc_o, out_o, orig = _launch(PAIRS['update_dataset.sh'], stubs, tmp_path / 'o.log',
                                DATA=str(tmp_path / 'd'))
    rc_p, out_p, mine = _launch(PORT_SCRIPTS / 'update_dataset.sh', stubs, tmp_path / 'p.log',
                                DATA=str(tmp_path / 'd'))
    assert rc_o == rc_p == 0 and out_o == out_p
    assert len(orig) == len(mine) and len(orig) > 2
    # the synthetic writer's program differs in the package it imports from
    assert [line.replace('inferbiomechanics_tpu.', 'inferbiomechanics_tpu_torch.')
            for line in orig[:-1]] == mine[:-1]
    assert sum('import write_synthetic_subject' in line for line in mine) == 1
    o, p = _argv(orig[-1]), _argv(mine[-1])
    assert o[1:2] == MAIN and p[1:3] == MODULE and p[3:] == o[2:]
    assert p[3] == 'create-splits'


def _tree(root: Path):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob('*'))
            if p.is_file()}


def test_dataset_launchers_write_the_same_bytes(tmp_path):
    """Both scripts for real, ``addb`` absent, ``PYTHONHASHSEED=0``: 7
    subjects of 3 x 2000 frames under ``processed/`` and their splits."""
    assert shutil.which('addb') is None
    env = dict(os.environ, PATH=f'{Path(sys.executable).parent}:/usr/bin:/bin',
               PYTHONHASHSEED='0',
               JAX_PLATFORMS='cpu')
    trees, outs = [], []
    try:
        for name, script in (('jax', PAIRS['update_dataset.sh']),
                             ('port', PORT_SCRIPTS / 'update_dataset.sh')):
            env['DATA'] = str(tmp_path / name)
            proc = subprocess.run(['bash', str(script)], cwd=str(REPO), env=env,
                                  capture_output=True, text=True, timeout=300)
            assert proc.returncode == 0, proc.stdout + proc.stderr
            outs.append(proc.stdout.replace(str(tmp_path / name), 'DATA'))
            trees.append(_tree(tmp_path / name))
        assert outs[0] == outs[1]
        assert list(trees[0]) == list(trees[1])
        assert sum(k.startswith('processed/') for k in trees[0]) == 7
        assert {k.split('/')[0] for k in trees[0]} == {'processed', 'train', 'dev'}
        for k in trees[0]:
            assert trees[0][k] == trees[1][k], k
    finally:
        for name in ('jax', 'port'):
            shutil.rmtree(tmp_path / name, ignore_errors=True)
