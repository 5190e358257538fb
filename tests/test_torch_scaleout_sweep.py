"""The port's sharded sweeps (``sweep --shard-configs``, ``sweep
--device-data sharded`` and both: inferbiomechanics_tpu_torch/train/
sweep.py over ``parallel/mesh.py``'s layouts) on the CPU, with gloo ranks
(``parallel/dist.py::spawn``; ``tests/torch_dist_workers.py`` is what they
run).

- ``--shard-configs``, K = 4 on 2 ranks through the sweep command with PBT
  every eval: the per-config losses, dev curves, PBT events,
  ``sweep_results.json`` and the best and final checkpoints bitwise the
  one-process command (no collective in a step; the dev losses gathered,
  a PBT exploit between the ranks moved bit for bit); a grid saved by 2
  ranks after epoch 0 resumes bitwise in one process, and the other way
  round; K = 3 on 2 ranks keeps the configs replicated with the JAX
  warning, bitwise one process.
- ``--device-data sharded`` on 2 ranks: an epoch of the sharded sweep step
  against the JAX ``make_sweep_sharded_train_step`` on a 2-device mesh, fed
  the JAX step's shard-local selections through the epoch's ``sel`` seam:
  each config's loss within 2e-2 relative, its SGD parameter change within
  5e-2 x the largest of the JAX change (tests/test_torch_sharded_data.py's
  tolerances). The (config 2, data 2) layout on 4 ranks is bitwise that
  1-D run per config (a gloo sum of two terms does not depend on their
  order), for feedforward and the denoiser; the sweep command's 2-D log
  line is the JAX one, and its diffusion results are the 1-D command's.
- The command under ``IB_MULTIHOST=gloo torchrun --nproc-per-node 2``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from inferbiomechanics_tpu.config import Config as JaxConfig
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.parallel.mesh import make_mesh as jax_make_mesh
from inferbiomechanics_tpu.train import optimizers as jopt
from inferbiomechanics_tpu.train import sharded_data as jshd
from inferbiomechanics_tpu.train import sweep as jsweep
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu.train.loop import loss_config_from as jax_loss_config_from
from inferbiomechanics_tpu.train.state import TrainState as JaxTrainState
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.__main__ import main
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.parallel import dist
from inferbiomechanics_tpu_torch.train.sharded_data import ShardedDeviceData

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_REL = 2e-2
DELTA_REL = 5e-2
B = 16                    # the global batch; 8 windows a data shard
STEPS = 3
KW = dict(window_size=20, stride=5)
FF = dict(model_type='feedforward', hidden_dims=[32])
DIFF = dict(model_type='diffusion', output_data_format='all_frames', d_model=64, num_layers=1,
            num_heads=4, diffusion_timesteps=64)
GRID2 = [(1e-3, 0), (1e-3, 1)]


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """Small models beside other test processes: one thread throughout."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """Two train subjects of unequal trials and a dev subject."""
    root = tmp_path_factory.mktemp('torch_scaleout_sweep')
    for split, subjects in (('train', [(3, 150, 0), (2, 220, 1)]), ('dev', [(1, 120, 2)])):
        os.makedirs(root / split)
        for i, (trials, length, seed) in enumerate(subjects):
            write_synthetic_subject(str(root / split / f's{i}.b3d'), num_trials=trials,
                                    trial_length=length, seed=seed)
    return root


def _argv(root, ckpt, *more, lrs=('1e-3', '3e-4'), seeds=('0', '1'), epochs=2):
    return ['--dataset-home', str(root), '--checkpoint-dir', str(ckpt), '--device', 'cpu',
            '--history-len', '20', '--stride', '5', '--batch-size', str(B), '--hidden-dims',
            '32', '--epochs', str(epochs), '--max-batches-per-epoch', '3', '--no-wandb',
            '--lrs', *lrs, '--seeds', *seeds, *more]


def _cli(root, ckpt, *more, **kw):
    return dict(fn='sweep_cli', argv=_argv(root, ckpt, *more, **kw), ckpt=str(ckpt))


def _results(ckpt, model='feedforward'):
    with open(os.path.join(ckpt, 'sweep', model, 'sweep_results.json')) as f:
        out = json.load(f)
    strip = lambda p: p and {k: v for k, v in p.items() if not k.endswith('path')}  # noqa: E731
    return dict(points=[strip(p) for p in out['points']], best=strip(out['best']),
                pbt_events=out['pbt_events'])


def _point_files(ckpt, model='feedforward'):
    """Every point's checkpoints under ``ckpt``, by relative path."""
    base = os.path.join(ckpt, 'sweep', model, 'base')
    return {os.path.relpath(os.path.join(d, f), base): os.path.join(d, f)
            for d, _, fs in os.walk(base) for f in fs
            if f.endswith('.torch.pt') and '_grid' not in d}


def _assert_same_checkpoints(a, b):
    """Every checkpoint of the points under ``b`` (best and final) is under
    ``a`` too, bitwise (a resumed sweep also keeps its first part's final
    checkpoints)."""
    fa, fb = _point_files(a), _point_files(b)
    assert fb and set(fb) <= set(fa)
    for name in fb:
        pa, pb = (torch.load(f, weights_only=True) for f in (fa[name], fb[name]))
        assert (pa['epoch'], pa['step']) == (pb['epoch'], pb['step']), name
        for k, v in pa['model_state_dict'].items():
            assert torch.equal(v, pb['model_state_dict'][k]), (name, k)
        for i, st in pa['optimizer_state_dict']['state'].items():
            for k, v in st.items():
                assert torch.equal(v, pb['optimizer_state_dict']['state'][i][k]), (name, i, k)


# -- the JAX sharded sweep step ---------------------------------------------------


def _jax_sharded_sweep(root, tmp):
    """The JAX sharded sweep step over GRID2 (SGD) on a 2-device mesh for
    STEPS steps, from each seed's flax init; the port's weights of each seed
    saved under ``tmp``. Returns the JAX side and the selections it drew
    [2 shards, STEPS, B / 2]."""
    jds = JaxWindowDataset(str(root / 'train'), skip_loading_skeletons=True, **KW)
    jcfg = JaxConfig()
    for k, v in dict(KW, batch_size=B, opt_type='sgd', **FF).items():
        setattr(jcfg, k, v)
    jm = jax_build(jcfg, jds)
    sample = jnp.asarray(jds.gather(np.arange(4)).inputs)
    trees = {s: jax.device_get(jm.init({'params': jax.random.PRNGKey(s)}, sample,
                                       train=False)['params']) for _, s in GRID2}
    cfg = Config()
    for k, v in dict(KW, **FF).items():
        setattr(cfg, k, v)
    fam = weights.model_family(build_model_for_dataset(cfg, WindowDataset(
        str(root / 'train'), skip_loading_skeletons=True, **KW)))
    files = {}
    for s, tree in trees.items():
        files[s] = str(tmp / f'seed{s}.pt')
        torch.save(weights.params_from_jax(fam, tree), files[s])
    params = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[trees[s] for _, s in GRID2])
    tx = jopt.make_optimizer('sgd', 1.0)
    jstate = JaxTrainState(step=jnp.zeros((2,), jnp.int32), params=params,
                           opt_state=jax.vmap(tx.init)(params), batch_stats={}, tx=tx,
                           apply_fn=jm.apply)
    jdata = jshd.ShardedDeviceData(jds, jax_make_mesh(n_devices=2))
    step = jsweep.make_sweep_sharded_train_step(jm, tx, jdata, jax_loss_config_from(jcfg),
                                                [lr for lr, _ in GRID2], B, donate=False)
    cnt = np.asarray(jax.device_get(jdata.win_count))
    losses, sel = [], []
    for i in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(7), i)
        rng_s, _ = jax.random.split(key)
        sel.append([np.asarray(jax.random.randint(jax.random.fold_in(rng_s, s), (1, B // 2), 0,
                                                  int(cnt[s]), dtype=jnp.int32))[0]
                    for s in range(2)])
        jstate, m = step(jstate, key)
        losses.append(np.asarray(m['loss']))
    return dict(trees=trees, files=files, params=jax.device_get(jstate.params), losses=losses,
                fam=fam), np.asarray(sel).transpose(1, 0, 2)


@pytest.fixture(scope='module')
def runs(root, tmp_path_factory):
    """The one-process runs, one spawn of 2 ranks and one of 4, then the
    one-process halves of the resumes."""
    tmp = tmp_path_factory.mktemp('torch_scaleout_sweep_runs')
    out = {'dirs': {}}

    def d(name):
        out['dirs'][name] = str(tmp / name)
        return tmp / name

    jax_side, sel = _jax_sharded_sweep(root, tmp)
    out['jax'] = jax_side
    diff_ds = WindowDataset(str(root / 'train'), skip_loading_skeletons=True,
                            output_data_format='all_frames', **KW)
    cnt = ShardedDeviceData(diff_ds, 0, 2, 'cpu').win_count
    rng = np.random.default_rng(5)
    diff_sel = np.stack([rng.integers(0, cnt[s], (STEPS, B // 2)) for s in range(2)])
    epoch = dict(fn='sweep_epoch', data=str(root / 'train'), ds=KW, grid=GRID2)
    ff_epoch = dict(epoch, cfg=dict(KW, batch_size=B, opt_type='sgd', **FF), sel=sel,
                    weights=jax_side['files'])
    diff_epoch = dict(epoch, ds=dict(KW, output_data_format='all_frames'), sel=diff_sel,
                      cfg=dict(KW, batch_size=B, opt_type='sgd', **DIFF))
    diff_cli = ['--model-type', 'diffusion', '--output-data-format', 'all_frames',
                '--d-model', '64', '--num-layers', '1', '--num-heads', '4',
                '--diffusion-timesteps', '64', '--device-data', 'sharded']

    # one process: the reference runs, and the first half of a resume
    for name, more, kw in (('one_pbt', ['--shard-configs', '--pbt-every', '1'], {}),
                           ('one_whole', [], {}), ('one_k3', [], dict(lrs=('1e-3', '3e-4', '1e-4'),
                                                                      seeds=('0',), epochs=1))):
        assert main(['sweep', *_argv(root, d(name), *more, **kw)]) == 0
    assert main(['sweep', *_argv(root, d('resume_12'), '--shard-configs', epochs=1)]) == 0
    two = [_cli(root, d('two_pbt'), '--shard-configs', '--pbt-every', '1'),
           _cli(root, d('resume_21'), '--shard-configs', epochs=1),
           _cli(root, tmp / 'resume_12', '--shard-configs'),
           _cli(root, d('two_k3'), '--shard-configs', lrs=('1e-3', '3e-4', '1e-4'), seeds=('0',),
                epochs=1),
           dict(ff_epoch, shard=False), dict(diff_epoch, shard=False),
           _cli(root, d('two_diff'), *diff_cli, seeds=('0', '1'), lrs=('1e-3',), epochs=1),
           dict(fn='exploit', data=str(root / 'train'), ds=KW, cfg=dict(KW, **FF),
                grid=[(1e-3, s) for s in range(4)], src=[0, 2], dst=[3, 1])]
    ranks2 = dist.spawn(W.run_jobs, 2, two, init_file=str(tmp / 'rdv2'), timeout_s=300)
    four = [dict(ff_epoch, shard=True), dict(diff_epoch, shard=True),
            _cli(root, d('four_diff'), *diff_cli, '--shard-configs', seeds=('0', '1'),
                 lrs=('1e-3',), epochs=1)]
    ranks4 = dist.spawn(W.run_jobs, 4, four, init_file=str(tmp / 'rdv4'), timeout_s=300)
    # the second half of the 2-rank resume, in one process
    assert main(['sweep', *_argv(root, tmp / 'resume_21')]) == 0
    names2 = ['pbt', 'resume_21', 'resume_12', 'k3', 'ff_epoch', 'diff_epoch', 'diff_cli',
              'exploit']
    out['two'] = {n: [r[i] for r in ranks2] for i, n in enumerate(names2)}
    out['four'] = {n: [r[i] for r in ranks4]
                   for i, n in enumerate(['ff_epoch', 'diff_epoch', 'diff_cli'])}
    return out


def test_shard_configs_on_two_ranks_is_bitwise_one_process_with_pbt(runs):
    r0, r1 = runs['two']['pbt']
    assert r0['rc'] == r1['rc'] == 0
    assert 'sweep configs sharded 2-way across the mesh' in r0['log']
    assert any(line.startswith('PBT at epoch 0') for line in r0['log'])
    # the step holds no collective: each rank runs its two configs in chunks
    for r in (r0, r1):
        assert any(line.startswith('sweep chunked dispatch:') and
                   line.endswith(', 2 configs a step') for line in r['log']), r['log']
    got, want = _results(runs['dirs']['two_pbt']), _results(runs['dirs']['one_pbt'])
    assert got == want and len(got['pbt_events']) == 1
    _assert_same_checkpoints(runs['dirs']['two_pbt'], runs['dirs']['one_pbt'])


def test_an_exploit_between_ranks_moves_the_state_bit_for_bit(runs):
    """K = 4 on 2 ranks (configs 0, 1 on rank 0; 2, 3 on rank 1): config 3
    takes config 0's parameters and optimizer state, config 1 config 2's,
    each across the ranks; the winners stay as they were."""
    r0, r1 = runs['two']['exploit']
    assert sorted(r0['before']) == [0, 1] and sorted(r1['before']) == [2, 3]
    pairs = ((r0['before'][0], r1['after'][3]), (r1['before'][2], r0['after'][1]),
             (r0['before'][0], r0['after'][0]), (r1['before'][2], r1['after'][2]))
    for want, got in pairs:
        assert len(want) == len(got) and all(np.array_equal(a, b) for a, b in zip(want, got))
    assert not np.array_equal(r1['before'][3][0], r1['after'][3][0])


def test_a_grid_resumes_across_world_sizes(runs):
    """Epoch 0 on 2 ranks, epoch 1 in one process; and the other way round:
    both bitwise the uninterrupted one-process sweep."""
    assert all(r['rc'] == 0 for r in runs['two']['resume_21'] + runs['two']['resume_12'])
    want = _results(runs['dirs']['one_whole'])
    for name in ('resume_21', 'resume_12'):
        assert _results(runs['dirs'][name]) == want, name
        _assert_same_checkpoints(runs['dirs'][name], runs['dirs']['one_whole'])


def test_k3_on_two_ranks_stays_replicated_with_the_jax_warning(runs):
    r0, r1 = runs['two']['k3']
    for r in (r0, r1):
        assert r['rc'] == 0
        assert ('--shard-configs: 3 configs do not divide the 2-device data axis; configs '
                'stay replicated') in r['log']
    assert _results(runs['dirs']['two_k3']) == _results(runs['dirs']['one_k3'])


def test_sharded_data_sweep_tracks_the_jax_sharded_sweep_step(runs):
    jax_side = runs['jax']
    r0, r1 = runs['two']['ff_epoch']
    assert r0['placement'] == (1, 0, 2, 0) and r1['placement'] == (1, 0, 2, 1)
    for i in range(len(GRID2)):
        for k, v in r0['states'][i].items():
            assert np.array_equal(v, r1['states'][i][k]), (i, k)
    for row, want in zip(r0['rows'], jax_side['losses']):
        np.testing.assert_allclose(row['loss'], want, rtol=LOSS_REL)
    for i, (_, seed) in enumerate(GRID2):
        now = weights.params_to_jax(jax_side['fam'], {
            k: torch.from_numpy(v) for k, v in r0['states'][i].items()})
        flat_now = dict(jax.tree_util.tree_flatten_with_path(now)[0])
        flat_b = dict(jax.tree_util.tree_flatten_with_path(jax_side['trees'][seed])[0])
        for path, stacked in jax.tree_util.tree_flatten_with_path(jax_side['params'])[0]:
            before = np.asarray(flat_b[path], np.float64)
            dj = np.asarray(stacked[i], np.float64) - before
            dt = np.asarray(flat_now[path], np.float64) - before
            np.testing.assert_allclose(dt, dj, rtol=0, atol=DELTA_REL * np.abs(dj).max() + 1e-9,
                                       err_msg=f'config {i} {jax.tree_util.keystr(path)}')


@pytest.mark.parametrize('name', ['ff_epoch', 'diff_epoch'])
def test_the_2d_layout_is_bitwise_the_1d_run_per_config(runs, name):
    """(config 2, data 2) on 4 ranks: rank r holds config r // 2 on data
    shard r % 2, and each config's parameters and losses are the 1-D run's
    (configs replicated on 2 data ranks)."""
    one_d = runs['two'][name][0]
    for r, got in enumerate(runs['four'][name]):
        assert got['placement'] == (2, r // 2, 2, r % 2)
        (i, state), = got['states'].items()
        assert i == r // 2
        for k, v in state.items():
            assert np.array_equal(v, one_d['states'][i][k]), (name, r, k)
        for row, want in zip(got['rows'], one_d['rows']):
            assert np.array_equal(row['loss'], want['loss'][i:i + 1]), (name, r)


def test_the_2d_command_logs_the_jax_line_and_matches_the_1d_command(runs):
    for r in runs['four']['diff_cli']:
        assert r['rc'] == 0
        assert 'sweep 2-D mesh: 2-way config x 2-way data sharding' in r['log']
    assert all(r['rc'] == 0 for r in runs['two']['diff_cli'])
    got = _results(runs['dirs']['four_diff'], 'diffusion')
    assert got == _results(runs['dirs']['two_diff'], 'diffusion')
    assert all(np.isfinite(p['final_train_loss']) for p in got['points'])


def test_sweep_command_under_torchrun(root, tmp_path):
    """``IB_MULTIHOST=gloo torchrun --nproc-per-node 2 -m
    inferbiomechanics_tpu_torch sweep ... --shard-configs``: rank 0 writes
    the results, those of the command in one process."""
    env = dict(os.environ, IB_MULTIHOST='gloo', PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    argv = _argv(root, tmp_path / 'run', '--shard-configs', seeds=('0',), epochs=1)
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone', '--nproc-per-node',
           '2', '-m', 'inferbiomechanics_tpu_torch', 'sweep', *argv]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=240,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert 'process group: 2 ranks, backend gloo' in proc.stdout
    assert proc.stdout.count('sweep winner: lr=') == 2
    assert main(['sweep', *_argv(root, tmp_path / 'one', seeds=('0',), epochs=1)]) == 0
    assert _results(tmp_path / 'run') == _results(tmp_path / 'one')
