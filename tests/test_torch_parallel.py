"""The port's data parallelism over processes (inferbiomechanics_tpu_torch/
parallel/dist.py, the all-reduce in train/step.py, the synced BatchNorm
statistics, the global batch's draws, both training loops at world size 2)
on the CPU: ranks are processes of this machine on gloo
(``parallel/dist.py::spawn``; ``tests/torch_dist_workers.py`` is what they
run), against the JAX package on the global batch.

A JAX process with one device is one rank. At world size 2 each rank takes B
rows of a global batch of 2B; the JAX step runs on the two ranks' rows
concatenated (rank 0's, then rank 1's), which is the array
``make_array_from_process_local_data`` assembles. Dropout masks are the JAX
step's own (recorded at each flax ``Dropout``) and each rank is fed its rows
of them. Sizes: window 20 / stride 5, feedforward 64 x 48, a ``pallas``
transformer of d_model 128, 1 layer, 4 heads; B = 8 a rank.

Tolerances: the models compute in bf16, so the JAX comparisons use
tests/test_torch_train.py's bf16 limits: each step's loss within 2e-2
relative, the parameters' change over the steps within 5e-2 x its largest
magnitude (SGD, so that the change is linear in the gradients), running
statistics within 5e-2 x max. The port at world size 2 against the port in
one process on the global batch differs only where a bf16 weight gradient
is rounded over B rather than 2B rows: within 2e-2 x max. The collectives'
own float32 results (synced batch statistics, the global standard
deviation, averaged metrics) are held at rtol 1e-5 / atol 1e-6. The ranks'
parameters are bitwise equal, and a world of one rank is bitwise the step
without a process group.
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
from flax import linen as flax_nn

import torch_dist_workers as W
from inferbiomechanics_tpu.config import Config as JaxConfig
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.parallel.mesh import make_mesh
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu.train.loop import loss_config_from as jax_loss_config_from
from inferbiomechanics_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from inferbiomechanics_tpu.train.state import TrainState as JaxTrainState
from inferbiomechanics_tpu.train.step import make_train_step as jax_make_train_step
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.__main__ import main
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.parallel import dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_REL = 2e-2
DELTA_REL = 5e-2
WORLD_REL = 2e-2
F32 = dict(rtol=1e-5, atol=1e-6)
B = 8                   # windows a rank
STEPS = 2
LR = 1e-3
KW = dict(window_size=20, stride=5)
FAMILIES = {
    'feedforward': dict(model_type='feedforward', hidden_dims=[64, 48]),
    'groundlink': dict(model_type='groundlink'),
    'pallas': dict(model_type='transformer', attn_impl='pallas', d_model=128, num_layers=1,
                   num_heads=4),
    'batchnorm': dict(model_type='feedforward', hidden_dims=[64, 48], batchnorm=True),
    'dropout': dict(model_type='feedforward', hidden_dims=[64, 48], dropout=True,
                    dropout_prob=0.1),
}


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """Small models beside other test processes: one thread throughout."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """Two train subjects of unequal trials (3 x 150 and 2 x 220 frames) and
    a dev subject."""
    root = tmp_path_factory.mktemp('torch_parallel')
    for split, subjects in (('train', [(3, 150, 0), (2, 220, 1)]), ('dev', [(1, 120, 2)])):
        os.makedirs(root / split)
        for i, (trials, length, seed) in enumerate(subjects):
            write_synthetic_subject(str(root / split / f's{i}.b3d'), num_trials=trials,
                                    trial_length=length, seed=seed)
    return root


def _cfg(fields, **more):
    return {**dict(window_size=20, stride=5, batch_size=2 * B, opt_type='sgd',
                   learning_rate=LR), **fields, **more}


def _jax_masks(jm, variables, x, key):
    """The keep masks of ``jm``'s dropout sites in call order, as flax's
    ``Dropout`` draws them (tests/test_torch_batchnorm_dropout.py)."""
    masks = []

    def record(next_fun, args, kwargs, context):
        module = context.module
        if not isinstance(module, flax_nn.Dropout) or context.method_name != '__call__':
            return next_fun(*args, **kwargs)
        inputs = args[0]
        deterministic = flax_nn.merge_param('deterministic', module.deterministic,
                                            kwargs.get('deterministic'))
        if module.rate == 0.0 or deterministic:
            return inputs
        keep_prob = 1.0 - module.rate
        keep = jax.random.bernoulli(module.make_rng(module.rng_collection), keep_prob,
                                    inputs.shape)
        masks.append(keep)
        return jnp.where(keep, inputs / keep_prob, jnp.zeros_like(inputs))

    with flax_nn.intercept_methods(record):
        jm.apply(variables, jnp.asarray(x), train=True, rngs={'dropout': key},
                 mutable=['batch_stats'])
    return [np.asarray(m) for m in masks]


def _global_batches(root, seed=0):
    ds = WindowDataset(str(root / 'train'), skip_loading_skeletons=True, **KW)
    idx = np.random.default_rng(seed).permutation(len(ds))[:STEPS * 2 * B]
    batches = [ds.gather(i) for i in idx.reshape(STEPS, 2 * B)]
    return (np.stack([b.inputs for b in batches]), np.stack([b.labels for b in batches]))


def _jax_run(root, fields, inputs, labels, sd_path, grad_accum=1, lowp=False):
    """The JAX model of ``fields`` (flax init, biases moved off zero), its
    weights saved for the port at ``sd_path``, then STEPS SGD steps of the
    JAX train step on the global batches; returns (params before, state
    after, per-step metrics, per-step masks, family, batch_stats after)."""
    jds = JaxWindowDataset(str(root / 'train'), skip_loading_skeletons=True, **KW)
    jcfg = JaxConfig()
    for k, v in _cfg(fields, grad_accum_steps=grad_accum).items():
        setattr(jcfg, k, v)
    jm = jax_build(jcfg, jds)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(inputs[0, :4]), train=False))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.05 * rng.normal(size=p.shape) if p.ndim == 1 else 0)
                   ).astype(np.float32), v['params'])
    stats = v.get('batch_stats', {})
    model = build_model_for_dataset(Config(**_cfg(fields)), WindowDataset(
        str(root / 'train'), skip_loading_skeletons=True, **KW))
    family = weights.model_family(model)
    torch.save(weights.state_dict_from_jax(family, params, stats or None), sd_path)
    tx = jax_make_optimizer('sgd', LR)
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                          opt_state=tx.init(params), batch_stats=stats, tx=tx,
                          apply_fn=jm.apply)
    kw = dict(grad_allreduce_dtype=jnp.bfloat16, mesh=make_mesh(n_devices=2)) if lowp else {}
    lc = jax_loss_config_from(jcfg)
    step = jax_make_train_step(jm, jds.lab_offsets, lc, donate=False, grad_accum=grad_accum,
                               **kw)
    start = state
    metrics, masks = [], []
    for k in range(STEPS):
        key = jax.random.PRNGKey(100 + k)
        variables = {'params': state.params, **({'batch_stats': state.batch_stats}
                                                 if state.batch_stats else {})}
        masks.append(_jax_masks(jm, variables, inputs[k], key) if fields.get('dropout') or
                     fields['model_type'] == 'groundlink' else [])
        state, m = step(state, jnp.asarray(inputs[k]), jnp.asarray(labels[k]), key)
        metrics.append(jax.device_get(m))
    exact = None
    if fields.get('batchnorm'):
        # a BatchNorm's bf16 gradients are ill-conditioned (its backward
        # cancels most of its cotangents): the same steps in float32 are the
        # reference both bf16 evaluations are held to
        f32 = jm.clone(compute_dtype=jnp.float32)
        exact = start.replace(apply_fn=f32.apply)
        f32_step = jax_make_train_step(f32, jds.lab_offsets, lc, donate=False)
        for k in range(STEPS):
            exact, _ = f32_step(exact, jnp.asarray(inputs[k]), jnp.asarray(labels[k]),
                                jax.random.PRNGKey(100 + k))
        exact = jax.device_get(exact)
    return params, jax.device_get(state), metrics, masks, family, exact


def _assert_delta_close(family, got_sd, before, jax_after, rel=DELTA_REL, msg='',
                        exact=None):
    """The port's parameter change against the JAX package's, tensor by
    tensor, within ``rel`` x the JAX change's largest magnitude; with
    ``exact`` (the float32 model's parameters after the same steps) both
    are held to its change instead, the port's within ``rel``, or within
    twice the JAX package's own distance where that is larger
    (tests/test_torch_batchnorm_dropout.py::_near_exact)."""
    now = weights.params_to_jax(family, {k: torch.from_numpy(v) for k, v in got_sd.items()
                                         if not k.endswith(('running_mean', 'running_var'))})
    flat_now = dict(jax.tree_util.tree_flatten_with_path(now)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(before)[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jax_after)[0])
    assert set(flat_now) == set(flat_j)
    flat_x = dict(jax.tree_util.tree_flatten_with_path(exact)[0]) if exact else None
    for path, want in flat_j.items():
        dj = np.asarray(want, np.float64) - np.asarray(flat_b[path], np.float64)
        dt = np.asarray(flat_now[path], np.float64) - np.asarray(flat_b[path], np.float64)
        limit = rel
        if flat_x is not None:
            dx = np.asarray(flat_x[path], np.float64) - np.asarray(flat_b[path], np.float64)
            limit = max(rel, 2 * np.abs(dj - dx).max() / np.abs(dx).max())
            dj = dx
        np.testing.assert_allclose(dt, dj, rtol=0, atol=limit * np.abs(dj).max() + 1e-9,
                                   err_msg=f'{msg} {jax.tree_util.keystr(path)}')


def _assert_world_close(got, want, before, rel=WORLD_REL):
    """Two port runs' parameter changes (state dicts) within ``rel`` x max."""
    assert got.keys() == want.keys()
    for k in want:
        dw = want[k].astype(np.float64) - before.get(k, 0)
        dg = got[k].astype(np.float64) - before.get(k, 0)
        np.testing.assert_allclose(dg, dw, rtol=0, atol=rel * np.abs(dw).max() + 1e-9,
                                   err_msg=k)


@pytest.fixture(scope='module')
def runs(root, tmp_path_factory):
    """Every world-2 job of this module in one spawn of two ranks, the same
    jobs in one process without a process group, and the step jobs in a
    world of one rank."""
    tmp = tmp_path_factory.mktemp('torch_parallel_runs')
    inputs, labels = _global_batches(root)
    data = dict(data=str(root / 'train'), ds=KW)
    jobs, jax_side = {}, {}
    for name, fields in FAMILIES.items():
        sd = str(tmp / f'{name}.pt')
        jax_side[name] = _jax_run(root, fields, inputs, labels, sd)
        jobs[name] = dict(data, fn='steps', cfg=_cfg(fields), sd=sd, inputs=inputs,
                          labels=labels, masks=jax_side[name][3] if any(
                              jax_side[name][3]) else None)
    # --grad-allreduce-dtype bf16 against lowp_allreduce_grads on 2 devices
    sd = str(tmp / 'lowp.pt')
    jax_side['lowp'] = _jax_run(root, FAMILIES['feedforward'], inputs, labels, sd, lowp=True)
    jobs['lowp'] = dict(data, fn='steps', cfg=_cfg(FAMILIES['feedforward']), sd=sd,
                        inputs=inputs, labels=labels, lowp=True)
    # --grad-accum-steps 2: rank r's microbatch k holds its rows k B/2 ..; the
    # JAX batch is laid out so that its microbatch k is the ranks' microbatch
    # k (rank 0's half, then rank 1's)
    mb = B // 2
    order = np.concatenate([np.arange(r * B + k * mb, r * B + (k + 1) * mb)
                            for k in range(2) for r in range(2)])
    sd = str(tmp / 'accum.pt')
    jax_side['accum'] = _jax_run(root, FAMILIES['feedforward'], inputs[:, order],
                                 labels[:, order], sd, grad_accum=2)
    jobs['accum'] = dict(data, fn='steps', cfg=_cfg(FAMILIES['feedforward'],
                                                    grad_accum_steps=2),
                         sd=sd, inputs=inputs, labels=labels)
    # the per-step generators: dropout and augmentation draws of the global batch
    jobs['draws'] = dict(data, fn='steps', generators=True, inputs=inputs, labels=labels,
                         cfg=_cfg(FAMILIES['dropout'], augment_mirror=True,
                                  augment_noise_std=0.05, seed=3))
    jobs['collectives'] = dict(fn='collectives')
    names = list(jobs)
    world2 = dict(zip(names, zip(*dist.spawn(W.run_jobs, 2, [jobs[n] for n in names],
                                             init_file=str(tmp / 'rdv2')))))
    one = dict(zip(names, W.run_jobs([jobs[n] for n in names])))
    steps_only = [n for n in names if jobs[n]['fn'] == 'steps']
    world1 = dict(zip(steps_only, dist.spawn(W.run_jobs, 1, [jobs[n] for n in steps_only],
                                             init_file=str(tmp / 'rdv1'))[0]))
    before = {n: {k: v.numpy().astype(np.float64) for k, v in torch.load(
        jobs[n]['sd'], weights_only=True).items()} for n in names if jobs[n].get('sd')}
    return dict(world2=world2, one=one, world1=world1, jax=jax_side, before=before,
                inputs=inputs, labels=labels)


def _assert_ranks_equal(pair):
    a, b = pair
    assert a['state'].keys() == b['state'].keys()
    for k in a['state']:
        assert np.array_equal(a['state'][k], b['state'][k]), k
    for ma, mb in zip(a['metrics'], b['metrics']):
        for k in ma:
            assert np.array_equal(ma[k], mb[k]), k


@pytest.mark.parametrize('name', list(FAMILIES))
def test_world2_step_matches_jax_on_the_global_batch(runs, name):
    params, jstate, jmetrics, _, family, exact = runs['jax'][name]
    r0, r1 = runs['world2'][name]
    _assert_ranks_equal((r0, r1))
    for k, (m, jm) in enumerate(zip(r0['metrics'], jmetrics)):
        assert set(m) == set(jm)
        assert float(m['loss']) == pytest.approx(float(jm['loss']), rel=LOSS_REL), k
    _assert_delta_close(family, r0['state'], params, jstate.params,
                        exact=exact.params if exact is not None else None)
    if name == 'batchnorm':
        got = dict(jax.tree_util.tree_flatten_with_path(weights.feedforward_batch_stats_to_jax(
            {k: torch.from_numpy(v) for k, v in r0['state'].items()}))[0])
        want = dict(jax.tree_util.tree_flatten_with_path(jstate.batch_stats)[0])
        assert got.keys() == want.keys()
        for path, s in want.items():
            s = np.asarray(s)
            np.testing.assert_allclose(got[path], s, rtol=0, atol=5e-2 * np.abs(s).max(),
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('name', list(FAMILIES) + ['draws'])
def test_world2_is_one_process_on_the_global_batch(runs, name):
    """World 2 at B a rank against the port in one process at 2B on the same
    rows (``draws``: the state's own generators, whose masks, mirror coins and
    noise at world 2 are the global batch's rows, and the Augmenter's noise
    scale the global batch's)."""
    r0, r1 = runs['world2'][name]
    _assert_ranks_equal((r0, r1))
    one = runs['one'][name]
    if name == 'batchnorm':
        # both held to the float32 model's change, world 2 within 2e-2 x max
        # or twice the one process's distance from it (bf16 BatchNorm
        # gradients, as in the JAX comparison)
        params, _, _, _, family, exact = runs['jax'][name]
        one_tree = weights.params_to_jax(family, {
            k: torch.from_numpy(v) for k, v in one['state'].items()
            if not k.endswith(('running_mean', 'running_var'))})
        _assert_delta_close(family, r0['state'], params, one_tree, rel=WORLD_REL,
                            exact=exact.params)
    else:
        _assert_world_close(r0['state'], one['state'], runs['before'].get(name) or {})
    for m, mo in zip(r0['metrics'], one['metrics']):
        assert float(m['loss']) == pytest.approx(float(mo['loss']), rel=WORLD_REL)


@pytest.mark.parametrize('name', list(FAMILIES) + ['lowp', 'accum', 'draws'])
def test_world1_is_bitwise_the_step_without_a_process_group(runs, name):
    got, want = runs['world1'][name], runs['one'][name]
    for k in want['state']:
        assert np.array_equal(got['state'][k], want['state'][k]), k
    for m, mo in zip(got['metrics'], want['metrics']):
        for k in mo:
            assert np.array_equal(m[k], mo[k]), k


def test_bf16_allreduce_matches_the_jax_lowp_allreduce(runs):
    """``--grad-allreduce-dtype bf16`` at world 2 against JAX's
    ``lowp_allreduce_grads`` (a bf16 psum over a 2-device mesh, then / 2)
    on the same global batch, at 2e-2."""
    params, jstate, jmetrics, _, family, _ = runs['jax']['lowp']
    r0, r1 = runs['world2']['lowp']
    _assert_ranks_equal((r0, r1))
    for m, jm in zip(r0['metrics'], jmetrics):
        assert float(m['loss']) == pytest.approx(float(jm['loss']), rel=LOSS_REL)
    _assert_delta_close(family, r0['state'], params, jstate.params, rel=2e-2)
    # the bf16 sum moved the gradients off the float32 reduction's
    f32 = runs['world2']['feedforward'][0]['state']
    assert any(not np.array_equal(f32[k], r0['state'][k]) for k in f32)


def test_grad_accumulation_with_the_allreduce(runs):
    """``--grad-accum-steps 2`` at world 2: each rank accumulates its two
    microbatches, then one all-reduce; against JAX's accumulating step on the
    global batch whose microbatches are the ranks' together."""
    params, jstate, jmetrics, _, family, _ = runs['jax']['accum']
    r0, r1 = runs['world2']['accum']
    _assert_ranks_equal((r0, r1))
    for m, jm in zip(r0['metrics'], jmetrics):
        assert float(m['loss']) == pytest.approx(float(jm['loss']), rel=LOSS_REL)
    _assert_delta_close(family, r0['state'], params, jstate.params)


def test_collectives_over_the_global_batch(runs):
    """BatchNorm statistics, the Augmenter's noise scale and averaged
    metrics of the two ranks' rows equal those of the rows together (float32,
    rtol 1e-5); a flag raised on one rank reaches both; the sum over the
    ranks differentiates to the sum of the cotangents."""
    r0, r1 = runs['world2']['collectives']
    one = runs['one']['collectives']       # the same rows in one process
    for got in (r0, r1):
        for k in ('mean', 'var', 'std', 'metric'):
            np.testing.assert_allclose(got[k], one[k], err_msg=k, **F32)
        assert got['flags'] == [False, True, True]
        np.testing.assert_allclose(got['grad'], one['grad'] * 2, err_msg='grad', **F32)


@pytest.fixture(scope='module')
def loop_runs(root, tmp_path_factory):
    """``train()`` at world 2 on both data-parallel tiers that need no
    shards (the device-resident tier and the host loader): uninterrupted,
    stopped after epoch 0 and resumed, and stopped by rank 1 alone mid-epoch
    and resumed; then the refused stream tier."""
    tmp = tmp_path_factory.mktemp('torch_parallel_loops')
    base = dict(data=str(root), ds=KW, fn='loop', dev=True)
    jobs = []
    for tier in ('on', 'off'):
        cfg = _cfg(FAMILIES['feedforward'], opt_type='rmsprop', epochs=2, device_data=tier,
                   keep_best=True, checkpoint_every_batches=4, seed=5)
        for run, fields in (('full', {}), ('first', dict(epochs=1)), ('resumed', {}),
                            ('stopped', {}), ('after_stop', {})):
            d = str(tmp / tier / ('full' if run == 'full' else 'resume' if run in (
                'first', 'resumed') else 'stop'))
            job = dict(base, cfg=dict(cfg, checkpoint_dir=d, **fields), run=run, tier=tier)
            if run == 'stopped':
                job['stop_after'] = 2
            jobs.append(job)
    jobs.append(dict(base, cfg=_cfg(FAMILIES['feedforward'], device_data='stream',
                                    checkpoint_dir=str(tmp / 'stream')), run='stream',
                     tier='stream'))
    ranks = dist.spawn(W.run_jobs, 2, jobs, init_file=str(tmp / 'rdv'), timeout_s=240)
    return {(j['tier'], j['run']): (ranks[0][i], ranks[1][i]) for i, j in enumerate(jobs)}


def _final(d):
    return torch.load(os.path.join(d, 'epoch_1_batch_0.torch.pt'), weights_only=True)


@pytest.mark.parametrize('tier', ['on', 'off'])
def test_train_at_world2_writes_from_rank0_and_resumes_bitwise(loop_runs, tier):
    r0, r1 = loop_runs[(tier, 'full')]
    assert r0['epochs_run'] == r1['epochs_run'] == 2
    assert r0['final_dev'] == r1['final_dev'] and 'loss' in r0['final_dev']
    assert ('sidecar',) in r0['writes'] and r1['writes'] == []
    assert [w for w in r0['writes'] if w[0] == 'ckpt' and w[3] == 'best.torch.pt']
    assert 'run_config.json' in r0['files'] and 'epoch_1_batch_0.torch.pt' in r0['files']
    # stopped after epoch 0, then the same command: bitwise the uninterrupted
    # run (the resumed run starts from epoch 0's last mid-epoch checkpoint)
    assert loop_runs[(tier, 'first')][0]['epochs_run'] == 1
    assert 'epoch_1_batch_0.torch.pt' in loop_runs[(tier, 'resumed')][0]['files']
    full = _final(os.path.join(os.path.dirname(r0['ckpt_dir']), 'full'))
    for run in ('resume', 'stop'):
        got = _final(os.path.join(os.path.dirname(r0['ckpt_dir']), run))
        assert got['epoch'] == full['epoch'] and got['step'] == full['step'], run
        for k, v in full['model_state_dict'].items():
            assert torch.equal(got['model_state_dict'][k], v), (run, k)


@pytest.mark.parametrize('tier', ['on', 'off'])
def test_a_stop_on_one_rank_stops_both_at_one_boundary(loop_runs, tier):
    r0, r1 = loop_runs[(tier, 'stopped')]
    assert r0['preempted'] and r1['preempted'] and r0['epochs_run'] == r1['epochs_run'] == 0
    stops = [w for w in r0['writes'] if w[0] == 'ckpt' and w[2] > 0]
    assert stops and stops[-1][1:3] == (0, 1) and r1['writes'] == []
    assert loop_runs[(tier, 'after_stop')][0]['epochs_run'] == 2


def test_stream_is_refused_under_several_processes(loop_runs):
    for r in loop_runs[('stream', 'stream')]:
        assert 'single-controller SPMD' in r['error']
        assert '--device-data stream is single-controller SPMD' in r['error']


def test_model_parallel_and_shard_configs_stay_refused_by_name(root, tmp_path):
    """Ported: ``--model-parallel 2`` in one process meets the JAX package's
    refusal of a world of one device; ``sweep --shard-configs`` and ``sweep
    --device-data sharded`` run in one process, the first's results those of
    the plain sweep (configs sharded 1-way)."""
    args = ['--dataset-home', str(root), '--device', 'cpu', '--history-len', '20',
            '--stride', '5', '--batch-size', '16']
    with pytest.raises(ValueError, match='1 devices not divisible by model_parallel=2'):
        main(['train', *args, '--checkpoint-dir', str(tmp_path / 't'), '--model-parallel', '2',
              '--no-wandb', '--geometry-folder', str(tmp_path)])
    assert not os.path.exists(tmp_path / 't')
    sweep_args = [*args, '--lrs', '1e-3', '3e-4', '--seeds', '0', '--hidden-dims', '32',
                  '--epochs', '1', '--max-batches-per-epoch', '2', '--no-wandb']
    results = {}
    for name, more in (('plain', []), ('shard', ['--shard-configs']),
                       ('sharded', ['--device-data', 'sharded'])):
        assert main(['sweep', *sweep_args, '--checkpoint-dir', str(tmp_path / name), *more]) == 0
        with open(tmp_path / name / 'sweep' / 'feedforward' / 'sweep_results.json') as f:
            results[name] = json.load(f)['points']
    strip = lambda pts: [{k: v for k, v in p.items() if not k.endswith('path')}  # noqa: E731
                         for p in pts]
    assert strip(results['shard']) == strip(results['plain'])
    assert len(results['sharded']) == 2 and all(
        np.isfinite(p['final_train_loss']) for p in results['sharded'])


def test_start_from_env_names_the_backend_and_the_device():
    """torchrun's environment on the CPU: gloo by default, NCCL refused for a
    CPU device, gloo named by ``IB_MULTIHOST``; the CUDA mapping is the
    chip's (chip_smoke.py)."""
    env = dict(IB_MULTIHOST='1', RANK='0', WORLD_SIZE='1')
    assert dist.default_backend('cpu') == 'gloo' and dist.default_backend('cuda') == 'nccl'
    with pytest.raises(ValueError, match='NCCL needs a CUDA device'):
        dist.start_from_env('cpu', dict(env, IB_MULTIHOST='nccl'))
    assert not dist.is_initialized()


def test_train_command_under_torchrun(root, tmp_path):
    """The user's command: ``IB_MULTIHOST=1 torchrun --nproc-per-node 2 -m
    inferbiomechanics_tpu_torch train ... --device cpu`` (gloo). Rank 0
    alone logs the run (wandb is not installed here: one JSONL file)."""
    env = dict(os.environ, IB_MULTIHOST='1', PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone', '--nproc-per-node',
           '2', '-m', 'inferbiomechanics_tpu_torch', 'train', '--dataset-home', str(root),
           '--checkpoint-dir', str(tmp_path), '--device', 'cpu', '--history-len', '20',
           '--stride', '5', '--batch-size', '16', '--hidden-dims', '32', '--epochs', '1',
           '--geometry-folder', str(tmp_path)]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=240,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert 'process group: 2 ranks, backend gloo' in proc.stdout
    assert proc.stdout.count('Training done: 1 epochs') == 2
    d = tmp_path / 'feedforward'
    assert (d / 'run_config.json').exists() and (d / 'epoch_0_batch_0.torch.pt').exists()
    logs = list((tmp_path / 'outputs' / 'logs').iterdir())
    assert len(logs) == 1 and '"train/loss"' in logs[0].read_text()
