"""The port's pipeline parallelism (``--pipeline-parallel``;
inferbiomechanics_tpu_torch/parallel/pipeline.py, ``make_pipeline_mesh`` in
parallel/mesh.py, the p2p of parallel/dist.py, the ``pp > 1`` branch of
train/loop.py) on the CPU, against the JAX package's
(inferbiomechanics_tpu/parallel/pipeline.py on the conftest's virtual CPU
devices) and against the port's own single-process step.

- Rank layouts against the JAX ``make_pipeline_mesh`` for n = 2, 4, 8; the
  JAX refusals with the JAX words (the loop's, ``_check``'s, the mesh's).
- The layouts of a parameter tree (``to_pipeline_params`` /
  ``to_canonical_params``) bitwise there and back, and their stacks the JAX
  layout's leaves.
- On gloo ranks (``parallel/dist.py::spawn``; ``tests/torch_dist_workers.py``
  runs them) at pipe 2 (world 2) and data 2 x pipe 2 (world 4), the
  ``vpu`` transformer at d_model 64, 4 layers, 4 heads, window 20 / stride
  5, a global batch of 16, 4 microbatches a data shard: the pipeline
  forward against JAX's ``make_pipeline_forward`` (2e-2 x max a head); one
  SGD step (lr 1e-2: the parameters' change is -lr x the gradient) against
  JAX's ``make_pipeline_train_step`` (loss within 2e-2; each parameter's
  change within 5e-2 x its largest, the suite's limit for the transformer's
  bf16 gradients) and against the port's plain step of the global batch in
  one process (the same limits); every rank of a pipeline ends with the
  same canonical state, bitwise; with ``--grad-clip-norm`` the norm spans
  the stages (the same step as the plain clipped step); ``remat`` is
  bitwise the step without it.
- ``train`` at ``--pipeline-parallel 2`` (``vpu`` and ``flax``) on 2 ranks
  against one process of the same flags without it (the same host-loader
  batches; train metrics within 2e-2, the checkpoint's parameters at 5e-2 x
  the largest change adagrad made), rank 0's canonical checkpoint loaded and
  served by one process, resume after a stop on rank 1 alone bitwise the
  uninterrupted run; on 4 ranks (data 2 x pipe 2) against 2 ranks of plain
  data parallelism (the same shards).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from inferbiomechanics_tpu.config import Config as JaxConfig
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.models.transformer import TransformerRegressor as JaxTransformer
from inferbiomechanics_tpu.parallel import pipeline as JP
from inferbiomechanics_tpu.parallel import shard_batch
from inferbiomechanics_tpu.train import make_optimizer as jax_make_optimizer
from inferbiomechanics_tpu.train.loop import loss_config_from as jax_loss_config_from
from inferbiomechanics_tpu.train.loop import train as jax_train
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.parallel import dist, mesh
from inferbiomechanics_tpu_torch.parallel import pipeline as P
from inferbiomechanics_tpu_torch.train import checkpoint as ckpt
from inferbiomechanics_tpu_torch.train.loop import check_pipeline_options, loss_config_from, train
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
from inferbiomechanics_tpu_torch.train.state import create_train_state
from inferbiomechanics_tpu_torch.train.step import make_train_step

KW = dict(window_size=20, stride=5)
TF = dict(model_type='transformer', d_model=64, num_layers=4, num_heads=4)
G, MICRO, LR = 16, 4, 1e-2
REL, GRAD_REL = 2e-2, 5e-2


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """Two train subjects and a dev subject."""
    root = tmp_path_factory.mktemp('torch_pipeline')
    for split, subjects in (('train', [(2, 150, 0), (2, 130, 1)]), ('dev', [(1, 120, 2)])):
        os.makedirs(root / split)
        for i, (trials, length, seed) in enumerate(subjects):
            write_synthetic_subject(str(root / split / f's{i}.b3d'), num_trials=trials,
                                    trial_length=length, seed=seed)
    return root


def _cfg(**fields):
    cfg = Config()
    for k, v in {**KW, **TF, **fields}.items():
        setattr(cfg, k, v)
    return cfg


def _jax_model():
    return JaxTransformer(num_dofs=23, num_contact_bodies=2, history_len=20, stride=5,
                          d_model=64, num_layers=4, num_heads=4)


@pytest.fixture(scope='module')
def setup(root):
    """The JAX model's parameters (flax init, every bias and LayerNorm row
    moved off its zeros / ones), a global batch, and the same parameters as
    the port's canonical state dict."""
    ds = WindowDataset(str(root / 'train'), skip_loading_skeletons=True, **KW)
    batch = ds.gather(np.random.default_rng(5).permutation(len(ds))[:G])
    x, y = np.asarray(batch.inputs), np.asarray(batch.labels)
    jm = _jax_model()
    params = jax.device_get(jax.jit(lambda k, xx: jm.init(k, xx, train=False)['params'])(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.1 * rng.normal(size=p.shape) if p.ndim == 1 else 0)
                   ).astype(np.float32), params)
    sd = {k: v.numpy() for k, v in weights.transformer_state_dict_from_jax(params).items()}
    return dict(ds=ds, x=x, y=y, jm=jm, params=params, sd=sd)


def _pipeline_job(root, setup, pipe, **kw):
    return {**dict(fn='pipeline_step', data=str(root / 'train'), ds=KW, cfg=dict(KW, **TF),
                   state=setup['sd'], x=setup['x'], y=setup['y'], pipe=pipe, micro=MICRO,
                   opt='sgd', lr=LR), **kw}


def _loop_job(root, tmp, tag, **fields):
    # adagrad: smooth in the gradient (RMSprop's first updates are +-10 lr
    # wherever a gradient is near 0, so two bf16 evaluations part there)
    cfg = {**KW, **TF, **dict(batch_size=8, epochs=1, seed=4, device_data='off',
                              opt_type='adagrad', learning_rate=1e-2,
                              checkpoint_every_batches=5, checkpoint_dir=str(tmp / tag)),
           **fields}
    return dict(fn='state_loop', data=str(root), ds=KW, dev=True, cfg=cfg)


@pytest.fixture(scope='module')
def runs(root, setup, tmp_path_factory):
    """Every multi-rank run of this module, in two spawns (of 2 and 4
    ranks), and their one-process references."""
    tmp = tmp_path_factory.mktemp('torch_pipeline_runs')
    loops = {'vpu': {}, 'flax': dict(attn_impl='flax')}
    two = {'step2': _pipeline_job(root, setup, 2),
           'clip2': _pipeline_job(root, setup, 2, opt='adagrad', steps=2, clip=0.5),
           'remat2': _pipeline_job(root, setup, 2, remat=True),
           **{f'loop2_{name}': _loop_job(root, tmp, f'pp2_{name}', pipeline_parallel=2, **f)
              for name, f in loops.items()},
           # a stop on rank 1 alone at its 6th step boundary, then the same
           # command; and the run uninterrupted
           'stopped': dict(_loop_job(root, tmp, 'pp2_stop', pipeline_parallel=2, epochs=2),
                           stop_after=6),
           'resumed': dict(_loop_job(root, tmp, 'pp2_stop', pipeline_parallel=2, epochs=2),
                           fn='loop'),
           'whole': _loop_job(root, tmp, 'pp2_whole', pipeline_parallel=2, epochs=2),
           'dp2': _loop_job(root, tmp, 'dp2')}
    ranks2 = dist.spawn(W.run_jobs, 2, list(two.values()), init_file=str(tmp / 'rdv2'),
                        timeout_s=300)
    four = {'step4': _pipeline_job(root, setup, 2),
            'loop4': _loop_job(root, tmp, 'pp4', pipeline_parallel=2)}
    ranks4 = dist.spawn(W.run_jobs, 4, list(four.values()), init_file=str(tmp / 'rdv4'),
                        timeout_s=300)
    out = {name: [r[i] for r in ranks2] for i, name in enumerate(two)}
    out.update({name: [r[i] for r in ranks4] for i, name in enumerate(four)})
    out['one'] = dict(zip(loops, W.run_jobs([_loop_job(root, tmp, f'one_{name}', **f)
                                             for name, f in loops.items()])))
    return out


# -- layouts and refusals ------------------------------------------------------------


def test_layouts_are_the_jax_pipeline_mesh(monkeypatch):
    for n in (2, 4, 8):
        for pipe in (p for p in (1, 2, 4, 8) if n % p == 0):
            jm = JP.make_pipeline_mesh(n_devices=n, pipe=pipe)
            ids = np.vectorize(lambda d: d.id)(jm.devices)
            index = {d.id: i for i, d in enumerate(jax.devices())}
            monkeypatch.setattr(dist, 'world_size', lambda n=n: n)
            monkeypatch.setattr(dist, 'subgroup', lambda ranks: dist.Group(tuple(ranks)))
            for r in range(n):
                monkeypatch.setattr(dist, 'rank', lambda r=r: r)
                lay = mesh.make_pipeline_mesh(pipe)
                pos = tuple(int(i) for i in np.argwhere(ids == jax.devices()[r].id)[0])
                assert lay.axes == tuple(jm.axis_names) == ('data', 'pipe')
                assert lay.shape == tuple(jm.devices.shape)
                assert (lay.coord('data'), lay.coord('pipe')) == pos, (n, pipe, r)
                along = tuple(index[i] for i in ids[pos[0], :])
                assert lay.group('pipe').ranks == along
                plan = P.StagePlan(lay, 8)
                assert plan.rank_of(plan.stage) == r
                assert list(plan.layers) == list(range(pos[1] * 8 // pipe,
                                                       (pos[1] + 1) * 8 // pipe))
    monkeypatch.undo()
    with pytest.raises(ValueError, match='1 devices not divisible by pipe=2'):
        mesh.make_pipeline_mesh(2)
    with pytest.raises(ValueError, match='1 devices not divisible by pipe=2'):
        JP.make_pipeline_mesh(n_devices=1, pipe=2)


_REFUSED = [
    dict(model_type='feedforward'),
    dict(model_parallel=2),
    dict(device_data='on'), dict(device_data='sharded'), dict(device_data='stream'),
    dict(grad_accum_steps=2),
    dict(grad_allreduce_dtype='bf16'),
    dict(dropout=True, dropout_prob=0.1),
    dict(attn_impl='pallas'),
]


@pytest.mark.parametrize('fields', _REFUSED, ids=lambda f: '-'.join(map(str, f.values())))
def test_the_loop_refuses_what_the_jax_loop_refuses_in_its_words(root, tmp_path, fields):
    base = dict(KW, **TF, batch_size=8, device_data='off', pipeline_parallel=2)
    jcfg = JaxConfig(checkpoint_dir=str(tmp_path / 'j'), **{**base, **fields})
    jds = JaxWindowDataset(str(root / 'train'), **KW)
    with pytest.raises(ValueError) as want:
        jax_train(jcfg, jds, None)
    cfg = _cfg(checkpoint_dir=str(tmp_path / 'p'), **{**base, **fields})
    with pytest.raises(ValueError) as got:
        check_pipeline_options(cfg)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        train(cfg, WindowDataset(str(root / 'train'), skip_loading_skeletons=True, **KW),
              None, device='cpu')
    assert not os.path.exists(tmp_path / 'p')


def test_check_refuses_what_the_jax_check_refuses_in_its_words(setup):
    """``_check``'s refusals on a (data 4, pipe 2) layout: 3 layers over 2
    stages, dropout, a global batch that data x microbatches does not
    divide."""
    jmesh = JP.make_pipeline_mesh(n_devices=8, pipe=2)
    plan = P.StagePlan(mesh.Layout(('data', 'pipe'), (4, 2), 0, (None, None)), 4)
    ds = setup['ds']
    cases = [(dict(num_layers=3), 16), (dict(dropout=True, dropout_prob=0.1), 16), ({}, 10)]
    for fields, batch in cases:
        cfg = _cfg(**fields)
        jm = JaxTransformer(num_dofs=23, num_contact_bodies=2, history_len=20, stride=5,
                            d_model=64, num_layers=cfg.num_layers, num_heads=4,
                            dropout=cfg.dropout_prob if cfg.dropout else 0.0)
        with pytest.raises(ValueError) as want:
            JP._check(jm, jmesh, batch, 2)
        with pytest.raises(ValueError) as got:
            P._check(build_model_for_dataset(cfg, ds), plan, batch, 2)
        assert str(got.value) == str(want.value)


def test_layouts_round_trip_and_stack_as_the_jax_layout(setup):
    named = {k: torch.from_numpy(v) for k, v in setup['sd'].items()}
    pp = P.to_pipeline_params(named, 4)
    assert set(pp['rest']) == {k for k in named if not k.startswith('blocks.')}
    back = P.to_canonical_params(pp, 4)
    assert back.keys() == named.keys()
    assert all(torch.equal(back[k], v) for k, v in named.items())
    jpp = JP.to_pipeline_params(setup['params'], 4)
    assert pp['stages']['ln1.weight'].shape == (4, 64)
    np.testing.assert_array_equal(pp['stages']['ln1.weight'].numpy(),
                                  np.asarray(jpp['stages']['LayerNorm_0']['scale']))
    np.testing.assert_array_equal(
        pp['stages']['mlp2.weight'].numpy(),
        np.swapaxes(np.asarray(jpp['stages']['Dense_1']['kernel']), 1, 2))
    np.testing.assert_array_equal(pp['rest']['input_proj.weight'].numpy(),
                                  np.asarray(jpp['rest']['Dense_0']['kernel']).T)


# -- the step against JAX and against one process ---------------------------------------


def _jax_step(setup, n_devices):
    """JAX's pipeline forward and one SGD step on ``n_devices`` virtual
    devices at pipe 2: (outputs, loss, the new canonical parameters by the
    port's names)."""
    jm, params = setup['jm'], setup['params']
    jmesh = JP.make_pipeline_mesh(n_devices=n_devices, pipe=2)
    n_dp = n_devices // 2
    pp = JP.shard_pipeline_params(jmesh, JP.to_pipeline_params(params, 4))
    out = JP.make_pipeline_forward(jm, jmesh, num_microbatches=MICRO)(
        pp, shard_batch(jmesh, setup['x']))
    tx = jax_make_optimizer('sgd', LR)
    state = JP.create_pipeline_state(jm, jax.random.PRNGKey(0), jnp.asarray(setup['x']), tx,
                                     jmesh)
    state = state.replace(params=pp, opt_state=tx.init(pp))
    step = JP.make_pipeline_train_step(jm, setup['ds'].lab_offsets,
                                       jax_loss_config_from(JaxConfig(**KW, **TF)), jmesh,
                                       num_microbatches=MICRO, donate=False)
    xs, ys = shard_batch(jmesh, setup['x'], setup['y'])
    state, metrics = step(state, xs, ys, jax.random.PRNGKey(1))
    new = weights.transformer_state_dict_from_jax(
        jax.device_get(JP.to_canonical_params(state.params, 4)))
    return ({k: np.asarray(v) for k, v in out.items()}, float(metrics['loss']),
            {k: v.numpy() for k, v in new.items()})


def _plain_step(setup):
    """The port's plain step of the global batch in one process."""
    cfg = _cfg()
    model = build_model_for_dataset(cfg, setup['ds'])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in setup['sd'].items()})
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'sgd', LR))
    step = make_train_step(model, setup['ds'].lab_offsets, loss_config_from(cfg))
    m = step(state, torch.from_numpy(setup['x']), torch.from_numpy(setup['y']))
    return float(m['loss']), {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _assert_same_change(got, want, start, what):
    """Each parameter's change from ``start`` within 5e-2 x its largest."""
    for k, w in want.items():
        dw, dg = w - start[k], got[k] - start[k]
        np.testing.assert_allclose(dg, dw, rtol=0, atol=GRAD_REL * np.abs(dw).max() + 1e-9,
                                   err_msg=f'{what} {k}')


@pytest.mark.parametrize('world', [2, 4])
def test_the_pipeline_step_is_the_jax_step_and_the_plain_step(runs, setup, world):
    ranks = runs[f'step{world}']
    out, loss, new = _jax_step(setup, world)
    n_dp = world // 2
    b = G // n_dp
    for r, res in enumerate(ranks):
        d = r // 2
        for k, want in out.items():
            np.testing.assert_allclose(res['out'][k], want[d * b:(d + 1) * b], rtol=0,
                                       atol=REL * np.abs(want).max(), err_msg=f'rank {r} {k}')
        assert float(res['metrics'][0]['loss']) == pytest.approx(loss, rel=REL), r
        _assert_same_change(res['state'], new, setup['sd'], f'rank {r} vs JAX')
        # every rank ends with the whole canonical state, the same bitwise
        for k, v in ranks[0]['state'].items():
            assert np.array_equal(res['state'][k], v), (r, k)
        # stage s sent its M activations (and received M gradients) over p2p
        assert res['p2p']['calls'] > 0 and res['p2p']['bytes'] > 0
    plain_loss, plain = _plain_step(setup)
    assert float(ranks[0]['metrics'][0]['loss']) == pytest.approx(plain_loss, rel=REL)
    _assert_same_change(ranks[0]['state'], plain, setup['sd'], 'vs the plain step')


def test_clipping_spans_the_stages_and_remat_changes_nothing(runs, setup):
    """Two adagrad steps (lr 1e-2, smooth in the gradient) with
    --grad-clip-norm 0.5 (the norm is above it: the clip binds) against the
    plain clipped steps in one process: each parameter's change within 5e-2
    x its largest, the moments gathered with the parameters within 0.1 x
    their largest (squares of bf16 gradients); remat bitwise the stage
    without it."""
    cfg = _cfg()
    model = build_model_for_dataset(cfg, setup['ds'])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in setup['sd'].items()})
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'adagrad', LR,
                                                     grad_clip_norm=0.5))
    step = make_train_step(model, setup['ds'].lab_offsets, loss_config_from(cfg))
    for _ in range(2):
        m = step(state, torch.from_numpy(setup['x']), torch.from_numpy(setup['y']))
        norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()
                                                     if p.grad is not None]))
        assert float(norm) > 2 * 0.5       # the clip binds
    want = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    sums = {n: state.optimizer.state[p]['sum'].numpy() for n, p in model.named_parameters()
            if p in state.optimizer.state}
    for res in runs['clip2']:
        assert float(res['metrics'][-1]['loss']) == pytest.approx(float(m['loss']), rel=REL)
        _assert_same_change(res['state'], want, setup['sd'], 'clipped')
        for n, v in sums.items():         # 0.1 + the sum of the clipped squares
            np.testing.assert_allclose(res['moments'][n]['sum'] - 0.1, v - 0.1, rtol=0,
                                       atol=0.1 * np.abs(v - 0.1).max() + 1e-9, err_msg=n)
    for a, b in zip(runs['remat2'], runs['step2']):
        assert all(np.array_equal(a['state'][k], v) for k, v in b['state'].items())


# -- train --pipeline-parallel -------------------------------------------------------


def _close_runs(a, b, what):
    for key in ('final_train', 'final_dev'):
        assert a[key].keys() == b[key].keys(), what
        for k, v in b[key].items():
            assert a[key][k] == pytest.approx(v, rel=REL), (what, key, k)


@pytest.mark.parametrize('name', ['vpu', 'flax'])
def test_train_at_pipe_2_is_one_process_and_writes_canonical_checkpoints(runs, root, name):
    ranks, one = runs[f'loop2_{name}'], runs['one'][name]
    for res in ranks:
        assert 'error' not in res, res.get('error')
        _close_runs(res, one, name)
        # both ranks gathered the same whole state
        assert all(np.array_equal(res['state'][k], v) for k, v in ranks[0]['state'].items())
    assert [w[0] for w in ranks[0]['writes']][:1] == ['sidecar'] and not ranks[1]['writes']
    assert ranks[0]['files'] == one['files']
    # the parameters: within 5e-2 of the largest change adagrad made
    start = build_model_for_dataset(_cfg(attn_impl=name, seed=4), WindowDataset(
        str(root / 'train'), skip_loading_skeletons=True, **KW),
        generator=torch.Generator().manual_seed(4)).state_dict()
    for k, v in one['state'].items():
        if k.endswith('attn.key.bias'):
            continue    # its exact gradient is 0: it moves by rounding noise alone
        moved = np.abs(v - start[k].numpy()).max()
        np.testing.assert_allclose(ranks[0]['state'][k], v, rtol=0,
                                   atol=GRAD_REL * moved + 1e-7, err_msg=k)
    # rank 0's checkpoint is canonical: one process loads it and serves it
    d = ranks[0]['ckpt_dir']
    cfg = _cfg(attn_impl=name, checkpoint_dir=d)
    ds = WindowDataset(str(root / 'train'), skip_loading_skeletons=True, **KW)
    model, epoch, _ = ckpt.load_model(cfg, ds, d, device='cpu')     # as serve loads it
    assert epoch == 0
    with torch.no_grad():
        out = model(torch.from_numpy(np.asarray(ds.gather(np.arange(4)).inputs)))
    assert all(torch.isfinite(v).all() for v in out.values())
    # the end of the epoch's file is the state both ranks gathered
    assert ckpt.load_checkpoint_file(model, os.path.join(d, 'epoch_0_batch_0.torch.pt')) == (0, 0)
    for k, v in model.state_dict().items():
        assert np.array_equal(v.numpy(), ranks[1]['state'][k]), k
    payload = torch.load(ckpt.list_checkpoints(d)[-1][2], weights_only=True)
    assert len(payload['optimizer_state_dict']['state']) == len(list(model.parameters()))


def test_resume_at_pipe_2_is_bitwise_the_uninterrupted_run(runs):
    stopped, resumed, whole = runs['stopped'], runs['resumed'], runs['whole']
    assert all(r['preempted'] for r in stopped)
    assert all(not r['preempted'] and r['epochs_run'] == 2 for r in resumed)
    assert resumed[0]['files'] == whole[0]['files']
    for name in whole[0]['files']:
        if name.endswith('.torch.pt'):
            got, want = (torch.load(os.path.join(r[0]['ckpt_dir'], name), weights_only=True)
                         for r in (resumed, whole))
            assert got['step'] == want['step'], name
            for key in ('model_state_dict', 'optimizer_state_dict'):
                assert _flat_tensors(got[key]) == _flat_tensors(want[key]), (name, key)


def _flat_tensors(tree):
    """A nested payload's tensors as bytes by path (bitwise comparison)."""
    if isinstance(tree, torch.Tensor):
        return tree.numpy().tobytes()
    if isinstance(tree, dict):
        return {k: _flat_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flat_tensors(v) for v in tree]
    return tree


def test_train_at_data_2_pipe_2_is_two_data_parallel_ranks(runs):
    """4 ranks, (data 2, pipe 2), against 2 ranks of plain data parallelism
    of the same flags: the same shards, the same global batch."""
    four, dp = runs['loop4'], runs['dp2']
    for res in four:
        assert 'error' not in res, res.get('error')
        _close_runs(res, dp[0], 'data 2 x pipe 2')
        assert all(np.array_equal(res['state'][k], v) for k, v in four[0]['state'].items())
    for k, v in dp[0]['state'].items():
        np.testing.assert_allclose(four[0]['state'][k], v, rtol=0,
                                   atol=GRAD_REL * np.abs(v).max() + 1e-7, err_msg=k)
