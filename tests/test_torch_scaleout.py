"""The port's model parallelism (``--model-parallel`` in both training loops,
inferbiomechanics_tpu_torch/parallel/mesh.py, and the library
``parallel/sharding_rules.py``) on the CPU.

- Rank layouts against the JAX ``make_mesh`` / ``make_sweep_mesh``
  coordinates and axis groups for n = 1, 2, 4, 8 (no process group).
- ``train`` and ``train_diffusion`` on gloo ranks (``parallel/dist.py::
  spawn``; ``tests/torch_dist_workers.py`` is what they run): 2 ranks at
  ``--model-parallel 2`` are bitwise each other and bitwise one process at
  the same batch; 4 ranks at ``--model-parallel 2`` are bitwise 2 ranks
  without it (the same global batch), each ``model`` pair equal, for the
  feedforward model with batchnorm, the ``pallas`` transformer with
  ``--augment-noise-std`` and the denoiser with EMA. The JAX loops
  replicate the state on the mesh and split the batch over ``data`` only,
  so these are exact equalities.
- ``sharding_rules`` against the JAX ``shard_params_for_mesh`` on a (data 4,
  model 2) mesh of CPU devices for every family: the same leaves split, and
  rank j's slices (parameters and adam moments) equal the JAX leaf's shard
  at ``model`` j, exactly; ``gather_state(shard_state(s))`` is bitwise s on
  2 ranks (mp 2) and on 4 (data 2 x model 2).

Sizes: window 20 / stride 5; feedforward 64 x 48; the transformers d_model
128, one layer, 4 heads; the denoiser d_model 64; B = 8 windows a rank.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import torch_dist_workers as W
from inferbiomechanics_tpu.config import Config as JaxConfig
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.parallel import mesh as jmesh
from inferbiomechanics_tpu.parallel.sharding_rules import shard_params_for_mesh
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from inferbiomechanics_tpu.train.state import TrainState as JaxTrainState
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.parallel import dist, mesh
from inferbiomechanics_tpu_torch.parallel import sharding_rules as sr
from inferbiomechanics_tpu_torch.train.loop import train
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
from inferbiomechanics_tpu_torch.train.state import create_train_state

B = 8
KW = dict(window_size=20, stride=5)
DIFF = dict(model_type='diffusion', output_data_format='all_frames', d_model=64, num_layers=1,
            num_heads=4, diffusion_timesteps=64)
LOOPS = {
    'batchnorm': dict(model_type='feedforward', hidden_dims=[64, 48], batchnorm=True),
    'pallas_noise': dict(model_type='transformer', attn_impl='pallas', d_model=128,
                         num_layers=1, num_heads=4, augment_noise_std=0.05),
    'diffusion_ema': dict(DIFF, ema_decay=0.9),
}
FAMILIES = {
    'feedforward': dict(model_type='feedforward', hidden_dims=[64, 48]),
    'vpu': dict(model_type='transformer', d_model=128, num_layers=1, num_heads=4),
    'pallas': dict(model_type='transformer', attn_impl='pallas', d_model=128, num_layers=1,
                   num_heads=4),
    'groundlink': dict(model_type='groundlink'),
    'diffusion': DIFF,
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
    """Two train subjects of unequal trials and a dev subject."""
    root = tmp_path_factory.mktemp('torch_scaleout')
    for split, subjects in (('train', [(3, 150, 0), (2, 220, 1)]), ('dev', [(1, 120, 2)])):
        os.makedirs(root / split)
        for i, (trials, length, seed) in enumerate(subjects):
            write_synthetic_subject(str(root / split / f's{i}.b3d'), num_trials=trials,
                                    trial_length=length, seed=seed)
    return root


# -- rank layouts ------------------------------------------------------------------


def _port_layouts(monkeypatch, n, make):
    """Every rank's layout of a world of ``n`` (groups without process
    groups: only their ranks are read)."""
    monkeypatch.setattr(dist, 'world_size', lambda: n)
    monkeypatch.setattr(dist, 'subgroup', lambda ranks: dist.Group(tuple(ranks)))
    out = []
    for r in range(n):
        monkeypatch.setattr(dist, 'rank', lambda r=r: r)
        out.append(make())
    return out


def _jax_coords(m, r):
    """Device r's coordinates in JAX mesh ``m`` and, for each axis, the
    devices (by index) that share its other coordinate, in the axis's
    order."""
    ids = np.vectorize(lambda d: d.id)(m.devices)
    pos = tuple(int(i) for i in np.argwhere(ids == jax.devices()[r].id)[0])
    index = {d.id: i for i, d in enumerate(jax.devices())}
    along = (tuple(index[i] for i in ids[:, pos[1]]), tuple(index[i] for i in ids[pos[0], :]))
    return pos, along


@pytest.mark.parametrize('n', [1, 2, 4, 8])
def test_layouts_are_the_jax_mesh_coordinates(monkeypatch, n):
    devices = jax.devices()[:n]
    cases = [(mp, lambda mp=mp: mesh.make_mesh(model_parallel=mp),
              jmesh.make_mesh(model_parallel=mp, devices=devices))
             for mp in range(1, n + 1) if n % mp == 0]
    cases += [(k, lambda k=k: mesh.make_sweep_mesh(k), jmesh.make_sweep_mesh(k, devices=devices))
              for k in (1, 2, 3, 4, 6, 8)]
    for what, make, jm in cases:
        layouts = _port_layouts(monkeypatch, n, make)
        for r, lay in enumerate(layouts):
            pos, along = _jax_coords(jm, r)
            assert lay.axes == tuple(jm.axis_names) and lay.shape == tuple(jm.devices.shape)
            assert tuple(lay.coord(a) for a in lay.axes) == pos, (n, what, r)
            assert lay.rank_at(dict(zip(lay.axes, pos))) == r, (n, what, r)
            assert tuple(lay.group(a).ranks for a in lay.axes) == along, (n, what, r)
    with pytest.raises(ValueError, match=f'{n} devices not divisible by model_parallel={n + 1}'):
        _port_layouts(monkeypatch, n, lambda: mesh.make_mesh(model_parallel=n + 1))


def test_one_process_is_a_world_of_one_device(root, tmp_path):
    """Without a process group: rank 0 of 1, every axis the whole world;
    ``--model-parallel`` with ``--pipeline-parallel`` keeps the JAX
    refusal."""
    lay = mesh.make_mesh()
    assert (lay.shape, lay.coord(mesh.DATA_AXIS), lay.groups) == ((1, 1), 0, (None, None))
    cfg = Config()
    for k, v in dict(KW, dataset_home=str(root), checkpoint_dir=str(tmp_path / 'c'),
                     batch_size=B, model_type='transformer', pipeline_parallel=2,
                     model_parallel=2).items():
        setattr(cfg, k, v)
    ds = WindowDataset(str(root / 'train'), skip_loading_skeletons=True, **KW)
    with pytest.raises(ValueError, match='--pipeline-parallel and --model-parallel are '
                                         'mutually exclusive mesh layouts'):
        train(cfg, ds, None, device='cpu')


# -- --model-parallel in both loops --------------------------------------------------


@pytest.fixture(scope='module')
def mp_runs(root, tmp_path_factory):
    """Each loop config of LOOPS trained for one epoch: in one process; on 2
    ranks at --model-parallel 2 and without it; on 4 ranks at
    --model-parallel 2; and the sharding-rules gather on each world."""
    tmp = tmp_path_factory.mktemp('torch_scaleout_runs')

    def job(name, tag, mp):
        fields = LOOPS[name]
        ds = dict(KW, output_data_format=fields.get('output_data_format', 'last_frame'))
        cfg = dict(KW, batch_size=B, epochs=1, seed=4, model_parallel=mp,
                   checkpoint_dir=str(tmp / tag / name), **fields)
        return dict(data=str(root), ds=ds, fn='state_loop', dev=True, cfg=cfg)

    gather = dict(fn='shard_gather', data=str(root / 'train'), ds=KW,
                  cfgs=[dict(KW, **f) for f in FAMILIES.values()])
    two = [job(n, 'two_mp2', 2) for n in LOOPS] + [job(n, 'two_mp1', 1) for n in LOOPS]
    two.append(dict(gather, mp=2))
    ranks2 = dist.spawn(W.run_jobs, 2, two, init_file=str(tmp / 'rdv2'), timeout_s=300)
    four = [job(n, 'four_mp2', 2) for n in LOOPS] + [dict(gather, mp=2)]
    ranks4 = dist.spawn(W.run_jobs, 4, four, init_file=str(tmp / 'rdv4'), timeout_s=300)
    one = W.run_jobs([job(n, 'one', 1) for n in LOOPS])
    n = len(LOOPS)
    return dict(
        one=dict(zip(LOOPS, one)),
        two_mp2={name: [r[i] for r in ranks2] for i, name in enumerate(LOOPS)},
        two_mp1={name: [r[n + i] for r in ranks2] for i, name in enumerate(LOOPS)},
        four_mp2={name: [r[i] for r in ranks4] for i, name in enumerate(LOOPS)},
        gather={2: [r[2 * n] for r in ranks2], 4: [r[n] for r in ranks4]})


def _assert_same_state(a, b, what):
    assert 'error' not in a and 'error' not in b, (a.get('error'), b.get('error'))
    for key in ('state', 'ema'):
        assert (key in a) == (key in b), (what, key)
        if key in a:
            assert a[key].keys() == b[key].keys()
            for k, v in a[key].items():
                assert np.array_equal(v, b[key][k]), (what, key, k)
    assert a['final_dev'] == b['final_dev'] and a['final_train'] == b['final_train'], what


@pytest.mark.parametrize('name', list(LOOPS))
def test_n_equal_mp_ranks_are_bitwise_one_process(mp_runs, name):
    """World 2 at --model-parallel 2: one ``data`` row of two replicas, each
    bitwise the other and one process at the same batch (no collective in
    the step); rank 0 alone writes."""
    r0, r1 = mp_runs['two_mp2'][name]
    _assert_same_state(r0, r1, f'{name} rank 1')
    _assert_same_state(r0, mp_runs['one'][name], f'{name} one process')
    assert r0['epochs_run'] == 1 and r1['writes'] == [] and r0['writes']


@pytest.mark.parametrize('name', list(LOOPS))
def test_four_ranks_at_mp2_are_bitwise_two_ranks_without_it(mp_runs, name):
    """World 4 at --model-parallel 2 is (data 2, model 2): each ``data``
    group {0, 2}, {1, 3} reduces as world 2 without --model-parallel does, so
    every rank is bitwise world 2's ranks (BatchNorm statistics, the noise
    scale and the draws over the ``data`` group)."""
    four, two = mp_runs['four_mp2'][name], mp_runs['two_mp1'][name]
    _assert_same_state(two[0], two[1], f'{name} world 2')
    for r, got in enumerate(four):
        _assert_same_state(got, two[0], f'{name} world 4 rank {r}')
    assert all(r['writes'] == [] for r in four[1:]) and four[0]['writes']
    # the batch was split: world 2's ranks differ from one process
    if name != 'diffusion_ema':
        assert any(not np.array_equal(v, mp_runs['one'][name]['state'][k])
                   for k, v in two[0]['state'].items())


@pytest.mark.parametrize('world', [2, 4])
def test_gather_state_is_bitwise_the_state(mp_runs, world):
    for rank_out in mp_runs['gather'][world]:
        for fam, got in zip(FAMILIES, rank_out):
            assert got['equal'], (world, fam)
            assert got['nbytes'] < got['full_nbytes'] or not got['split'], (world, fam)


# -- sharding_rules against the JAX rule -----------------------------------------------


def _jax_state(root, fields):
    """A JAX model of ``fields``, its parameters (biases moved off zero) and an
    adam state whose moments are random trees."""
    fmt = fields.get('output_data_format', 'last_frame')
    jds = JaxWindowDataset(str(root / 'train'), skip_loading_skeletons=True,
                           output_data_format=fmt, **KW)
    jcfg = JaxConfig()
    for k, v in dict(KW, batch_size=B, **fields).items():
        setattr(jcfg, k, v)
    jm = jax_build(jcfg, jds)
    x = jnp.asarray(jds.gather(np.arange(4)).inputs)
    if fields['model_type'] == 'diffusion':
        params = jm.init({'params': jax.random.PRNGKey(0)},
                         jnp.zeros((4, x.shape[1], jm.target_channels)),
                         jnp.zeros((4,), jnp.int32), x)['params']
    else:
        params = jm.init({'params': jax.random.PRNGKey(0)}, x, train=False)['params']
    rng = np.random.default_rng(3)
    rand = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda p: rng.normal(size=p.shape).astype(np.float32), tree)
    params = rand(jax.device_get(params))
    tx = jax_make_optimizer('adam', 1e-3)
    opt = tx.init(params)
    opt = (opt[0]._replace(mu=rand(params), nu=rand(params)), *opt[1:])
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params, opt_state=opt,
                          batch_stats={}, tx=tx, apply_fn=jm.apply)
    cfg = Config()
    for k, v in dict(KW, **fields).items():
        setattr(cfg, k, v)
    ds = WindowDataset(str(root / 'train'), skip_loading_skeletons=True,
                       output_data_format=fmt, **KW)
    return state, build_model_for_dataset(cfg, ds)


def _shard_at(leaf, device):
    return np.asarray(next(s.data for s in leaf.addressable_shards if s.device == device))


@pytest.mark.parametrize('family', list(FAMILIES))
def test_sharding_rules_split_the_jax_leaves_into_the_jax_shards(root, family):
    jstate, model = _jax_state(root, FAMILIES[family])
    fam = weights.model_family(model)
    model.load_state_dict(weights.params_from_jax(fam, jstate.params))
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'adam', 1e-3))
    moments = {key: weights.params_from_jax(fam, getattr(jstate.opt_state[0], key))
               for key in ('mu', 'nu')}
    for n, p in model.named_parameters():
        state.optimizer.state[p] = {key: moments[key][n].clone() for key in ('mu', 'nu')}

    jm = jmesh.make_mesh(model_parallel=2, devices=jax.devices()[:8])
    sharded = shard_params_for_mesh(jm, jstate)
    leaves = sr.jax_leaves(model)
    pdims, _ = sr.split_dims(model, 2)
    specs = {tuple(str(getattr(k, 'key', k)) for k in path): leaf.sharding.spec
             for path, leaf in jax.tree_util.tree_flatten_with_path(sharded.params)[0]}
    assert {leaf.path for leaf in leaves.values()} == set(specs)
    split = {leaves[n].path for n, d in pdims.items() if d is not None}
    assert split == {p for p, s in specs.items() if s == PartitionSpec(None, 'model')}
    assert split, family
    for j in range(2):
        device = jm.devices[0, j]
        shard = sr.shard_state(state, 2, j)
        want = weights.params_from_jax(fam, jax.tree_util.tree_map(
            lambda leaf: _shard_at(leaf, device), sharded.params))
        for n, t in shard.params.items():
            assert np.array_equal(t.numpy(), want[n].numpy()), (family, j, n)
        for key in ('mu', 'nu'):
            want = weights.params_from_jax(fam, jax.tree_util.tree_map(
                lambda leaf: _shard_at(leaf, device), getattr(sharded.opt_state[0], key)))
            for n, m in shard.moments.items():
                assert np.array_equal(m[key].numpy(), want[n].numpy()), (family, j, key, n)
