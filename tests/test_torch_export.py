"""The port's ``export`` command (inferbiomechanics_tpu_torch/cli/export_cmd.py)
and its custom operators (ops/library.py) against the JAX package's ``export``
(inferbiomechanics_tpu/cli/export_cmd.py), in this process on the CPU.

Each model family's weights come from a seeded flax init with the biases
(and a batchnorm model's running statistics) moved off their defaults; the
JAX package reads them from its own checkpoint, the port from a ``.torch.pt``
of the same weights converted by ``weights.py`` in the same directory. The
program that ``export --device cpu`` writes, loaded back with
``torch.export.load``, is held:

- bitwise to the port's eager eval forward on the same inputs, at B = 1, 3
  and 7 (the batch is symbolic): on the CPU the operators run the kernels'
  plain versions, the same ops as the eager forward;
- to the JAX model's ``apply`` at B = 7 within 2e-2 x the output's largest value (bf16
  compute on both sides, as tests/test_torch_compat.py holds the forwards;
  GroundLink within 5e-2 x the largest value of its 30-wide head vector, the
  JAX suite's own GroundLink tolerance, as tests/test_torch_analyze.py holds it),
  and the int8 program to the JAX quantized forward at rtol 1e-5 / atol 1e-6
  (tests/test_torch_quant.py's tolerance);
- its sidecar to the JAX command's for the same flags, field by field, with
  ``torch_version`` and ``artifact_bytes`` in place of ``jax_version`` and
  ``stablehlo_bytes``.

The diffusion chain (2 DDIM steps, guidance 1 and 2, ``--static-batch 2``)
draws from ``models/diffusion.py::seeded_noise``, which the JAX package's
threefry stream cannot match: its program is held bitwise to the port's
eager chain fed the same source, the same seed twice bitwise, another seed
different. Small sizes: window 20 / stride 5 (4 frames x 177 channels),
hidden 32 and 48, d_model 32 with 2 layers and 4 heads, GroundLink at its
default widths.
"""

import argparse
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.cli.export_cmd import ExportCommand
from inferbiomechanics_tpu.config import add_config_flags as jax_add_config_flags
from inferbiomechanics_tpu.config import config_from_args as jax_config_from_args
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu.ops import quant as jq
from inferbiomechanics_tpu.train import create_train_state, make_optimizer
from inferbiomechanics_tpu.train.checkpoint import save_checkpoint as jax_save
from inferbiomechanics_tpu.train.loop import build_model_for_dataset as jax_build
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.__main__ import build_parser, main
from inferbiomechanics_tpu_torch.cli.export_cmd import eval_forward
from inferbiomechanics_tpu_torch.config import config_from_args
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.models import diffusion
from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg
from inferbiomechanics_tpu_torch.ops import fused_mlp as fm
from inferbiomechanics_tpu_torch.ops import library
from inferbiomechanics_tpu_torch.ops.quant import quantized_feedforward_forward
from inferbiomechanics_tpu_torch.train.checkpoint import load_model, save_checkpoint
from inferbiomechanics_tpu_torch.train.loop import build_model_for_dataset

BASE = ['--history-len', '20', '--hidden-dims', '32', '48']
SMALL_TF = ['--d-model', '32', '--num-layers', '2', '--num-heads', '4']
# case -> (flags, converter, ib_torch operators in the program)
CASES = {
    'feedforward': ([], weights.feedforward_state_dict_from_jax, {'fused_mlp': 1}),
    'batchnorm': (['--batchnorm'], weights.feedforward_state_dict_from_jax, {'fused_mlp': 1}),
    'pallas': (['--model-type', 'transformer', '--attn-impl', 'pallas', *SMALL_TF],
               weights.transformer_pallas_state_dict_from_jax, {'fused_encoder_layer': 2}),
    'vpu': (['--model-type', 'transformer', *SMALL_TF],
            weights.transformer_state_dict_from_jax, {}),
    'groundlink': (['--model-type', 'groundlink'], weights.groundlink_state_dict_from_jax,
                   {'fused_groundlink': 1}),
    'int8': (['--quantize', 'int8'], weights.feedforward_state_dict_from_jax, {}),
}
BF16_REL = 2e-2
GL_REL = 5e-2
TOL = dict(rtol=1e-5, atol=1e-6)
DIFF = ['--model-type', 'diffusion', '--output-data-format', 'all_frames', '--d-model', '32',
        '--num-layers', '1', '--num-heads', '4', '--diffusion-timesteps', '16',
        '--sample-steps', '2', '--static-batch', '2']
# the sidecar keys the two packages name differently, or the port alone has
JAX_ONLY = {'jax_version', 'stablehlo_bytes'}
PORT_ONLY = {'torch_version', 'artifact_bytes', 'requires_import', 'device'}


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_export')
    os.makedirs(root / 'data' / 'dev')
    write_synthetic_subject(str(root / 'data' / 'dev' / 's0.b3d'), num_trials=1,
                            trial_length=80, seed=0)
    kw = dict(window_size=20, stride=5, skip_loading_skeletons=True)
    return dict(root=root, data=str(root / 'data'),
                ds=WindowDataset(str(root / 'data' / 'dev'), **kw),
                jds=JaxWindowDataset(str(root / 'data' / 'dev'), **kw))


def _argv(data, case_dir, flags, out):
    return ['export', '--dataset-home', data['data'], '--checkpoint-dir', str(case_dir),
            *BASE, *flags, '--out', str(out)]


def _jax_config(argv):
    parser = argparse.ArgumentParser(allow_abbrev=False)
    jax_add_config_flags(parser)
    known, _ = parser.parse_known_args(argv[1:])
    return jax_config_from_args(known)


def _run_jax(argv) -> str:
    parser = argparse.ArgumentParser()
    ExportCommand().register_subcommand(parser.add_subparsers(dest='command'))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert ExportCommand().run(parser.parse_args(argv))
    return out.getvalue()


def _run_port(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv + ['--device', 'cpu']) == 0
    return out.getvalue()


def _write_pair(data, case_dir, flags, converter, seed=0):
    """Seeded flax weights as a JAX checkpoint and, converted, as the port's,
    in one directory; returns the JAX model and its variables."""
    argv = _argv(data, case_dir, flags, 'x')
    jcfg = _jax_config(argv)
    jmodel = jax_build(jcfg, data['jds'])
    state = create_train_state(jmodel, jax.random.PRNGKey(seed),
                               jnp.asarray(data['jds'].gather(np.arange(4)).inputs),
                               make_optimizer(jcfg.opt_type, jcfg.learning_rate))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.1 * rng.normal(size=p.shape) if p.ndim == 1 else 0)
                   ).astype(np.float32), jax.device_get(state.params))
    stats = jax.tree_util.tree_map(
        lambda s: (np.asarray(s) + 0.2 * np.abs(rng.normal(size=s.shape))).astype(np.float32),
        jax.device_get(state.batch_stats)) if state.batch_stats else {}
    state = state.replace(params=params, batch_stats=stats)
    ckpt = str(case_dir / jcfg.model_type)
    jax_save(ckpt, state, 1, 3)
    cfg = config_from_args(build_parser().parse_args(argv))
    model = build_model_for_dataset(cfg, data['ds'])
    model.load_state_dict(converter(params, stats) if stats else converter(params))
    save_checkpoint(ckpt, model, 1, 3)
    variables = {'params': params, **({'batch_stats': stats} if stats else {})}
    return jmodel, variables, cfg, ckpt


def _ops(program):
    counts = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if name.startswith(f'{library.NAMESPACE}.'):
            op = name.split('.')[1]
            counts[op] = counts.get(op, 0) + 1
    return counts


def _sidecars(path, jax_path):
    port, jx = (json.load(open(str(p) + '.json')) for p in (path, jax_path))
    assert set(port) - PORT_ONLY == set(jx) - JAX_ONLY
    assert port['artifact_bytes'] == os.path.getsize(path)
    assert port['requires_import'] == 'inferbiomechanics_tpu_torch.ops.library'
    assert port['torch_version'] == torch.__version__ and port['device'] == 'cpu'
    return ({k: v for k, v in port.items() if k not in PORT_ONLY},
            {k: v for k, v in jx.items() if k not in JAX_ONLY})


@pytest.mark.parametrize('case', list(CASES))
def test_loaded_program_is_the_eager_forward_and_near_jax(data, tmp_path, case):
    flags, converter, ops = CASES[case]
    jmodel, variables, cfg, ckpt = _write_pair(data, tmp_path, flags, converter)
    out = tmp_path / f'{case}.pt2'
    counts = (fm.launches, fe.launches, fg.launches)
    printed = _run_port(_argv(data, tmp_path, flags, out))
    assert f'-> {out}' in printed and 'symbolic batch' in printed
    assert 'WARNING: no checkpoint' not in printed
    program = torch.export.load(str(out))
    assert _ops(program) == ops
    model, _, _ = load_model(cfg, data['ds'], ckpt, device='cpu')
    eager = quantized_feedforward_forward(model) if case == 'int8' else model
    if case == 'int8':
        jfwd = jax.jit(jq.quantized_feedforward_forward(jmodel, variables['params']))
    else:
        jfwd = jax.jit(lambda x: jmodel.apply(variables, x, train=False))
    if case == 'groundlink':
        # the JAX suite's GroundLink tolerance, on the whole 30-wide head
        # vector, of which each output is a slice (tests/test_torch_analyze.py)
        limit = lambda j, all_heads: GL_REL * max(  # noqa: E731
            float(np.abs(np.asarray(v)).max()) for v in all_heads.values())
    else:
        limit = lambda j, all_heads: BF16_REL * max(float(np.abs(j).max()), 1e-6)  # noqa: E731
    for b in (1, 3, 7):
        x = data['ds'].gather(np.arange(b)).inputs
        with torch.no_grad():
            got = program.module()(torch.from_numpy(x))
            want = eager(torch.from_numpy(x))
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want), (case, b)
    jwant = jfwd(jnp.asarray(x))        # at B = 7: one JAX compile a case
    assert set(jwant) == set(got)
    for k in want:
        j = np.asarray(jwant[k], np.float32)
        if case == 'int8':
            np.testing.assert_allclose(got[k].numpy(), j, err_msg=k, **TOL)
        else:
            err = float(np.abs(got[k].numpy() - j).max())
            assert err <= limit(j, jwant), (case, k, err)
    assert (fm.launches, fe.launches, fg.launches) == counts    # plain versions on the CPU
    if case in ('feedforward', 'int8'):
        jax_out = tmp_path / f'{case}.stablehlo'
        _run_jax(_argv(data, tmp_path, flags, jax_out))
        port, jx = _sidecars(out, jax_out)
        assert port == jx


def test_static_batch_fixes_the_shape(data, tmp_path):
    jmodel, variables, cfg, ckpt = _write_pair(data, tmp_path, [],
                                               weights.feedforward_state_dict_from_jax)
    out = tmp_path / 'static.pt2'
    _run_port(_argv(data, tmp_path, ['--static-batch', '3'], out))
    assert json.load(open(str(out) + '.json'))['input']['shape'] == [3, 4, 177]
    program = torch.export.load(str(out))
    model, _, _ = load_model(cfg, data['ds'], ckpt, device='cpu')
    x = torch.from_numpy(data['ds'].gather(np.arange(5)).inputs)
    got, want = program.module()(x[:3]), model(x[:3])
    assert all(torch.equal(got[k], want[k]) for k in want)
    for b in (1, 5):
        with pytest.raises(Exception, match='3'):
            program.module()(x[:b])


@pytest.mark.parametrize('guidance', ['1', '2'])
def test_diffusion_program_takes_its_seed_at_call_time(data, tmp_path, guidance):
    flags = DIFF + ['--guidance-scale', guidance]
    out, jax_out = tmp_path / 'diffusion.pt2', tmp_path / 'diffusion.stablehlo'
    printed = _run_port(_argv(data, tmp_path, flags, out))
    assert 'WARNING: no checkpoint in' in printed and '2 batch' in printed
    _run_jax(_argv(data, tmp_path, flags, jax_out))
    port, jx = _sidecars(out, jax_out)
    assert port == jx and port['extra_inputs'] == [{'name': 'seed', 'shape': [],
                                                    'dtype': 'int32'}]
    assert port['input']['shape'][0] == 2 and port['diffusion_sample_steps'] == 2
    program = torch.export.load(str(out)).module()
    cfg = config_from_args(build_parser().parse_args(_argv(data, tmp_path, flags, out)))
    ds = WindowDataset(os.path.join(data['data'], 'dev'), window_size=20, stride=5,
                       output_data_format='all_frames', skip_loading_skeletons=True)
    ckpt = str(tmp_path / 'diffusion')
    model, _, _ = load_model(cfg, ds, ckpt, device='cpu')
    chain = eval_forward(cfg, model, ckpt, sample_steps=2)
    x = torch.from_numpy(ds.gather(np.arange(2)).inputs)
    seed = lambda s: torch.tensor(s, dtype=torch.int32)  # noqa: E731
    a, b, c = program(x, seed(7)), program(x, seed(7)), program(x, seed(8))
    with torch.no_grad():
        eager = chain(x, seed(7))
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], eager[k]), k
        assert torch.isfinite(a[k]).all() and a[k].shape[:2] == (2, 4), k
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_seeded_noise_is_normal_and_keyed_by_seed_and_draw():
    draws = {(s, i): diffusion.seeded_noise(torch.tensor(s, dtype=torch.int32))(
        i, (64, 10, 30), torch.device('cpu')) for s in (0, 1) for i in (0, 1)}
    for z in draws.values():
        assert z.dtype == torch.float32 and z.shape == (64, 10, 30)
        assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1.0) < 0.05
    again = diffusion.seeded_noise(torch.tensor(0))(0, (64, 10, 30), 'cpu')
    assert torch.equal(again, draws[(0, 0)])
    keys = list(draws)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            assert abs(float(np.corrcoef(draws[a].flatten(), draws[b].flatten())[0, 1])) < 0.05


@pytest.mark.parametrize('flags,match', [
    (['--model-type', 'analytical'], 'export supports learned models'),
    (['--model-type', 'transformer', *SMALL_TF, '--quantize', 'int8'],
     'export --quantize int8 supports the feedforward family only'),
    (['--model-type', 'diffusion'], 'requires --output-data-format all_frames'),
])
def test_export_refusals_are_the_jax_commands(data, tmp_path, flags, match):
    errors = []
    for run in (_run_jax, _run_port):
        with pytest.raises(SystemExit) as e:
            run(_argv(data, tmp_path, flags, tmp_path / 'x'))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and match in errors[0]
    assert not os.path.exists(tmp_path / 'x')


def _op_cases():
    """(operator, real-call arguments) of each custom op at two batches."""
    gen = torch.Generator().manual_seed(0)
    mlp = fm.pack_mlp_params([(torch.randn(708, 32, generator=gen), torch.randn(32, generator=gen)),
                              (torch.randn(32, 30, generator=gen), torch.randn(30, generator=gen))],
                             'cpu')
    enc = fe.pack_encoder_params(fe.init_encoder_params(gen, 32, 4), 'cpu')
    tree = {'Conv_0': {'kernel': torch.randn(7, 177, 16, generator=gen),
                       'bias': torch.randn(16, generator=gen)},
            'Dense_0': {'kernel': torch.randn(16, 16, generator=gen),
                        'bias': torch.randn(16, generator=gen)},
            'Dense_1': {'kernel': torch.randn(16, 30, generator=gen)}}
    gl = fg.pack_groundlink_params(tree, 'cpu')
    for b in (1, 5):
        yield 'mlp', lambda x: library.mlp(x, mlp, 'sigmoid'), torch.randn(b, 708)
        yield 'encoder', lambda x: library.encoder_layer(x, enc, 4), torch.randn(b, 4, 32)
        for fmt in ('last_frame', 'all_frames'):
            yield (f'groundlink {fmt}', lambda x, fmt=fmt: library.groundlink(x, gl, fmt),
                   torch.randn(b, 4, 177))


def test_fake_implementations_give_the_real_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    for name, call, x in _op_cases():
        real = call(x)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = call(mode.from_tensor(x))
        assert (fake.shape, fake.dtype) == (real.shape, real.dtype), name
