"""The port's attention converter
(``inferbiomechanics_tpu_torch/scripts/convert_attn_checkpoint.py``) against
the JAX package's ``scripts/convert_attn_checkpoint.py``.

The JAX script is loaded as a module from ``scripts/`` (its functions) and
run as it is, in a subprocess with ``PYTHONPATH=<repo>`` (its ``main``,
which needs flax). Small size: d_model 128 (the fused layer's width
multiple), 2 layers, 4 heads, window 50 / stride 5 (T = 10).

- ``convert_params`` equals the JAX function, both ways, for the transformer
  and the denoiser at two head counts, and a round trip is bitwise.
- On ``.ckpt`` files written by the JAX package's ``save_checkpoint``, the
  port's output file is the JAX script's, byte for byte, both ways, for both
  families, with and without ``ema_params``; the refusals are the script's,
  in its words, and write nothing.
- The port's ``.torch.pt`` converts to what the same weights' ``.ckpt``
  converts to, read back by ``read_payload``.
- The converted model's outputs, within 2e-2 x max (the JAX suite's
  flax-vs-vpu bound, ``tests/test_models.py``): the ``vpu`` forward, the
  fused forward (K2's plain version on the CPU) and the denoiser's fused eps
  against the flax original, and the ``vpu`` forward against the JAX ``vpu``
  forward on the JAX script's tree.
- ``--use-ema`` of a converted file whose EMA the converter left in the
  flax layout is refused, naming both layouts.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.models import get_model as jax_get_model
from inferbiomechanics_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from inferbiomechanics_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from inferbiomechanics_tpu.train.state import TrainState as JaxTrainState
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.models import get_model
from inferbiomechanics_tpu_torch.models.diffusion import fused_denoiser_eps, make_sampler
from inferbiomechanics_tpu_torch.models.transformer import fused_transformer_forward
from inferbiomechanics_tpu_torch.scripts import convert_attn_checkpoint as port_tool
from inferbiomechanics_tpu_torch.train import checkpoint as ckpt
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
from inferbiomechanics_tpu_torch.train.state import create_train_state
from inferbiomechanics_tpu_torch.utils import flax_msgpack

REPO = Path(__file__).resolve().parents[1]
JAX_SCRIPT = REPO / 'scripts' / 'convert_attn_checkpoint.py'
SIZE = dict(num_dofs=23, num_contact_bodies=2, history_len=50, stride=5,
            root_history_len=10, d_model=128, num_layers=2, num_heads=4)
# vpu against flax (the JAX suite's bound, tests/test_models.py), the port
# against JAX (tests/test_torch_transformer.py): two bf16 forwards
REL = 2e-2


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def jax_tool():
    spec = importlib.util.spec_from_file_location('jax_convert_attn_checkpoint', JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_model(family, attn_impl, heads=4):
    return jax_get_model(family, **dict(SIZE, num_heads=heads), attn_impl=attn_impl,
                         **({'output_data_format': 'all_frames'}
                            if family == 'transformer' else {}))


def _jax_inputs(model, family):
    if family == 'transformer':
        return (jnp.zeros((2, 10, 177), jnp.float32),)
    return (jnp.zeros((2, 10, model.target_channels), jnp.float32),
            jnp.zeros((2,), jnp.int32), jnp.zeros((2, 10, 177), jnp.float32))


def _jax_params(family, attn_impl, seed, heads=4):
    """Initialised by flax, then every array moved by seeded numpy noise, so
    that each bias and LayerNorm row matters."""
    model = _jax_model(family, attn_impl, heads)
    params = jax.device_get(jax.jit(lambda k: model.init({'params': k}, *_jax_inputs(
        model, family), train=False))(jax.random.PRNGKey(seed))['params'])
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (p + 0.05 * rng.normal(size=p.shape)).astype(np.float32), params)


def _flat(tree):
    return {jax.tree_util.keystr(path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize('heads', [4, 8])
@pytest.mark.parametrize('family', ['transformer', 'diffusion'])
def test_convert_params_equals_the_jax_function(jax_tool, family, heads):
    """Both ways, on JAX-initialised trees; a round trip is bitwise."""
    for to, src in (('vpu', 'flax'), ('flax', 'vpu')):
        params = _jax_params(family, src, 1, heads)
        mine, theirs = [], []
        got = port_tool.convert_params(params, to, heads, _converted=mine)
        want = jax_tool.convert_params(params, to, heads, _converted=theirs)
        assert mine == theirs == ['EncoderBlock_0', 'EncoderBlock_1']
        _assert_trees_equal(got, want)
        # the other tree's layout, the input untouched, and back bitwise
        assert weights.attention_layout(got) == to
        assert weights.attention_layout(params) == src
        _assert_trees_equal(port_tool.convert_params(got, src, heads), params)
        # a tree in the target layout already: nothing converted
        left = []
        _assert_trees_equal(port_tool.convert_params(got, to, heads, _converted=left), got)
        assert left == []


def _write_jax_ckpt(directory, family, attn_impl, seed, ema):
    """A ``.ckpt`` of the JAX package's ``save_checkpoint`` (an rmsprop
    state, step 5, epoch 2, batch 3), with an EMA tree when ``ema``."""
    model = _jax_model(family, attn_impl)
    params = model.init({'params': jax.random.PRNGKey(seed)}, *_jax_inputs(model, family),
                        train=False)['params']
    tx = jax_make_optimizer('rmsprop', 1e-3)
    state = JaxTrainState(step=jnp.asarray(5, jnp.int32), params=params,
                          opt_state=tx.init(params), batch_stats={}, tx=tx,
                          apply_fn=model.apply)
    ema_params = jax.tree_util.tree_map(lambda p: p * 0.5, params) if ema else None
    return jax_save_checkpoint(str(directory), state, 2, 3, ema_params=ema_params)


def _run(argv, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS='cpu')
    return subprocess.run([sys.executable, *argv], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=300)


def _jax_script(cwd, *args):
    return _run([str(JAX_SCRIPT), *map(str, args)], cwd)


def _port_script(cwd, *args):
    return _run(['-m', 'inferbiomechanics_tpu_torch.scripts.convert_attn_checkpoint',
                 *map(str, args)], cwd)


@pytest.mark.parametrize('family,to,ema', [
    ('transformer', 'vpu', False), ('transformer', 'flax', True),
    ('diffusion', 'vpu', True), ('diffusion', 'flax', False)])
def test_ckpt_output_is_the_jax_scripts_byte_for_byte(tmp_path, family, to, ema):
    src = _write_jax_ckpt(tmp_path / 'run', family, 'flax' if to == 'vpu' else 'vpu', 7, ema)
    jax_out, port_out = tmp_path / 'jax.ckpt', tmp_path / 'port.ckpt'
    j = _jax_script(tmp_path, src, 'jax.ckpt', '--to', to, '--num-heads', 4)
    assert j.returncode == 0, j.stderr
    assert port_tool.main([src, str(port_out), '--to', to, '--num-heads', '4']) == 0
    # array by array, then byte for byte
    got, want = (flax_msgpack.loads(p.read_bytes()) for p in (port_out, jax_out))
    assert list(got) == list(want) and 'opt_state' not in got
    assert ('ema_params' in got) == ema
    _assert_trees_equal(got, want)
    assert port_out.read_bytes() == jax_out.read_bytes()
    # the EMA stays in the layout the converter found, as in JAX
    if ema:
        assert weights.attention_layout(got['ema_params']) != to
        assert weights.attention_layout(got['params']) == to
    if (family, to) == ('transformer', 'vpu'):    # the CLI prints the JAX script's line
        p = _port_script(tmp_path, src, 'cli.ckpt', '--to', to, '--num-heads', '4')
        assert p.returncode == 0, p.stderr
        assert p.stdout.replace('cli.ckpt', 'jax.ckpt') == j.stdout
        assert (tmp_path / 'cli.ckpt').read_bytes() == jax_out.read_bytes()


def _refusal(tmp_path, src, *args):
    """Both scripts on ``src``: (exit code, stderr's last line, written?)."""
    out = []
    for name, run in (('jax', _jax_script), ('port', _port_script)):
        dst = tmp_path / f'{name}_out'
        proc = run(tmp_path, src, dst, *args)
        out.append((proc.returncode, proc.stderr.strip().splitlines()[-1:], dst.exists()))
    return out


def test_refusals_are_the_jax_scripts_and_write_nothing(tmp_path):
    vpu = _write_jax_ckpt(tmp_path / 'vpu', 'transformer', 'vpu', 3, False)
    flax = _write_jax_ckpt(tmp_path / 'flax', 'diffusion', 'flax', 3, False)
    # already in the format asked for
    for src, to in ((vpu, 'vpu'), (flax, 'flax')):
        jax_side, port_side = _refusal(tmp_path, src, '--to', to)
        assert jax_side == port_side, (jax_side, port_side)
        assert jax_side[0] == 1 and not jax_side[2]
        assert 'no EncoderBlock attention parameters to convert' in jax_side[1][0]
        assert '(nothing written)' in jax_side[1][0]
    # a pallas tree (enc{i}_*) is left alone: nothing to convert
    pallas = _write_jax_ckpt(tmp_path / 'pallas', 'transformer', 'pallas', 0, False)
    jax_side, port_side = _refusal(tmp_path, pallas, '--to', 'flax')
    assert jax_side == port_side and jax_side[0] == 1 and not jax_side[2]
    # --to flax with a head count that does not divide d_model, by block
    jax_side, port_side = _refusal(tmp_path, vpu, '--to', 'flax', '--num-heads', '3')
    assert jax_side == port_side, (jax_side, port_side)
    assert jax_side == (1, ['EncoderBlock_0: d_model 128 not divisible by --num-heads 3'],
                        False)
    # a wrong head count that divides d_model is taken silently (the NOTE)
    assert _jax_script(tmp_path, vpu, tmp_path / 'j2', '--to', 'flax',
                       '--num-heads', '2').returncode == 0
    assert port_tool.main([vpu, str(tmp_path / 'p2'), '--to', 'flax', '--num-heads', '2']) == 0
    assert (tmp_path / 'p2').read_bytes() == (tmp_path / 'j2').read_bytes()
    # the port's own format refuses in the same words
    model = get_model('feedforward', **{k: v for k, v in SIZE.items()
                                        if k not in ('d_model', 'num_layers', 'num_heads')},
                      hidden_dims=(32,), generator=torch.Generator().manual_seed(0))
    ff = ckpt.save_checkpoint(str(tmp_path / 'ff'), model, 0, 0)
    with pytest.raises(SystemExit, match='no EncoderBlock attention parameters to convert '
                                         "to 'vpu'"):
        port_tool.main([ff, str(tmp_path / 'ff_out'), '--to', 'vpu'])
    assert not (tmp_path / 'ff_out').exists()


def _port_run(tmp_path, family, attn_impl, seed, ema):
    """The same weights in both of the port's formats: a ``.torch.pt`` of a
    TrainState (rmsprop after one update, step 1) and the ``.ckpt`` that
    ``weights.jax_payload`` makes of it, each with the same EMA when
    ``ema``."""
    model = get_model(family, **SIZE, attn_impl=attn_impl,
                      **({'output_data_format': 'all_frames'}
                         if family == 'transformer' else {}),
                      generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(model.named_parameters(), 'rmsprop', 1e-3)
    for p in model.parameters():
        p.grad = torch.full_like(p, 1e-2)
    opt.step()
    state = create_train_state(model, opt)
    state.step = 1
    ema_params = ({n: p.detach() * 0.5 for n, p in model.named_parameters()}
                  if ema else None)
    pt = ckpt.save_checkpoint(str(tmp_path / 'pt'), state, 4, 2, ema_params=ema_params)
    jx = tmp_path / 'run.ckpt'
    jx.write_bytes(flax_msgpack.dumps(weights.jax_payload(model, opt, 4, 2, 1,
                                                          ema_params=ema_params)))
    return model, pt, str(jx)


@pytest.mark.parametrize('family,ema', [('transformer', False), ('diffusion', True)])
def test_torch_pt_converts_as_its_ckpt_does(tmp_path, family, ema):
    model, pt, jx = _port_run(tmp_path, family, 'flax', 2, ema)
    assert port_tool.main([pt, str(tmp_path / 'out.torch.pt'), '--to', 'vpu']) == 0
    assert port_tool.main([jx, str(tmp_path / 'out.ckpt'), '--to', 'vpu']) == 0
    got = torch.load(tmp_path / 'out.torch.pt', weights_only=True)
    want = ckpt.read_payload(str(tmp_path / 'out.ckpt'))
    assert sorted(got) == sorted(want) == sorted(
        ['epoch', 'batch', 'step', 'model_state_dict', *(['ema_params'] if ema else [])])
    assert (got['epoch'], got['batch'], got['step']) == (want['epoch'], want['batch'],
                                                         want['step']) == (4, 2, 1)
    for part in ('model_state_dict', *(['ema_params'] if ema else [])):
        assert set(got[part]) == set(want[part])
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), (part, k)
    # the converted state dict is the vpu model's, strictly
    vpu = get_model(family, **SIZE, **({'output_data_format': 'all_frames'}
                                       if family == 'transformer' else {}))
    vpu.load_state_dict(got['model_state_dict'])
    assert weights.model_family(vpu) == family
    # and back to flax: the original parameters bitwise
    assert port_tool.main([str(tmp_path / 'out.torch.pt'), str(tmp_path / 'back.torch.pt'),
                           '--to', 'flax', '--num-heads', '4']) == 0
    back = torch.load(tmp_path / 'back.torch.pt', weights_only=True)['model_state_dict']
    orig = model.state_dict()
    assert set(back) == set(orig)
    for k in orig:
        assert torch.equal(back[k], orig[k]), k


def _x(seed, b=6):
    return np.random.default_rng(seed).normal(0, 1, (b, 10, 177)).astype(np.float32)


def _assert_close(got, want, rel, what):
    for k in want:
        a, b = np.asarray(want[k], np.float32), np.asarray(got[k], np.float32)
        assert a.shape == b.shape, (what, k)
        err = float(np.abs(a - b).max())
        assert err <= rel * float(np.abs(a).max()), f'{what} {k}: {err} > {rel} x max'


def test_converted_transformer_forwards(jax_tool):
    """The flax original (the port's and JAX's), the port's ``vpu`` and fused
    forwards on the port-converted tree, JAX's ``vpu`` forward on the JAX
    script's tree."""
    flax_params = _jax_params('transformer', 'flax', 5)
    vpu_params = port_tool.convert_params(flax_params, 'vpu', 4)
    jax_vpu_params = jax_tool.convert_params(flax_params, 'vpu', 4)
    x = _x(5)
    jflax, jvpu = _jax_model('transformer', 'flax'), _jax_model('transformer', 'vpu')
    want_flax = jax.jit(lambda p, x: jflax.apply({'params': p}, x, train=False))(
        flax_params, jnp.asarray(x))
    want_vpu = jax.jit(lambda p, x: jvpu.apply({'params': p}, x, train=False))(
        jax_vpu_params, jnp.asarray(x))
    pm = get_model('transformer', **SIZE, output_data_format='all_frames')
    pm.load_state_dict(weights.params_from_jax('transformer', vpu_params))
    pflax = get_model('transformer', **SIZE, output_data_format='all_frames',
                      attn_impl='flax')
    pflax.load_state_dict(weights.params_from_jax('transformer_flax', flax_params))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        vpu_out, flax_out = pm.eval()(xt), pflax.eval()(xt)
        fused = fused_transformer_forward(pm, xt)
    _assert_close(vpu_out, want_flax, REL, 'vpu (converted) vs JAX flax')
    _assert_close(vpu_out, flax_out, REL, 'vpu (converted) vs the port\'s flax')
    _assert_close(vpu_out, want_vpu, REL, 'port vpu vs JAX vpu on the JAX script\'s tree')
    _assert_close(fused, want_flax, REL, 'fused (converted) vs JAX flax')


def test_converted_denoiser_eps_through_the_fused_layer():
    """The flax denoiser's eps (JAX ``apply``) against the converted
    denoiser's through the fused sampler's layer (its plain version on the
    CPU), on the same (x_t, t, cond); the fused sampler takes the converted
    denoiser and refuses the flax one."""
    flax_params = _jax_params('diffusion', 'flax', 6)
    jm = _jax_model('diffusion', 'flax')
    net = get_model('diffusion', **SIZE)
    net.load_state_dict(weights.params_from_jax(
        'diffusion', port_tool.convert_params(flax_params, 'vpu', 4)))
    flax_net = get_model('diffusion', **SIZE, attn_impl='flax')
    flax_net.load_state_dict(weights.params_from_jax('diffusion_flax', flax_params))
    rng = np.random.default_rng(6)
    cond = _x(6, 4)
    x_t = rng.normal(size=(4, 10, net.target_channels)).astype(np.float32)
    for t in (0, 250, 999):
        tt = np.full((4,), t, np.int32)
        want = np.asarray(jax.jit(lambda p, a, b, c: jm.apply({'params': p}, a, b, c))(
            flax_params, x_t, tt, cond))
        with torch.no_grad():
            got = fused_denoiser_eps(net.eval(), torch.from_numpy(x_t), torch.from_numpy(tt),
                                     torch.from_numpy(cond))
        _assert_close({'eps': got.numpy()}, {'eps': want}, REL, f'eps t={t}')
    sample = make_sampler(net, num_steps=3, fused_inference=True)
    out = sample(net, torch.from_numpy(cond), generator=torch.Generator().manual_seed(0))
    assert all(np.isfinite(v.numpy()).all() and v.shape[:2] == (4, 10) for v in out.values())
    with pytest.raises(ValueError, match='consumes the vpu parameter tree'):
        make_sampler(flax_net, num_steps=3, fused_inference=True)


def test_use_ema_of_a_converted_file_names_the_layouts(tmp_path):
    """The JAX script converts the parameters and leaves the EMA in the flax
    layout. The port refuses ``--use-ema`` of such a file (``.ckpt`` and
    ``.torch.pt``) by naming both layouts; without ``--use-ema`` it loads.
    The JAX package's own ``load_ema_params`` raises inside flax's
    ``from_state_dict``."""
    from inferbiomechanics_tpu.train.checkpoint import load_ema_params as jax_load_ema_params
    src = _write_jax_ckpt(tmp_path / 'run', 'diffusion', 'flax', 4, True)
    out = tmp_path / 'vpu.ckpt'
    assert _jax_script(tmp_path, src, out, '--to', 'vpu').returncode == 0
    like = _jax_model('diffusion', 'vpu')
    with pytest.raises(Exception):
        jax_load_ema_params(str(out), like.init(jax.random.PRNGKey(0), *_jax_inputs(
            like, 'diffusion'))['params'])
    net = get_model('diffusion', **SIZE)
    match = "ema_params hold the attn_impl='flax' attention tree and its parameters the " \
            "attn_impl='vpu' one"
    with pytest.raises(ValueError, match=match):
        ckpt.load_ema_params(str(out), like=net)
    with pytest.raises(ValueError, match=match):
        ckpt.load_checkpoint_file(net, str(out), use_ema=True)
    with pytest.raises(ValueError, match=match):
        ckpt.require_ema_params(str(out))
    assert ckpt.load_checkpoint_file(net, str(out)) == (2, 3)
    # the port's own format, converted by the port's tool
    _, pt, _ = _port_run(tmp_path / 'p', 'diffusion', 'flax', 1, True)
    conv = tmp_path / 'vpu.torch.pt'
    assert port_tool.main([pt, str(conv), '--to', 'vpu']) == 0
    with pytest.raises(ValueError, match=match):
        ckpt.load_checkpoint_file(net, str(conv), use_ema=True)
    with pytest.raises(ValueError, match=match):
        ckpt.load_ema_params(str(conv), like=net)
    assert ckpt.load_checkpoint_file(net, str(conv)) == (4, 2)
