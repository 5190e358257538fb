"""``convert-checkpoint`` and model soups in the port
(``inferbiomechanics_tpu_torch/cli/convert_checkpoint_cmd.py``,
``torch_compat.py``, ``train/checkpoint.py::soup_checkpoints``).

- A reference-layout torch network (``tests/test_torch_compat.py``'s
  ``net.{i}`` Sequential, DDP prefix; GroundLink's ``cnn``/``fc``) converted
  by the port gives the reference's own outputs, sliced as the reference
  slices them: the port's float32 plain version within rtol 1e-4 / atol
  1e-5, its bf16 eval forward within 2e-2 x the largest output.
  ``--to-torch`` round-trips bitwise; reference BatchNorm files stay a
  ValueError; a reference file resumes in ``train`` with the fresh state
  of ``--opt-type`` and no warning.
- ``soup_checkpoints`` of two port checkpoints is bitwise the JAX package's
  ``soup_checkpoints`` of the same members written as JAX checkpoints
  through ``weights.py``, and keeps the JAX soup's refusals.
- A JAX run resumed on the port: the JAX package trains a feedforward model
  on its device-resident tier and writes a mid-epoch checkpoint; the
  port's ``convert-checkpoint`` carries it (and its ``run_config.json``)
  over; the port's ``train`` resumes it with no warning and runs the
  epoch's remaining steps on the batches the JAX run drew (both loops draw
  an epoch's order from ``np.random.default_rng((seed, epoch))``). It ends
  where the JAX run ends: each tensor's distance from the JAX run's final
  value is under 5e-2 x the JAX run's change over those steps, in L2 norm
  (the three-step parity tests' gradient tolerance; bf16 operands rounded at
  different places by XLA and PyTorch, which rmsprop's normalisation
  amplifies for the elements whose gradient is near 0, so no element-wise
  bound holds), where the same steps with a fresh optimizer land 0.5-0.8
  of that change away.
"""

import json
import logging
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn

from inferbiomechanics_tpu.config import Config as JaxConfig
from inferbiomechanics_tpu.data.dataset import WindowDataset as JaxWindowDataset
from inferbiomechanics_tpu.train.checkpoint import soup_checkpoints as jax_soup_checkpoints
from inferbiomechanics_tpu.train.loop import train as jax_train
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.__main__ import main
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.keys import OutputDataKeys
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.models import build_model_for_dataset
from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg
from inferbiomechanics_tpu_torch.ops.fused_mlp import mlp_reference
from inferbiomechanics_tpu_torch.torch_compat import (
    convert_state_dict, convert_torch_checkpoint, export_state_dict, output_permutation,
)
from inferbiomechanics_tpu_torch.train import checkpoint as ckpt
from inferbiomechanics_tpu_torch.train.loop import train
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
from inferbiomechanics_tpu_torch.train.state import create_train_state
from inferbiomechanics_tpu_torch.utils import flax_msgpack

BATCH = 8
BF16_REL = 2e-2
GRAD_REL = 5e-2


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp('convert_data')
    os.makedirs(root / 'train')
    write_synthetic_subject(str(root / 'train' / 's.b3d'), num_trials=2,
                            trial_length=120, seed=0)
    kw = dict(window_size=20, stride=5, skip_loading_skeletons=True)
    return {'root': root, 'train': WindowDataset(str(root / 'train'), **kw),
            'jax_train': JaxWindowDataset(str(root / 'train'), **kw)}


def _torch_net(in_size, hidden, out_size, seed=0):
    """tests/test_torch_compat.py's reference-layout feedforward network."""
    torch.manual_seed(seed)
    dims = [in_size] + hidden + [out_size]
    layers = []
    for i, (h0, h1) in enumerate(zip(dims[:-1], dims[1:])):
        layers.append(tnn.Linear(h0, h1))
        if i < len(dims) - 2:
            layers.append(tnn.Sigmoid())
    return tnn.Sequential(*layers)


def _ref_head_slices(y, F):
    """The reference's output slicing: component blocks across frames."""
    B = y.shape[0]
    return {
        OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME: y[:, 0 * F:6 * F].reshape(B, F, 6),
        OutputDataKeys.GROUND_CONTACT_FORCES_IN_ROOT_FRAME: y[:, 6 * F:12 * F].reshape(B, F, 6),
        OutputDataKeys.GROUND_CONTACT_TORQUES_IN_ROOT_FRAME: y[:, 12 * F:18 * F].reshape(B, F, 6),
        OutputDataKeys.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME:
            y[:, 18 * F:30 * F].reshape(B, F, 12),
    }


def _ff_config(ckpt_dir, **fields):
    cfg = Config()
    cfg.model_type, cfg.window_size, cfg.stride, cfg.batch_size = 'feedforward', 20, 5, BATCH
    cfg.hidden_dims, cfg.checkpoint_dir = [64, 32], str(ckpt_dir)
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


@pytest.mark.parametrize('frames,fmt', [(1, 'last_frame'), (4, 'all_frames')])
def test_a_converted_reference_network_gives_its_outputs(data, tmp_path, frames, fmt):
    x = np.asarray(data['train'].gather(np.arange(8)).inputs, np.float32)
    B = x.shape[0]
    net = _torch_net(x[0].size, [64, 32], 30 * frames, seed=frames)
    pt = str(tmp_path / 'epoch_3_batch_7.pt')
    torch.save({'epoch': 3, 'model_state_dict':
                {'module.net.' + k: v for k, v in net.state_dict().items()}}, pt)
    written = convert_torch_checkpoint(pt, str(tmp_path / 'converted'))
    assert written.endswith('epoch_3_batch_7.torch.pt')
    with torch.no_grad():
        y = net(torch.from_numpy(x.reshape(B, -1))).numpy()
    cfg = _ff_config(tmp_path / 'converted', output_data_format=fmt)
    model, epoch, batch = ckpt.load_model(cfg, data['train'], str(tmp_path / 'converted'))
    assert (epoch, batch) == (3, 7)
    with torch.no_grad():
        exact = mlp_reference(torch.from_numpy(x.reshape(B, -1)), model.layer_params(),
                              'sigmoid', torch.float32).numpy()
        served = model(torch.from_numpy(x))
    np.testing.assert_allclose(exact, y[:, output_permutation(frames)], rtol=1e-4, atol=1e-5)
    for k, v in _ref_head_slices(y, frames).items():
        got = served[k].numpy().reshape(v.shape)
        np.testing.assert_allclose(got, v, rtol=0, atol=BF16_REL * np.abs(v).max(), err_msg=k)
    sidecar = json.load(open(tmp_path / 'converted' / 'run_config.json'))
    assert sidecar['model_type'] == 'feedforward' and sidecar['hidden_dims'] == [64, 32]


def test_a_converted_reference_groundlink_gives_its_outputs(data, tmp_path):
    x = np.asarray(data['train'].gather(np.arange(6)).inputs, np.float32)
    torch.manual_seed(0)
    feats = [x.shape[2], 128, 128, 256, 256]
    cnn = tnn.Sequential(*[m for c0, c1 in zip(feats[:-1], feats[1:]) for m in (
        tnn.Dropout(0.0), tnn.Conv1d(c0, c1, 7, padding=3, padding_mode='replicate'),
        tnn.ELU())])
    fc = tnn.Sequential(tnn.Identity(), tnn.Dropout(0.2), tnn.Linear(256, 256), tnn.ELU(),
                        tnn.Dropout(0.2), tnn.Linear(256, 256), tnn.ELU(), tnn.Dropout(0.2),
                        tnn.Linear(256, 30, bias=False))
    sd = {'cnn.' + k: v for k, v in cnn.state_dict().items()}
    sd.update({'fc.' + k: v for k, v in fc.state_dict().items()})
    pt = str(tmp_path / 'epoch_1_batch_2.pt')
    torch.save({'model_state_dict': sd}, pt)
    assert main(['convert-checkpoint', pt, '--out-dir', str(tmp_path / 'gl')]) == 0
    with torch.no_grad():
        cnn.eval(), fc.eval()
        y = fc(cnn(torch.from_numpy(x).transpose(-2, -1)).transpose(-2, -1)).numpy()
    cfg = _ff_config(tmp_path / 'gl', model_type='groundlink', output_data_format='all_frames')
    model, epoch, batch = ckpt.load_model(cfg, data['train'], str(tmp_path / 'gl'))
    assert (epoch, batch) == (1, 2)
    with torch.no_grad():
        exact = fg.groundlink_reference(torch.from_numpy(x), model.layer_params(),
                                        'all_frames', 3, torch.float32).numpy()
    np.testing.assert_allclose(exact, y, rtol=1e-4, atol=1e-5)
    # and back: --to-torch loads strictly into the reference's modules
    assert main(['convert-checkpoint', str(tmp_path / 'gl'), '--to-torch', '--out-dir',
                 str(tmp_path / 'back')]) == 0
    back = torch.load(tmp_path / 'back' / 'epoch_1_batch_2.pt', weights_only=True)
    cnn.load_state_dict({k[4:]: v for k, v in back['model_state_dict'].items()
                         if k.startswith('cnn.')}, strict=True)
    fc.load_state_dict({k[3:]: v for k, v in back['model_state_dict'].items()
                        if k.startswith('fc.')}, strict=True)
    for k, v in sd.items():
        assert torch.equal(back['model_state_dict'][k], v), k


def test_dropout_shifted_indices_and_the_refusals(data, tmp_path):
    x = np.asarray(data['train'].gather(np.arange(4)).inputs, np.float32)
    torch.manual_seed(2)
    net = tnn.Sequential(tnn.Dropout(0.1), tnn.Linear(x[0].size, 32), tnn.Sigmoid(),
                         tnn.Dropout(0.1), tnn.Linear(32, 30))
    converted = convert_state_dict({'net.' + k: v for k, v in net.state_dict().items()}, 1)
    assert set(converted) == {'layers.0.weight', 'layers.0.bias', 'layers.1.weight',
                              'layers.1.bias'}
    shifted = export_state_dict(converted, 1, dropout=True)
    assert set(shifted) == {'net.1.weight', 'net.1.bias', 'net.4.weight', 'net.4.bias'}
    for k, v in shifted.items():
        assert torch.equal(v, net.state_dict()[k[4:]]), k
    with pytest.raises(ValueError, match='[Bb]atch[Nn]orm'):
        convert_state_dict({'net.0.weight': torch.zeros(4, 4), 'net.0.bias': torch.zeros(4),
                            'net.0.running_mean': torch.zeros(4),
                            'net.0.running_var': torch.ones(4)}, 1)
    # best.pt and final.pt into one --out-dir: two stem-named files, neither
    # a resume point
    for name, seed in (('best.pt', 3), ('final.pt', 4)):
        net = _torch_net(x[0].size, [16], 30, seed=seed)
        torch.save({'model_state_dict': {'net.' + k: v for k, v in net.state_dict().items()}},
                   tmp_path / name)
    assert main(['convert-checkpoint', str(tmp_path / 'best.pt'), str(tmp_path / 'final.pt'),
                 '--out-dir', str(tmp_path / 'out')]) == 0
    assert sorted(os.listdir(tmp_path / 'out')) == ['best.torch.pt', 'final.torch.pt',
                                                     'run_config.json']
    assert ckpt.list_checkpoints(str(tmp_path / 'out')) == []
    assert main(['convert-checkpoint', str(tmp_path / 'best.pt')]) == 2     # no --out-dir


def test_a_converted_reference_file_resumes_with_no_warning(data, tmp_path, caplog):
    net = _torch_net(np.asarray(data['train'].gather(np.arange(1)).inputs[0]).size,
                     [64, 32], 30)
    pt = tmp_path / 'ref' / 'epoch_0_batch_0.pt'
    os.makedirs(pt.parent)
    torch.save({'epoch': 0, 'model_state_dict': {'net.' + k: v for k, v in
                                                 net.state_dict().items()}}, pt)
    assert main(['convert-checkpoint', str(pt.parent), '--opt-type', 'adam',
                 '--out-dir', str(tmp_path / 'c' / 'feedforward')]) == 0
    payload = torch.load(tmp_path / 'c' / 'feedforward' / 'epoch_0_batch_0.torch.pt',
                         weights_only=True)
    assert payload['opt_type'] == 'adam' and payload['step'] == 0
    assert set(payload['optimizer_state_dict']['state'][0]) == {'mu', 'nu'}
    with caplog.at_level(logging.WARNING):
        result = train(_ff_config(tmp_path / 'c' / 'feedforward', opt_type='adam', epochs=2),
                       data['train'], None, max_batches_per_epoch=2, device='cpu')
    assert result.epochs_run == 1 and 'WARNING' not in caplog.text, caplog.text
    # the same run from the converted weights with a fresh optimizer
    fresh = tmp_path / 'fresh' / 'feedforward'
    os.makedirs(fresh)
    torch.save({k: v for k, v in payload.items()
                if k in ('epoch', 'batch', 'model_state_dict')},
               fresh / 'epoch_0_batch_0.torch.pt')
    train(_ff_config(fresh, opt_type='adam', epochs=2), data['train'], None,
          max_batches_per_epoch=2, device='cpu')
    a = torch.load(tmp_path / 'c' / 'feedforward' / 'epoch_1_batch_0.torch.pt',
                   weights_only=True)
    b = torch.load(fresh / 'epoch_1_batch_0.torch.pt', weights_only=True)
    for k, v in a['model_state_dict'].items():
        assert torch.equal(v, b['model_state_dict'][k]), k


def test_to_torch_round_trips(data, tmp_path):
    cfg = _ff_config(tmp_path / 'a')
    model = build_model_for_dataset(cfg, data['train'],
                                    generator=torch.Generator().manual_seed(5))
    ckpt.save_checkpoint(str(tmp_path / 'a'), model, 2, 9)
    assert main(['convert-checkpoint', str(tmp_path / 'a'), '--to-torch', '--out-dir',
                 str(tmp_path / 'ref')]) == 0
    blob = torch.load(tmp_path / 'ref' / 'epoch_2_batch_9.pt', weights_only=True)
    assert blob['epoch'] == 2 and set(blob['model_state_dict']) == {
        'net.0.weight', 'net.0.bias', 'net.2.weight', 'net.2.bias', 'net.4.weight',
        'net.4.bias'}
    # the reference network loads it strictly and answers as the port does
    x = np.asarray(data['train'].gather(np.arange(5)).inputs, np.float32)
    net = _torch_net(x[0].size, [64, 32], 30)
    net.load_state_dict({k[4:]: v for k, v in blob['model_state_dict'].items()}, strict=True)
    with torch.no_grad():
        y = net(torch.from_numpy(x.reshape(5, -1))).numpy()
        exact = mlp_reference(torch.from_numpy(x.reshape(5, -1)), model.layer_params(),
                              'sigmoid', torch.float32).numpy()
    np.testing.assert_allclose(exact, y[:, output_permutation(1)], rtol=1e-4, atol=1e-5)
    assert main(['convert-checkpoint', str(tmp_path / 'ref'), '--out-dir',
                 str(tmp_path / 'again')]) == 0
    again = torch.load(tmp_path / 'again' / 'epoch_2_batch_9.torch.pt', weights_only=True)
    for k, v in model.state_dict().items():
        assert torch.equal(again['model_state_dict'][k], v), k


def _member(data, tmp_path, seed, epoch):
    """A batchnorm feedforward train state after one adam update, saved by
    the port and, through weights.py, as the JAX package would save it."""
    cfg = _ff_config(tmp_path, batchnorm=True)
    model = build_model_for_dataset(cfg, data['train'],
                                    generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for norm in model.norms:
            norm.running_mean.normal_(generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'adam', 1e-3))
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=torch.Generator().manual_seed(seed + 1))
    state.apply_gradients()
    port = ckpt.save_checkpoint(str(tmp_path / f'm{seed}'), state, epoch, 0)
    jax_file = tmp_path / f'j{seed}' / f'epoch_{epoch}_batch_0.ckpt'
    os.makedirs(jax_file.parent)
    jax_file.write_bytes(flax_msgpack.dumps(weights.jax_payload(
        model, state.optimizer, epoch, 0, step=state.step)))
    return cfg, port, str(jax_file)


def test_soup_equals_the_jax_soup(data, tmp_path):
    members = [_member(data, tmp_path, seed, epoch) for seed, epoch in ((0, 2), (1, 1))]
    cfg = members[0][0]
    port = ckpt.soup_checkpoints([m[1] for m in members], str(tmp_path / 'soup.torch.pt'))
    jax = jax_soup_checkpoints([m[2] for m in members], str(tmp_path / 'soup.ckpt'))
    states = []
    for path in (port, jax):
        model = build_model_for_dataset(cfg, data['train'])
        state = create_train_state(model, make_optimizer(model.named_parameters(), 'adam', 1e-3))
        assert ckpt.load_checkpoint_file(state, path) == (2, 0)     # the newest member's
        states.append(state)
    for (k, a), (_, b) in zip(states[0].model.state_dict().items(),
                              states[1].model.state_dict().items()):
        assert torch.equal(a, b), k
    newest = torch.load(members[0][1], weights_only=True)
    for k, v in states[0].model.state_dict().items():
        if 'running' in k:                              # the newest member's buffers
            assert torch.equal(v, newest['model_state_dict'][k]), k
    opt = [s.optimizer.state_dict()['state'] for s in states]
    for i, st in opt[0].items():
        for key, v in st.items():
            assert torch.equal(v, opt[1][i][key]), (i, key)
    # the port's soup of JAX members, through the command, is the same file
    assert main(['convert-checkpoint', members[0][2], members[1][2],
                 '--soup', str(tmp_path / 'of_jax.torch.pt')]) == 0
    of_jax = torch.load(tmp_path / 'of_jax.torch.pt', weights_only=True)
    for k, v in states[0].model.state_dict().items():
        assert torch.equal(of_jax['model_state_dict'][k], v), k


def test_soup_refuses_what_the_jax_soup_refuses(data, tmp_path):
    files = []
    for i, hidden in enumerate(([16], [24])):
        model = build_model_for_dataset(_ff_config(tmp_path, hidden_dims=hidden), data['train'])
        files.append(ckpt.save_checkpoint(str(tmp_path / f'a{i}'), model, 0, 0))
    with pytest.raises(ValueError, match='shape mismatch|structure differs'):
        ckpt.soup_checkpoints(files, str(tmp_path / 'bad.torch.pt'))
    with pytest.raises(ValueError, match='at least 2'):
        ckpt.soup_checkpoints(files[:1], str(tmp_path / 'bad2.torch.pt'))
    gl = build_model_for_dataset(_ff_config(tmp_path, model_type='groundlink'), data['train'])
    other = ckpt.save_checkpoint(str(tmp_path / 'gl'), gl, 0, 0)
    with pytest.raises(ValueError, match='structure differs'):
        ckpt.soup_checkpoints([files[0], other], str(tmp_path / 'bad3.torch.pt'))
    assert not os.path.exists(tmp_path / 'bad.torch.pt')


def test_a_jax_run_resumes_on_the_port(data, tmp_path, caplog):
    fields = dict(model_type='feedforward', window_size=20, stride=5, hidden_dims=[32],
                  batch_size=BATCH, epochs=1, checkpoint_every_batches=2, seed=3,
                  device_data='on', device_chunk_steps=1, learning_rate=1e-3,
                  log_every_batches=1000)
    jcfg = JaxConfig(checkpoint_dir=str(tmp_path / 'jax' / 'feedforward'), **fields)
    jax_train(jcfg, data['jax_train'], None)
    jdir = tmp_path / 'jax' / 'feedforward'
    steps = len(data['train']) // BATCH
    assert os.path.exists(jdir / 'epoch_0_batch_2.ckpt') and steps >= 4
    # the JAX run's mid-epoch checkpoint alone, with its sidecar
    pdir = tmp_path / 'port' / 'feedforward'
    assert main(['convert-checkpoint', str(jdir / 'epoch_0_batch_2.ckpt'),
                 '--out-dir', str(pdir)]) == 0
    assert sorted(os.listdir(pdir)) == ['epoch_0_batch_2.torch.pt', 'run_config.json']
    start = torch.load(pdir / 'epoch_0_batch_2.torch.pt', weights_only=True)
    assert start['opt_type'] == 'rmsprop' and start['step'] == 3
    with caplog.at_level(logging.WARNING):
        result = train(_ff_config(pdir, **{k: v for k, v in fields.items()
                                            if k != 'model_type'}),
                       data['train'], None, device='cpu')
    assert 'WARNING' not in caplog.text, caplog.text
    assert result.windows_seen == (steps - 3) * BATCH
    got = torch.load(pdir / 'epoch_0_batch_0.torch.pt', weights_only=True)
    assert got['step'] == steps
    with open(jdir / 'epoch_0_batch_0.ckpt', 'rb') as f:
        want = weights.feedforward_state_dict_from_jax(flax_msgpack.loads(f.read())['params'])
    # the optimizer's state crossed: the same steps from the same parameters
    # with a fresh optimizer go elsewhere
    fresh = tmp_path / 'fresh' / 'feedforward'
    os.makedirs(fresh)
    torch.save({k: start[k] for k in ('epoch', 'batch', 'model_state_dict')},
               fresh / 'epoch_0_batch_2.torch.pt')
    train(_ff_config(fresh, **{k: v for k, v in fields.items() if k != 'model_type'}),
          data['train'], None, device='cpu')
    other = torch.load(fresh / 'epoch_0_batch_0.torch.pt', weights_only=True)
    for k, w in want.items():
        jax_moved = w - start['model_state_dict'][k]
        errs = [float((run['model_state_dict'][k] - w).norm() / jax_moved.norm())
                for run in (got, other)]
        assert errs[0] < GRAD_REL < errs[1], (k, errs)


def test_a_jax_flax_run_converts_resumes_goes_back_and_soups(data, tmp_path, caplog):
    """A JAX run of the transformer with ``--attn-impl flax`` (d_model 64,
    4 layers, 4 heads): its mid-epoch ``.ckpt`` converted (parameters,
    adam's moments and the step), resumed by the port's ``train`` to the
    epoch's end, which lands within 5e-2 of the JAX run's own end relative
    to how far JAX moved each parameter (a fresh optimizer lands farther);
    the converted state written back as the JAX package's tree is the JAX
    file's, parameters and moments bitwise; and the port's soup of two JAX
    files is the JAX soup's parameters."""
    fields = dict(model_type='transformer', attn_impl='flax', d_model=64, num_layers=4,
                  num_heads=4, window_size=20, stride=5, batch_size=BATCH, epochs=1,
                  checkpoint_every_batches=2, seed=3, device_data='off', opt_type='adam',
                  learning_rate=1e-3, log_every_batches=1000)
    jdir = tmp_path / 'jax' / 'transformer'
    jax_train(JaxConfig(checkpoint_dir=str(jdir), **fields), data['jax_train'], None)
    steps = len(data['train']) // BATCH
    assert os.path.exists(jdir / 'epoch_0_batch_2.ckpt') and steps >= 4
    pdir = tmp_path / 'port' / 'transformer'
    assert main(['convert-checkpoint', str(jdir / 'epoch_0_batch_2.ckpt'),
                 '--out-dir', str(pdir)]) == 0
    start = torch.load(pdir / 'epoch_0_batch_2.torch.pt', weights_only=True)
    assert start['opt_type'] == 'adam' and start['step'] == 3
    assert 'blocks.3.attn.out.kernel' in start['model_state_dict']

    def config(d):
        cfg = Config()
        for k, v in dict(fields, checkpoint_dir=str(d), device_chunk_steps=1).items():
            setattr(cfg, k, v)
        return cfg

    with caplog.at_level(logging.WARNING):
        result = train(config(pdir), data['train'], None, device='cpu')
    assert 'WARNING' not in caplog.text, caplog.text
    assert result.windows_seen == (steps - 3) * BATCH
    got = torch.load(pdir / 'epoch_0_batch_0.torch.pt', weights_only=True)
    assert got['step'] == steps
    with open(jdir / 'epoch_0_batch_0.ckpt', 'rb') as f:
        want = weights.params_from_jax('transformer_flax', flax_msgpack.loads(f.read())['params'])
    fresh = tmp_path / 'fresh' / 'transformer'
    os.makedirs(fresh)
    torch.save({k: start[k] for k in ('epoch', 'batch', 'model_state_dict')},
               fresh / 'epoch_0_batch_2.torch.pt')
    train(config(fresh), data['train'], None, device='cpu')
    other = torch.load(fresh / 'epoch_0_batch_0.torch.pt', weights_only=True)
    # not the attention's key biases, whose exact gradient is 0 (the softmax
    # ignores a shift shared by every key: adam moves them by rounding noise
    # alone), nor the heads the loss does not weigh (they do not move)
    errs = np.array([[float((run['model_state_dict'][k] - w).norm()
                            / (w - start['model_state_dict'][k]).norm())
                      for run in (got, other)] for k, w in want.items()
                     if not k.endswith('attn.key.bias')])
    errs = errs[np.isfinite(errs).all(1)]
    assert errs[:, 0].max() < GRAD_REL < np.median(errs[:, 1]), errs
    # back: the converted state as the JAX package writes it
    model = build_model_for_dataset(config(pdir), data['train'])
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'adam', 1e-3))
    assert ckpt.load_checkpoint_file(state, str(jdir / 'epoch_0_batch_2.ckpt')) == (0, 2)
    tree = flax_msgpack.loads(flax_msgpack.dumps(weights.jax_payload(
        model, state.optimizer, 0, 2, step=state.step)))
    with open(jdir / 'epoch_0_batch_2.ckpt', 'rb') as f:
        raw = flax_msgpack.loads(f.read())
    for key in ('params', 'opt_state', 'step'):
        flat_a = dict(jax.tree_util.tree_flatten_with_path(tree[key])[0])
        flat_b = dict(jax.tree_util.tree_flatten_with_path(raw[key])[0])
        assert flat_a.keys() == flat_b.keys(), key
        for path, v in flat_b.items():
            np.testing.assert_array_equal(np.asarray(flat_a[path]), np.asarray(v),
                                          err_msg=f'{key} {path}')
    # soups of the flax tree
    members = [str(jdir / 'epoch_0_batch_2.ckpt'), str(jdir / 'epoch_0_batch_0.ckpt')]
    jax_soup_checkpoints(members, str(tmp_path / 'soup.ckpt'))
    assert main(['convert-checkpoint', *members, '--soup', str(tmp_path / 's.torch.pt')]) == 0
    soup = torch.load(tmp_path / 's.torch.pt', weights_only=True)['model_state_dict']
    with open(tmp_path / 'soup.ckpt', 'rb') as f:
        jsoup = weights.params_from_jax('transformer_flax', flax_msgpack.loads(f.read())['params'])
    for k, v in jsoup.items():
        assert torch.equal(soup[k], v), k
