"""The port's pre-materialized blocks (``data/pickled.py``, the
``pickle-data`` command) and ``train --use-pickled`` against the JAX
package's, in this process on the CPU.

One synthetic subject a split (two 150-frame trials in train, 258 windows
at window 20 / stride 5; one in dev). Blocks cross both ways: the JAX
command's blocks read by the port's ``PickledDataset`` and the port's read
by the JAX package's, each array and each metadata field exactly (both
sides are the same numpy code). ``train --use-pickled --device cpu`` is
held bitwise to the ``.b3d`` run of the same flags on every data tier the
JAX loop takes it on; the loop's needs a ``PickledDataset`` cannot meet get
the JAX package's answers or refusals. Three RMSprop steps from converted
weights are held to the JAX ``TrainCommand --use-pickled`` at the f32
tolerances (rtol 1e-4 / atol 1e-5). No test reaches ``urlretrieve``: it is
replaced by one that raises.
"""

import argparse
import contextlib
import functools
import io
import os
import shutil
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.cli import pickle_data_cmd as jax_pickle_cmd
from inferbiomechanics_tpu.cli.train_cmd import TrainCommand
from inferbiomechanics_tpu.data.pickled import PickledDataset as JaxPickledDataset
from inferbiomechanics_tpu.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu.train import loop as jax_loop
from inferbiomechanics_tpu_torch import weights
from inferbiomechanics_tpu_torch.__main__ import main
from inferbiomechanics_tpu_torch.cli import pickle_data_cmd
from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.pickled import PickledDataset
from inferbiomechanics_tpu_torch.models import feedforward
from inferbiomechanics_tpu_torch.train import checkpoint as ckpt
from inferbiomechanics_tpu_torch.train import loop

HISTORY = ['--history-len', '20', '--stride', '5']
BATCH = 16
ARRAYS = ('features_all', 'labels_all', 'trial_row_offset', 'win_ft', 'win_subject',
          'win_trial', 'win_start')
FIELDS = ('window_size', 'stride', 'num_dofs', 'root_history_len', 'num_contact_bodies',
          'output_data_format', 'num_input_channels', 'num_label_channels',
          'num_model_frames', 'num_output_frames', 'contact_bodies', 'in_offsets',
          'lab_offsets')


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_download(monkeypatch):
    def refuse(*a, **kw):
        raise OSError('no network in tests')
    monkeypatch.setattr(urllib.request, 'urlretrieve', refuse)


def _home(root, trials=2, subjects=1):
    for split, n, seed in (('train', trials, 0), ('dev', 1, 1)):
        os.makedirs(root / split, exist_ok=True)
        for s in range(subjects):
            write_synthetic_subject(str(root / split / f's{s}.b3d'), num_trials=n,
                                    trial_length=150, seed=seed + 10 * s)
    return root


def _pickle(package: str, home) -> None:
    """``pickle-data`` of one package over ``home``, quietly."""
    with contextlib.redirect_stdout(io.StringIO()):
        if package == 'jax':
            args = argparse.Namespace(command='pickle-data', dataset_home=str(home),
                                      history_len=20, stride=5, geometry_folder='')
            assert jax_pickle_cmd.PickleDataCommand().run(args)
        else:
            assert main(['pickle-data', '--dataset-home', str(home), *HISTORY]) == 0


@pytest.fixture(scope='module')
def homes(tmp_path_factory):
    """A dataset home a package's ``pickle-data`` ran over."""
    out = {}
    for package in ('jax', 'port'):
        home = _home(tmp_path_factory.mktemp(f'pickled_{package}'))
        _pickle(package, home)
        out[package] = home
    return out


def _assert_same(got, want) -> None:
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    assert [tuple(e) for e in got.in_layout] == [tuple(e) for e in want.in_layout]
    assert [tuple(e) for e in got.lab_layout] == [tuple(e) for e in want.lab_layout]
    idx = np.arange(0, len(want), 5)
    for split in (got.gather(idx), want.gather(idx)):
        assert split.inputs.shape == (idx.size, 4, got.num_input_channels)
    gb, wb = got.gather(idx), want.gather(idx)
    for name in ('inputs', 'labels', 'subject_indices', 'trial_indices'):
        np.testing.assert_array_equal(getattr(gb, name), getattr(wb, name), err_msg=name)


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_blocks_read_both_ways(homes, writer):
    """The blocks one package wrote read the same through both packages'
    ``PickledDataset``, for both splits, the metadata adopted."""
    for split in ('train', 'dev'):
        d = str(homes[writer] / f'{split}_pickled')
        got, want = PickledDataset(d), JaxPickledDataset(d)
        _assert_same(got, want)
        assert (got.num_dofs, got.window_size, got.stride) == (23, 20, 5)
    # the two writers' blocks hold the same arrays
    for name in ('train_0.npz',):
        a, b = (np.load(homes[p] / 'train_pickled' / name) for p in ('jax', 'port'))
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_multi_block_order(tmp_path, monkeypatch):
    """Blocks of 7 windows (37 of them for the train split's 258): both
    readers put block 10 after block 9, not after block 1, and the table is
    the dataset's in order; block 0 alone holds the packed matrices."""
    monkeypatch.setattr(pickle_data_cmd, 'BLOCK', 7)
    monkeypatch.setattr(jax_pickle_cmd, 'BLOCK', 7)
    for package in ('jax', 'port'):
        home = _home(tmp_path / package)
        _pickle(package, home)
        d = home / 'train_pickled'
        assert len(list(d.glob('*.npz'))) == 37
        assert 'features_all' in np.load(d / 'train_0.npz').files
        assert 'features_all' not in np.load(d / 'train_10.npz').files
        ref = WindowDataset(str(home / 'train'), window_size=20, stride=5,
                            skip_loading_skeletons=True)
        got, want = PickledDataset(str(d)), JaxPickledDataset(str(d))
        _assert_same(got, want)
        for name in ARRAYS:
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)


def test_metadata_mismatch_and_pre_metadata_blocks(homes, tmp_path):
    """A stated layout that disagrees with the stored one raises the JAX
    package's ValueError, word for word; blocks without metadata fall back
    to 23 / 10 / 2 in both packages."""
    d = str(homes['port'] / 'train_pickled')
    messages = []
    for cls in (PickledDataset, JaxPickledDataset):
        with pytest.raises(ValueError) as e:
            cls(d, num_dofs=22)
        messages.append(str(e.value))
    assert messages[0] == messages[1] == (f'{d}/train_0.npz: stored num_dofs=23 does not '
                                          f'match requested num_dofs=22')
    _assert_same(PickledDataset(d, num_dofs=23, root_history_len=10),
                 JaxPickledDataset(d, num_dofs=23, root_history_len=10))
    old = tmp_path / 'old_pickled'
    old.mkdir()
    z = np.load(os.path.join(d, 'train_0.npz'))
    keep = {k: z[k] for k in z.files if k not in ('num_dofs', 'root_history_len',
                                                   'num_contact_bodies', 'output_data_format')}
    np.savez_compressed(old / 'train_0.npz', **keep)
    got, want = PickledDataset(str(old)), JaxPickledDataset(str(old))
    _assert_same(got, want)
    assert (got.num_dofs, got.root_history_len, got.num_contact_bodies) == (23, 10, 2)
    with pytest.raises(FileNotFoundError, match='no .npz blocks'):
        PickledDataset(str(tmp_path))


def _train(home, ckpt_dir, *more):
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(['train', '--dataset-home', str(home), '--checkpoint-dir', str(ckpt_dir),
                     *HISTORY, '--batch-size', str(BATCH), '--hidden-dims', '32',
                     '--epochs', '2', '--device', 'cpu', '--no-wandb', '--geometry-folder',
                     str(ckpt_dir), *more]) == 0


def _payloads(d):
    files = ckpt.list_checkpoints(str(d / 'feedforward'))
    return [(f[:2], torch.load(f[2], weights_only=True)) for f in files]


def _assert_bitwise(a, b) -> None:
    pa, pb = _payloads(a), _payloads(b)
    assert [p[0] for p in pa] == [p[0] for p in pb] and pa
    for (_, x), (_, y) in zip(pa, pb):
        for part in ('model_state_dict', 'optimizer_state_dict'):
            flat_x = jax.tree_util.tree_leaves(x[part])
            flat_y = jax.tree_util.tree_leaves(y[part])
            assert len(flat_x) == len(flat_y) > 0
            for u, v in zip(flat_x, flat_y):
                assert (torch.equal(u, v) if torch.is_tensor(u) else u == v), part


@pytest.mark.parametrize('tier', ['on', 'off', 'stream', 'sharded'])
def test_use_pickled_trains_bitwise_the_b3d_run(homes, tmp_path, tier):
    """``--use-pickled`` on each data tier: the checkpoints of every epoch
    (parameters and optimizer state) bitwise those of the run on the
    ``.b3d`` files with the same flags and seed; the window size and stride
    come from the blocks."""
    home = homes['port']
    more = ['--device-data', tier]
    if tier == 'stream':
        more += ['--device-data-max-bytes', '200000']     # two segments
    _train(home, tmp_path / 'pickled', *more, '--use-pickled', '--history-len', '50')
    _train(home, tmp_path / 'b3d', *more)
    _assert_bitwise(tmp_path / 'pickled', tmp_path / 'b3d')


def test_use_pickled_without_dev_blocks_trains_without_dev(homes, tmp_path):
    """No ``dev_pickled/``: no dev split, as the JAX command's
    FileNotFoundError fallback."""
    home = _home(tmp_path / 'home')
    _pickle('port', home)
    shutil.rmtree(home / 'dev_pickled')
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(['train', '--dataset-home', str(home), '--checkpoint-dir',
                     str(tmp_path / 'c'), '--batch-size', str(BATCH), '--hidden-dims', '32',
                     '--epochs', '1', '--device', 'cpu', '--no-wandb', '--use-pickled',
                     '--geometry-folder', str(tmp_path)]) == 0
    assert 'dev report' not in out.getvalue() and 'Training done: 1 epochs' in out.getvalue()


def test_what_a_pickled_dataset_lacks(homes, tmp_path):
    """A ``PickledDataset`` has no subjects and no skeletons. Augmentation
    needs subject 0's header for its mirror spec: both packages refuse in
    the JAX words. The torque report falls back to the standard skeleton at
    70 kg for every window (the JAX gather clamps to the one mass): the port
    reports a finite value."""
    d = str(homes['port'] / 'train_pickled')
    from inferbiomechanics_tpu.train.augment import spec_from_dataset as jax_spec
    from inferbiomechanics_tpu_torch.train.augment import spec_from_dataset
    messages = []
    for spec in (jax_spec, spec_from_dataset):
        with pytest.raises(ValueError) as e:
            spec(JaxPickledDataset(d) if spec is jax_spec else PickledDataset(d))
        messages.append(str(e.value))
    assert messages[0] == messages[1] == 'empty dataset: cannot derive a mirror spec'
    with pytest.raises(ValueError, match='empty dataset: cannot derive a mirror spec'):
        _train(homes['port'], tmp_path / 'aug', '--use-pickled', '--augment-mirror')
    from inferbiomechanics_tpu_torch.loss.tau_report import make_tau_report_fn
    two = _home(tmp_path / 'two', trials=1, subjects=2)
    _pickle('port', two)
    ds = PickledDataset(str(two / 'train_pickled'))
    batch = ds.gather(np.arange(len(ds) // 2 - 4, len(ds) // 2 + 4))
    assert set(batch.subject_indices.tolist()) == {0, 1}
    tau = make_tau_report_fn(ds, 'cpu')
    labels = {k: torch.from_numpy(v) for k, v in ds.unpack_labels(batch.labels).items()}
    got = tau(torch.from_numpy(batch.inputs), labels, labels, batch.subject_indices)
    assert np.isfinite(got)
    assert got == tau(torch.from_numpy(batch.inputs), labels, labels, None)


def test_three_steps_track_the_jax_train_command(tmp_path, monkeypatch):
    """``train --use-pickled`` of both packages over the same blocks (one
    split of 129 windows: 3 steps of 40 at RMSprop 1e-4), from the same
    weights: the trained parameters within rtol 1e-4 / atol 1e-5. Both
    feedforward models compute in float32 here (their bf16 default rounds
    where XLA and PyTorch sum in different orders; ``test_torch_train.py``
    holds the bf16 steps at 2e-2)."""
    home = _home(tmp_path / 'home', trials=1)
    _pickle('port', home)
    shutil.rmtree(home / 'dev_pickled')      # no dev evaluation to compile
    flags = ['--dataset-home', str(home), '--batch-size', '40', '--hidden-dims', '32',
             '--epochs', '1', '--no-wandb', '--use-pickled', '--geometry-folder',
             str(tmp_path)]
    start = {}
    make_state = jax_loop.create_train_state

    def capture(*args, **kw):
        state = make_state(*args, **kw)
        start['params'] = jax.device_get(state.params)
        return state

    monkeypatch.setattr(jax_loop, 'create_train_state', capture)
    jax_build = jax_loop.build_model_for_dataset
    monkeypatch.setattr(jax_loop, 'build_model_for_dataset', lambda *a, **kw: jax_build(
        *a, **kw).clone(compute_dtype=jnp.float32))
    monkeypatch.setattr(feedforward, 'mlp_reference', functools.partial(
        feedforward.mlp_reference, compute_dtype=torch.float32))
    parser = argparse.ArgumentParser()
    TrainCommand().register_subcommand(parser.add_subparsers(dest='command'))
    with contextlib.redirect_stdout(io.StringIO()):
        assert TrainCommand().run(parser.parse_args(
            ['train', *flags, '--checkpoint-dir', str(tmp_path / 'jax')]))

    build = loop.build_model_for_dataset

    def with_jax_weights(*args, **kw):
        model = build(*args, **kw)
        model.load_state_dict(weights.feedforward_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, start['params'])))
        return model

    monkeypatch.setattr(loop, 'build_model_for_dataset', with_jax_weights)
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(['train', *flags, '--checkpoint-dir', str(tmp_path / 'port'),
                     '--device', 'cpu']) == 0
    ds = PickledDataset(str(home / 'train_pickled'))
    assert len(ds) // 40 == 3
    cfg = Config()
    cfg.hidden_dims, cfg.window_size, cfg.stride = [32], 20, 5
    got, epoch, _ = ckpt.load_model(cfg, ds, str(tmp_path / 'port' / 'feedforward'),
                                    device='cpu')
    want, jax_epoch, _ = ckpt.load_model(
        cfg, ds, checkpoint_file=str(tmp_path / 'jax' / 'feedforward' / 'epoch_0_batch_0.ckpt'),
        device='cpu')
    assert epoch == jax_epoch == 0
    start_sd = weights.feedforward_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, start['params']))
    moved = 0
    for name, w in want.state_dict().items():
        np.testing.assert_allclose(got.state_dict()[name].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        moved += int(not torch.equal(w, start_sd[name]))
    assert moved == len(start_sd)


def test_copies_are_the_originals():
    """``data/pickled.py`` is the JAX file but for its import of the
    dataset's helpers; ``utils/gitinfo.py`` is the JAX file, and gives the
    same answers."""
    from pathlib import Path

    from inferbiomechanics_tpu.data import pickled as jax_pickled
    from inferbiomechanics_tpu.utils import gitinfo as jax_gitinfo
    from inferbiomechanics_tpu_torch.data import pickled as port_pickled
    from inferbiomechanics_tpu_torch.utils import gitinfo
    jax_text = Path(jax_pickled.__file__).read_text().replace(
        'from inferbiomechanics_tpu.data.dataset import WindowDataset, input_layout, '
        'label_layout, _offsets',
        'from inferbiomechanics_tpu_torch.data.dataset import (\n'
        '    WindowDataset, _offsets, input_layout, label_layout,\n)')
    assert Path(port_pickled.__file__).read_text() == jax_text
    assert Path(gitinfo.__file__).read_text() == Path(jax_gitinfo.__file__).read_text()
    assert gitinfo.get_git_hash() == jax_gitinfo.get_git_hash()
    assert gitinfo.has_uncommitted_changes() == jax_gitinfo.has_uncommitted_changes()

