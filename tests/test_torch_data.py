"""The port's own copies of the config schema and the data layer
(inferbiomechanics_tpu_torch/config.py, data/) against the JAX package's
(inferbiomechanics_tpu/config.py, data/): the same synthetic subject gives
identical arrays and layouts through both, and both flag parsers agree
field by field. Exact equality: both sides are the same numpy code. The
port's copy of the mirror tables (train/augment.py) is held the same way,
and so are the copies ``analyze`` needs: ``utils/wandb_compat.py`` and the
motion classes of make-plots (``cli/motion.py``).
"""

import argparse
import dataclasses

import numpy as np
import pytest

from inferbiomechanics_tpu import config as jax_config
from inferbiomechanics_tpu.data import dataset as jax_dataset
from inferbiomechanics_tpu.data import keys as jax_keys
from inferbiomechanics_tpu.data import synthetic as jax_synthetic
from inferbiomechanics_tpu.train import augment as jax_augment
from inferbiomechanics_tpu_torch import config as port_config
from inferbiomechanics_tpu_torch.data import dataset as port_dataset
from inferbiomechanics_tpu_torch.data import keys as port_keys
from inferbiomechanics_tpu_torch.data import synthetic as port_synthetic
from inferbiomechanics_tpu_torch.train import augment as port_augment


@pytest.fixture(scope='module')
def subjects(tmp_path_factory):
    root = tmp_path_factory.mktemp('torchdata')
    paths = {}
    for name, module in (('jax', jax_synthetic), ('port', port_synthetic)):
        (root / name).mkdir()
        paths[name] = str(root / name / 's.b3d')
        module.write_synthetic_subject(paths[name], num_trials=2,
                                       trial_length=90, seed=3)
    return paths


def test_synthetic_subject_files_are_identical(subjects):
    with open(subjects['jax'], 'rb') as a, open(subjects['port'], 'rb') as b:
        assert a.read() == b.read()


@pytest.mark.parametrize('fmt', ['last_frame', 'all_frames'])
@pytest.mark.parametrize('window,stride', [(50, 5), (20, 5)])
def test_window_datasets_agree(subjects, window, stride, fmt):
    """One file, opened by both packages' WindowDataset."""
    kwargs = dict(window_size=window, stride=stride, output_data_format=fmt,
                  skip_loading_skeletons=True)
    jd = jax_dataset.WindowDataset(subjects['jax'], **kwargs)
    pd = port_dataset.WindowDataset(subjects['jax'], **kwargs)
    assert len(pd) == len(jd) > 0
    for name in ('num_dofs', 'num_contact_bodies', 'root_history_len',
                 'num_model_frames', 'num_input_channels', 'window_size', 'stride'):
        assert getattr(pd, name) == getattr(jd, name), name
    assert list(pd.contact_bodies) == list(jd.contact_bodies)
    assert [tuple(e) for e in pd.in_layout] == [tuple(e) for e in jd.in_layout]
    assert [tuple(e) for e in pd.lab_layout] == [tuple(e) for e in jd.lab_layout]
    for name in ('win_subject', 'win_trial', 'win_start'):
        np.testing.assert_array_equal(getattr(pd, name), getattr(jd, name))
    idx = np.arange(0, len(jd), 3)
    jb, pb = jd.gather(idx), pd.gather(idx)
    np.testing.assert_array_equal(np.asarray(pb.inputs), np.asarray(jb.inputs))
    np.testing.assert_array_equal(np.asarray(pb.labels), np.asarray(jb.labels))


def test_input_layout_and_keys_agree():
    for dofs, root in ((23, 10), (37, 5)):
        assert port_dataset.input_layout(dofs, root) == jax_dataset.input_layout(dofs, root)
    assert port_keys.INPUT_CONCAT_ORDER == jax_keys.INPUT_CONCAT_ORDER
    for cls in ('InputDataKeys', 'OutputDataKeys'):
        a, b = getattr(port_keys, cls), getattr(jax_keys, cls)
        assert ({k: v for k, v in vars(a).items() if not k.startswith('_')}
                == {k: v for k, v in vars(b).items() if not k.startswith('_')})


def test_config_defaults_agree_field_by_field():
    jc, pc = jax_config.Config(), port_config.Config()
    jf = {f.name: f.type for f in dataclasses.fields(jc)}
    pf = {f.name: f.type for f in dataclasses.fields(pc)}
    assert pf == jf
    for name in jf:
        assert getattr(pc, name) == getattr(jc, name), name
    assert (pc.model_type, pc.d_model, pc.num_layers, pc.num_heads,
            pc.attn_impl, pc.fused_inference) == ('feedforward', 256, 4, 8, 'vpu', False)


def _parser(module):
    parser = argparse.ArgumentParser()
    module.add_config_flags(parser)
    return parser


def test_flag_parsers_declare_the_same_flags():
    def flags(parser):
        return {tuple(a.option_strings): (a.dest, a.default, a.nargs, a.type,
                                          tuple(a.choices) if a.choices else None,
                                          type(a).__name__)
                for a in parser._actions}
    assert flags(_parser(port_config)) == flags(_parser(jax_config))


@pytest.mark.parametrize('argv', [
    [],
    ['--model-type', 'transformer', '--fused-inference', '--d-model', '128',
     '--num-layers', '2', '--num-heads', '4', '--history-len', '20', '--stride', '5'],
    ['--hidden-dims', '64', '32', '--activation', 'relu', '--output-data-format',
     'all_frames', '--dataset-home', 'D', '--checkpoint-dir', 'C', '--short'],
])
def test_config_from_args_agrees(argv):
    jc = jax_config.config_from_args(_parser(jax_config).parse_args(argv))
    pc = port_config.config_from_args(_parser(port_config).parse_args(argv))
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)


def _assert_specs_equal(ps, js):
    for name in ('in_perm', 'in_sign', 'lab_perm', 'lab_sign'):
        a, b = getattr(ps, name), getattr(js, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ps.approximate_dofs == js.approximate_dofs
    assert ps.unpaired_names == js.unpaired_names


@pytest.mark.parametrize('lateral_axis', [0, 1, 2])
@pytest.mark.parametrize('skeletons', [True, False])
def test_mirror_spec_from_dataset_agrees(subjects, lateral_axis, skeletons):
    kwargs = dict(window_size=20, stride=5, skip_loading_skeletons=not skeletons)
    jd = jax_dataset.WindowDataset(subjects['jax'], **kwargs)
    pd = port_dataset.WindowDataset(subjects['jax'], **kwargs)
    js = jax_augment.spec_from_dataset(jd, lateral_axis=lateral_axis)
    ps = port_augment.spec_from_dataset(pd, lateral_axis=lateral_axis)
    _assert_specs_equal(ps, js)
    assert len(ps.in_perm) == pd.num_input_channels
    # an involution, as the JAX package's
    x = np.random.default_rng(0).normal(size=(3, 4, len(ps.in_perm))).astype(np.float32)
    np.testing.assert_array_equal(ps.mirror_inputs(ps.mirror_inputs(x)), x)
    np.testing.assert_array_equal(ps.mirror_inputs(x), js.mirror_inputs(x))


def test_build_mirror_spec_agrees_on_opensim_names():
    """Semantic DOF names, an unpaired body and a short joint list."""
    dofs = ['pelvis_tilt', 'pelvis_list', 'pelvis_rotation', 'pelvis_tx', 'pelvis_tz',
            'hip_flexion_r', 'hip_adduction_r', 'hip_flexion_l', 'hip_adduction_l',
            'knee_angle_r', 'lumbar_bending', 'ankle_r_x', 'ankle_l_x', 'ankle_l_y']
    joints = ['hip_r', 'hip_l', 'knee_r', 'walker_knee_l', 'back']
    args = (dofs, joints, ['calcn_r', 'calcn_l'], 5)
    for axis in (0, 2):
        ps = port_augment.build_mirror_spec(*args, lateral_axis=axis)
        _assert_specs_equal(ps, jax_augment.build_mirror_spec(*args, lateral_axis=axis))
    assert ps.unpaired_names
    for module in (port_augment, jax_augment):
        with pytest.raises(ValueError, match='lateral_axis'):
            module.build_mirror_spec(*args, lateral_axis=3)


def test_mirror_outputs_and_tta_average_agree():
    """The torch ``mirror_outputs`` / ``tta_average`` against the JAX ones
    on the same arrays."""
    import jax.numpy as jnp
    import torch
    args = (['hip_r_x', 'hip_l_x', 'pelvis_tz', 'knee_angle_r', 'knee_angle_l'],
            ['hip_r', 'hip_l'], ['calcn_r', 'calcn_l'], 3)
    ps, js = port_augment.build_mirror_spec(*args), jax_augment.build_mirror_spec(*args)
    offsets = port_dataset._offsets(port_dataset.label_layout(5, 2))
    assert offsets == jax_dataset._offsets(jax_dataset.label_layout(5, 2))
    rng = np.random.default_rng(1)
    keys = [port_keys.OutputDataKeys.GROUND_CONTACT_FORCES_IN_ROOT_FRAME,
            port_keys.OutputDataKeys.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME,
            port_keys.OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME]
    outs = {k: rng.normal(size=(4, 2, offsets[k][1])).astype(np.float32) for k in keys}
    want = jax_augment.mirror_outputs(js, offsets, {k: jnp.asarray(v) for k, v in outs.items()})
    got = port_augment.mirror_outputs(ps, offsets, {k: torch.from_numpy(v) for k, v in outs.items()})
    assert list(got) == list(want)
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

    w = rng.normal(size=(len(ps.in_perm), 6)).astype(np.float32)
    force = keys[0]
    x = rng.normal(size=(4, 2, len(ps.in_perm))).astype(np.float32)
    want = jax_augment.tta_average(js, offsets, lambda s, v: {force: s * (v @ w)})(
        2.0, jnp.asarray(x))
    got = port_augment.tta_average(ps, offsets, lambda s, v: {force: s * (v @ torch.from_numpy(w))})(
        2.0, torch.from_numpy(x))
    np.testing.assert_allclose(got[force].numpy(), np.asarray(want[force]), rtol=1e-5, atol=1e-5)


def test_metric_logger_copy_is_the_original(tmp_path):
    """``utils/wandb_compat.py`` is the original file, and logs the same
    lines."""
    from pathlib import Path

    from inferbiomechanics_tpu.utils import wandb_compat as jax_wandb
    from inferbiomechanics_tpu_torch.utils import wandb_compat as port_wandb
    assert Path(port_wandb.__file__).read_text() == Path(jax_wandb.__file__).read_text()
    for module, name in ((jax_wandb, 'jax'), (port_wandb, 'port')):
        off = module.MetricLogger(enabled=False)
        off.log({'a': 1.0})
        off.finish()
        assert off.backend == 'disabled'
        (tmp_path / name).mkdir()
        on = module.MetricLogger(config={'x': 1}, log_dir=str(tmp_path / name))
        on.log({'dev/loss': 0.5, 'obj': object})
        on.finish()
    if on.backend == 'jsonl':
        lines = [[line for line in next((tmp_path / n).iterdir()).read_text().splitlines()
                  if '_config' not in line] for n in ('jax', 'port')]
        assert lines[0] == lines[1] and len(lines[0]) == 1


@pytest.mark.parametrize('name', ['Walking_01', 'treadmill run', 'STS_2', 'stair ascent',
                                  'drop jump', 'trial_0', 'Jogging', 'static', ''])
def test_motion_classes_copy_agrees(name):
    from inferbiomechanics_tpu.cli import make_plots_cmd
    from inferbiomechanics_tpu_torch.cli import motion
    assert motion.MOTION_CLASSES == make_plots_cmd.MOTION_CLASSES
    assert motion.classify_motion(name) == make_plots_cmd.classify_motion(name)


def test_b3d_infer_copy_is_the_original():
    """``data/b3d_infer.py`` is the JAX module's code: every function the
    same source, once the port's reads of the built-in tables through
    ``b3d_legacy`` when called are written back as the original's names
    bound at import (``tests/test_torch_b3d_infer.py`` holds the reports)."""
    import inspect

    from inferbiomechanics_tpu.data import b3d_infer as jax_infer
    from inferbiomechanics_tpu_torch.data import b3d_infer as port_infer

    def functions(module):
        return {name: inspect.getsource(f) for name, f in vars(module).items()
                if inspect.isfunction(f) and f.__module__ == module.__name__}

    want, got = functions(jax_infer), functions(port_infer)
    assert sorted(got) == sorted(want) and 'infer_legacy_schema' in got
    for name, source in got.items():
        source = source.replace('    _PF = _legacy._PF\n', '')
        for table in ('_H', '_TH', '_F', '_PF'):
            source = source.replace(f'_legacy.{table},', f'{table},')
        assert source == want[name], name
