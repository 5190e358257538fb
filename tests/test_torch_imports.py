"""The port imports no jax, flax, optax or msgpack and nothing of the JAX
package, and never swaps the GPU for the CPU.

Each test runs a fresh interpreter in which ``import jax`` (and jaxlib,
flax, optax, msgpack) fails, as on a machine that has only PyTorch. The JAX
package ``inferbiomechanics_tpu`` is importable there (it lies beside the
port), so that a stray import of it would succeed and show up in
``sys.modules``.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / 'inferbiomechanics_tpu_torch'

_NO_JAX = """
import sys
for name in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack'):
    sys.modules[name] = None        # any import of them raises ImportError

def jax_package_modules():
    return sorted(k for k, v in sys.modules.items() if v is not None and
                  k.split('.')[0] == 'inferbiomechanics_tpu')
"""


def _run(body: str, tmp_path) -> str:
    code = _NO_JAX + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _jax_checkpoint(path: Path) -> None:
    """A JAX package checkpoint of a small feedforward model, written by the
    JAX package in this (the parent) process."""
    import jax
    import jax.numpy as jnp

    from inferbiomechanics_tpu.models import get_model
    from inferbiomechanics_tpu.train.checkpoint import save_checkpoint
    from inferbiomechanics_tpu.train.optimizers import make_optimizer
    from inferbiomechanics_tpu.train.state import create_train_state
    model = get_model('feedforward', num_dofs=23, num_contact_bodies=2, history_len=20,
                      stride=5, root_history_len=10, hidden_dims=(32,))
    state = create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((2, 4, 177)),
                               make_optimizer('rmsprop', 1e-3))
    save_checkpoint(str(path), state, 1, 0)


def test_every_port_module_imports_and_serves_without_jax(tmp_path):
    _jax_checkpoint(tmp_path / 'jax_run')
    out = _run("""
        import importlib, pkgutil
        import numpy as np
        import inferbiomechanics_tpu_torch as port
        names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]
        for name in names:
            importlib.import_module(name)
        print('modules', ' '.join(names))

        import json, threading, urllib.request
        from inferbiomechanics_tpu_torch.config import Config
        from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
        from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
        from inferbiomechanics_tpu_torch.serve import InferenceService, serve
        write_synthetic_subject('s.b3d', num_trials=1, trial_length=60, seed=0)
        ds = WindowDataset('s.b3d', window_size=20, stride=5,
                           skip_loading_skeletons=True)
        x = np.asarray(ds.gather(np.arange(3)).inputs)
        for model_type in ('feedforward', 'groundlink', 'transformer'):
            cfg = Config()
            cfg.model_type, cfg.window_size, cfg.hidden_dims = model_type, 20, [32]
            cfg.d_model, cfg.num_layers, cfg.num_heads = 128, 1, 4
            cfg.fused_inference = model_type == 'transformer'
            svc = InferenceService(cfg, 'ckpt', ds, max_batch=8, device='cpu',
                                   tta_mirror=model_type == 'groundlink')
            server = serve(svc, port=0)
            threading.Thread(target=server.serve_forever, daemon=True).start()
            req = urllib.request.Request(
                f'http://127.0.0.1:{server.server_address[1]}/predict',
                data=json.dumps({'inputs': x.tolist()}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                out = json.loads(r.read())['outputs']
            server.shutdown()
            server.server_close()
            svc.close()
            assert all(np.asarray(v).shape[0] == 3 and np.isfinite(v).all()
                       for v in out.values())
            print('predicted', model_type, len(out))
        cfg = Config()
        cfg.model_type, cfg.window_size, cfg.output_data_format = 'diffusion', 20, 'all_frames'
        cfg.d_model, cfg.num_layers, cfg.num_heads = 128, 1, 4
        cfg.diffusion_timesteps, cfg.fused_inference = 16, True
        svc = InferenceService(cfg, 'ckpt', ds, max_batch=8, device='cpu', sample_steps=2,
                               diffusion_samples=2)
        out, spread = svc.predict_packed(x, with_spread=True)
        assert all(v.shape[0] == 3 and np.isfinite(v).all() for v in out.values())
        assert set(spread) == set(out)
        print('predicted diffusion', len(out))
        # a JAX package checkpoint, converted and served
        from inferbiomechanics_tpu_torch.__main__ import main
        assert main(['convert-checkpoint', 'jax_run', '--out-dir', 'conv/feedforward']) == 0
        cfg = Config()
        cfg.window_size, cfg.hidden_dims = 20, [32]
        svc = InferenceService(cfg, 'conv/feedforward', ds, max_batch=8, device='cpu')
        assert svc.epoch == 1
        out = svc.predict_packed(x)
        assert all(v.shape[0] == 3 and np.isfinite(v).all() for v in out.values())
        print('converted and served', svc.epoch)
        assert all(sys.modules[n] is None for n in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack'))
        assert jax_package_modules() == [], jax_package_modules()
    """, tmp_path)
    for module in ('config', 'data.dataset', 'data.b3d_legacy', 'ops.fused_mlp',
                   'ops.fused_encoder', 'ops.fused_groundlink', 'models.feedforward',
                   'models.groundlink', 'models.transformer', 'serve', 'cli.serve_cmd',
                   'train.augment', 'train.checkpoint', 'weights', '__main__',
                   'ops.losses', 'loss.evaluator', 'train.optimizers', 'train.state',
                   'train.step', 'train.device_data', 'data.loader', 'train.run_config',
                   'train.loop', 'cli.train_cmd', 'cli.analyze_cmd', 'cli.motion',
                   'utils.wandb_compat', 'models.diffusion', 'utils.flax_msgpack',
                   'torch_compat', 'cli.convert_checkpoint_cmd', 'parallel.dist',
                   'parallel.mesh', 'parallel.sharding_rules', 'parallel.pipeline',
                   'train.sharded_data',
                   'train.sweep', 'cli.sweep_cmd', 'ops.quant', 'ops.library', 'inference',
                   'cli.export_cmd', 'cli.save_prediction_csv_cmd', 'viz.ws', 'viz.mesh',
                   'viz.viewer', 'viz.live', 'viz.live_model', 'utils.geometry',
                   'cli.visualize_file_cmd', 'cli.visualize_cmd', 'cli.review_file_cmd',
                   'data.b3d_infer', 'cli.convert_b3d_cmd', 'cli.doctor_cmd',
                   'cli.make_plots_cmd', 'cli.plot_training_cmd', 'utils.png_plot'):
        assert f'inferbiomechanics_tpu_torch.{module}' in out.split()
    assert 'predicted feedforward 4' in out and 'predicted transformer 7' in out
    assert 'predicted groundlink 4' in out and 'predicted diffusion 4' in out
    assert 'converted and served 1' in out


def test_every_port_module_imports_first(tmp_path):
    """Each module of the port imports as the first module of the port in
    its process (no circular import that an earlier import would hide):
    ``train/augment.py`` imported first once failed, because ``models/``,
    which it imported, imports it back."""
    out = _run("""
        import importlib, pkgutil
        import inferbiomechanics_tpu_torch as port
        names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]
        failed = []
        for name in names:
            for k in [k for k in sys.modules if k.startswith('inferbiomechanics_tpu_torch')]:
                del sys.modules[k]
            try:
                importlib.import_module(name)
            except ImportError as e:
                failed.append((name, str(e)))
        assert failed == [], failed
        assert jax_package_modules() == []
        print('imported first', len(names))
    """, tmp_path)
    assert int(out.split()[-1]) > 70


def test_chip_smoke_loads_no_module_of_the_jax_package(tmp_path):
    """Every import that ``chip_smoke.py`` makes, at module level or inside
    its functions, loads no module of the JAX package."""
    out = _run(f"""
        import ast, importlib
        tree = ast.parse(open({str(REPO / 'chip_smoke.py')!r}).read())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                module = importlib.import_module(node.module)
                names.add(node.module)
                for a in node.names:
                    if not hasattr(module, a.name):   # a submodule
                        names.add(f'{{node.module}}.{{a.name}}')
        for name in sorted(names):
            importlib.import_module(name)
        assert 'inferbiomechanics_tpu_torch.serve' in sys.modules
        assert 'inferbiomechanics_tpu_torch.ops.fused_encoder' in sys.modules
        assert 'inferbiomechanics_tpu_torch.ops.fused_groundlink' in sys.modules
        assert 'inferbiomechanics_tpu_torch.models.diffusion' in sys.modules
        assert jax_package_modules() == [], jax_package_modules()
        assert all(sys.modules[n] is None for n in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack'))
        print('imported', ' '.join(sorted(names)))
    """, tmp_path)
    assert 'inferbiomechanics_tpu_torch.data.synthetic' in out.split()


def test_cuda_device_without_a_gpu_raises(tmp_path):
    """``--device cuda`` (the default) fails loudly where there is no GPU;
    nothing falls back to the CPU."""
    out = _run("""
        import torch
        torch.cuda.is_available = lambda: False      # a machine with no GPU
        from inferbiomechanics_tpu_torch.cli.serve_cmd import build_parser, main
        from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
        assert build_parser().parse_args(['serve']).device == 'cuda'
        import os
        os.makedirs('data')
        write_synthetic_subject('data/s.b3d', num_trials=1, trial_length=60, seed=0)
        try:
            main(['serve', '--dataset-home', 'data', '--checkpoint-dir', 'ckpt',
                  '--history-len', '20', '--port', '0'])
        except RuntimeError as e:
            assert 'is_available() is False' in str(e), e
            print('refused')
    """, tmp_path)
    assert 'refused' in out


def test_every_command_defaults_to_cuda_and_refuses_without_a_gpu(tmp_path):
    """Each command of ``python -m inferbiomechanics_tpu_torch`` that runs a
    model takes ``--device``, defaults it to ``cuda``, and raises on a
    machine with no GPU instead of carrying on on the CPU
    (``convert-checkpoint``, ``pickle-data``, ``create-splits``,
    ``sanity-check``, ``convert-b3d``, ``make-plots`` and ``plot-training``
    run no model and take no device); ``doctor`` defaults to ``cuda`` too,
    and there exits 1 naming the missing device, with no probe run on the
    CPU."""
    out = _run("""
        import os, torch
        torch.cuda.is_available = lambda: False      # a machine with no GPU
        from inferbiomechanics_tpu_torch.__main__ import COMMANDS, build_parser, main
        from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
        for split in ('train', 'dev'):
            os.makedirs(f'data/{split}')
            write_synthetic_subject(f'data/{split}/s.b3d', num_trials=1, trial_length=60,
                                    seed=0)
        home = ['--dataset-home', 'data', '--checkpoint-dir', 'ckpt']
        file = ['--file', 'data/dev/s.b3d', '--checkpoint-dir', 'ckpt']
        argvs = {'serve': home + ['--port', '0'], 'train': home + ['--epochs', '1'],
                 'analyze': home, 'sweep': home + ['--epochs', '1'],
                 'export': home + ['--out', 'm.pt2'], 'save-prediction-csv': file,
                 'visualize-file': file, 'review-file': file, 'visualize': home}
        host = {'convert-checkpoint': ['ckpt', '--out-dir', 'x'], 'pickle-data': [],
                'create-splits': [], 'sanity-check': [], 'convert-b3d': ['data'],
                'make-plots': [], 'plot-training': []}
        assert sorted(argvs) == sorted(set(COMMANDS) - set(host) - {'doctor'})
        import contextlib, io, json
        assert build_parser().parse_args(['doctor']).device == 'cuda'
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(['doctor', '--json']) == 1
        report = json.loads(next(l for l in out.getvalue().splitlines() if l.startswith('{')))
        assert 'is_available() is False' in report['degraded'][0], report
        assert report['probes'] == {} and 'k1' not in report
        print('refused doctor')
        for cmd, argv in host.items():
            assert not hasattr(build_parser().parse_args([cmd, *argv]), 'device'), cmd
        for cmd, argv in argvs.items():
            argv = [cmd, *argv, '--history-len', '20', '--hidden-dims', '32']
            assert build_parser().parse_args(argv).device == 'cuda', cmd
            try:
                main(argv)
            except RuntimeError as e:
                assert 'is_available() is False' in str(e), (cmd, e)
                print('refused', cmd)
    """, tmp_path)
    assert out.split().count('refused') == 10


def test_port_sources_name_no_jax_import():
    """No import line of the port or of ``chip_smoke.py`` names jax, jaxlib,
    flax, optax, msgpack or the JAX package."""
    pattern = re.compile(
        r'^\s*(import|from)\s+(jax|jaxlib|flax|optax|msgpack|inferbiomechanics_tpu)(\.|\s|$)',
        re.M)
    sources = sorted(PORT.rglob('*.py')) + [REPO / 'chip_smoke.py']
    assert len(sources) > 20
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []
    assert pattern.search('    from inferbiomechanics_tpu.data import keys')
    assert not pattern.search('from inferbiomechanics_tpu_torch.data import keys')
    assert not (PORT / 'shared.py').exists()
