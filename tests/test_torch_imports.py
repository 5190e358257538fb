"""The port imports no jax, flax or optax, and never swaps the GPU for the CPU.

Each test runs a fresh interpreter in which ``import jax`` (and flax,
optax) fails, as on a machine that has only PyTorch.
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
for name in ('jax', 'jaxlib', 'flax', 'optax'):
    sys.modules[name] = None        # any import of them raises ImportError
"""


def _run(body: str, tmp_path) -> str:
    code = _NO_JAX + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_every_port_module_imports_and_serves_without_jax(tmp_path):
    out = _run("""
        import importlib, pkgutil
        import numpy as np
        import inferbiomechanics_tpu_torch as port
        names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]
        for name in names:
            importlib.import_module(name)
        print('modules', ' '.join(names))

        from inferbiomechanics_tpu_torch.serve import InferenceService
        from inferbiomechanics_tpu_torch.shared import (
            Config, WindowDataset, write_synthetic_subject)
        write_synthetic_subject('s.b3d', num_trials=1, trial_length=60, seed=0)
        cfg = Config()
        cfg.window_size, cfg.hidden_dims = 20, [32]
        ds = WindowDataset('s.b3d', window_size=20, stride=5,
                           skip_loading_skeletons=True)
        svc = InferenceService(cfg, 'ckpt', ds, max_batch=8, device='cpu')
        out = svc.predict(np.asarray(ds.gather(np.arange(3)).inputs))
        assert all(v.shape[0] == 3 and np.isfinite(v).all() for v in out.values())
        assert sys.modules['jax'] is None and sys.modules['flax'] is None
        from inferbiomechanics_tpu_torch.shared import JAX_FREE_MODULES
        loaded = {k for k, v in sys.modules.items() if v is not None and
                  k.split('.')[0] == 'inferbiomechanics_tpu'}
        assert loaded <= JAX_FREE_MODULES, sorted(loaded - JAX_FREE_MODULES)
        print('predicted', sorted(out))
    """, tmp_path)
    for module in ('ops.fused_mlp', 'models.feedforward', 'serve', 'cli.serve_cmd',
                   'train.checkpoint', 'weights', '__main__'):
        assert f'inferbiomechanics_tpu_torch.{module}' in out
    assert 'predicted' in out


def test_chip_smoke_loads_only_jax_free_modules_of_the_jax_package(tmp_path):
    """Every import that ``chip_smoke.py`` makes, at module level or inside
    its functions, loads no module of the JAX package beyond the jax-free
    ones that the port shares (``shared.JAX_FREE_MODULES``)."""
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
        from inferbiomechanics_tpu_torch.shared import JAX_FREE_MODULES
        loaded = {{k for k, v in sys.modules.items() if v is not None and
                  k.split('.')[0] == 'inferbiomechanics_tpu'}}
        assert 'inferbiomechanics_tpu_torch.serve' in sys.modules
        assert loaded <= JAX_FREE_MODULES, sorted(loaded - JAX_FREE_MODULES)
        assert all(sys.modules[n] is None for n in ('jax', 'flax', 'optax'))
        print('loaded', ' '.join(sorted(loaded)))
    """, tmp_path)
    assert 'inferbiomechanics_tpu.serve' in out


def test_cuda_device_without_a_gpu_raises(tmp_path):
    """``--device cuda`` (the default) fails loudly where there is no GPU;
    nothing falls back to the CPU."""
    out = _run("""
        import torch
        torch.cuda.is_available = lambda: False      # a machine with no GPU
        from inferbiomechanics_tpu_torch.cli.serve_cmd import build_parser, main
        from inferbiomechanics_tpu_torch.shared import write_synthetic_subject
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


def test_port_sources_name_no_jax_import():
    pattern = re.compile(r'^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b', re.M)
    offenders = [str(p.relative_to(REPO)) for p in PORT.rglob('*.py')
                 if pattern.search(p.read_text())]
    assert offenders == []
    chip_smoke = (REPO / 'chip_smoke.py').read_text()
    assert not pattern.search(chip_smoke)
    assert not re.search(r'^\s*(import|from)\s+inferbiomechanics_tpu\b(?!_torch)',
                         chip_smoke, re.M)
