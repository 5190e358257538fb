"""Split a whole-run difference between the port's quality studies and the
JAX package's into the training arithmetic and the initial weights, on the
CPU at the study's full size.

For one family and seed, both sides train on the study split's batches for
``--epochs`` epochs from the same initial weights, twice:

- from the JAX package's initial weights (``create_train_state`` with
  ``PRNGKey(seed)``, as ``scripts/parity_rmse.py::run_jax`` makes them):
  ``run_jax`` against the port's ``run_port(init_params=...)``;
- from the port's (a torch generator seeded by ``seed``, as ``run_port``
  makes them): ``run_jax`` with its ``create_train_state`` handed those
  weights against ``run_port``.

If each pair agrees to the bf16 tolerance while the two pairs differ, the
study's difference comes from the initial draws and not from the port's
training. GroundLink's dropout masks are drawn by each side from its own
stream in both pairs (the feed of JAX's masks is held in
``tests/test_torch_quality_parity.py``); use it for the deterministic
families. ``--attn-impl pallas`` trains the port's ``pallas`` transformer
(on the CPU, K3's plain version) against the JAX study's ``vpu`` model,
the same function: the ``vpu`` tree crosses into the ``pallas`` model and
back through ``weights.py``.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_parity_split.py --family transformer \\
        --seed 1 --epochs 3 --data /tmp/ib_study --out docs/port_parity/split_transformer_seed1.json

``--write-inits DIR --seeds 0 1 ...`` writes the JAX package's initial
weights of each seed instead, as ``DIR/seed{N}.npz`` ('/'-joined paths),
for the port's studies to start from on the card (``--init-from DIR``);
``--family diffusion`` writes the JAX diffusion study's denoiser (under
``denoiser/``) and partial-denoising proposal (under ``proposal/``).
"""

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'scripts'))

import parity_rmse as JP  # noqa: E402  (the JAX package's study)

import inferbiomechanics_tpu.train as jax_train  # noqa: E402
from inferbiomechanics_tpu_torch.scripts import parity_rmse as PP  # noqa: E402
from inferbiomechanics_tpu_torch.weights import (  # noqa: E402
    model_family, params_to_jax, transformer_pallas_tree_to_vpu,
)


def port_init_tree(family, ds, seed, attn_impl='vpu'):
    """The port's initial weights for ``seed`` as a JAX tree (the ``vpu``
    layout for either transformer)."""
    model = PP.study_model(family, ds, attn_impl=attn_impl,
                           generator=torch.Generator().manual_seed(seed), device='cpu')
    tree = params_to_jax(model_family(model), {n: p.detach()
                                               for n, p in model.named_parameters()})
    if model_family(model) == 'pallas':
        tree = transformer_pallas_tree_to_vpu(tree)
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_init_tree(family, ds, x_tr, seed):
    """The JAX package's initial weights for ``seed``, as ``run_jax`` (and
    for diffusion ``scripts/anchor_quality.py::run_diffusion`` and its
    ``train_proposal``) make them: the model built the same way,
    ``PRNGKey(seed)``."""
    from inferbiomechanics_tpu.models import get_model
    kw = dict(num_dofs=ds.num_dofs, num_contact_bodies=ds.num_contact_bodies,
              history_len=PP.WINDOW, stride=PP.STRIDE, root_history_len=ds.root_history_len)
    if family == 'diffusion':
        model = get_model('diffusion', **kw)
        variables = model.init({'params': jax.random.PRNGKey(seed)},
                               jnp.zeros((2, x_tr.shape[1], model.target_channels)),
                               jnp.zeros((2,), jnp.int32), jnp.asarray(x_tr[:2]),
                               train=False)
        return {'denoiser': jax.device_get(variables['params']),
                'proposal': jax_init_tree('proposal', ds, x_tr, seed)}
    if family in ('feedforward', 'proposal'):
        model = get_model('feedforward', hidden_dims=list(PP.HIDDEN), activation='sigmoid',
                          output_data_format='all_frames' if family == 'proposal'
                          else 'last_frame', **kw)
    else:
        model = get_model(family, output_data_format='all_frames', **kw)
    state = jax_train.create_train_state(model, jax.random.PRNGKey(seed),
                                         jnp.asarray(x_tr[:2]),
                                         jax_train.make_optimizer('rmsprop', PP.LR))
    return jax.device_get(state.params)


def run_jax_from(tree, *args, **kw):
    """``run_jax`` with its initial weights replaced by ``tree``."""
    original = jax_train.create_train_state

    def handed(model, rng, x, tx):
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        return original(model, rng, x, tx).replace(params=params, opt_state=tx.init(params))

    jax_train.create_train_state = handed
    try:
        return JP.run_jax(*args, **kw)
    finally:
        jax_train.create_train_state = original


def write_inits(family, ds, x_tr, seeds, directory) -> None:
    """The JAX initial weights of each seed as ``directory/seed{N}.npz``."""
    os.makedirs(directory, exist_ok=True)
    for seed in seeds:
        flat = jax.tree_util.tree_flatten_with_path(jax_init_tree(family, ds, x_tr, seed))[0]
        np.savez(os.path.join(directory, f'seed{seed}.npz'),
                 **{'/'.join(k.key for k in path): np.asarray(v, np.float32)
                    for path, v in flat})


def max_rel(a, b):
    return {m: max(abs(x[m] - y[m]) / abs(y[m]) for x, y in zip(a, b)) for m in PP.METRICS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--family', choices=('feedforward', 'transformer', 'diffusion'),
                    required=True, help='diffusion: --write-inits only')
    ap.add_argument('--attn-impl', choices=('vpu', 'pallas'), default='vpu',
                    help="the port's transformer (JAX trains the vpu model)")
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--epochs', type=int, default=3)
    ap.add_argument('--trial-length', type=int, default=1500)
    ap.add_argument('--data', required=True)
    ap.add_argument('--out', default=None)
    ap.add_argument('--write-inits', default=None, metavar='DIR')
    ap.add_argument('--seeds', type=int, nargs='+', default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    if args.family == 'diffusion' and not args.write_inits:
        raise SystemExit('--family diffusion writes initial weights only (--write-inits)')
    fmt = 'last_frame' if args.family == 'feedforward' else 'all_frames'
    ds, _, x_tr, y_tr, x_dev, lab_dev, sl, digest = PP.build_study_data(
        args.data, args.trial_length, fmt)
    if args.write_inits:
        write_inits(args.family, ds, x_tr, args.seeds or [args.seed], args.write_inits)
        return 0
    schedule = PP.batch_schedule(len(ds), args.seed, args.epochs)
    common = (ds, x_tr, y_tr, x_dev, lab_dev, sl, args.seed, args.epochs, schedule)
    out = {'family': args.family, 'attn_impl': args.attn_impl, 'seed': args.seed,
           'epochs': args.epochs,
           'data_sha256': digest, 'device': 'cpu', 'torch': torch.__version__,
           'jax': jax.__version__}
    for start, tree in (('jax_init', jax_init_tree(args.family, ds, x_tr, args.seed)),
                        ('port_init', port_init_tree(args.family, ds, args.seed,
                                                     args.attn_impl))):
        t0 = time.perf_counter()
        jax_curve = run_jax_from(tree, *common, model_type=args.family)
        t1 = time.perf_counter()
        port_curve = PP.run_port(*common, model_type=args.family, device='cpu',
                                 attn_impl=args.attn_impl, init_params=tree)
        t2 = time.perf_counter()
        out[start] = {'jax': jax_curve, 'port': port_curve,
                      'max_rel_diff': max_rel(port_curve, jax_curve),
                      'seconds': {'jax': t1 - t0, 'port': t2 - t1}}
        print(f'{args.family} seed {args.seed} from the {start.replace("_", " ")}: force by '
              f'epoch jax {[round(c["force_avg_err"], 4) for c in jax_curve]} port '
              f'{[round(c["force_avg_err"], 4) for c in port_curve]}; max rel diff '
              f'{out[start]["max_rel_diff"]}', flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
