"""Whole-run learning quality of the port's feedforward, GroundLink and
transformer models on the study split of the JAX package's
``scripts/parity_rmse.py``.

PyTorch counterpart of that script's JAX side (``run_jax``): the same
synthetic split (2 train subjects, 1 dev subject, window 50, stride 5), the
same batch schedule a seed (numpy's ``default_rng(seed)``: byte-identical
batches on both sides), the same loss components (all 6 / 6 / 6 / 12),
RMSprop at 1e-4, batches of 64, dev batches of 512, and the same numpy
scoring (:func:`dev_metrics`, the reference's last-frame Avg Err of force,
CoP and COM acceleration). Every epoch ends with a dev eval; a run's curve
is one :func:`dev_metrics` dict an epoch.

What cannot match across frameworks comes from torch generators: the
initial weights from one seeded by ``seed`` (``init_params`` carries a JAX
tree across instead), GroundLink's dropout masks from one seeded by ``seed
+ 1000`` and the step count (``draws`` hands the model another source a
step: the seam through which tests feed the JAX step's own masks). The
reference-shaped torch model of the JAX script (``run_torch``) is not
ported: the port is held to the JAX package.

On the card the feedforward model evaluates through K1 and GroundLink
through K4; ``--attn-impl pallas`` trains the transformer through K3 and
evaluates it through K2. The others train through plain autograd, as the
JAX package does.

Run on the card (``--device cpu`` runs the plain versions on the CPU)::

    python -m inferbiomechanics_tpu_torch.scripts.parity_rmse --model feedforward \\
        --epochs 10 --seeds 0 1 2 --out docs/port_parity/port_feedforward.json

``--digest-only`` builds the study data and writes the sha256 of its packed
arrays for both output formats, without training.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from inferbiomechanics_tpu_torch.cli.doctor_cmd import nvidia_smi
from inferbiomechanics_tpu_torch.data import keys as K
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.loss.evaluator import LossConfig
from inferbiomechanics_tpu_torch.models import get_model
from inferbiomechanics_tpu_torch.models.common import MaskSource, generator_masks
from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg
from inferbiomechanics_tpu_torch.ops import fused_mlp as fm
from inferbiomechanics_tpu_torch.serve import resolve_device
from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
from inferbiomechanics_tpu_torch.train.state import create_train_state
from inferbiomechanics_tpu_torch.train.step import make_eval_step, make_train_step
from inferbiomechanics_tpu_torch.weights import (
    model_family, params_from_jax, transformer_vpu_tree_to_pallas, tree_family,
)

WINDOW, STRIDE, BATCH, LR = 50, 5, 64, 1e-4
HIDDEN = (512, 512)
DEV_BATCH = 512
METRICS = ('force_avg_err', 'cop_avg_err', 'com_acc_avg_err')
# the four ground-contact heads under the scoring's short names
SHORT = {'cops': K.OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME,
         'forces': K.OutputDataKeys.GROUND_CONTACT_FORCES_IN_ROOT_FRAME,
         'torques': K.OutputDataKeys.GROUND_CONTACT_TORQUES_IN_ROOT_FRAME,
         'wrenches': K.OutputDataKeys.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME}


# ---------------------------------------------------------------------------
# Scoring and batches: copies of the JAX script's numpy functions
# ---------------------------------------------------------------------------

def _mean_norm_err(out: np.ndarray, lab: np.ndarray, vec: int = 3) -> float:
    """Reference get_mean_norm_error: last-frame-only norms."""
    b, t, c = out.shape
    d = (out - lab).reshape(b, t, c // vec, vec)
    return float(np.linalg.norm(d[:, -1:, :, :], axis=3).mean())


def dev_metrics(pred: dict, lab: dict) -> dict:
    """Force / CoP / COM-acc Avg Err as the reference reports them."""
    f_o, f_l = pred['forces'], lab['forces']
    # CoP masked to >=10 N/kg contact frames
    b, t, c = f_l.shape
    norms = np.linalg.norm(f_l.reshape(b, t, c // 3, 3), axis=-1)
    mask = (norms > 10.0).astype(f_l.dtype)
    mask = np.broadcast_to(mask[..., None], (b, t, c // 3, 3)).reshape(b, t, c)
    com_o = f_o[:, :, :3] + f_o[:, :, 3:]
    com_l = f_l[:, :, :3] + f_l[:, :, 3:]
    return {
        'force_avg_err': _mean_norm_err(f_o, f_l),
        'cop_avg_err': _mean_norm_err(pred['cops'] * mask, lab['cops'] * mask),
        'com_acc_avg_err': _mean_norm_err(com_o, com_l),
    }


def label_slices(lab_offsets) -> dict:
    return {short: lab_offsets[full] for short, full in SHORT.items()}


def slice_labels(y: np.ndarray, sl: dict) -> dict:
    return {k: y[..., o:o + w] for k, (o, w) in sl.items()}


def batch_schedule(n: int, seed: int, epochs: int) -> list:
    """One permutation stream a seed -> the same batches on both sides."""
    rng = np.random.default_rng(seed)
    per_epoch = []
    for _ in range(epochs):
        order = rng.permutation(n)
        nb = n // BATCH
        per_epoch.append([order[i * BATCH:(i + 1) * BATCH] for i in range(nb)])
    return per_epoch


# ---------------------------------------------------------------------------
# Study data
# ---------------------------------------------------------------------------

def data_sha256(*arrays: np.ndarray) -> str:
    """sha256 over each array's dtype, shape and bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f'{a.dtype.str}{a.shape}'.encode())
        h.update(a.tobytes())
    return h.hexdigest()


def build_study_data(data_dir: str, trial_length: int, fmt: str):
    """Build (or reuse) the study's synthetic split and return ``(ds_tr,
    ds_dev, x_tr, y_tr, x_dev, lab_dev, sl, digest)``: the JAX script's
    packed arrays, and :func:`data_sha256` of ``x_tr``, ``y_tr`` and
    ``x_dev``.

    Refuses a --data dir written at a different --trial-length (stale
    files would silently change the corpus)."""
    tr_dir = os.path.join(data_dir, 'train')
    dev_dir = os.path.join(data_dir, 'dev')
    os.makedirs(tr_dir, exist_ok=True)
    os.makedirs(dev_dir, exist_ok=True)
    marker = os.path.join(data_dir, '.trial_length')
    have_files = any(
        os.path.exists(os.path.join(d, n))
        for d, n in [(tr_dir, 'train_s0.b3d'), (dev_dir, 'dev_s0.b3d')])
    if os.path.exists(marker):
        with open(marker) as f:
            prev = int(f.read().strip())
        if prev != trial_length:
            raise SystemExit(
                f'{data_dir} holds trials of length {prev}, not '
                f'{trial_length}; pass a fresh --data dir')
    elif have_files:
        raise SystemExit(
            f'{data_dir} holds subject files of unknown trial length '
            f'(no .trial_length marker); pass a fresh --data dir')
    else:
        with open(marker, 'w') as f:
            f.write(str(trial_length))
    for i in range(2):
        p = os.path.join(tr_dir, f'train_s{i}.b3d')
        if not os.path.exists(p):
            write_synthetic_subject(p, num_trials=2, trial_length=trial_length,
                                    seed=100 + i)
    p = os.path.join(dev_dir, 'dev_s0.b3d')
    if not os.path.exists(p):
        write_synthetic_subject(p, num_trials=2, trial_length=trial_length, seed=200)

    ds_tr = WindowDataset(tr_dir, window_size=WINDOW, stride=STRIDE,
                          output_data_format=fmt)
    ds_dev = WindowDataset(dev_dir, window_size=WINDOW, stride=STRIDE,
                           output_data_format=fmt)
    b_tr = ds_tr.gather(np.arange(len(ds_tr)))
    b_dev = ds_dev.gather(np.arange(len(ds_dev)))
    x_tr = np.asarray(b_tr.inputs, np.float32)
    y_tr = np.asarray(b_tr.labels, np.float32)
    x_dev = np.asarray(b_dev.inputs, np.float32)
    y_dev = np.asarray(b_dev.labels, np.float32)
    sl = label_slices(ds_tr.lab_offsets)
    lab_dev = slice_labels(y_dev, sl)
    return ds_tr, ds_dev, x_tr, y_tr, x_dev, lab_dev, sl, data_sha256(x_tr, y_tr, x_dev)


# ---------------------------------------------------------------------------
# The port's side
# ---------------------------------------------------------------------------

def study_loss_config() -> LossConfig:
    """Every component of the four loss vectors (the reference's train.py
    defaults)."""
    return LossConfig(predict_grf_components=tuple(range(6)),
                      predict_cop_components=tuple(range(6)),
                      predict_moment_components=tuple(range(6)),
                      predict_wrench_components=tuple(range(12)))


def study_model(model_type: str, ds, *, attn_impl: str = 'vpu',
                output_data_format: Optional[str] = None,
                generator: Optional[torch.Generator] = None, device=None):
    """The model ``run_jax`` builds for ``model_type``, sized to ``ds``:
    feedforward (512, 512) sigmoid (``last_frame`` unless
    ``output_data_format`` says otherwise), GroundLink and the transformer
    at the shipped defaults in ``all_frames`` (``attn_impl``: the
    transformer's tree)."""
    kw = dict(num_dofs=ds.num_dofs, num_contact_bodies=ds.num_contact_bodies,
              history_len=WINDOW, stride=STRIDE, root_history_len=ds.root_history_len,
              generator=generator, device=device)
    if model_type == 'feedforward':
        return get_model('feedforward', hidden_dims=list(HIDDEN), activation='sigmoid',
                         output_data_format=output_data_format or 'last_frame', **kw)
    if model_type == 'groundlink':
        return get_model('groundlink', output_data_format='all_frames', **kw)
    if model_type == 'transformer':
        return get_model('transformer', output_data_format='all_frames',
                         attn_impl=attn_impl, **kw)
    raise ValueError(f'unknown study model {model_type!r}')


def load_init_tree(path: str) -> dict:
    """A parameter tree saved as an ``.npz`` of '/'-joined paths (``tests/
    torch_parity_split.py --write-inits``) -> nested dicts of arrays."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split('/')
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = z[key]
    return tree


def init_params_for(init_from: Optional[str], seed: int) -> Optional[dict]:
    """``--init-from``'s tree for ``seed`` (``seed{seed}.npz``), or None."""
    return None if init_from is None else load_init_tree(
        os.path.join(init_from, f'seed{seed}.npz'))


def load_jax_params(model, tree) -> None:
    """Load a JAX parameter tree of ``model``'s family into ``model``. A
    ``vpu`` transformer tree loads into the ``pallas`` model as the same
    function (its blocks flattened into ``enc{i}_*``)."""
    family = model_family(model)
    if family == 'pallas' and tree_family(tree) == 'transformer':
        tree = transformer_vpu_tree_to_pallas(tree)
    model.load_state_dict(params_from_jax(family, tree))


def to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def epoch_batches(schedule: list, epoch: int, device) -> torch.Tensor:
    """Epoch ``epoch``'s batches (``schedule[epoch % len(schedule)]``) as
    one int64 tensor [batches, BATCH] on ``device``: one copy an epoch."""
    idx = np.asarray(schedule[epoch % len(schedule)], np.int64).reshape(-1, BATCH)
    return torch.from_numpy(idx).to(device)


def dev_predictions(predict: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                    xd: torch.Tensor) -> Dict[str, np.ndarray]:
    """``predict`` over ``xd`` in dev batches of 512 -> the four heads under
    their short names, float32 host arrays."""
    preds = []
    for i in range(0, xd.shape[0], DEV_BATCH):
        outputs = predict(xd[i:i + DEV_BATCH])
        preds.append({k: outputs[full].float().cpu().numpy() for k, full in SHORT.items()})
    return {k: np.concatenate([p[k] for p in preds]) for k in SHORT}


def run_port(ds, x_tr, y_tr, x_dev, lab_dev, sl, seed, epochs, schedule,
             model_type='feedforward', *, device='cuda', attn_impl: str = 'vpu',
             init_params=None, draws: Optional[Callable[[int], MaskSource]] = None
             ) -> List[dict]:
    """Train the port's ``model_type`` on ``schedule``'s batches for
    ``epochs`` epochs through ``train/step.py``'s step and return the curve:
    :func:`dev_metrics` of the dev split after each epoch, predicted through
    ``make_eval_step``. ``init_params`` (a JAX tree of the model's family;
    for the ``pallas`` transformer the ``vpu`` tree too) replaces the seeded
    initial weights; ``draws(i)`` gives the model's
    dropout masks of step ``i`` (counted from 0 over the run)."""
    device = torch.device(device)
    model = study_model(model_type, ds, attn_impl=attn_impl,
                        generator=torch.Generator().manual_seed(seed), device=device)
    if init_params is not None:
        load_jax_params(model, init_params)
    state = create_train_state(model, make_optimizer(model.named_parameters(), 'rmsprop', LR))
    if hasattr(model, 'dropout_masks'):
        state.dropout_gen = torch.Generator(device=device)
        state.dropout_seed = seed + 1000
        model.dropout_masks = generator_masks(state.dropout_gen)
    cfg = study_loss_config()
    step = make_train_step(model, ds.lab_offsets, cfg)
    eval_step = make_eval_step(model, ds.lab_offsets, cfg)

    x, y, xd = to_device(x_tr, device), to_device(y_tr, device), to_device(x_dev, device)
    # the eval step's labels feed only its loss metrics, which go unread
    yd = torch.zeros((DEV_BATCH, *y_tr.shape[1:]), device=device)

    def predict(xb: torch.Tensor) -> Dict[str, torch.Tensor]:
        return eval_step(state, xb, yd[:xb.shape[0]])[0]

    curve, it = [], 0
    for ep in range(epochs):
        for bi in epoch_batches(schedule, ep, device):
            if draws is not None:
                model.dropout_masks = draws(it)
            step(state, x[bi], y[bi])
            it += 1
        curve.append(dev_metrics(dev_predictions(predict, xd), lab_dev))
    return curve


def kernel_launches() -> Dict[str, int]:
    """The kernels' launches so far in this process, as their wrappers count
    them (K3: its three launches a layer); none on the CPU."""
    return {'K1': fm.launches, 'K2': fe.launches, 'K3': fe.bwd_launches, 'K4': fg.launches}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in kernel_launches().items()}


def run_record(curve: List[dict], seconds: float, launches: Dict[str, int]) -> dict:
    """A run as the JSON keeps it: the curve, the entry of the best dev
    force, the final entry, the run's seconds and its kernel launches."""
    return {'curve': curve, 'best': min(curve, key=lambda c: c['force_avg_err']),
            'final': curve[-1], 'seconds': seconds, 'launches': launches}


def card_line() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    None where there is no ``nvidia-smi``."""
    lines = nvidia_smi()
    return lines[0] if lines else None


def study_device(name: str) -> torch.device:
    """``--device`` as a torch.device; stops naming the device when it is a
    GPU that is not there (nothing falls back to the CPU)."""
    try:
        return resolve_device(name)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f'--device {name}: {e}') from None


def provenance(device: torch.device, digest: str) -> dict:
    """What a study's JSON records of where it ran and on which data."""
    return {'side': 'port', 'device': str(device),
            'card': card_line() if device.type == 'cuda' else None,
            'torch': torch.__version__, 'cuda': torch.version.cuda,
            'data_sha256': digest}


def write_json(path: str, results: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(results, f, indent=1)


def print_summary(results: dict, seeds) -> None:
    for which in ('best', 'final'):
        for m in METRICS:
            v = [results['runs'][str(s)][which][m] for s in seeds]
            print(f'{which} {m}: mean {np.mean(v):.4f} (range {min(v):.4f}-{max(v):.4f})')


def write_digests(data_dir: str, trial_length: int, out: str) -> dict:
    """The study data's digests in both output formats, written to ``out``."""
    digests = {'trial_length': trial_length}
    for fmt in ('last_frame', 'all_frames'):
        ds_tr, ds_dev, *_, digest = build_study_data(data_dir, trial_length, fmt)
        digests[fmt] = digest
        digests.update(n_train=len(ds_tr), n_dev=len(ds_dev))
    write_json(out, digests)
    return digests


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--epochs', type=int, default=10)
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    ap.add_argument('--model', choices=('feedforward', 'groundlink', 'transformer'),
                    default='feedforward')
    ap.add_argument('--out', default=os.path.join('outputs', 'port_parity_rmse.json'))
    ap.add_argument('--data', default=os.path.join('outputs', 'ib_parity_data'))
    ap.add_argument('--trial-length', type=int, default=1500,
                    help='frames per synthetic trial (small values make a fast '
                         'smoke run; the study used 1500)')
    ap.add_argument('--device', default='cuda',
                    help='cuda (default; stops when there is no GPU) or cpu')
    ap.add_argument('--attn-impl', choices=('vpu', 'pallas'), default='vpu',
                    help='the transformer\'s tree: pallas trains through K3 and '
                         'evaluates through K2 on the card')
    ap.add_argument('--init-from', default=None,
                    help='a directory of seed{N}.npz JAX parameter trees: each seed '
                         'starts from its tree instead of the seeded draw (the '
                         'pallas transformer takes the vpu tree too)')
    ap.add_argument('--digest-only', action='store_true',
                    help='write the study data\'s digests to --out and stop')
    args = ap.parse_args(argv)
    if args.digest_only:
        print(json.dumps(write_digests(args.data, args.trial_length, args.out)))
        return 0
    device = study_device(args.device)
    if args.attn_impl != 'vpu' and args.model != 'transformer':
        raise SystemExit(f'--attn-impl {args.attn_impl} applies to the transformer')

    fmt = 'last_frame' if args.model == 'feedforward' else 'all_frames'
    ds_tr, ds_dev, x_tr, y_tr, x_dev, lab_dev, sl, digest = build_study_data(
        args.data, args.trial_length, fmt)
    print(f'train windows {len(ds_tr)}  dev windows {len(ds_dev)}  '
          f'input [{x_tr.shape[1]}x{x_tr.shape[2]}]  data sha256 {digest}', flush=True)
    results = {'config': {'window': WINDOW, 'stride': STRIDE, 'batch': BATCH,
                          'lr': LR, 'hidden': list(HIDDEN), 'model': args.model,
                          'attn_impl': args.attn_impl, 'opt': 'rmsprop',
                          'epochs': args.epochs, 'seeds': args.seeds,
                          'n_train': len(ds_tr), 'n_dev': len(ds_dev),
                          'trial_length': args.trial_length, 'init_from': args.init_from},
               **provenance(device, digest), 'runs': {}}
    for seed in args.seeds:
        schedule = batch_schedule(len(ds_tr), seed, args.epochs)
        t0, before = time.perf_counter(), kernel_launches()
        curve = run_port(ds_tr, x_tr, y_tr, x_dev, lab_dev, sl, seed, args.epochs,
                         schedule, model_type=args.model, device=device,
                         attn_impl=args.attn_impl,
                         init_params=init_params_for(args.init_from, seed))
        run = results['runs'][str(seed)] = run_record(curve, time.perf_counter() - t0,
                                                      launches_since(before))
        f = run['final']
        print(f'seed {seed}: {run["seconds"]:.1f}s  final force {f["force_avg_err"]:.4f} '
              f'cop {f["cop_avg_err"]:.4f} com {f["com_acc_avg_err"]:.4f}', flush=True)
        write_json(args.out, results)
    print(f'wrote {args.out}')
    print_summary(results, args.seeds)
    return 0


if __name__ == '__main__':
    sys.exit(main())
