"""``analyze`` subcommand: score a checkpoint over the dev and train splits.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/analyze_cmd.py``, with its
flags and defaults (vertical GRF loss only, ``--batch-size`` 1). For each
split, dev then train, it evaluates the newest checkpoint under
``<checkpoint-dir>/<model-type>/`` (or ``--checkpoint-file``; a fresh model,
with a warning, when there is none) through the model's eval forward: K1 for
the feedforward model, K2 a layer for the ``pallas`` transformer, K4 for
GroundLink, the plain bf16 forward for the ``vpu`` transformer.
``--model-type analytical`` scores the physics baseline of
``models/analytical.py`` on each subject's skeleton, and
``--compute-report`` adds, for any model, the inverse-dynamics joint-torque
report (``loss/tau_report.py``); both read the subjects' skeletons and log
each approximation their parsing made. A diffusion checkpoint is scored by
sampling: a 50-step DDIM chain a batch (``models/diffusion.py::make_sampler``), through
K2 a layer and step with ``--fused-inference``, its draws from a generator
seeded 7 at each batch as the JAX command uses ``PRNGKey(7)``; with
``--use-ema`` on the checkpoint's EMA weights, with ``--diffusion-partial``
from the proposal of an ``--init-checkpoint`` model, with
``--guidance-scale`` guided. It appends a row per window to
``{split}_analysis.csv`` (subject, trial, loss, force_avg_err,
com_acc_avg_err, in the JAX command's window order), prints a report every
1000 batches and at the end, and on request bootstrap confidence intervals
(``--bootstrap``) and per-group summaries (``--group-by``).

``--eval-chunk-steps K`` (default 64) runs K same-shape batches between two
device-to-host copies of their metrics (``train/step.py::
make_eval_chunk_runner``; the short trailing batch is its own chunk); 1 is
one batch a copy. The analytical baseline's step (forward, metrics and,
with ``--compute-report``, the torque report) is one CUDA graph a batch
shape, replayed for each batch of a chunk (``make_graphed_chunk_runner``).
The learned models with ``--compute-report`` run batch by batch, as in the
JAX command, the report of each through its own graph
(``loss/tau_report.py``). ``--ensemble`` scores the mean of several
checkpoints through the port's ``InferenceService`` (``--tta-mirror`` per member);
``--tta-mirror`` alone goes through ``train/augment.py::make_tta_eval_step``.
``--quantize int8`` scores a feedforward checkpoint through the int8 forward
of ``ops/quant.py`` (no K1), batch by batch, as the JAX command does.
``--plot-errors`` also draws the first batch of each split's GRF errors
(``RegressionLossEvaluator.plot_errors``: ``{split}_grferror{COMPONENT}.png``
under ``--plot-path-root``); its splits run batch by batch, as in the JAX
command, with the rows of the chunked run.
``--device`` defaults to ``cuda`` and fails without a GPU; ``--device cpu``
runs the kernels' plain versions.

    python -m inferbiomechanics_tpu_torch analyze --dataset-home D --checkpoint-dir C
    python -m inferbiomechanics_tpu_torch analyze ... --model-type groundlink --tta-mirror
    python -m inferbiomechanics_tpu_torch analyze ... --ensemble C1 C2 --bootstrap 2000
    python -m inferbiomechanics_tpu_torch analyze ... --model-type diffusion \
        --output-data-format all_frames --fused-inference
    python -m inferbiomechanics_tpu_torch analyze ... --model-type analytical --compute-report
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from inferbiomechanics_tpu_torch.cli.motion import classify_motion
from inferbiomechanics_tpu_torch.config import Config, add_config_flags, config_from_args
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset, unpack
from inferbiomechanics_tpu_torch.loss.evaluator import (
    LossConfig, RegressionLossEvaluator, loss_and_metrics,
)
from inferbiomechanics_tpu_torch.loss.tau_report import make_tau_report_fn
from inferbiomechanics_tpu_torch.models import diffusion
from inferbiomechanics_tpu_torch.models.analytical import make_analytical_fn
from inferbiomechanics_tpu_torch.models.transformer import TransformerRegressor
from inferbiomechanics_tpu_torch.ops.quant import quantized_feedforward_forward
from inferbiomechanics_tpu_torch.serve import InferenceService, resolve_device
from inferbiomechanics_tpu_torch.train.augment import make_tta_eval_step, spec_from_dataset
from inferbiomechanics_tpu_torch.train.checkpoint import MissingEMAError, load_model
from inferbiomechanics_tpu_torch.train.loop import loss_config_from
from inferbiomechanics_tpu_torch.train.run_config import (
    add_run_config_flag, use_run_config_if_requested, warn_on_architecture_mismatch,
)
from inferbiomechanics_tpu_torch.train.step import (
    make_eval_chunk_runner, make_eval_step, make_graphed_chunk_runner,
)
from inferbiomechanics_tpu_torch.utils.wandb_compat import MetricLogger

ROW_KEYS = ('loss', 'force_avg_err', 'com_acc_avg_err')


def register_subcommand(sub) -> None:
    p = sub.add_parser('analyze', conflict_handler='resolve',
                       help='Evaluate a model checkpoint over dev and train splits')
    add_config_flags(p, Config(predict_grf_components=[1], predict_cop_components=[],
                               predict_moment_components=[],
                               predict_wrench_components=[], batch_size=1))
    add_run_config_flag(p)
    p.add_argument('--device', type=str, default='cuda',
                   help='torch device to evaluate on: cuda (default; fails '
                        'without a GPU) or cpu')
    p.add_argument('--checkpoint-file', type=str, default=None,
                   help='Evaluate this checkpoint file (e.g. best.torch.pt) '
                        'instead of the newest epoch_* one')
    p.add_argument('--ensemble', type=str, nargs='+', default=None, metavar='CKPT',
                   help='Evaluate the mean of several checkpoints (dirs or '
                        'checkpoint files), one forward per member')
    p.add_argument('--tta-mirror', action='store_true',
                   help='Mirror test-time augmentation: average each '
                        'prediction with the un-mirrored prediction of the '
                        'sagittally mirrored window (one extra forward)')
    p.add_argument('--plot-errors', action='store_true',
                   help='Write per-component GRF error PNGs of the first batch of '
                        'each split (ref analyze=True path)')
    p.add_argument('--plot-path-root', type=str, default='outputs/plots')
    p.add_argument('--eval-chunk-steps', type=int, default=64,
                   help='Evaluate K same-shape batches between two copies of '
                        'their metrics to the host; 1 = one batch at a time. '
                        'Ignored with --ensemble, --quantize, --plot-errors and '
                        '--model-type diffusion')
    p.add_argument('--bootstrap', type=int, default=0,
                   help='Resample the per-window rows N times and print 95%% '
                        'confidence intervals on the mean loss / force / '
                        'COM-acc errors (exact at --batch-size 1)')
    p.add_argument('--group-by', type=str, default=None,
                   choices=['trial', 'subject', 'activity'],
                   help='Also write {split}_summary_{group}.csv: per-group '
                        'window counts and mean loss / force / COM-acc errors, '
                        'worst force error first (activity = trial-name '
                        'motion classes). Exact at --batch-size 1')
    p.add_argument('--use-ema', action='store_true',
                   help='Evaluate the checkpoint\'s EMA parameters (diffusion '
                        'checkpoints trained with --ema-decay)')
    p.add_argument('--diffusion-partial', type=float, default=None,
                   help='Diffusion: partial denoising; each chain starts at this '
                        'fraction of the schedule from the --init-checkpoint '
                        'model\'s all-frames proposal')
    p.add_argument('--init-checkpoint', type=str, default=None,
                   help='Checkpoint dir of the all-frames proposal model for '
                        '--diffusion-partial')
    p.add_argument('--quantize', type=str, default=None, choices=['int8'],
                   help='Evaluate the int8-quantized forward (feedforward; '
                        'ops/quant.py): the accuracy cost of serve --quantize '
                        'on the standard metrics')


def _check_consistency(config: Config, args: argparse.Namespace) -> None:
    """The JAX command's own refusals of option pairs, in its words."""
    if args.ensemble and config.model_type in ('analytical', 'diffusion'):
        raise SystemExit(f'analyze --ensemble supports learned '
                         f'regression models; --model-type '
                         f'{config.model_type} has its own evaluation '
                         f'path and would silently ignore the ensemble')
    if args.use_ema and config.model_type != 'diffusion':
        raise SystemExit('analyze --use-ema applies to diffusion '
                         'checkpoints (train --ema-decay); '
                         f'--model-type {config.model_type} would '
                         'silently evaluate the raw params')
    if args.quantize and config.model_type != 'feedforward':
        raise SystemExit('analyze --quantize int8 currently supports '
                         'the feedforward family only (like serve '
                         'and export)')
    if args.diffusion_partial is not None and config.model_type != 'diffusion':
        raise SystemExit('analyze --diffusion-partial applies to '
                         f'--model-type diffusion; --model-type '
                         f'{config.model_type} would silently evaluate '
                         'without the warm start')
    if args.init_checkpoint and args.diffusion_partial is None:
        raise SystemExit('analyze --init-checkpoint only does something '
                         'with --diffusion-partial (it seeds the '
                         'truncated DDIM chains)')


def _pack_for_eval(model, fused: bool = False) -> None:
    """Pack the eval kernel's weights before the timed loop (the eval
    forward would pack them on its first call)."""
    with torch.no_grad():
        if isinstance(model, diffusion.DiffusionDenoiser):
            if fused:
                model.packed()
        elif isinstance(model, TransformerRegressor):
            if model.attn_impl == 'pallas':
                model.packed_layers(transposes=False)
        else:
            model.packed()      # feedforward (K1), GroundLink (K4)


def _bootstrap(split: str, rows: np.ndarray, n_boot: int) -> None:
    """95% percentile bootstrap over the per-window rows, in chunks of
    resamples so that the indices never take more than ~64M entries."""
    rng = np.random.default_rng(0)
    w = rows.shape[0]
    chunks = []
    chunk = max(1, min(n_boot, 64_000_000 // max(w, 1)))
    for lo_i in range(0, n_boot, chunk):
        k = min(chunk, n_boot - lo_i)
        idx = rng.integers(0, w, (k, w))
        chunks.append(rows[idx].mean(axis=1))
    means = np.concatenate(chunks)           # [N, 3]
    lo = np.percentile(means, 2.5, axis=0)
    hi = np.percentile(means, 97.5, axis=0)
    mid = rows.mean(axis=0)
    names = ['loss', 'force_avg_err (N/kg)', 'com_acc_avg_err (m/s^2)']
    print(f'[{split}] bootstrap 95% CIs ({w} windows, {n_boot} resamples):')
    for j, name in enumerate(names):
        print(f'  {name}: {mid[j]:.4f} [{lo[j]:.4f}, {hi[j]:.4f}]')


def _write_summary(path: str, group_by: str, groups: Dict[str, list]) -> None:
    with open(path, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow([group_by, 'windows', 'loss', 'force_avg_err', 'com_acc_avg_err'])
        ranked = sorted(groups.items(), key=lambda kv: kv[1][2] / kv[1][0],
                        reverse=True)   # worst force error first
        for key, (n, sl, sf, sc) in ranked:
            w.writerow([key, n, sl / n, sf / n, sc / n])


def _refuse_tta(args: argparse.Namespace) -> None:
    if args.tta_mirror:
        raise SystemExit('--tta-mirror supports the learned-model eval paths '
                         '(not analytical/diffusion/quantized)')


def analytical_eval_step(ds: WindowDataset, lc: LossConfig, predict, tau_fn,
                         last_frame: bool):
    """``step(inputs [B, T, C], labels, subject_indices [B]) -> metrics``:
    the analytical baseline's prediction (its last frame unless
    ``last_frame`` is False), the batch's metrics and, with a ``tau_fn``, its
    torque report (``tau_report``), on the device without a copy from the
    host: the function :func:`make_graphed_chunk_runner` captures."""

    def step(inputs, labels, subject_indices):
        out = predict(inputs, subject_indices)
        if last_frame:
            out = {k: v[:, -1:, :] for k, v in out.items()}
        lab = unpack(labels, ds.lab_offsets)
        _, metrics = loss_and_metrics(out, lab, lc)
        if tau_fn is not None:
            metrics['tau_report'] = tau_fn.traceable(inputs, out, lab, subject_indices)
        return metrics

    return step


def _last_frame(predict, last_frame: bool):
    """The analytical baseline's ``predict(x, subjects)`` batch by batch:
    its prediction, cut to the last frame unless ``last_frame`` is False
    (the label frames it is scored on)."""

    def last(x: np.ndarray, subjects) -> Dict[str, torch.Tensor]:
        out = predict(x, subjects)
        return {k: v[:, -1:, :] for k, v in out.items()} if last_frame else out

    return last


def _diffusion_predict(config: Config, args: argparse.Namespace, ds: WindowDataset,
                       checkpoint_dir: str, device: torch.device):
    """The JAX command's diffusion evaluation: ``predict(x, subjects) -> outputs`` of
    a 50-step DDIM chain on ``x`` (numpy [B, T, C_in]), drawn from a
    generator seeded 7 at each call."""
    if config.output_data_format != 'all_frames':
        raise ValueError('analyze --model-type diffusion requires '
                         '--output-data-format all_frames')
    _refuse_tta(args)
    model = _load(config, ds, checkpoint_dir, args, device,
                  f'WARNING: no checkpoint found in {checkpoint_dir}')
    if args.use_ema:
        print('evaluating EMA parameters')
    _pack_for_eval(model, config.fused_inference)
    try:
        forward = diffusion.make_chain_forward(
            config, ds, model, checkpoint_dir, num_steps=50, seed=7,
            partial=args.diffusion_partial, init_checkpoint=args.init_checkpoint,
            fused_inference=config.fused_inference, device=device)
    except ValueError as e:
        raise SystemExit(str(e))
    if config.guidance_scale != 1.0:
        print(f'classifier-free guidance scale {config.guidance_scale}')
    if args.diffusion_partial is not None:
        print(f'partial denoising from {args.init_checkpoint} at frac '
              f'{args.diffusion_partial}')

    def predict(x: np.ndarray, _subjects=None) -> Dict[str, torch.Tensor]:
        return forward(model, torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device))

    return predict


def _quantized_predict(model, device: torch.device):
    """The JAX command's int8 evaluation: ``predict(x, subjects) -> outputs`` of the
    quantized forward (``ops/quant.py``, weights quantized here once) on
    ``x`` (numpy [B, T, C_in]); batch by batch, as the diffusion chains."""
    forward = quantized_feedforward_forward(model)

    def predict(x: np.ndarray, _subjects=None) -> Dict[str, torch.Tensor]:
        return forward(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device))

    return predict


def _load(config: Config, ds: WindowDataset, checkpoint_dir: str,
          args: argparse.Namespace, device: torch.device, missing: str):
    """The model to evaluate, from ``--checkpoint-file`` or the newest
    checkpoint in ``checkpoint_dir`` (printing ``missing`` when there is
    none), its EMA weights with ``--use-ema``."""
    try:
        model, epoch, _ = load_model(config, ds, checkpoint_dir,
                                     checkpoint_file=args.checkpoint_file,
                                     use_ema=args.use_ema, device=device)
    except MissingEMAError as e:
        raise SystemExit(str(e))
    if epoch < 0:
        print(missing)
    return model


def analyze(args: argparse.Namespace) -> Dict[str, dict]:
    """Run ``analyze`` as the parsed arguments say. Returns, by split
    evaluated, its final report (``summary``), its window count and the
    seconds its evaluation loop took (forwards, metrics and rows)."""
    config = use_run_config_if_requested(config_from_args(args), args)
    _check_consistency(config, args)
    checkpoint_dir = os.path.join(os.path.abspath(config.checkpoint_dir),
                                  config.model_type)
    warn_on_architecture_mismatch(config, checkpoint_dir, 'analyze')
    device = resolve_device(args.device)

    ml = MetricLogger(config=vars(args), enabled=not config.no_wandb)
    lc = loss_config_from(config)
    results: Dict[str, dict] = {}
    analytical = config.model_type == 'analytical'
    needs_skels = analytical or config.compute_report
    eval_chunk = max(1, int(args.eval_chunk_steps or 1))
    for split in ('dev', 'train'):
        ds = WindowDataset(os.path.join(config.dataset_home, split),
                           window_size=config.window_size, stride=config.stride,
                           output_data_format=config.output_data_format,
                           testing_with_short_dataset=config.short,
                           trial_filter=config.trial_filter,
                           skip_loading_skeletons=not needs_skels)
        if len(ds) == 0:
            print(f'{split}: no windows, skipping')
            continue
        if needs_skels:
            # an approximation that could bias the torque report or the
            # analytical baseline is never silent
            for w in sorted({w for sk in ds.skeletons if sk is not None
                             for w in sk.fidelity_warnings}):
                logging.warning('skeleton approximation (may bias the tau report / '
                                'analytical baseline): %s', w)
        tau_fn = make_tau_report_fn(ds, device) if config.compute_report else None
        evaluator = RegressionLossEvaluator(split, lc, tau_fn=tau_fn, wandb_logger=ml)

        run_chunk = None   # K same-shape batches -> their metrics on the host
        if analytical:
            _refuse_tta(args)
            eval_fn = None
            analytical_fn = make_analytical_fn(ds, device)
            if args.plot_errors:
                predict = _last_frame(analytical_fn, config.output_data_format != 'all_frames')
            else:
                run_chunk = make_graphed_chunk_runner(
                    analytical_eval_step(ds, lc, analytical_fn, tau_fn,
                                         config.output_data_format != 'all_frames'),
                    (torch.float32, torch.float32, torch.int64), device)
        elif config.model_type == 'diffusion':
            predict = _diffusion_predict(config, args, ds, checkpoint_dir, device)
            eval_fn = None
        elif args.ensemble:
            svc = InferenceService(config, checkpoint_dir, ds,
                                   max_batch=max(config.batch_size, 1), device=device,
                                   ensemble=args.ensemble, tta_mirror=args.tta_mirror)
            print(f'ensemble of {len(svc.members)}: '
                  + ', '.join(m['path'] for m in svc.members))
            if svc.tta_mirror:
                print('mirror test-time augmentation enabled (per ensemble member)')

            def predict(x, _subjects=None, svc=svc):
                return {k: torch.from_numpy(v).to(device)
                        for k, v in svc.predict_packed(x).items()}
            eval_fn = None
        else:
            model = _load(config, ds, checkpoint_dir, args, device, 'WARNING: no '
                          f'checkpoint found in {checkpoint_dir}; evaluating a fresh model')
            if args.quantize:
                predict = _quantized_predict(model, device)
                eval_fn = None
                print('evaluating int8-quantized forward')
                _refuse_tta(args)
            else:
                _pack_for_eval(model)
                if args.tta_mirror:
                    spec = spec_from_dataset(ds, lateral_axis=config.mirror_lateral_axis)
                    eval_fn = make_tta_eval_step(model, ds.lab_offsets, lc, spec)
                    print('mirror test-time augmentation enabled')
                else:
                    eval_fn = make_eval_step(model, ds.lab_offsets, lc)
                if not (config.compute_report or args.plot_errors):
                    runner = make_eval_chunk_runner(eval_fn, device)

                    def run_chunk(xs, ys, _ss, runner=runner):
                        return runner(None, xs, ys)

        csv_path = os.path.join(checkpoint_dir, f'{split}_analysis.csv')
        os.makedirs(checkpoint_dir, exist_ok=True)
        group_by = args.group_by
        groups: Dict[str, list] = {}     # key -> [n, sum_loss, sum_force, sum_com_acc]
        n_boot = int(args.bootstrap or 0)
        boot_rows = []                   # per-window [loss, force, com_acc]
        windows = 0

        t0 = time.perf_counter()
        with open(csv_path, 'a', newline='') as f:
            writer = csv.writer(f)

            def emit_rows(i, batch, row):
                """A batch's CSV rows, bootstrap rows, group sums and
                progress report; ``row`` is the batch's three host floats."""
                for b in range(batch.inputs.shape[0]):
                    s_idx = int(batch.subject_indices[b])
                    subj = os.path.basename(ds.subject_paths[s_idx])
                    trial = ds.subjects[s_idx].getTrialName(int(batch.trial_indices[b]))
                    writer.writerow([subj, trial] + row)
                    if n_boot:
                        boot_rows.append(row)
                    if group_by:
                        if group_by == 'trial':
                            key = f'{subj}/{trial}'
                        elif group_by == 'subject':
                            key = subj
                        else:
                            key = classify_motion(trial)
                        g = groups.setdefault(key, [0, 0.0, 0.0, 0.0])
                        g[0] += 1
                        for j, v in enumerate(row):
                            g[1 + j] += v
                if i > 0 and i % 1000 == 0:
                    print(f'[{split}] batch {i}:')
                    evaluator.print_report(reset=False, log_to_wandb=True)

            batches = ds.batches(config.batch_size, shuffle=False, drop_last=False)
            if run_chunk is None:
                # one batch at a time: --ensemble, diffusion, --quantize,
                # --plot-errors, --compute-report with a learned model
                for i, batch in enumerate(batches):
                    windows += batch.inputs.shape[0]
                    x, y = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                            for a in (batch.inputs, batch.labels))
                    labels = unpack(y, ds.lab_offsets)
                    with torch.no_grad():
                        if eval_fn is not None:
                            outputs, metrics = eval_fn(None, x, y)
                        else:
                            outputs = predict(batch.inputs, batch.subject_indices)
                            metrics = evaluator.compute_metrics(outputs, labels)
                        evaluator(x, outputs, labels, batch.subject_indices,
                                  compute_report=config.compute_report,
                                  precomputed_metrics=metrics)
                    if args.plot_errors and i == 0:
                        for path in evaluator.plot_errors(outputs, labels, args.plot_path_root,
                                                          tag=split):
                            print(f'wrote {path}')
                    emit_rows(i, batch, torch.stack(
                        [metrics[key].float() for key in ROW_KEYS]).tolist())
            else:
                pend = []   # [(i, batch)]: same-shape batches only

                def flush():
                    if not pend:
                        return
                    ms = run_chunk(np.stack([b.inputs for _, b in pend]),
                                   np.stack([b.labels for _, b in pend]),
                                   np.stack([b.subject_indices for _, b in pend]))
                    tau = ms.pop('tau_report', None)
                    for k, (bi, b) in enumerate(pend):
                        mk = {key: v[k] for key, v in ms.items()}
                        if tau is not None:
                            evaluator.tau_reported_metrics.append(float(tau[k]))
                        evaluator(None, None, None, precomputed_metrics=mk)
                        emit_rows(bi, b, [float(mk[key]) for key in ROW_KEYS])
                    pend.clear()

                for i, batch in enumerate(batches):
                    windows += batch.inputs.shape[0]
                    if pend and batch.inputs.shape != pend[0][1].inputs.shape:
                        flush()   # the trailing short batch
                    pend.append((i, batch))
                    if len(pend) >= eval_chunk:
                        flush()
                flush()
        seconds = time.perf_counter() - t0
        print(f'[{split}] final report:')
        summary = evaluator.print_report(log_to_wandb=True)
        print(f'wrote {csv_path}')
        print(f'[{split}] {windows} windows evaluated in {seconds:.3f} s '
              f'({windows / seconds:.1f} windows/s on {device})')
        if n_boot and boot_rows:
            _bootstrap(split, np.asarray(boot_rows), n_boot)
        if group_by and groups:
            spath = os.path.join(checkpoint_dir, f'{split}_summary_{group_by}.csv')
            _write_summary(spath, group_by, groups)
            print(f'wrote {spath}')
        results[split] = dict(summary=summary, windows=windows, seconds=seconds)
    ml.finish()
    return results


def run(args: argparse.Namespace) -> int:
    analyze(args)
    return 0
