"""``plot-training`` subcommand: training curves from logged metrics.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/plot_training_cmd.py``,
with its flags and its words: the numeric metric streams of a
``metrics_*.jsonl`` file that ``utils/wandb_compat.py::MetricLogger`` wrote
(newest in ``--log-dir`` by default; its leading ``{"_config": ...}``
record names the run) in one small-multiples PNG, a panel a metric group,
and each series' final value printed; ``--compare`` overlays several runs,
a panel a key that every run logged. :func:`read_metrics`, :func:`group_key`,
:func:`ema` and :func:`newest_log` are copies of the JAX functions. The
figure is drawn by matplotlib where it is installed, else by
``utils/png_plot.py`` (the same file). A host-side command: it runs no model
and takes no ``--device``.

    python -m inferbiomechanics_tpu_torch plot-training [--log-file F] [--smooth 10]
    python -m inferbiomechanics_tpu_torch plot-training --compare A.jsonl B.jsonl [--labels a b]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Tuple

from inferbiomechanics_tpu_torch.utils import png_plot

# Validated categorical palette (fixed slot order, never cycled) and
# surface/ink tokens from the dataviz reference palette; lines use the
# adjacent pairlist, which this 8-slot order passes (CVD dE >= 8.4).
SERIES = ['#2a78d6', '#eb6834', '#1baf7a', '#eda100',
          '#e87ba4', '#008300', '#4a3aa7', '#e34948']
SURFACE = '#fcfcfb'
GRID = '#e4e3df'


def read_metrics(path: str) -> Tuple[dict, Dict[str, List[Tuple[int, float]]]]:
    """Parse a MetricLogger JSONL file.

    Returns ``(config, series)`` where ``series[key]`` is a list of
    ``(record_index, value)`` for every numeric metric key. The record
    index is the honest x-axis: log() calls are ordered but different
    keys fire at different cadences (per-batch train loss vs per-epoch
    dev reports)."""
    config: dict = {}
    series: Dict[str, List[Tuple[int, float]]] = {}
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue          # torn final line of a live run
            if '_config' in rec:
                config = rec['_config'] or {}
                continue
            for k, v in rec.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                series.setdefault(k, []).append((i, float(v)))
    return config, series


def group_key(key: str) -> str:
    """Panel assignment: per-component keys (``dev/force_rmse/left-x``)
    share one panel per metric group; everything else gets its own."""
    parts = key.split('/')
    if len(parts) >= 3:
        return '/'.join(parts[:-1])
    return key


def ema(values: List[float], alpha: float) -> List[float]:
    out, m = [], values[0]
    for v in values:
        m = alpha * m + (1.0 - alpha) * v
        out.append(m)
    return out


def newest_log(log_dir: str) -> str:
    paths = sorted(glob.glob(os.path.join(log_dir, 'metrics_*.jsonl')),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(
            f'no metrics_*.jsonl under {log_dir} (runs logged to a real '
            f'wandb server have no local JSONL; pass --log-file)')
    return paths[-1]


def _grid_figure(n: int, title: str) -> png_plot.Figure:
    ncols = min(3, n)
    nrows = -(-n // ncols)
    return png_plot.Figure(nrows, ncols, figsize=(5.2 * ncols, 3.4 * nrows), title=title,
                           facecolor=SURFACE, grid=GRID)


def _curve(panel: png_plot.Panel, points, color: str, label, smooth: int) -> float:
    """One series (raw, and its EMA over it when ``smooth`` > 1); returns
    its final value."""
    xs = [x for x, _v in points]
    ys = [v for _x, v in points]
    if smooth > 1 and len(ys) >= smooth:
        alpha = 1.0 - 2.0 / (smooth + 1)
        panel.line(xs, ys, color=color, linewidth=1.0, alpha=0.25)
        panel.line(xs, ema(ys, alpha), color=color, linewidth=2.0, label=label)
    else:
        panel.line(xs, ys, color=color, linewidth=2.0, label=label)
    return ys[-1]


def _save(fig: png_plot.Figure, out_path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.save(out_path, png_plot.pyplot())


def plot_training(path: str, out_path: str, keys=None, smooth: int = 0,
                  drop: Tuple[str, ...] = ('epoch', 'batch')) -> dict:
    """Render the run at ``path`` to ``out_path``; returns
    ``{key: final_value}`` for the plotted series."""
    config, series = read_metrics(path)
    if keys:
        missing = [k for k in keys if k not in series]
        if missing:
            raise ValueError(f'keys {missing} not in {path}; available: '
                             f'{sorted(series)}')
        series = {k: series[k] for k in keys}
    else:
        series = {k: v for k, v in series.items() if k not in drop}
    if not series:
        raise ValueError(f'{path} holds no numeric metric series')

    panels: Dict[str, List[str]] = {}
    for k in sorted(series):
        panels.setdefault(group_key(k), []).append(k)
    run_name = config.get('model_type') or os.path.basename(path)
    fig = _grid_figure(len(panels), f'training curves — {run_name}')
    finals = {}
    for panel, (name, panel_keys) in zip(fig.panels, panels.items()):
        for si, k in enumerate(panel_keys):
            label = k.split('/')[-1] if len(panel_keys) > 1 else None
            finals[k] = _curve(panel, series[k], SERIES[si % len(SERIES)], label, smooth)
        panel.title, panel.xlabel, panel.legend = name, 'log record', len(panel_keys) > 1
    _save(fig, out_path)
    return finals


def plot_training_compare(paths, out_path, keys=None, smooth: int = 0,
                          labels=None,
                          drop: Tuple[str, ...] = ('epoch', 'batch')) -> dict:
    """Overlay several runs (``--compare``): one panel per metric key
    present in EVERY run, one color per run — the did-my-change-help
    view. Returns ``{label: {key: final_value}}``."""
    if labels and len(labels) != len(paths):
        raise ValueError(f'{len(labels)} labels for {len(paths)} runs')
    runs = []
    for i, path in enumerate(paths):
        label = labels[i] if labels else os.path.splitext(
            os.path.basename(path))[0]
        runs.append((label, *read_metrics(path)))
    common = set(runs[0][2])
    for _label, _cfg, series in runs[1:]:
        common &= set(series)
    if keys:
        missing = [k for k in keys if k not in common]
        if missing:
            raise ValueError(f'keys {missing} not present in every run; '
                             f'common keys: {sorted(common)}')
    else:
        keys = sorted(k for k in common if k not in drop)
    if not keys:
        raise ValueError('the runs share no numeric metric keys')

    fig = _grid_figure(len(keys), f'training curves — {len(runs)} runs')
    finals: Dict[str, dict] = {label: {} for label, _c, _s in runs}
    for panel, k in zip(fig.panels, keys):
        for ri, (label, _cfg, series) in enumerate(runs):
            finals[label][k] = _curve(panel, series[k], SERIES[ri % len(SERIES)], label,
                                      smooth)
        panel.title, panel.xlabel, panel.legend = k, 'log record', True
    _save(fig, out_path)
    return finals


def register_subcommand(sub) -> None:
    p = sub.add_parser('plot-training',
                       help='Render training curves from the offline metric JSONL (the wandb '
                            'fallback) into one PNG')
    p.add_argument('--log-file', type=str, default=None,
                   help='A metrics_*.jsonl file (default: newest in --log-dir)')
    p.add_argument('--log-dir', type=str, default='outputs/logs',
                   help='Where MetricLogger wrote its fallback JSONL files')
    p.add_argument('--out', type=str, default='outputs/plots/training_curves.png')
    p.add_argument('--keys', type=str, nargs='+', default=None,
                   help='Plot only these metric keys (default: every numeric key except '
                        'epoch/batch)')
    p.add_argument('--smooth', type=int, default=0,
                   help='EMA smoothing span; raw series stays visible underneath (0 = off)')
    p.add_argument('--compare', type=str, nargs='+', default=None, metavar='JSONL',
                   help='Overlay several runs: one panel per shared metric key, one color '
                        'per run')
    p.add_argument('--labels', type=str, nargs='+', default=None,
                   help='Legend labels for --compare runs (default: file names)')


def run(args: argparse.Namespace) -> int:
    if args.compare:
        finals = plot_training_compare(args.compare, args.out, keys=args.keys,
                                       smooth=args.smooth, labels=args.labels)
        print(f'compared {len(args.compare)} runs -> {args.out}')
        for label, fin in finals.items():
            for k in sorted(fin):
                print(f'  {label} {k}  final {fin[k]:.6g}')
        return 0
    path = args.log_file or newest_log(args.log_dir)
    finals = plot_training(path, args.out, keys=args.keys, smooth=args.smooth)
    print(f'plotted {len(finals)} series from {path} -> {args.out}')
    width = max(len(k) for k in finals)
    for k in sorted(finals):
        print(f'  {k:<{width}}  final {finals[k]:.6g}')
    return 0
