"""Check and time the port's kernels that have two shapes on the card, batch by batch.

    python -m inferbiomechanics_tpu_torch.ops.tune [--quick]
    python -m inferbiomechanics_tpu_torch.ops.tune --kernel encoder [--quick] [--baseline DIR]
    python -m inferbiomechanics_tpu_torch.ops.tune --kernel groundlink [--quick] [--baseline DIR]
    python -m inferbiomechanics_tpu_torch.ops.tune --kernel encoder_bwd [--quick] [--baseline DIR]

K1 (the default): builds the kernels, prints what ``-Xptxas -v`` says about
the MLP kernels, holds the kernel against :func:`fused_mlp.mlp_reference` over
a list of shapes, and then, for the full-width chain 1770 -> 512 -> 512 -> 30,
times the small-batch kernel, the large-batch kernel and a bf16 chain of
library calls at each batch (CUDA events around many launches, and the
profiler's device time), which is how ``fused_mlp.SMALL_BATCH_MAX`` was
chosen.

K2 (``--kernel encoder``): the same for the fused encoder layer at the
served width (T = 10, d = 256, H = 8, 4x MLP): each shape of the forward
kernel (the cluster shape, the pair shape and the large tile) against
:func:`fused_encoder.encoder_layer_reference` at several shapes, the cycle
counters by phase, then each shape and ``nn.TransformerEncoderLayer`` in
bf16 timed at B = 1 ... 4096, which is how ``fused_encoder.SMALL_BATCH_MAX``
and ``PAIR_BATCH_MIN`` were chosen. ``--baseline DIR`` also times the
``fused_encoder_layer`` of the
checkout in DIR (another commit, unpacked with ``git archive``) in the same
run, before and after this tree's: baseline, this tree, this tree,
baseline.

K4 (``--kernel groundlink``): the fused GroundLink forward at the served
width (177 -> 128 -> 128 -> 256 -> 256, k = 7, T = 10, fc_depth 3): both
shapes against :func:`fused_groundlink.groundlink_reference` at several
shapes, the cycle counters by layer and exchange, the large shape's tile
(windows a block) swept at a few batches, then both shapes, the bf16
``F.conv1d``/``F.linear`` chain and, with ``--baseline DIR``, the other
checkout's K4 timed at B = 1 ... 4096 in both output formats, which is how
``fused_groundlink.SMALL_BATCH_MAX``, ``LARGE_WINDOWS`` and
``LARGE_BLOCKS`` were chosen.

K3 (``--kernel encoder_bwd``): the encoder layer's backward at the served
width: each shape of the tile kernel that the tree has (with
``fused_encoder.plan_encoder_bwd``: the cluster shape, the pair shape and
the large tile) against :func:`fused_encoder.encoder_layer_bwd_reference`
at several shapes (dx and the 12 gradients, two calls bitwise equal), the
small and pair shapes' cycle counters by phase, then the profiler's device
time by launch (tile kernel, weight-gradient kernel, reduce) of each shape,
``torch.autograd.grad`` through ``nn.TransformerEncoderLayer`` in bf16 and,
with ``--baseline DIR``, the other checkout's backward, at B = 1 ... 4096;
this is how ``fused_encoder.BWD_SMALL_BATCH_MAX`` and
``BWD_PAIR_BATCH_MIN`` were chosen. Then the weight-gradient stage alone
(``fused_encoder.encoder_wgrad``) by launch at the same batches, beside four
bf16 ``torch.mm`` on the same workspace and its bound.

It needs a CUDA device and prints the card's name with the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch

from inferbiomechanics_tpu_torch.ops import _build
from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg
from inferbiomechanics_tpu_torch.ops import fused_mlp as fm

FULL = [1770, 512, 512, 30]
SHAPES = [
    (1, FULL, 'sigmoid'), (2, FULL, 'relu'), (17, FULL, 'tanh'), (63, FULL, 'gelu'),
    (64, FULL, 'elu'), (65, FULL, 'sigmoid'), (fm.SMALL_BATCH_MAX, FULL, 'sigmoid'),
    (fm.SMALL_BATCH_MAX + 1, FULL, 'sigmoid'), (4096, FULL, 'sigmoid'), (4099, FULL, 'sigmoid'),
    (37, [1770, 512, 512, 300], 'gelu'), (5, [708, 64, 48, 30], 'elu'),
    (70, [177, 256, 256, 256, 30], 'tanh'), (300, [177, 256, 256, 256, 30], 'tanh'),
    (16, [2048, 1024, 1024], 'sigmoid'), (200, [2048, 1024, 1024], 'sigmoid'),
    (9, [33, 30], 'relu'), (150, [33, 30], 'relu'),
    (3, [100] + [72] * 7 + [30], 'sigmoid'), (140, [100] + [72] * 7 + [30], 'sigmoid'),
]


def _params(dims, gen):
    return [((torch.rand(d0, d1, generator=gen) * 2 - 1) / d0 ** 0.5,
             (torch.rand(d1, generator=gen) * 2 - 1) / d0 ** 0.5)
            for d0, d1 in zip(dims[:-1], dims[1:])]


def _time_us(fn, iters):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


# A profiler trace was seen to lose the first kernels of its window: the
# first ~75 of a chunk's replays, and the first ~10 of a train step 50 ms
# after the window opened. So a window opens with PRE_ROLL launches of a
# one-element kernel that are not counted, then the device idles
# TRACE_MARGIN_S before the traced work and after it.
TRACE_MARGIN_S = 0.05
PRE_ROLL = 256
WORK_RANGE = 'traced work'


class ShortTraceError(AssertionError):
    """A profiler trace that lacks some of the launches it ran."""


def traced_kernels(fn, host: bool = True):
    """Run ``fn()`` once under ``torch.profiler``; return its result and the
    (name, device us) of each GPU kernel (and copy) that started after
    ``fn()`` did, in trace order. ``host`` False traces the device alone (a
    whole training run holds ~10^5 host operations, which a trace of the
    host takes minutes to record and read): the work then starts after the
    pre-roll's idle margin, the first gap of at least half of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    one = torch.zeros(1, device='cuda')
    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(PRE_ROLL):
            one.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
        with record_function(WORK_RANGE):
            result = fn()
            torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    # the range itself shows on the device's timeline too: not a kernel
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and e.name != WORK_RANGE]
    if host:
        begin = min(e.time_range.start for e in prof.events() if e.name == WORK_RANGE)
        return result, [(e.name, e.time_range.elapsed_us()) for e in device
                        if e.time_range.start >= begin]
    device.sort(key=lambda e: e.time_range.start)
    gap_us = TRACE_MARGIN_S / 2 * 1e6
    first = next((i for i in range(1, len(device)) if device[i].time_range.start
                  - device[i - 1].time_range.end >= gap_us), None)
    if first is None or first > PRE_ROLL:
        raise ShortTraceError(f'no idle margin after the pre-roll in a trace of '
                              f'{len(device)} device events')
    return result, [(e.name, e.time_range.elapsed_us()) for e in device[first:]]


def device_times(fn, iters=20):
    """Profiler device time of ``fn``'s kernels: ``(us, traced)``. One
    traced call gives the launches a call, by kernel name; ``iters`` traced
    calls give the durations and ``traced``, their launches by name.
    ``us[name]`` is a call's time in that kernel: its summed duration over
    the launches traced, divided by that count (not by ``iters``), times
    its launches a call. Raises :class:`ShortTraceError` unless the second
    trace holds ``iters`` x the first's launches of every kernel."""
    fn()
    torch.cuda.synchronize()
    _, one = traced_kernels(fn)
    per_call = Counter(name for name, _ in one)
    _, many = traced_kernels(lambda: [fn() for _ in range(iters)])
    traced = Counter(name for name, _ in many)
    want = Counter({name: n * iters for name, n in per_call.items()})
    if traced != want:
        lost = {k: (traced[k], v) for k, v in want.items() if traced[k] != v}
        extra = sorted(set(traced) - set(want))
        raise ShortTraceError(f'profiler trace short of its launches (traced, want): '
                              f'{lost}{f", unexpected {extra}" if extra else ""}')
    total = Counter()
    for name, us in many:
        total[name] += us
    return {name: total[name] / traced[name] * n for name, n in per_call.items()}, traced


def device_us_by_name(fn, names, iters=20):
    """Device time a call of the GPU kernels whose name holds each of
    ``names`` (and of all the others, ``other``), and how many launches of
    each the profiler traced over ``iters`` calls (:func:`device_times`)."""
    us, traced = device_times(fn, iters)
    out = {n: 0.0 for n in (*names, 'other')}
    seen = {n: 0 for n in out}
    for name, t in us.items():
        key = next((n for n in names if n in name), 'other')
        out[key] += t
        seen[key] += traced[name]
    return out, seen


def device_us(fn, iters=20):
    """Device time a call: :func:`device_times` summed over the kernels."""
    return sum(device_times(fn, iters)[0].values())


# K2: the served width, and the batches it is timed at (either side of both
# thresholds among them, and of the batches where the pair shape needs a
# second wave of clusters, 397-528 windows, which the plan gives the large
# shape)
ENC = dict(t=10, d=256, heads=8, m=1024)
_THRESHOLDS = (fe.SMALL_BATCH_MAX, getattr(fe, 'PAIR_BATCH_MIN', fe.SMALL_BATCH_MAX + 1))
ENC_BATCHES = tuple(sorted({1, 2, 4, 8, 14, 16, 28, 37, 42, 48, 56, 57, 64, 65, 96, 128, 256,
                            396, 397, 512, 528, 529, 4096}
                           | {b + e for b in _THRESHOLDS for e in (-1, 0, 1)} - {0}))
# (batch, t, d, heads, mlp_ratio) that every shape that takes it is checked at
ENC_SHAPES = [(1, 10, 256, 8, 4), (5, 10, 256, 8, 4), (37, 10, 256, 8, 4),
              (64, 10, 256, 8, 4), (4099, 10, 256, 8, 4), (64, 4, 256, 16, 4),
              (19, 16, 256, 4, 4), (23, 7, 256, 8, 2), (13, 10, 256, 8, 6),
              (37, 4, 128, 4, 4), (37, 10, 384, 8, 4), (9, 48, 256, 8, 4),
              (5, 16, 768, 8, 4)]
ENC_TOL = 1e-2       # rtol = atol, as tests/test_torch_cuda_kernels.py holds K2


def library_encoder_layer(params, d, heads, m):
    """K2's speed baseline, not the precision reference: PyTorch's own
    encoder layer in bf16 on the same weights (pre-LN, tanh GELU, eps 1e-6;
    its ``in_proj`` columns are ``[q | k | v]`` too). Timed beside the kernel,
    used nowhere in the port."""
    from torch import nn
    import torch.nn.functional as F
    layer = nn.TransformerEncoderLayer(
        d, heads, m, dropout=0.0, activation=lambda v: F.gelu(v, approximate='tanh'),
        layer_norm_eps=1e-6, batch_first=True, norm_first=True)
    g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bm1, w2, bm2 = (
        p.float() for p in params)
    with torch.no_grad():
        for dst, src in ((layer.norm1.weight, g1), (layer.norm1.bias, b1),
                         (layer.self_attn.in_proj_weight, wqkv.t()),
                         (layer.self_attn.in_proj_bias, bqkv),
                         (layer.self_attn.out_proj.weight, wproj.t()),
                         (layer.self_attn.out_proj.bias, bproj),
                         (layer.norm2.weight, g2), (layer.norm2.bias, b2),
                         (layer.linear1.weight, w1.t()), (layer.linear1.bias, bm1),
                         (layer.linear2.weight, w2.t()), (layer.linear2.bias, bm2)):
            dst.copy_(src)
    return layer.to(device='cuda', dtype=torch.bfloat16).eval()


def _encoder_params(gen, d, m):
    params = list(fe.init_encoder_params(gen, d, m // d))
    for i, p in enumerate(params):
        if p.ndim == 1:   # biases and LayerNorm rows that show a wrong add
            noise = torch.randn(p.shape, generator=gen)
            params[i] = (1.0 + 0.2 * noise) if i in (0, 6) else 0.3 * noise
    return params


def _encoder_shapes(forced):
    """The shapes to time: this tree's three, each with the thresholds
    (``SMALL_BATCH_MAX``, ``PAIR_BATCH_MIN``) with which it takes every
    batch it can, or whatever the loaded tree's plan picks (None)."""
    if forced and hasattr(fe, 'thresholds'):
        return {shape: fe.thresholds(shape) for shape in ('small', 'pair', 'large')}
    return {'kernel': None}


def _set_thresholds(limits) -> None:
    if limits is not None:
        fe.SMALL_BATCH_MAX, fe.PAIR_BATCH_MIN = limits


def _saved_thresholds():
    """This tree's thresholds, to put back (None for a tree without the
    pair shape, whose single threshold is left alone)."""
    if hasattr(fe, 'PAIR_BATCH_MIN'):
        return fe.SMALL_BATCH_MAX, fe.PAIR_BATCH_MIN
    return None


def encoder_times(tag, forced=True):
    """JSON lines of K2's time at the served width at every batch of
    :data:`ENC_BATCHES`: CUDA events around 200 launches, and profiler
    device time, for each shape of this tree's kernel (or for the kernel of
    the tree on ``sys.path``)."""
    gen = torch.Generator().manual_seed(0)
    packed = fe.pack_encoder_params(_encoder_params(gen, ENC['d'], ENC['m']), 'cuda')
    saved = _saved_thresholds()
    for batch in ENC_BATCHES:
        x = torch.randn(batch, ENC['t'], ENC['d'], generator=gen).cuda()
        row = {'tree': tag, 'batch': batch}
        for name, limits in _encoder_shapes(forced).items():
            _set_thresholds(limits)
            run = lambda: fe.fused_encoder_layer(x, packed, ENC['heads'])   # noqa: E731
            row[f'{name}_us'] = _time_us(run, 200)
            row[f'{name}_device_us'] = device_us(run)
        _set_thresholds(saved)
        print(json.dumps(row), flush=True)


def encoder_clocks():
    """JSON lines of the forward kernel's cycle counters by phase (thread 0
    of each block, clock64 between the phases' barriers; the pair shape's
    summed over a block's tiles, with its warp 0's waits for weights): the
    mean over the blocks and the slowest block's total, for each shape at a
    few batches."""
    gen = torch.Generator().manual_seed(0)
    packed = fe.pack_encoder_params(_encoder_params(gen, ENC['d'], ENC['m']), 'cuda')
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    saved = _saved_thresholds()
    for shape, batch in (('small', 1), ('small', 4), ('small', 37), ('large', 1),
                         ('large', 4096), ('pair', 65), ('pair', 128), ('pair', 512),
                         ('pair', 4096)):
        _set_thresholds(fe.thresholds(shape))
        plan = fe.plan_encoder(batch, ENC['t'], ENC['d'], ENC['m'], ENC['heads'])
        blocks, phases = fe.encoder_blocks(plan, batch, sms), plan.phases
        x = torch.randn(batch, ENC['t'], ENC['d'], generator=gen).cuda()
        fe.phase_clocks = torch.zeros(blocks * len(phases), dtype=torch.int64, device='cuda')
        for _ in range(3):          # the last call's counts stand
            fe.fused_encoder_layer(x, packed, ENC['heads'])
        torch.cuda.synchronize()
        cyc = fe.phase_clocks.view(blocks, len(phases)).double()
        fe.phase_clocks = None
        timed = cyc[:, :-1] if shape == 'pair' else cyc      # the waits lie within phases
        print(json.dumps({'clocks': shape, 'batch': batch, 'blocks': blocks,
                          'tiles': plan.tiles(batch),
                          'mean_cycles': dict(zip(phases, cyc.mean(0).tolist())),
                          'slowest_block_cycles': float(timed.sum(1).max())}), flush=True)
    _set_thresholds(saved)


def _baseline_times(tree: str, kernel: str = 'encoder') -> int:
    """Run the times of ``kernel`` (:func:`encoder_times`,
    :func:`groundlink_times`) of this file on the package of the checkout in
    ``tree``, in a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
    return subprocess.run([sys.executable, str(Path(__file__).resolve()), '--kernel', kernel,
                           '--times-only'], env=env, cwd=tree).returncode


def encoder_main(args) -> int:
    if args.times_only:
        torch.backends.cuda.matmul.allow_tf32 = False
        encoder_times(str(Path(fe.__file__).resolve().parents[2]), forced=False)
        return 0
    report = _build.build()
    for line in re.findall(r"Compiling entry function '(\S*encoder_kernel\S*)'.*?\n(.*?registers.*?)\n",
                           report['log'], flags=re.S):
        print('ptxas', line[0][:60], '|', ' '.join(line[1].split()))
    saved = _saved_thresholds()
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'build_seconds': report['seconds'],
                      'small_batch_max': fe.SMALL_BATCH_MAX,
                      'pair_batch_min': fe.PAIR_BATCH_MIN}), flush=True)
    worst = 0.0
    for batch, t, d, heads, ratio in ENC_SHAPES:
        gen = torch.Generator().manual_seed(batch + t + d)
        packed = fe.pack_encoder_params(_encoder_params(gen, d, d * ratio), 'cuda')
        x = torch.randn(batch, t, d, generator=gen).cuda()
        ref = fe.encoder_layer_reference(x, packed.params, heads)
        for shape, limits in _encoder_shapes(True).items():
            _set_thresholds(limits)
            plan = fe.plan_encoder(batch, t, d, d * ratio, heads)
            if plan.shape != shape:
                continue              # no cluster splits this shape, or the pair takes it not
            before = fe.shape_launches[shape]
            out = fe.fused_encoder_layer(x, packed, heads)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            excess = float(((out - ref).abs() - ENC_TOL * ref.abs()).max())
            counted = fe.shape_launches[shape] == before + 1
            print(json.dumps({'batch': batch, 't': t, 'd': d, 'heads': heads, 'shape': plan.shape,
                              'cluster': plan.cluster, 'row_tiles': plan.row_tiles,
                              'max_abs_err': err, 'excess': excess, 'counted': counted}),
                  flush=True)
            excess = excess if counted else float('inf')
            worst = max(worst, excess if excess == excess else float('inf'))
        _set_thresholds(saved)
    if worst > ENC_TOL:
        print(f'FAILED: K2 beyond rtol = atol = {ENC_TOL} by {worst}', file=sys.stderr)
        return 1
    if args.quick:
        return 0
    encoder_clocks()
    order = ['baseline', 'tree', 'tree', 'baseline'] if args.baseline else ['tree']
    for which in order:
        if which == 'baseline':
            if _baseline_times(args.baseline) != 0:
                return 1
        else:
            encoder_times('this tree')
    gen = torch.Generator().manual_seed(0)
    layer = library_encoder_layer(_encoder_params(gen, ENC['d'], ENC['m']), ENC['d'],
                                  ENC['heads'], ENC['m'])
    with torch.no_grad():
        for batch in ENC_BATCHES:
            x = torch.randn(batch, ENC['t'], ENC['d'], generator=gen).cuda().to(torch.bfloat16)
            run = lambda: layer(x)                                        # noqa: E731
            print(json.dumps({'library': 'nn.TransformerEncoderLayer bf16', 'batch': batch,
                              'us': _time_us(run, 200), 'device_us': device_us(run)}),
                  flush=True)
    return 0


# K4: the served width, the batches it is timed at, and the cases both shapes
# are checked at: (batch, t, c_in, features, fc_depth, taps, format)
GL = dict(t=10, c_in=177, features=(128, 128, 256, 256), fc_depth=3, taps=7)
GL_BATCHES = (1, 2, 4, 8, 14, 15, 28, 42, 56, 64, 84, 128, 256, 512, 1024, 2048, 4096)
GL_BOTH_FORMATS = (1, 8, 64, 512, 4096)
GL_SHAPES = [
    (1, 10, 177, GL['features'], 3, 7, 'last_frame'),
    (1, 10, 177, GL['features'], 3, 7, 'all_frames'),
    (7, 10, 177, GL['features'], 3, 7, 'last_frame'),
    (56, 10, 177, GL['features'], 3, 7, 'all_frames'),
    (57, 10, 177, GL['features'], 3, 7, 'last_frame'),
    (4099, 10, 177, GL['features'], 3, 7, 'last_frame'),
    (4099, 10, 177, GL['features'], 3, 7, 'all_frames'),
    (37, 4, 177, (16, 16, 24, 24), 3, 7, 'last_frame'),
    (37, 10, 177, GL['features'], 1, 7, 'last_frame'),
    (5, 7, 100, (64, 48), 2, 7, 'all_frames'),
    (3, 64, 177, (32, 32), 2, 7, 'last_frame'),
    (200, 1, 177, (512,), 2, 7, 'all_frames'),
    (9, 10, 177, (32, 32), 3, 3, 'all_frames'),
    (300, 40, 177, (512, 512), 2, 7, 'all_frames'),
]
GL_REL = 1e-2        # x max|plain|, as tests/test_torch_cuda_kernels.py holds K4
GL_TILES = (2, 4, 6, 8, 12, 16, 20, 24, 32)


def random_groundlink_params(gen, c_in, features, fc_depth, taps=7):
    """A seeded flax-layout GroundLink tree with He-scaled kernels and random
    biases (the model's init has zero biases, and a wrong bias add would go
    unseen)."""
    def draw(*shape, fan_in):
        return torch.randn(*shape, generator=gen) * (2.0 / fan_in) ** 0.5
    tree, c = {}, c_in
    for i, f in enumerate(features):
        tree[f'Conv_{i}'] = {'kernel': draw(taps, c, f, fan_in=taps * c),
                             'bias': 0.3 * torch.randn(f, generator=gen)}
        c = f
    for j in range(fc_depth - 1):
        tree[f'Dense_{j}'] = {'kernel': draw(c, c, fan_in=c),
                              'bias': 0.3 * torch.randn(c, generator=gen)}
    tree[f'Dense_{fc_depth - 1}'] = {'kernel': draw(c, 30, fan_in=c)}
    return tree


def library_groundlink(params, fc_depth):
    """K4's speed baseline, not the precision reference: the same stack as
    PyTorch's own bf16 calls (replicate ``F.pad`` + ``F.conv1d`` + ``F.elu``
    per conv, then ``F.linear``), on weights cast and laid out once; returns
    ``forward(x, fmt)``. Timed beside the kernel, used nowhere in the port."""
    import torch.nn.functional as F
    bf = torch.bfloat16
    convs, i = [], 0
    while f'Conv_{i}' in params:
        p = params[f'Conv_{i}']
        convs.append((p['kernel'].permute(2, 1, 0).contiguous().to(bf), p['bias'].to(bf)))
        i += 1
    fcs = [(params[f'Dense_{j}']['kernel'].t().contiguous().to(bf),
            params[f'Dense_{j}']['bias'].to(bf)) for j in range(fc_depth - 1)]
    head = params[f'Dense_{fc_depth - 1}']['kernel'].t().contiguous().to(bf)

    def forward(x, fmt):
        h = x.to(bf).transpose(1, 2)                      # [B, C, T]
        for w, b in convs:
            half = w.shape[2] // 2
            h = F.elu(F.conv1d(F.pad(h, (half, half), mode='replicate'), w, b))
        h = h.transpose(1, 2)
        if fmt != 'all_frames':
            h = h[:, -1:, :]
        for w, b in fcs:
            h = F.elu(F.linear(h, w, b))
        return F.linear(h, head).float()

    return forward


def _gl_shapes(forced):
    """The shapes to time: this tree's two (the threshold moved so that each
    takes every batch), or whatever the loaded tree's plan picks."""
    if forced and hasattr(fg, 'plan_groundlink'):
        return {'small': 1 << 30, 'large': 0}
    return {'kernel': None}


def _gl_formats(batch):
    return ('last_frame', 'all_frames') if batch in GL_BOTH_FORMATS else ('last_frame',)


def _sustained(run, iters=1000):
    """CUDA-event time a launch over a burst of 10 launches and over a run of
    ``iters``, and the median SM clock (MHz) and power draw (W) that
    ``nvidia-smi`` sampled every 50 ms during the long run."""
    burst = _time_us(run, 10)
    smi = subprocess.Popen(['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
                            '--format=csv,noheader,nounits', '-lms', '50'],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        us = _time_us(run, iters)
    finally:
        smi.terminate()
        lines = smi.communicate(timeout=30)[0].splitlines()
    samples = sorted(tuple(float(v) for v in line.split(',')) for line in lines
                     if line.count(',') == 1 and '[' not in line)
    mid = samples[len(samples) // 2] if samples else (None, None)
    return {'burst_us': burst, 'sustained_us': us, 'sm_mhz': mid[0],
            'power_w': sorted(p for _, p in samples)[len(samples) // 2] if samples else None,
            'samples': len(samples)}


def groundlink_times(tag, forced=True):
    """JSON lines of K4's time at the served width at every batch of
    :data:`GL_BATCHES` (both formats at :data:`GL_BOTH_FORMATS`): CUDA events
    around 200 launches and profiler device time, for each shape of this
    tree's kernel (or for the kernel of the tree on ``sys.path``); at the
    largest batch also :func:`_sustained` (clock and power) but for the small
    shape."""
    gen = torch.Generator().manual_seed(0)
    packed = fg.pack_groundlink_params(
        random_groundlink_params(gen, GL['c_in'], GL['features'], GL['fc_depth'], GL['taps']),
        'cuda')
    threshold = getattr(fg, 'SMALL_BATCH_MAX', None)
    for batch in GL_BATCHES:
        x = torch.randn(batch, GL['t'], GL['c_in'], generator=gen).cuda()
        for fmt in _gl_formats(batch):
            row = {'tree': tag, 'batch': batch, 'format': fmt}
            for name, limit in _gl_shapes(forced).items():
                if limit is not None:
                    fg.SMALL_BATCH_MAX = limit
                run = lambda: fg.fused_groundlink_forward(x, packed, fmt)   # noqa: E731
                row[f'{name}_us'] = _time_us(run, 200)
                row[f'{name}_device_us'] = device_us(run)
                if batch == GL_BATCHES[-1] and name != 'small':
                    row[f'{name}_sustained'] = _sustained(run)
            if threshold is not None:
                fg.SMALL_BATCH_MAX = threshold
            print(json.dumps(row), flush=True)


def groundlink_clocks():
    """JSON lines of the kernel's cycle counters by layer and exchange (thread
    0 of each block, clock64 between the phases' barriers): the mean over the
    blocks and the slowest block's total, for each shape at a few batches."""
    gen = torch.Generator().manual_seed(0)
    packed = fg.pack_groundlink_params(
        random_groundlink_params(gen, GL['c_in'], GL['features'], GL['fc_depth'], GL['taps']),
        'cuda')
    names = fg.phase_names(len(GL['features']), GL['fc_depth'])
    threshold = fg.SMALL_BATCH_MAX
    for shape, batch, fmt in (('small', 1, 'last_frame'), ('small', 1, 'all_frames'),
                              ('small', 56, 'last_frame'), ('large', 1, 'last_frame'),
                              ('large', 4096, 'last_frame'), ('large', 4096, 'all_frames')):
        fg.SMALL_BATCH_MAX = 1 << 30 if shape == 'small' else 0
        plan = fg.plan_groundlink(batch, GL['t'], packed.pwidths, packed.n_conv,
                                  packed.fc_depth, packed.taps, fmt != 'all_frames')
        blocks = plan.blocks(batch)
        x = torch.randn(batch, GL['t'], GL['c_in'], generator=gen).cuda()
        fg.phase_clocks = torch.zeros(blocks * fg._PHASES, dtype=torch.int64, device='cuda')
        for _ in range(3):          # the last call's counts stand
            fg.fused_groundlink_forward(x, packed, fmt)
        torch.cuda.synchronize()
        cyc = fg.phase_clocks.view(blocks, fg._PHASES)[:, :len(names)].double()
        fg.phase_clocks = None
        print(json.dumps({'clocks': shape, 'batch': batch, 'format': fmt, 'blocks': blocks,
                          'windows': plan.windows, 'cluster': plan.cluster,
                          'mean_cycles': dict(zip(names, cyc.mean(0).tolist())),
                          'slowest_block_cycles': float(cyc.sum(1).max())}), flush=True)
    fg.SMALL_BATCH_MAX = threshold


def groundlink_tiles():
    """JSON lines of the large shape's device time at B = 512, 1024 and 4096
    for each tile of :data:`GL_TILES` windows a block, in both formats."""
    gen = torch.Generator().manual_seed(0)
    packed = fg.pack_groundlink_params(
        random_groundlink_params(gen, GL['c_in'], GL['features'], GL['fc_depth'], GL['taps']),
        'cuda')
    saved = fg.SMALL_BATCH_MAX, fg.LARGE_WINDOWS, fg.LARGE_WINDOWS_ALL_FRAMES, fg.LARGE_BLOCKS
    fg.SMALL_BATCH_MAX, fg.LARGE_BLOCKS = 0, 1
    for batch in (512, 1024, 4096):
        x = torch.randn(batch, GL['t'], GL['c_in'], generator=gen).cuda()
        for fmt in ('last_frame', 'all_frames'):
            row = {'tiles': fmt, 'batch': batch}
            for windows in GL_TILES:
                fg.LARGE_WINDOWS = fg.LARGE_WINDOWS_ALL_FRAMES = windows
                plan = fg.plan_groundlink(batch, GL['t'], packed.pwidths, packed.n_conv,
                                          packed.fc_depth, packed.taps, fmt != 'all_frames')
                run = lambda: fg.fused_groundlink_forward(x, packed, fmt)   # noqa: E731
                _time_us(run, 50)           # clocks up before the profiler's calls
                row[f'{plan.windows}w_{plan.blocks(batch)}b_device_us'] = device_us(run)
            print(json.dumps(row), flush=True)
    fg.SMALL_BATCH_MAX, fg.LARGE_WINDOWS, fg.LARGE_WINDOWS_ALL_FRAMES, fg.LARGE_BLOCKS = saved


def groundlink_main(args) -> int:
    if args.times_only:
        torch.backends.cuda.matmul.allow_tf32 = False
        groundlink_times(str(Path(fg.__file__).resolve().parents[2]), forced=False)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    report = _build.build()
    for line in re.findall(r"Compiling entry function '(\S*groundlink\S*)'.*?\n(.*?registers.*?)\n",
                           report['log'], flags=re.S):
        print('ptxas', line[0][:70], '|', ' '.join(line[1].split()))
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'build_seconds': report['seconds'],
                      'small_batch_max': fg.SMALL_BATCH_MAX,
                      'large_windows': fg.LARGE_WINDOWS,
                      'large_windows_all_frames': fg.LARGE_WINDOWS_ALL_FRAMES,
                      'large_blocks': fg.LARGE_BLOCKS}), flush=True)
    threshold = fg.SMALL_BATCH_MAX
    worst = 0.0
    for batch, t, c_in, features, fc_depth, taps, fmt in GL_SHAPES:
        gen = torch.Generator().manual_seed(batch + t + c_in)
        packed = fg.pack_groundlink_params(
            random_groundlink_params(gen, c_in, features, fc_depth, taps), 'cuda')
        x = torch.randn(batch, t, c_in, generator=gen).cuda()
        ref = fg.groundlink_reference(x, packed.params, fmt, fc_depth)
        for shape, limit in _gl_shapes(True).items():
            fg.SMALL_BATCH_MAX = limit
            before = dict(fg.shape_launches)
            out = fg.fused_groundlink_forward(x, packed, fmt)
            again = fg.fused_groundlink_forward(x, packed, fmt)
            torch.cuda.synchronize()
            rel = float((out - ref).abs().max()) / float(ref.abs().max())
            plan = fg.plan_groundlink(batch, t, packed.pwidths, packed.n_conv, fc_depth, taps,
                                      fmt != 'all_frames')
            print(json.dumps({'batch': batch, 't': t, 'features': features,
                              'fc_depth': fc_depth, 'taps': taps, 'format': fmt,
                              'shape': plan.shape, 'cluster': plan.cluster,
                              'windows': plan.windows, 'rel_err': rel,
                              'bitwise_repeat': bool(torch.equal(out, again)),
                              'launched': fg.shape_launches[shape] - before[shape]}),
                  flush=True)
            if not torch.equal(out, again) or fg.shape_launches[shape] != before[shape] + 2:
                rel = float('inf')
            worst = max(worst, rel if rel == rel else float('inf'))
        fg.SMALL_BATCH_MAX = threshold
    if worst > GL_REL:
        print(f'FAILED: K4 beyond {GL_REL} x max|plain| (or not repeatable): {worst}',
              file=sys.stderr)
        return 1
    if args.quick:
        return 0
    groundlink_clocks()
    groundlink_tiles()
    order = ['baseline', 'tree', 'tree', 'baseline'] if args.baseline else ['tree']
    for which in order:
        if which == 'baseline':
            if _baseline_times(args.baseline, 'groundlink') != 0:
                return 1
        else:
            groundlink_times('this tree')
    gen = torch.Generator().manual_seed(0)
    tree = random_groundlink_params(gen, GL['c_in'], GL['features'], GL['fc_depth'], GL['taps'])
    library = library_groundlink(
        {name: {k: v.cuda() for k, v in node.items()} for name, node in tree.items()},
        GL['fc_depth'])
    with torch.no_grad():
        for batch in GL_BATCHES:
            x = torch.randn(batch, GL['t'], GL['c_in'], generator=gen).cuda()
            for fmt in _gl_formats(batch):
                run = lambda: library(x, fmt)                             # noqa: E731
                print(json.dumps({'library': 'bf16 F.conv1d/F.linear chain', 'batch': batch,
                                  'format': fmt, 'us': _time_us(run, 200),
                                  'device_us': device_us(run)}), flush=True)
    return 0

# K3: the batches its backward is timed at, the cases each shape is checked
# at (batch, t, d, heads, mlp_ratio), and the names of its three launches
BWD_BATCHES = (1, 8, 16, 32, 40, 42, 43, 48, 56, 64, 65, 80, 96, 112, 127, 128, 256, 512,
               1024, 4096)
BWD_SHAPES = [(1, 10, 256, 8, 4), (8, 10, 256, 8, 4), (19, 10, 256, 8, 4),
              (64, 10, 256, 8, 4), (65, 10, 256, 8, 4), (128, 10, 256, 8, 4),
              (4099, 10, 256, 8, 4), (37, 4, 256, 8, 4), (19, 16, 256, 16, 4),
              (23, 7, 256, 4, 2), (37, 10, 128, 4, 4), (9, 10, 512, 8, 4),
              (700, 4, 128, 4, 2)]
BWD_REL = 2e-2       # x max|plain|, as tests/test_torch_cuda_kernels.py holds K3
BWD_KERNELS = ('encoder_bwd_tile_kernel', 'encoder_wgrad_kernel', 'encoder_bwd_reduce_kernel')
# above this batch the small shape is timed no more (it takes many waves there)
_BWD_SMALL_TIMED_MAX = 1024


def _bwd_shapes(forced, batch):
    """The shapes of K3 to time at ``batch``: this tree's three, each with
    the thresholds (``BWD_SMALL_BATCH_MAX``, ``BWD_PAIR_BATCH_MIN``) with
    which it takes the batch, or whatever the loaded tree runs (None)."""
    if forced and hasattr(fe, 'bwd_thresholds'):
        return {shape: fe.bwd_thresholds(shape) for shape in ('small', 'pair', 'large')
                if shape != 'small' or batch <= _BWD_SMALL_TIMED_MAX}
    return {'kernel': None}


def _set_bwd_thresholds(limits) -> None:
    if limits is not None:
        fe.BWD_SMALL_BATCH_MAX, fe.BWD_PAIR_BATCH_MIN = limits


def library_encoder_layer_grad(layer, x16, g16):
    """K3's speed baseline: ``torch.autograd.grad`` through the bf16
    ``nn.TransformerEncoderLayer`` (:func:`library_encoder_layer`), forward
    and backward, for dx and every parameter."""
    x16 = x16.detach().requires_grad_(True)
    return torch.autograd.grad(layer(x16), [x16, *layer.parameters()], g16)


def encoder_bwd_times(tag, forced=True):
    """JSON lines of K3's time at the served width at every batch of
    :data:`BWD_BATCHES`: CUDA events around 100 calls, and the profiler's
    device time a call by launch, for each shape of this tree's kernel (or
    for the kernel of the tree on ``sys.path``)."""
    gen = torch.Generator().manual_seed(0)
    packed = fe.pack_encoder_params(_encoder_params(gen, ENC['d'], ENC['m']), 'cuda',
                                    transposes=True)
    saved = _bwd_saved()
    for batch in BWD_BATCHES:
        x = torch.randn(batch, ENC['t'], ENC['d'], generator=gen).cuda()
        g = torch.randn(batch, ENC['t'], ENC['d'], generator=gen).cuda()
        row = {'tree': tag, 'batch': batch}
        for name, limits in _bwd_shapes(forced, batch).items():
            _set_bwd_thresholds(limits)
            run = lambda: fe.fused_encoder_layer_bwd(x, g, packed, ENC['heads'])   # noqa: E731
            row[f'{name}_us'] = _time_us(run, 100)
            by_launch, seen = device_us_by_name(run, BWD_KERNELS)
            row[f'{name}_device_us'] = sum(by_launch.values())
            row[f'{name}_by_launch_us'] = by_launch
            row[f'{name}_traced'] = seen
        _set_bwd_thresholds(saved)
        print(json.dumps(row), flush=True)


# the dense peaks of one H100 SXM (NVIDIA's data sheet), for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
WGRAD_KERNELS = ('encoder_wgrad_kernel', 'encoder_bwd_reduce_kernel')


def wgrad_bound(n: int, d: int, m: int):
    """The least time (us) the card could take for the weight-gradient
    stage on ``n`` rows, and what sets it: the bf16 workspace read once (8 d
    + 2 m values a row) and the f32 gradients written once, over the memory
    rate, against 2 n (4 d^2 + 2 d m) operations over the bf16 tensor-core
    peak."""
    w_total = 4 * d * d + 2 * d * m
    t_bytes = (n * (8 * d + 2 * m) * 2 + w_total * 4) / PEAK_BYTES * 1e6
    t_ops = 2.0 * n * w_total / PEAK_BF16_FLOPS * 1e6
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def wgrad_library(ws: torch.Tensor, n: int, d: int, m: int):
    """The stage's speed baseline, not its precision reference: four bf16
    ``torch.mm(A.t(), G)`` on the workspace's views (cuBLAS)."""
    widths = (d, 3 * d, d, d, d, m, m, d)
    views = [v.view(n, w) for v, w in zip(ws.split([n * w for w in widths]), widths)]
    pairs = list(zip(views[0::2], views[1::2]))
    return lambda: [torch.mm(a.t(), g) for a, g in pairs]


def encoder_wgrad_times(tag):
    """JSON lines of K3's weight-gradient stage alone at the served width
    (fused_encoder.encoder_wgrad on a random bf16 workspace of B T rows) at
    every batch of :data:`BWD_BATCHES`: the profiler's device time a call by
    launch (weight gradients, reduce) in the plan's schedule, beside four
    bf16 ``torch.mm`` on the same views and the bound."""
    gen = torch.Generator().manual_seed(1)
    d, m = ENC['d'], ENC['m']
    for batch in BWD_BATCHES:
        n = batch * ENC['t']
        ws = torch.randn(n * (8 * d + 2 * m), generator=gen).to(torch.bfloat16).cuda()
        plan = fe.plan_wgrad(n, d, m)
        run = lambda: fe.encoder_wgrad(ws, n, d, m)        # noqa: E731
        by_launch, seen = device_us_by_name(run, WGRAD_KERNELS)
        bound = wgrad_bound(n, d, m)
        print(json.dumps({'stage': tag, 'batch': batch, 'n': n,
                          'plan': plan.as_ints(torch.cuda.get_device_properties(0)
                                               .multi_processor_count),
                          'by_launch_us': by_launch, 'traced': seen,
                          'library_us': device_us(wgrad_library(ws, n, d, m)),
                          'bound_us': bound[0], 'bound_by': bound[1]}), flush=True)


def _bwd_saved():
    """This tree's thresholds, to put back (None for a tree without the
    pair shape, whose single threshold is left alone)."""
    if hasattr(fe, 'BWD_PAIR_BATCH_MIN'):
        return fe.BWD_SMALL_BATCH_MAX, fe.BWD_PAIR_BATCH_MIN
    return None


def encoder_bwd_clocks():
    """JSON lines of the small and pair shapes' cycle counters by phase
    (thread 0 of each block, clock64 between the phases' barriers; the pair
    shape's summed over a block's tiles, with its warp 0's waits for
    weights): the mean over the blocks and the slowest block's total, at a
    few batches each."""
    gen = torch.Generator().manual_seed(0)
    packed = fe.pack_encoder_params(_encoder_params(gen, ENC['d'], ENC['m']), 'cuda',
                                    transposes=True)
    saved = _bwd_saved()
    for shape, batches in (('small', (1, 8, 32, 64)), ('pair', (65, 128, 512, 4096))):
        _set_bwd_thresholds(fe.bwd_thresholds(shape))
        for batch in batches:
            plan = fe.plan_encoder_bwd(batch, ENC['t'], ENC['d'], ENC['m'], ENC['heads'])
            blocks = fe.bwd_blocks(plan, batch,
                                   torch.cuda.get_device_properties(0).multi_processor_count)
            phases = plan.phases
            x = torch.randn(batch, ENC['t'], ENC['d'], generator=gen).cuda()
            g = torch.randn(batch, ENC['t'], ENC['d'], generator=gen).cuda()
            fe.bwd_phase_clocks = torch.zeros(blocks * len(phases), dtype=torch.int64,
                                              device='cuda')
            for _ in range(3):          # the last call's counts stand
                fe.fused_encoder_layer_bwd(x, g, packed, ENC['heads'])
            torch.cuda.synchronize()
            cyc = fe.bwd_phase_clocks.view(blocks, len(phases)).double()
            fe.bwd_phase_clocks = None
            timed = cyc[:, :-1] if shape == 'pair' else cyc    # the waits lie within phases
            print(json.dumps({'clocks': shape, 'batch': batch, 'blocks': blocks,
                              'row_tiles': plan.row_tiles, 'tiles': plan.tiles(batch),
                              'mean_cycles': dict(zip(phases, cyc.mean(0).tolist())),
                              'slowest_block_cycles': float(timed.sum(1).max())}),
                  flush=True)
    _set_bwd_thresholds(saved)


def _check_bwd() -> float:
    """Each shape of this tree's K3 against the plain version at
    :data:`BWD_SHAPES`; the worst error relative to a tensor's max|plain|
    (infinite if two calls differ or the launch counters are off)."""
    worst = 0.0
    names = ('x',) + fe.PARAM_NAMES
    for batch, t, d, heads, ratio in BWD_SHAPES:
        gen = torch.Generator().manual_seed(batch + t + d)
        packed = fe.pack_encoder_params(_encoder_params(gen, d, d * ratio), 'cuda',
                                        transposes=True)
        x = torch.randn(batch, t, d, generator=gen).cuda()
        g = torch.randn(batch, t, d, generator=gen).cuda()
        ref = fe.encoder_layer_bwd_reference(x, g, packed.params, heads)
        ref = (ref[0], *ref[1])
        for shape, limits in _bwd_shapes(True, 0).items():
            _set_bwd_thresholds(limits)
            plan = fe.plan_encoder_bwd(batch, t, d, d * ratio, heads)
            if plan.shape != shape:
                continue              # no cluster splits this shape, or the pair takes it not
            before = dict(fe.bwd_shape_launches)
            launches = fe.bwd_launches
            one = fe.fused_encoder_layer_bwd(x, g, packed, heads)
            two = fe.fused_encoder_layer_bwd(x, g, packed, heads)
            torch.cuda.synchronize()
            one, two = (one[0], *one[1]), (two[0], *two[1])
            rel = {n: float((a - r).abs().max()) / float(r.abs().max())
                   for n, a, r in zip(names, one, ref)}
            repeat = all(torch.equal(a, b) for a, b in zip(one, two))
            counted = (fe.bwd_shape_launches[shape] == before[shape] + 2
                       and fe.bwd_launches == launches + 2 * fe.BWD_LAUNCHES_PER_LAYER)
            at = max(rel, key=rel.get)
            print(json.dumps({'batch': batch, 't': t, 'd': d, 'heads': heads,
                              'shape': plan.shape, 'cluster': plan.cluster,
                              'row_tiles': plan.row_tiles, 'windows': plan.windows,
                              'worst_rel_err': rel[at], 'at': 'd' + at,
                              'bitwise_repeat': repeat, 'counted': counted}), flush=True)
            err = rel[at] if repeat and counted else float('inf')
            worst = max(worst, err if err == err else float('inf'))
    return worst


# (n, d, m) the weight-gradient stage alone is checked at: one ragged box,
# ragged last boxes and ranges, the served width at B = 64, 512, 4096 and
# 4099, the other widths K3 takes
WGRAD_SHAPES = [(10, 256, 1024), (190, 256, 1024), (640, 256, 1024), (650, 256, 1024),
                (5120, 256, 1024), (40960, 256, 1024), (40990, 256, 1024), (37, 128, 512),
                (2800, 128, 256), (650, 384, 1536), (90, 512, 2048), (1, 128, 128)]


def _check_wgrad() -> float:
    """The weight-gradient stage alone against its plain version at
    :data:`WGRAD_SHAPES` on random bf16 workspaces; the worst error relative
    to a product's max|plain| (infinite if two calls differ)."""
    worst = 0.0
    for n, d, m in WGRAD_SHAPES:
        gen = torch.Generator().manual_seed(n + d + m)
        ws = torch.randn(n * (8 * d + 2 * m), generator=gen).to(torch.bfloat16).cuda()
        ref = fe.encoder_wgrad_reference(ws, n, d, m)
        one, two = fe.encoder_wgrad(ws, n, d, m), fe.encoder_wgrad(ws, n, d, m)
        torch.cuda.synchronize()
        rel = max(float((a - r).abs().max()) / float(r.abs().max()) for a, r in zip(one, ref))
        repeat = all(torch.equal(a, b) for a, b in zip(one, two))
        print(json.dumps({'stage': [n, d, m], 'plan': fe.plan_wgrad(n, d, m).as_ints(
            torch.cuda.get_device_properties(0).multi_processor_count),
            'worst_rel_err': rel, 'bitwise_repeat': repeat}), flush=True)
        worst = max(worst, rel if repeat and rel == rel else float('inf'))
    return worst


def encoder_bwd_main(args) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.times_only:
        encoder_bwd_times(str(Path(fe.__file__).resolve().parents[2]), forced=False)
        return 0
    report = _build.build()
    for line in re.findall(r"Compiling entry function '(\S*encoder_(?:bwd|wgrad)\S*)'.*?\n"
                           r"(.*?registers.*?)\n", report['log'], flags=re.S):
        print('ptxas', line[0][:70], '|', ' '.join(line[1].split()))
    saved = _bwd_saved()
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'build_seconds': report['seconds'],
                      'bwd_small_batch_max': fe.BWD_SMALL_BATCH_MAX,
                      'bwd_pair_batch_min': fe.BWD_PAIR_BATCH_MIN}), flush=True)
    if hasattr(fe, 'plan_encoder_bwd'):
        worst = max(_check_bwd(), _check_wgrad())
        _set_bwd_thresholds(saved)
        if worst > BWD_REL:
            print(f'FAILED: K3 beyond {BWD_REL} x max|plain| (or not repeatable): {worst}',
                  file=sys.stderr)
            return 1
    if args.quick:
        return 0
    if hasattr(fe, 'BWD_PHASES'):
        encoder_bwd_clocks()
    order = ['baseline', 'tree', 'tree', 'baseline'] if args.baseline else ['tree']
    for which in order:
        if which == 'baseline':
            if _baseline_times(args.baseline, 'encoder_bwd') != 0:
                return 1
        else:
            encoder_bwd_times('this tree')
            encoder_wgrad_times('this tree')
    gen = torch.Generator().manual_seed(0)
    layer = library_encoder_layer(_encoder_params(gen, ENC['d'], ENC['m']), ENC['d'],
                                  ENC['heads'], ENC['m'])
    for batch in BWD_BATCHES:
        x16 = torch.randn(batch, ENC['t'], ENC['d'], generator=gen).cuda().to(torch.bfloat16)
        g16 = torch.randn(batch, ENC['t'], ENC['d'], generator=gen).cuda().to(torch.bfloat16)
        run = lambda: library_encoder_layer_grad(layer, x16, g16)        # noqa: E731
        try:
            dev = device_us(run)
        except ShortTraceError:       # a trace that lost launches: trace it once more
            dev = device_us(run)
        print(json.dumps({'library': 'autograd through nn.TransformerEncoderLayer bf16',
                          'batch': batch, 'us': _time_us(run, 100),
                          'device_us': dev}), flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--quick', action='store_true', help='build and check only')
    ap.add_argument('--kernel', choices=('mlp', 'encoder', 'groundlink', 'encoder_bwd'), default='mlp')
    ap.add_argument('--baseline', metavar='DIR',
                    help='(encoder, groundlink, encoder_bwd) also time the checkout in DIR, in the same run')
    ap.add_argument('--times-only', action='store_true', help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    if args.kernel == 'encoder':
        return encoder_main(args)
    if args.kernel == 'groundlink':
        return groundlink_main(args)
    if args.kernel == 'encoder_bwd':
        return encoder_bwd_main(args)
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    report = _build.build()
    for line in re.findall(r"Compiling entry function '(\S*mlp\S*)'.*?\n(.*?registers.*?)\n",
                           report['log'], flags=re.S):
        print('ptxas', line[0][:60], '|', ' '.join(line[1].split()))
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'build_seconds': report['seconds']}))

    worst = 0.0
    for batch, dims, act in SHAPES:
        gen = torch.Generator().manual_seed(batch)
        packed = fm.pack_mlp_params(_params(dims, gen), dev)
        x = torch.randn(batch, dims[0], generator=gen).to(dev)
        out = fm.fused_mlp_forward(x, packed, act)
        torch.cuda.synchronize()
        err = float((out - fm.mlp_reference(x, packed.layers, act)).abs().max())
        plan = fm.plan_mlp(batch, packed.pdims)
        print(json.dumps({'batch': batch, 'dims': dims, 'act': act, 'kernel': plan.kernel,
                          'rows': plan.rows, 'max_abs_err': err}))
        worst = max(worst, err if err == err else float('inf'))
    if worst > 1e-2:
        print(f'FAILED: max_abs_err {worst}', file=sys.stderr)
        return 1
    if args.quick:
        return 0

    gen = torch.Generator().manual_seed(0)
    params = _params(FULL, gen)
    packed = fm.pack_mlp_params(params, dev)
    chain = [(W.to(dev).bfloat16(), b.to(dev).bfloat16()) for W, b in params]

    def library(x):
        h = x.bfloat16()
        for i, (W, b) in enumerate(chain):
            h = torch.addmm(b, h, W)
            if i < len(chain) - 1:
                h = torch.sigmoid(h)
        return h.float()

    threshold = fm.SMALL_BATCH_MAX
    for batch in (1, 8, 32, 64, 128, 192, 256, 512, 1024, 4096):
        x = torch.randn(batch, FULL[0], generator=gen).to(dev)
        row = {'batch': batch}
        for name, limit in (('small_us', 1 << 30), ('large_us', 0)):
            fm.SMALL_BATCH_MAX = limit
            if name == 'small_us' and batch > 1024:
                continue
            run = lambda: fm.fused_mlp_forward(x, packed, 'sigmoid')   # noqa: E731
            row[name] = _time_us(run, 200)
            row[name.replace('_us', '_device_us')] = device_us(run)
        fm.SMALL_BATCH_MAX = threshold
        row['library_us'] = _time_us(lambda: library(x), 200)
        row['library_device_us'] = device_us(lambda: library(x))
        print(json.dumps(row))
    return 0


if __name__ == '__main__':
    sys.exit(main())
