"""Check and time the port's kernels that have two shapes on the card, batch by batch.

    python -m inferbiomechanics_tpu_torch.ops.tune [--quick]
    python -m inferbiomechanics_tpu_torch.ops.tune --kernel encoder [--quick] [--baseline DIR]

K1 (the default): builds the kernels, prints what ``-Xptxas -v`` says about
the MLP kernels, holds the kernel against :func:`fused_mlp.mlp_reference` over
a list of shapes, and then, for the full-width chain 1770 -> 512 -> 512 -> 30,
times the small-batch kernel, the large-batch kernel and a bf16 chain of
library calls at each batch (CUDA events around many launches, and the
profiler's device time), which is how ``fused_mlp.SMALL_BATCH_MAX`` was
chosen.

K2 (``--kernel encoder``): the same for the fused encoder layer at the
served width (T = 10, d = 256, H = 8, 4x MLP): both shapes of the forward
kernel against :func:`fused_encoder.encoder_layer_reference` at several
shapes, then both shapes and ``nn.TransformerEncoderLayer`` in bf16 timed
at B = 1 ... 4096, which is how ``fused_encoder.SMALL_BATCH_MAX`` was
chosen. ``--baseline DIR`` also times the ``fused_encoder_layer`` of the
checkout in DIR (another commit, unpacked with ``git archive``) in the same
run, before and after this tree's: baseline, this tree, this tree,
baseline.

It needs a CUDA device and prints the card's name with the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

from inferbiomechanics_tpu_torch.ops import _build
from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
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


def _device_us(fn, iters=20):
    """Device time a call: the GPU kernels' durations that ``torch.profiler``
    traced over ``iters`` calls, summed, over ``iters``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / iters


# K2: the served width, and the batches it is timed at
ENC = dict(t=10, d=256, heads=8, m=1024)
ENC_BATCHES = (1, 2, 4, 8, 14, 16, 37, 42, 48, 56, 64, 128, 256, 512, 4096)
ENC_PHASES = ('stage x, LN1', 'q/k/v', 'attention', 'a to all', 'projection', 'h to all',
              'LN2', 'W1', 'u to all', 'W2, store')
# (batch, t, d, heads, mlp_ratio) that both shapes are checked at
ENC_SHAPES = [(1, 10, 256, 8, 4), (5, 10, 256, 8, 4), (37, 10, 256, 8, 4),
              (4099, 10, 256, 8, 4), (37, 4, 128, 4, 4), (37, 10, 384, 8, 4),
              (9, 48, 256, 8, 4), (5, 16, 768, 8, 4)]
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
    """The shapes to time: this tree's two (the threshold moved so that each
    takes every batch), or whatever the loaded tree's plan picks."""
    if forced and hasattr(fe, 'plan_encoder'):
        return {'small': 1 << 30, 'large': 0}
    return {'kernel': None}


def encoder_times(tag, forced=True):
    """JSON lines of K2's time at the served width at every batch of
    :data:`ENC_BATCHES`: CUDA events around 200 launches, and profiler
    device time, for each shape of this tree's kernel (or for the kernel of
    the tree on ``sys.path``)."""
    gen = torch.Generator().manual_seed(0)
    packed = fe.pack_encoder_params(_encoder_params(gen, ENC['d'], ENC['m']), 'cuda')
    threshold = getattr(fe, 'SMALL_BATCH_MAX', None)
    for batch in ENC_BATCHES:
        x = torch.randn(batch, ENC['t'], ENC['d'], generator=gen).cuda()
        row = {'tree': tag, 'batch': batch}
        for name, limit in _encoder_shapes(forced).items():
            if limit is not None:
                fe.SMALL_BATCH_MAX = limit
            run = lambda: fe.fused_encoder_layer(x, packed, ENC['heads'])   # noqa: E731
            row[f'{name}_us'] = _time_us(run, 200)
            row[f'{name}_device_us'] = _device_us(run)
        if threshold is not None:
            fe.SMALL_BATCH_MAX = threshold
        print(json.dumps(row), flush=True)


def encoder_clocks():
    """JSON lines of the forward kernel's cycle counters by phase (thread 0
    of each block, clock64 between the phases' barriers): the mean over the
    blocks and the slowest block's total, for each shape at a few batches."""
    gen = torch.Generator().manual_seed(0)
    packed = fe.pack_encoder_params(_encoder_params(gen, ENC['d'], ENC['m']), 'cuda')
    threshold = fe.SMALL_BATCH_MAX
    for shape, batch in (('small', 1), ('small', 4), ('small', 37), ('large', 1),
                         ('large', 4096)):
        fe.SMALL_BATCH_MAX = 1 << 30 if shape == 'small' else 0
        plan = fe.plan_encoder(batch, ENC['t'], ENC['d'], ENC['m'], ENC['heads'])
        blocks = -(-batch // plan.windows) * plan.cluster
        x = torch.randn(batch, ENC['t'], ENC['d'], generator=gen).cuda()
        fe.phase_clocks = torch.zeros(blocks * len(ENC_PHASES), dtype=torch.int64,
                                      device='cuda')
        for _ in range(3):          # the last call's counts stand
            fe.fused_encoder_layer(x, packed, ENC['heads'])
        torch.cuda.synchronize()
        cyc = fe.phase_clocks.view(blocks, len(ENC_PHASES)).double()
        fe.phase_clocks = None
        print(json.dumps({'clocks': shape, 'batch': batch, 'blocks': blocks,
                          'mean_cycles': dict(zip(ENC_PHASES, cyc.mean(0).tolist())),
                          'slowest_block_cycles': float(cyc.sum(1).max())}), flush=True)
    fe.SMALL_BATCH_MAX = threshold


def _baseline_times(tree: str) -> int:
    """Run :func:`encoder_times` of this file on the package of the checkout
    in ``tree``, in a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
    return subprocess.run([sys.executable, str(Path(__file__).resolve()), '--kernel', 'encoder',
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
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'build_seconds': report['seconds'],
                      'small_batch_max': fe.SMALL_BATCH_MAX}), flush=True)
    threshold = fe.SMALL_BATCH_MAX
    worst = 0.0
    for batch, t, d, heads, ratio in ENC_SHAPES:
        gen = torch.Generator().manual_seed(batch + t + d)
        packed = fe.pack_encoder_params(_encoder_params(gen, d, d * ratio), 'cuda')
        x = torch.randn(batch, t, d, generator=gen).cuda()
        ref = fe.encoder_layer_reference(x, packed.params, heads)
        for shape, limit in _encoder_shapes(True).items():
            fe.SMALL_BATCH_MAX = limit
            if shape == 'small' and fe.small_cluster(d, heads) == 1:
                continue
            out = fe.fused_encoder_layer(x, packed, heads)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            excess = float(((out - ref).abs() - ENC_TOL * ref.abs()).max())
            plan = fe.plan_encoder(batch, t, d, d * ratio, heads)
            print(json.dumps({'batch': batch, 't': t, 'd': d, 'heads': heads, 'shape': plan.shape,
                              'cluster': plan.cluster, 'row_tiles': plan.row_tiles,
                              'max_abs_err': err, 'excess': excess}), flush=True)
            worst = max(worst, excess if excess == excess else float('inf'))
        fe.SMALL_BATCH_MAX = threshold
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
                              'us': _time_us(run, 200), 'device_us': _device_us(run)}),
                  flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--quick', action='store_true', help='build and check only')
    ap.add_argument('--kernel', choices=('mlp', 'encoder'), default='mlp')
    ap.add_argument('--baseline', metavar='DIR',
                    help='(encoder) also time the checkout in DIR, in the same run')
    ap.add_argument('--times-only', action='store_true', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    if args.kernel == 'encoder':
        return encoder_main(args)
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
            row[name.replace('_us', '_device_us')] = _device_us(run)
        fm.SMALL_BATCH_MAX = threshold
        row['library_us'] = _time_us(lambda: library(x), 200)
        row['library_device_us'] = _device_us(lambda: library(x))
        print(json.dumps(row))
    return 0


if __name__ == '__main__':
    sys.exit(main())
