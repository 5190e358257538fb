"""Check and time the fused MLP's two kernels on the card, batch by batch.

    python -m inferbiomechanics_tpu_torch.ops.tune [--quick]

Builds the kernels, prints what ``-Xptxas -v`` says about the MLP kernels,
holds the kernel against :func:`fused_mlp.mlp_reference` over a list of
shapes, and then, for the full-width chain 1770 -> 512 -> 512 -> 30, times
the small-batch kernel, the large-batch kernel and a bf16 chain of library
calls at each batch (CUDA events around many launches, and the profiler's
device time), which is how
``fused_mlp.SMALL_BATCH_MAX`` was chosen. It needs a CUDA device and prints
the card's name with the numbers.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import torch

from inferbiomechanics_tpu_torch.ops import _build
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--quick', action='store_true', help='build and check only')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
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
