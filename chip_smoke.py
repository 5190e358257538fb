#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``inferbiomechanics_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run:
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. build kernel K1 (``ops/csrc/fused_mlp.cu``) from this checkout with nvcc;
  3. K1 against its plain PyTorch version on the card, atol 1e-2;
  4. the serving slice through the ``serve`` command's wiring: the default
     feedforward model at full width (1770->512->512->30, sigmoid,
     window 50 / stride 5, max_batch 4096) with seeded random weights,
     answering /health, /schema, /predict (JSON, b64), /predict_file,
     concurrent clients through the dynamic batcher, /reload and /metrics;
     every answer is held against the plain version on the card, and every
     device forward must have launched K1;
  5. times at B=1 and B=4096: K1 against its plain version (the f32
     precision reference) and against a bf16 cuBLAS chain (a speed
     baseline), by CUDA events and by profiler device time; /predict p50.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or run outside a checkout
of the repo, it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import base64
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
# One bf16 ulp below 2.0 is 7.8e-3: a different summation order in f32 can
# flip the final bf16 rounding by one ulp, and the outputs stay below 2.
ATOL = 1e-2
FULL_DIMS = [1770, 512, 512, 30]
KERNEL = {
    'name': 'fused_mlp_forward (K1)',
    'route': 'cuda',
    'source': 'inferbiomechanics_tpu_torch/ops/csrc/fused_mlp.cu',
    'replaces': 'inferbiomechanics_tpu/ops/pallas_mlp.py:53',
}


def _get(url: str):
    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read())


def _post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body,
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _decode(outputs: dict, keys) -> np.ndarray:
    """Response outputs (JSON lists or b64) -> [B, F * 30] in head order."""
    parts = []
    for k in keys:
        v = outputs[k]
        if isinstance(v, dict):
            v = np.frombuffer(base64.b64decode(v['b64']), '<f4').reshape(v['shape'])
        parts.append(np.asarray(v, np.float32))
    out = np.concatenate(parts, axis=-1)
    return out.reshape(out.shape[0], -1)


def _random_params(torch, dims, gen):
    k_params = []
    for d0, d1 in zip(dims[:-1], dims[1:]):
        k = d0 ** -0.5
        k_params.append(((torch.rand(d0, d1, generator=gen) * 2 - 1) * k,
                         (torch.rand(d1, generator=gen) * 2 - 1) * k))
    return k_params


def phase_kernel_vs_plain(torch, fm, seed: int) -> float:
    gen = torch.Generator().manual_seed(seed)
    cases = [(b, FULL_DIMS, 'sigmoid') for b in (1, 37, 4096)]
    cases += [(37, FULL_DIMS, a) for a in ('relu', 'tanh', 'gelu', 'elu')]
    cases += [(37, [1770, 512, 512, 300], 'sigmoid'),      # all_frames head
              (37, [1770, 256, 256, 256, 30], 'sigmoid')]  # another depth
    worst = 0.0
    for b, dims, act in cases:
        packed = fm.pack_mlp_params(_random_params(torch, dims, gen), 'cuda')
        x = torch.randn(b, dims[0], generator=gen).cuda()
        before = fm.launches
        out = fm.fused_mlp_forward(x, packed, act)
        _check(fm.launches == before + 1, 'launch counter did not rise')
        ref = fm.mlp_reference(x, packed.layers, act)
        torch.cuda.synchronize()
        _check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
               f'bad output {tuple(out.shape)} for {dims}')
        err = float((out - ref).abs().max())
        print(f'[kernel] B={b} {"->".join(map(str, dims))} {act}: '
              f'max abs err {err:.3g} (atol {ATOL})', flush=True)
        _check(err <= ATOL, f'K1 disagrees with the plain version: {err}')
        worst = max(worst, err)
    return worst


def _cuda_ms(torch, fn, iters: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _device_us(torch, fn, iters: int = 20):
    """Device time per call: the summed durations of the GPU kernels that
    ``torch.profiler`` traced over ``iters`` calls, divided by ``iters``;
    None if the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    return total / iters if total > 0 else None


def _bf16_chain(torch, x, layers, act):
    """A speed baseline, not the precision reference: the layer chain as
    bf16 cuBLAS GEMMs (f32 accumulate, bf16 out, bias added in bf16)."""
    h = x.to(torch.bfloat16)
    for i, (W, b) in enumerate(layers):
        h = torch.addmm(b, h, W)
        if i < len(layers) - 1:
            h = act(h)
    return h.float()


def _host_p50_ms(fn, iters: int) -> float:
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    if not (REPO / 'inferbiomechanics_tpu_torch').is_dir():
        print('chip_smoke: run from a checkout of the repo (no '
              'inferbiomechanics_tpu_torch/ beside this script)', file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this run needs '
              'a GPU', file=sys.stderr)
        return 1

    # 1. the card
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    print(card, flush=True)     # name, power limit: as nvidia-smi prints them
    print(f'[card] torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}',
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's f32 matmuls
    torch.backends.cudnn.allow_tf32 = False

    from inferbiomechanics_tpu_torch.cli.serve_cmd import build_parser, start
    from inferbiomechanics_tpu_torch.models.common import slice_output_heads
    from inferbiomechanics_tpu_torch.ops import _build
    from inferbiomechanics_tpu_torch.ops import fused_mlp as fm
    from inferbiomechanics_tpu_torch.shared import (
        Config, WindowDataset, write_synthetic_subject,
    )
    from inferbiomechanics_tpu_torch.train.checkpoint import save_checkpoint
    from inferbiomechanics_tpu_torch.train.loop import build_model_for_dataset

    # 2. build
    info = _build.build()
    print(f'[build] K1 built with nvcc in {info["seconds"]:.2f} s', flush=True)
    for line in info['log'].splitlines():
        if 'registers' in line or 'spill' in line:
            print(f'[build] {line.strip()}', flush=True)

    # 3. kernel vs plain
    max_err = phase_kernel_vs_plain(torch, fm, args.seed)

    # 4. the slice
    tmp = Path(tempfile.mkdtemp(prefix='ib_chip_smoke_'))
    servers = []
    try:
        data, ckpt_root = tmp / 'data', tmp / 'checkpoints'
        data.mkdir()
        for s in range(2):
            write_synthetic_subject(str(data / f'subject_{s}.b3d'), num_trials=2,
                                    trial_length=1100, seed=args.seed + s)
        cfg = Config()     # defaults: feedforward 512x512 sigmoid, window 50 / stride 5
        ds = WindowDataset(str(data), window_size=cfg.window_size,
                           stride=cfg.stride, skip_loading_skeletons=True)
        _check(len(ds) >= 4096, f'only {len(ds)} windows')
        ckpt_dir = ckpt_root / cfg.model_type

        def new_weights(seed: int, epoch: int):
            model = build_model_for_dataset(
                cfg, ds, generator=torch.Generator().manual_seed(seed),
                device='cuda')
            save_checkpoint(str(ckpt_dir), model, epoch, 0)
            return model

        model = new_weights(args.seed, 1)
        keys = list(slice_output_heads(torch.zeros(1, 30), 2, 1))

        def plain(x: np.ndarray) -> np.ndarray:
            xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()
            with torch.no_grad():
                return fm.mlp_reference(xt.reshape(len(x), -1), model.layer_params(),
                                        cfg.activation).cpu().numpy()

        def agree(outputs: dict, x: np.ndarray, what: str) -> float:
            got = _decode(outputs, keys)
            _check(got.shape == (len(x), 30) and np.isfinite(got).all(),
                   f'{what}: bad output {got.shape}')
            err = float(np.abs(got - plain(x)).max())
            _check(err <= ATOL, f'{what}: max abs err {err} > {ATOL}')
            return err

        serve_args = ['serve', '--dataset-home', str(data), '--checkpoint-dir',
                      str(ckpt_root), '--port', '0', '--device', 'cuda']
        parser = build_parser()
        fm.launches = 0     # counts from here on are the main path's
        svc, server = start(parser.parse_args(serve_args + ['--warmup']))
        svc_b, server_b = start(parser.parse_args(serve_args + ['--batch-wait-ms', '5']))
        for srv, sv in ((server, svc), (server_b, svc_b)):
            servers.append((srv, sv))
            threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f'http://127.0.0.1:{server.server_address[1]}'
        url_b = f'http://127.0.0.1:{server_b.server_address[1]}'

        h = _get(url + '/health')
        _check(h['status'] == 'ok' and h['model'] == 'feedforward'
               and h['epoch'] == 1, f'/health {h}')
        s = _get(url + '/schema')
        _check((s['num_model_frames'], s['num_input_channels'], s['max_batch'],
                s['window_size'], s['stride'], s['output_data_format'])
               == (10, 177, 4096, 50, 5, 'last_frame')
               and s['device'].startswith('cuda'), f'/schema {s}')
        errs = {}
        for b in (1, 37):
            x = ds.gather(np.arange(b)).inputs
            r = _post(url + '/predict', json.dumps({'inputs': x.tolist()}).encode())
            errs[f'json B={b}'] = agree(r['outputs'], x, f'/predict json B={b}')
        x4096 = np.ascontiguousarray(ds.gather(np.arange(4096)).inputs, '<f4')
        body4096 = json.dumps({'inputs_b64': base64.b64encode(x4096.tobytes()).decode(),
                               'shape': list(x4096.shape), 'encoding': 'b64'}).encode()
        r = _post(url + '/predict', body4096)
        errs['b64 B=4096'] = agree(r['outputs'], x4096, '/predict b64 B=4096')
        subject = str(data / 'subject_0.b3d')
        r = _post(url + '/predict_file', json.dumps({'file': subject, 'trial': 1}).encode())
        fds = WindowDataset(subject, window_size=cfg.window_size, stride=cfg.stride,
                            skip_loading_skeletons=True)
        xf = fds.gather(np.nonzero(fds.win_trial == 1)[0]).inputs
        _check(len(r['window_starts']) == len(xf), '/predict_file window count')
        errs[f'predict_file {len(xf)} windows'] = agree(r['outputs'], xf, '/predict_file')

        # 8 concurrent clients through the dynamic batcher
        rng = np.random.default_rng(args.seed)
        jobs = [[(int(rng.integers(0, len(ds) - 64)), int(rng.integers(1, 65)))
                 for _ in range(6)] for _ in range(8)]
        failures, worst = [], [0.0]

        def client(reqs):
            try:
                for start_i, b in reqs:
                    x = ds.gather(np.arange(start_i, start_i + b)).inputs
                    r = _post(url_b + '/predict', json.dumps({'inputs': x.tolist()}).encode())
                    worst[0] = max(worst[0], agree(r['outputs'], x, 'batched /predict'))
            except Exception as e:   # reported below; the run fails
                failures.append(repr(e))

        threads = [threading.Thread(target=client, args=(j,)) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        _check(not failures and not any(t.is_alive() for t in threads),
               f'concurrent clients: {failures}')
        errs['8 concurrent clients'] = worst[0]
        coalesced = _get(url_b + '/schema')['dynamic_batching']['forwards']

        # /reload onto a newer checkpoint
        model = new_weights(args.seed + 1, 2)
        r = _post(url + '/reload', b'{}')
        _check(r['reloaded'] and r['epoch'] == 2, f'/reload {r}')
        x = ds.gather(np.arange(37)).inputs
        r = _post(url + '/predict', json.dumps({'inputs': x.tolist()}).encode())
        errs['after /reload B=37'] = agree(r['outputs'], x, '/predict after /reload')

        m, m_b = _get(url + '/metrics'), _get(url_b + '/metrics')
        launches = fm.launches
        forwards = m['device_forwards'] + m_b['device_forwards']
        for what, e in errs.items():
            print(f'[slice] {what}: max abs err vs plain {e:.3g}', flush=True)
        print(f'[slice] 48 concurrent requests in {coalesced} device forwards; '
              f'metrics {m} / {m_b}', flush=True)
        _check(m['errors'] == 0 and m_b['errors'] == 0, 'errors in /metrics')
        _check(m_b['requests'] == 48, f'batched requests {m_b["requests"]}')
        _check(launches == forwards > 0,
               f'{launches} K1 launches for {forwards} device forwards')
        print(f'[slice] K1 launches {launches} == device forwards {forwards}',
              flush=True)

        # 5. times
        gen = torch.Generator().manual_seed(args.seed)
        packed = fm.pack_mlp_params(_random_params(torch, FULL_DIMS, gen), 'cuda')
        layers16 = [(W, b.to(torch.bfloat16)) for W, b in packed.layers]
        act = fm.ACTIVATIONS['sigmoid']
        times, dev_us = {}, {}
        for b in (1, 4096):
            xt = torch.randn(b, FULL_DIMS[0], generator=gen).cuda()
            fns = {
                'kernel': lambda: fm.fused_mlp_forward(xt, packed, 'sigmoid'),  # noqa: B023
                'plain': lambda: fm.mlp_reference(xt, packed.layers, 'sigmoid'),  # noqa: B023
                'bf16': lambda: _bf16_chain(torch, xt, layers16, act),  # noqa: B023
            }
            err16 = float((fns['bf16']() - fns['plain']()).abs().max())
            # plain, bf16, kernel, kernel, bf16, plain: the better of two runs each
            order = ['plain', 'bf16', 'kernel', 'kernel', 'bf16', 'plain']
            t = {}
            for name in order:
                t[name] = min(t.get(name, float('inf')), _cuda_ms(torch, fns[name]))
            times[b] = t
            dev_us[b] = {name: _device_us(torch, f) for name, f in fns.items()}
            print(f'[times] bf16 cuBLAS chain B={b}: max abs err vs plain '
                  f'{err16:.3g} (speed baseline only)', flush=True)
        x1 = json.dumps({'inputs': ds.gather(np.arange(1)).inputs.tolist()}).encode()
        p50_b1 = _host_p50_ms(lambda: _post(url + '/predict', x1), 30)
        p50_b4096 = _host_p50_ms(lambda: _post(url + '/predict', body4096), 20)
        print(f'[times] card {card}', flush=True)
        fmt = lambda us: 'not measured' if us is None else f'{us:.1f} us'  # noqa: E731
        for b, t in times.items():
            d = dev_us[b]
            print(f'[times] K1 B={b} 1770->512->512->30 sigmoid, CUDA events '
                  f'(median of 30, better of two runs): kernel '
                  f'{t["kernel"] * 1e3:.1f} us, plain (f32 reference) '
                  f'{t["plain"] * 1e3:.1f} us, bf16 cuBLAS chain '
                  f'{t["bf16"] * 1e3:.1f} us', flush=True)
            print(f'[times] K1 B={b} profiler device time per call: kernel '
                  f'{fmt(d["kernel"])}, plain (f32 reference) {fmt(d["plain"])}, '
                  f'bf16 cuBLAS chain {fmt(d["bf16"])}', flush=True)
        print(f'[times] /predict B=1 json p50 {p50_b1:.2f} ms (30 requests); '
              f'B=4096 b64 p50 {p50_b4096:.1f} ms (20 requests) = '
              f'{4096 / p50_b4096 * 1e3:.0f} windows/s', flush=True)
    finally:
        for srv, sv in servers:
            srv.shutdown()
            srv.server_close()
            sv.close()
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({'kernels': [dict(
        KERNEL, launches=launches, max_abs_err=max_err,
        ms=times[4096]['kernel'], plain_ms=times[4096]['plain'],
        shape='B=4096, 1770->512->512->30, sigmoid',
        bf16_cublas_ms=times[4096]['bf16'],
        ms_b1=times[1]['kernel'], plain_ms_b1=times[1]['plain'],
        bf16_cublas_ms_b1=times[1]['bf16'],
        device_us={str(b): d for b, d in dev_us.items()})]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
