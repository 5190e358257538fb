"""``convert-b3d`` subcommand: legacy protobuf ``.b3d`` subjects to B3D-TPU.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/convert_b3d_cmd.py``, on
the port's ``data/b3d_legacy.py`` (``convert_to_tpu``, ``verify_legacy``)
and ``data/b3d_infer.py``, with its flags, its words and its exit codes: a
file or a directory tree of ``.b3d`` files; each legacy one is decoded once
into the B3D-TPU matrices (beside it as ``<name>.b3dtpu``, or mirrored
under ``--out-dir``), an output already up to date is skipped unless
``--force``; ``--verify`` runs the strict decode diagnosis and
``--infer-schema`` the table-free wire analysis instead, each exiting 1
when a file fails or disagrees. A host-side command: it runs no model and
takes no ``--device``.

    python -m inferbiomechanics_tpu_torch convert-b3d DIR [--out-dir OUT] [--force]
    python -m inferbiomechanics_tpu_torch convert-b3d S.b3d --verify [--verify-frames N]
    python -m inferbiomechanics_tpu_torch convert-b3d S.b3d --infer-schema
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List

from inferbiomechanics_tpu_torch.data.b3d import is_current_b3dt
from inferbiomechanics_tpu_torch.data.b3d_infer import format_infer_report, infer_legacy_schema
from inferbiomechanics_tpu_torch.data.b3d_legacy import (
    convert_to_tpu, format_verify_report, is_legacy_b3d, verify_legacy,
)


def register_subcommand(sub) -> None:
    p = sub.add_parser('convert-b3d', help='Convert legacy protobuf .b3d subjects to B3D-TPU')
    p.add_argument('input', type=str, help='A legacy .b3d file or a directory tree')
    p.add_argument('--out-dir', type=str, default='',
                   help='Output directory (default: beside sources, suffix .b3dtpu)')
    p.add_argument('--force', action='store_true',
                   help='Reconvert even if an up-to-date output exists')
    p.add_argument('--verify', action='store_true',
                   help='Strict-decode diagnosis instead of converting: unknown-field census, '
                        'framing reconciliation, channel-width checks; non-zero exit on any '
                        'problem')
    p.add_argument('--verify-frames', type=int, default=None,
                   help='With --verify: cap frames checked per trial')
    p.add_argument('--infer-schema', action='store_true',
                   help="Table-free wire analysis: propose the file's own field-number tables "
                        'from structural invariants and diff them against the built-in '
                        'reconstruction (the tool to run FIRST when a real nimble-written '
                        'file mis-parses)')


def input_paths(root: str) -> List[str]:
    """``root`` itself, or every ``.b3d`` file of its tree (sorted within a
    directory, in ``os.walk`` order)."""
    if not os.path.isdir(root):
        return [root]
    return [os.path.join(d, f) for d, _dirs, files in os.walk(root)
            for f in sorted(files) if f.endswith('.b3d')]


def output_path(path: str, args: argparse.Namespace) -> str:
    if not args.out_dir:
        return path + 'tpu'
    rel = (os.path.relpath(path, args.input) if os.path.isdir(args.input)
           else os.path.basename(path))
    out = os.path.join(args.out_dir, rel)
    os.makedirs(os.path.dirname(out) or '.', exist_ok=True)
    return out


def _diagnose(paths: List[str], report_of, format_report, failed_of, summary: str) -> int:
    """--infer-schema / --verify: a report for each legacy file; 1 when any
    fails."""
    failed = 0
    for path in paths:
        if not is_legacy_b3d(path):
            print(f'skip (already B3D-TPU): {path}')
            continue
        report = report_of(path)
        print(format_report(report))
        failed += failed_of(report)
    if failed:
        print(summary.format(failed=failed, total=len(paths)))
        return 1
    return 0


def run(args: argparse.Namespace) -> int:
    paths = input_paths(args.input)
    if args.infer_schema:
        return _diagnose(paths, infer_legacy_schema, format_infer_report,
                         lambda r: 1 if r['builtin_diff'] else 0,
                         'SCHEMA DISAGREEMENT in {failed} of {total} files — edit the '
                         'b3d_legacy.py tables as printed')
    if args.verify:
        return _diagnose(paths,
                         lambda p: verify_legacy(p, max_frames_per_trial=args.verify_frames),
                         format_verify_report, lambda r: 0 if r['ok'] else 1,
                         'VERIFY FAILED for {failed} of {total} files')

    converted = skipped = 0
    for path in paths:
        if not is_legacy_b3d(path):
            print(f'skip (already B3D-TPU): {path}')
            skipped += 1
            continue
        out = output_path(path, args)
        if (not args.force and os.path.exists(out)
                and os.path.getmtime(out) >= os.path.getmtime(path) and is_current_b3dt(out)):
            print(f'skip (up to date): {out}')
            skipped += 1
            continue
        t0 = time.time()
        convert_to_tpu(path, out)
        print(f'converted {path} -> {out} '
              f'({os.path.getsize(out) / 1e6:.1f} MB, {time.time() - t0:.1f}s)')
        converted += 1
    print(f'{converted} converted, {skipped} skipped')
    return 0
