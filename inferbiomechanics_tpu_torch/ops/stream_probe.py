"""Measure how fast a block pulls weights from L2 into shared memory.

    python -m inferbiomechanics_tpu_torch.ops.stream_probe

Compiles ``csrc/probe/stream_probe.cu`` with nvcc into the build directory
and runs it on the card: a ring of tiles behind mbarriers, filled by bulk
copies (from one thread that also consumes, split over several, or from a
producer warp that never consumes) or by ``cp.async`` from every thread,
waited for by ``try_wait`` or by a spin on ``test_wait`` alone; plain loads
into registers without barriers; and bulk copies with no consumer at all,
``depth`` of them always in flight. Over tile sizes and ring depths, with
one block and with one block a multiprocessor. It prints the card's name
and power limit and one JSON line a configuration (bytes a clock a
multiprocessor, clocks a tile). The port's kernels stream their weights
these ways; the probe says what each allows them.
"""

from __future__ import annotations

import subprocess
import sys

from inferbiomechanics_tpu_torch.ops import _build

SOURCE = _build.CSRC_DIR / 'probe' / 'stream_probe.cu'


def main() -> int:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    binary = _build.BUILD_DIR / 'stream_probe'
    flags = [f for f in _build.NVCC_FLAGS if f not in ('-Xcompiler', '-fPIC', '-Xptxas', '-v')]
    subprocess.run([_build._nvcc(), *flags, '-o', str(binary), str(SOURCE)], check=True)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    return subprocess.run([str(binary)]).returncode


if __name__ == '__main__':
    sys.exit(main())
