"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Every ``.cu`` file in ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source and all of them at once, and the
objects are linked into one shared library with a plain C interface,
``build/torch_kernels/libib_torch_kernels.so`` in the checkout (or in
``$IB_TORCH_BUILD_DIR``, for an installed package), which is loaded with
``ctypes``. The build happens at first use and again whenever the stamp
beside the library, a hash of the sources, of this file and of the nvcc
flags, differs. No PyTorch headers are involved, so a build takes
seconds. A failed build raises; nothing falls back. Processes that load
the library at once (the ranks of a data-parallel run) build it once: the
first takes a file lock beside the library and builds, the others wait for
the lock and find the library up to date.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(os.environ.get('IB_TORCH_BUILD_DIR') or
                 Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels')
LIBRARY = BUILD_DIR / 'libib_torch_kernels.so'
STAMP = LIBRARY.with_name(LIBRARY.name + '.stamp')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc'), shutil.which('nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, '
                       '/usr/local/cuda/bin and PATH): the CUDA kernels are '
                       'built from source at first use')


def _sources():
    return sorted(CSRC_DIR.glob('*.cu'))


def _fingerprint() -> str:
    """Hash of everything the library is built from: the sources, this
    file and the nvcc flags."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in _sources() + sorted(CSRC_DIR.glob('*.cuh')) + [Path(__file__)]:
        h.update(p.name.encode() + b'\0' + p.read_bytes())
    return h.hexdigest()


def _stale() -> bool:
    return (not LIBRARY.exists() or not STAMP.exists()
            or STAMP.read_text().strip() != _fingerprint())


def build() -> dict:
    """Compile every ``csrc/*.cu`` into :data:`LIBRARY`; returns the build
    time and the compiler's report (``-Xptxas -v``: registers, shared
    memory and spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fingerprint = _fingerprint()
    nvcc, pid = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    jobs = []                          # one nvcc per source, all at once
    for src in _sources():
        obj = BUILD_DIR / f'{src.stem}.{pid}.o'
        cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    # wait for every compiler before looking at any result, so that none
    # outlives a failure; then link
    steps = [(cmd, proc.communicate()[0], proc.returncode) for cmd, _, proc in jobs]
    tmp = LIBRARY.with_name(f'{LIBRARY.name}.{pid}.tmp')
    if all(rc == 0 for _, _, rc in steps):
        cmd = [nvcc, '-shared', '-o', str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        steps.append((cmd, proc.stdout + proc.stderr, proc.returncode))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    for cmd, out, rc in steps:
        if rc != 0:
            raise RuntimeError(f'nvcc failed ({rc}):\n{" ".join(cmd)}\n{out}')
    log = ''.join(out for _, out, _ in steps)
    seconds = time.perf_counter() - t0
    os.replace(tmp, LIBRARY)   # atomic: a concurrent loader never sees half a file
    STAMP.write_text(fingerprint + '\n')
    return {'seconds': seconds, 'log': log}


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    int_p = ctypes.POINTER(ctypes.c_int)
    lib.ib_fused_mlp_forward.argtypes = [vp, i, i, vp, vp, int_p, i, vp, i, i, int_p, vp]
    lib.ib_fused_mlp_forward.restype = i
    lib.ib_fused_encoder_forward.argtypes = [vp, i, i, i, i, i, vp, vp, vp, int_p, i, vp, vp]
    lib.ib_fused_encoder_forward.restype = i
    lib.ib_fused_encoder_backward.argtypes = [vp, vp, i, i, i, i, i, vp, vp, vp, vp, vp,
                                              vp, vp, vp, vp, i, i, i, vp]
    lib.ib_fused_encoder_backward.restype = i
    lib.ib_fused_encoder_backward_cluster.argtypes = [vp, vp, i, i, i, i, i, vp, vp, vp, vp,
                                                      vp, vp, vp, vp, int_p, i, i, vp, vp]
    lib.ib_fused_encoder_backward_cluster.restype = i
    lib.ib_fused_groundlink_forward.argtypes = [vp, i, i, i, vp, vp, int_p, i, i, i, i,
                                                vp, i, int_p, i, vp, vp]
    lib.ib_fused_groundlink_forward.restype = i
    lib.ib_cuda_error_string.argtypes = [i]
    lib.ib_cuda_error_string.restype = ctypes.c_char_p
    return lib


def ensure_built() -> Optional[dict]:
    """Build :data:`LIBRARY` if it is missing or stale, by one process of
    those that ask at once (the others wait on the lock file); returns
    :func:`build`'s report, or None where the stamp matched."""
    if not _stale():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / '.build.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return build() if _stale() else None


def library() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale
    (:func:`ensure_built`)."""
    global _lib
    with _lock:
        if _lib is None:
            ensure_built()
            _lib = _declare(ctypes.CDLL(str(LIBRARY)))
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.ib_cuda_error_string(code).decode()
        raise RuntimeError(f'{what}: CUDA error {code} ({msg})')
