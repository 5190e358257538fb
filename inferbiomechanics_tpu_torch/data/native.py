"""ctypes bindings for the native C++ data plane (native/ib_native.cpp).

Loads ``libib_native.so`` if present (``make -C native``); every entry
point has a numpy fallback so the framework works without the build.
The native path owns the hot host-side op: batched strided window gather
with optional fused column-select + scaling (featurization).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CANDIDATES = [
    os.path.join(_REPO_ROOT, 'native', 'libib_native.so'),
    os.path.join(os.path.dirname(__file__), 'libib_native.so'),
]

_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for path in _CANDIDATES:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.ib_gather_rows.argtypes = [
                    _f32p, ctypes.c_int64, ctypes.c_int64,
                    _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    _f32p, ctypes.c_int]
                lib.ib_gather_columns.argtypes = [
                    _f32p, ctypes.c_int64, ctypes.c_int64,
                    _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    _i64p, _f32p, ctypes.c_int64, _f32p, ctypes.c_int]
                if hasattr(lib, 'ib_decode_legacy_trial'):
                    lib.ib_decode_legacy_trial.argtypes = [
                        _u8p, ctypes.c_int64, _i64p, ctypes.c_int64,
                        _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
                        ctypes.POINTER(_f32p), ctypes.c_int64,
                        ctypes.c_int64, ctypes.c_int]
                    lib.ib_decode_legacy_trial.restype = ctypes.c_int64
                _LIB = lib
                break
            except OSError:
                continue
    return _LIB


def available() -> bool:
    return _load() is not None


def default_threads() -> int:
    return max(1, (os.cpu_count() or 1) - 0)


def gather_windows(src: np.ndarray, starts: np.ndarray, frames: int,
                   stride: int, n_threads: Optional[int] = None) -> np.ndarray:
    """out[w, f, :] = src[starts[w] + f*stride, :] — native if available."""
    lib = _load()
    n = starts.shape[0]
    cols = src.shape[1]
    if lib is None:
        rows = starts[:, None] + stride * np.arange(frames)[None, :]
        return src[rows]
    src = np.ascontiguousarray(src, np.float32)
    starts64 = np.ascontiguousarray(starts, np.int64)
    out = np.empty((n, frames, cols), np.float32)
    lib.ib_gather_rows(
        src.ctypes.data_as(_f32p), src.shape[0], cols,
        starts64.ctypes.data_as(_i64p), n, frames, stride,
        out.ctypes.data_as(_f32p), n_threads or default_threads())
    return out


def gather_columns(src: np.ndarray, starts: np.ndarray, frames: int,
                   stride: int, col_idx: np.ndarray, scale: np.ndarray,
                   n_threads: Optional[int] = None) -> np.ndarray:
    """Fused featurization gather:
    out[w, f, j] = src[starts[w]+f*stride, col_idx[j]] * scale[j]."""
    lib = _load()
    n = starts.shape[0]
    k = col_idx.shape[0]
    if lib is None:
        rows = starts[:, None] + stride * np.arange(frames)[None, :]
        return src[rows][:, :, col_idx] * scale[None, None, :]
    src = np.ascontiguousarray(src, np.float32)
    starts64 = np.ascontiguousarray(starts, np.int64)
    idx64 = np.ascontiguousarray(col_idx, np.int64)
    scale32 = np.ascontiguousarray(scale, np.float32)
    out = np.empty((n, frames, k), np.float32)
    lib.ib_gather_columns(
        src.ctypes.data_as(_f32p), src.shape[0], src.shape[1],
        starts64.ctypes.data_as(_i64p), n, frames, stride,
        idx64.ctypes.data_as(_i64p), scale32.ctypes.data_as(_f32p), k,
        out.ctypes.data_as(_f32p), n_threads or default_threads())
    return out


def decode_legacy_trial(frames_blob: bytes, frame_offsets: np.ndarray,
                        field_col: np.ndarray, field_width: np.ndarray,
                        contact_field: int, n_passes: int, row_cols: int,
                        n_threads: Optional[int] = None):
    """Decode a legacy trial's frame records into n_passes [T, C] float32
    matrices with the C decoder. Returns None if the native lib (or the
    symbol) is unavailable — callers fall back to the Python codec."""
    lib = _load()
    if lib is None or not hasattr(lib, 'ib_decode_legacy_trial'):
        return None
    n_frames = frame_offsets.shape[0]
    blob = np.frombuffer(frames_blob, np.uint8)
    offs = np.ascontiguousarray(frame_offsets, np.int64)
    cols = np.ascontiguousarray(field_col, np.int64)
    widths = np.ascontiguousarray(field_width, np.int64)
    mats = [np.zeros((n_frames, row_cols), np.float32)
            for _ in range(n_passes)]
    out_ptrs = (_f32p * n_passes)(*[m.ctypes.data_as(_f32p) for m in mats])
    decoded = lib.ib_decode_legacy_trial(
        blob.ctypes.data_as(_u8p), blob.shape[0],
        offs.ctypes.data_as(_i64p), n_frames,
        cols.ctypes.data_as(_i64p), widths.ctypes.data_as(_i64p),
        len(cols), contact_field, out_ptrs, n_passes, row_cols,
        n_threads or default_threads())
    if decoded != n_frames:
        return None  # truncated/odd file: let the Python path report it
    return mats
