"""Read and write the msgpack that ``flax.serialization.to_bytes`` emits.

The JAX package saves its whole train state as flax msgpack
(``inferbiomechanics_tpu/train/checkpoint.py``). A machine that runs the
port has neither ``flax`` nor ``msgpack``, so this module reads and writes
that format in pure Python and numpy:

- maps (fixmap, map16, map32) with str keys, arrays (fixarray, array16,
  array32), str (fixstr, str8, str16, str32), bin (bin8, bin16, bin32),
  ints and uints of every width, float32 and float64, nil and the two
  bools;
- ext type 1, an ndarray: its payload is itself msgpack, the array
  ``(shape, dtype name, C-order bytes)``; ext type 3, a numpy scalar, the
  same payload for a 0-d array, read back as a numpy scalar;
- flax's chunked form of an array above ``MAX_CHUNK_SIZE`` bytes,
  ``{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}}``,
  joined back into one array by the reader and made by the writer.

numpy has no ``bfloat16``: such an array is read as a ``torch.bfloat16``
tensor through a ``uint16`` view, and a ``torch.bfloat16`` tensor is
written under that dtype name. Any other ext type (flax's complex
scalars, msgpack's timestamp) and any unknown code raises ``ValueError``
with the byte offset.

:func:`loads` gives the tree ``flax.serialization.msgpack_restore`` gives
(dicts in file order, numpy arrays read-only over the input); :func:`dumps`
gives the bytes of ``flax.serialization.to_bytes`` for trees of dicts,
arrays and scalars.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30        # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = '__msgpack_chunked_array__'
EXT_NDARRAY, EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, data: bytes):
        self.view = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.view):
            raise ValueError(f'msgpack: truncated at byte {self.pos} (wants {n} bytes, '
                             f'{len(self.view) - self.pos} left)')
        out = self.view[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, raw: bool = False) -> Any:
        at = self.pos
        code = self.take(1)[0]
        if code <= 0x7f:
            return code
        if code >= 0xe0:
            return code - 0x100
        if 0x80 <= code <= 0x8f:
            return self.map(code & 0x0f, raw)
        if 0x90 <= code <= 0x9f:
            return self.array(code & 0x0f, raw)
        if 0xa0 <= code <= 0xbf:
            return self.str(code & 0x1f, raw)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if code in simple:
            return simple[code]
        sized = {0xc4: ('>B', 'bin'), 0xc5: ('>H', 'bin'), 0xc6: ('>I', 'bin'),
                 0xd9: ('>B', 'str'), 0xda: ('>H', 'str'), 0xdb: ('>I', 'str'),
                 0xdc: ('>H', 'array'), 0xdd: ('>I', 'array'),
                 0xde: ('>H', 'map'), 0xdf: ('>I', 'map')}
        if code in sized:
            fmt, kind = sized[code]
            n = self.unpack(fmt)
            if kind == 'bin':
                return bytes(self.take(n))
            return getattr(self, kind)(n, raw)
        numbers = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
                   0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
        if code in numbers:
            return self.unpack(numbers[code])
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        ext = {0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}
        if code in fixext or code in ext:
            n = fixext[code] if code in fixext else self.unpack(ext[code])
            kind = self.unpack('>b')
            return _ext(kind, bytes(self.take(n)), at)
        raise ValueError(f'msgpack: unknown code 0x{code:02x} at byte {at}')

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            key = self.value(raw)
            out[key] = self.value(raw)
        return out

    def array(self, n: int, raw: bool) -> list:
        return [self.value(raw) for _ in range(n)]

    def str(self, n: int, raw: bool):
        b = bytes(self.take(n))
        return b if raw else b.decode('utf-8')


def _ndarray(payload: bytes, at: int):
    """An ext payload's ``(shape, dtype name, bytes)`` as an array."""
    r = _Reader(payload)
    try:
        shape, name, buf = r.value(raw=True)
    except (TypeError, ValueError) as e:
        raise ValueError(f'msgpack: malformed ndarray payload in the ext at byte {at}: '
                         f'{e}') from e
    if name == b'bfloat16':
        bits = np.frombuffer(buf, np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name.decode())).reshape(shape)


def _ext(kind: int, payload: bytes, at: int):
    if kind == EXT_NDARRAY:
        return _ndarray(payload, at)
    if kind == EXT_NPSCALAR:
        arr = _ndarray(payload, at)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f'msgpack: ext type {kind} at byte {at} is not one a flax '
                     f'checkpoint of arrays holds (1, ndarray; 3, numpy scalar)')


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
            chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        for k, v in tree.items():
            tree[k] = _unchunk(v)
    return tree


def loads(data: bytes) -> Any:
    """The tree in ``data`` (flax msgpack), as ``msgpack_restore`` gives it."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(data):
        raise ValueError(f'msgpack: {len(data) - r.pos} trailing bytes at byte {r.pos}')
    return _unchunk(tree)


def is_msgpack_map(head: bytes) -> bool:
    """True when ``head``, a file's first byte(s), opens a msgpack map."""
    return bool(head) and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf))


# ---- the writer ---------------------------------------------------------

def _header(n: int, fix: Tuple[int, int], wide: Tuple[Tuple[int, str, int], ...]) -> bytes:
    """The header of a sized value: ``fix`` (first code, limit) for the
    short form, then (code, struct format, limit) for each wider form."""
    code, limit = fix
    if n < limit:
        return bytes([code | n])
    for code, fmt, limit in wide:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f'msgpack: a length of {n} does not fit')


_ARRAY = ((0x90, 16), ((0xdc, '>H', 1 << 16), (0xdd, '>I', 1 << 32)))
_MAP = ((0x80, 16), ((0xde, '>H', 1 << 16), (0xdf, '>I', 1 << 32)))
_STR = ((0xa0, 32), ((0xd9, '>B', 1 << 8), (0xda, '>H', 1 << 16), (0xdb, '>I', 1 << 32)))
_BIN = ((0, 0), ((0xc4, '>B', 1 << 8), (0xc5, '>H', 1 << 16), (0xc6, '>I', 1 << 32)))


def _int(n: int) -> bytes:
    if 0 <= n < 0x80 or -32 <= n < 0:
        return struct.pack('>b' if n < 0 else '>B', n)
    if n >= 0:
        for code, fmt, limit in ((0xcc, '>B', 1 << 8), (0xcd, '>H', 1 << 16),
                                 (0xce, '>I', 1 << 32), (0xcf, '>Q', 1 << 64)):
            if n < limit:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, limit in ((0xd0, '>b', 1 << 7), (0xd1, '>h', 1 << 15),
                                 (0xd2, '>i', 1 << 31), (0xd3, '>q', 1 << 63)):
            if n >= -limit:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f'msgpack: the int {n} does not fit in 64 bits')


def _ext_bytes(kind: int, payload: bytes) -> bytes:
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    n = len(payload)
    if n in fixext:
        head = bytes([fixext[n]])
    else:
        head = _header(n, (0, 0), ((0xc7, '>B', 1 << 8), (0xc8, '>H', 1 << 16),
                                   (0xc9, '>I', 1 << 32)))
    return head + struct.pack('>b', kind) + payload


def _array_payload(shape, name: str, buf: bytes) -> bytes:
    """The msgpack of the triple ``(shape, dtype name, bytes)``."""
    parts = [b'\x93', _header(len(shape), *_ARRAY)]
    parts += [_int(int(s)) for s in shape]
    raw = name.encode()
    parts += [_header(len(raw), *_STR), raw, _header(len(buf), *_BIN), buf]
    return b''.join(parts)


def _leaf_array(x) -> Tuple[tuple, str, bytes]:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return tuple(x.shape), 'bfloat16', x.view(torch.uint16).numpy().tobytes('C')
        x = x.numpy()
    return x.shape, x.dtype.name, x.tobytes('C')


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(x) -> dict:
    """flax's chunked form of an array leaf above MAX_CHUNK_SIZE bytes."""
    item = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / item))
    flat = x.reshape(-1)
    n = x.numel() if isinstance(x, torch.Tensor) else x.size
    return {_CHUNKED: True, 'shape': {str(i): int(s) for i, s in enumerate(x.shape)},
            'chunks': {str(i): flat[k:k + size] for i, k in enumerate(range(0, n, size))}}


def _dump(x, out: list) -> None:
    if x is None:
        out.append(b'\xc0')
    elif x is True or x is False:
        out.append(b'\xc3' if x else b'\xc2')
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(b'\xcb' + struct.pack('>d', x))
    elif type(x) is str:
        raw = x.encode('utf-8')
        out += [_header(len(raw), *_STR), raw]
    elif type(x) is bytes:
        out += [_header(len(x), *_BIN), x]
    elif type(x) is dict:
        out.append(_header(len(x), *_MAP))
        for k, v in x.items():
            if type(k) is not str:
                raise ValueError(f'msgpack: a checkpoint key must be a str, got {k!r}')
            _dump(k, out)
            _dump(v, out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        if _nbytes(x) > MAX_CHUNK_SIZE:
            _dump(_chunk(x), out)
        else:
            out.append(_ext_bytes(EXT_NDARRAY, _array_payload(*_leaf_array(x))))
    elif isinstance(x, np.generic):
        out.append(_ext_bytes(EXT_NPSCALAR, _array_payload(*_leaf_array(np.asarray(x)))))
    else:
        raise ValueError(f'msgpack: cannot write a {type(x).__name__} into a checkpoint')


def dumps(tree) -> bytes:
    """``tree`` (dicts with str keys, numpy arrays and scalars, torch
    tensors, Python scalars, str, bytes, None) as flax msgpack."""
    out: list = []
    _dump(tree, out)
    return b''.join(out)
