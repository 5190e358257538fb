"""A line plot as a PNG file, with numpy, zlib and struct only.

``analyze --plot-errors`` draws its series with matplotlib (on ``Agg``) as
the JAX package does. Where matplotlib is not installed, as on a GPU
machine that carries only what the port needs, :func:`write_line_png` draws
the same series: its values over their index, scaled to fill a frame, as a
black polyline on white, with the y label in the file's ``tEXt`` chunk
(``Title``). No text is drawn on the image.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(gray: np.ndarray, title: str = '') -> bytes:
    """An 8-bit grayscale image [H, W] as PNG bytes."""
    h, w = gray.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), gray.astype(np.uint8)], axis=1)
    return (b'\x89PNG\r\n\x1a\n'
            + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 0, 0, 0, 0))
            + (_chunk(b'tEXt', b'Title\x00' + title.encode('latin-1', 'replace'))
               if title else b'')
            + _chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
            + _chunk(b'IEND', b''))


def line_image(y, width: int = 640, height: int = 480, margin: int = 40) -> np.ndarray:
    """The polyline of ``y`` over its index inside a frame, [height, width]
    uint8 (0 ink, 255 paper). Non-finite values sit at the bottom."""
    y = np.asarray(y, np.float64).ravel()
    img = np.full((height, width), 255, np.uint8)
    x0, x1, y0, y1 = margin, width - 1 - margin, margin, height - 1 - margin
    img[[y0, y1], x0:x1 + 1] = 0
    img[y0:y1 + 1, [x0, x1]] = 0
    if not y.size:
        return img
    finite = np.isfinite(y)
    lo, hi = (y[finite].min(), y[finite].max()) if finite.any() else (0.0, 1.0)
    v = np.where(finite, y, lo)
    px = x0 + np.arange(y.size) * (x1 - x0) / max(y.size - 1, 1)
    py = y1 - (v - lo) * (y1 - y0) / ((hi - lo) or 1.0)
    if y.size == 1:
        xs, ys = px, py
    else:
        # each segment sampled at one point a pixel of its longer side
        steps = np.maximum(np.ceil(np.maximum(np.abs(np.diff(px)), np.abs(np.diff(py)))),
                           1).astype(np.int64)
        seg = np.repeat(np.arange(y.size - 1), steps)
        t = (np.arange(steps.sum()) - np.repeat(np.cumsum(steps) - steps, steps)) / steps[seg]
        xs = np.append(px[seg] + t * (px[seg + 1] - px[seg]), px[-1])
        ys = np.append(py[seg] + t * (py[seg + 1] - py[seg]), py[-1])
    img[np.rint(ys).astype(np.int64), np.rint(xs).astype(np.int64)] = 0
    return img


def write_line_png(path: str, y, ylabel: str = '') -> None:
    """Write :func:`line_image` of ``y`` to ``path`` as a PNG titled
    ``ylabel``."""
    with open(path, 'wb') as f:
        f.write(encode_png(line_image(y), ylabel))
