"""Figures as PNG files, with numpy, zlib and struct only.

The port's plotting commands draw with matplotlib (on ``Agg``) as the JAX
package does. Where matplotlib is not installed, as on a GPU machine that
carries only what the port needs, they write the same files through this
module. No text is drawn on an image: a figure's title goes into the file's
``tEXt`` chunk (``Title``), its panels' titles and labels into another
(``Description``).

- :func:`write_line_png`: one series over its index, a black polyline on
  white in a frame (``analyze --plot-errors``).
- :class:`Figure`: a grid of panels, each a list of marks, recorded once and
  written either way (:meth:`Figure.save`): polylines (with markers), points
  (a scatter), bars, bands between two curves, histograms (drawn as bars of
  their bins' counts), pie charts (drawn as bars of their shares) and box
  plots (drawn as bars of their five numbers: minimum, lower quartile,
  median, upper quartile, maximum). With matplotlib the marks are its own:
  ``plot``, ``scatter``, ``bar``, ``fill_between``, ``hist``, ``pie``,
  ``boxplot``.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

PX_PER_INCH = 80            # a figure's pixels for each inch of its matplotlib size
FRAME = (150, 150, 150)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))


def _text(key: str, value: str) -> bytes:
    return _chunk(b'tEXt', key.encode('latin-1') + b'\x00'
                  + value.encode('latin-1', 'replace')) if value else b''


def encode_png(img: np.ndarray, title: str = '', description: str = '') -> bytes:
    """An 8-bit grayscale [H, W] or RGB [H, W, 3] image as PNG bytes."""
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.astype(np.uint8).reshape(h, -1)], axis=1)
    return (b'\x89PNG\r\n\x1a\n'
            + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color, 0, 0, 0))
            + _text('Title', title) + _text('Description', description)
            + _chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
            + _chunk(b'IEND', b''))


def _polyline(px: np.ndarray, py: np.ndarray):
    """Pixel positions along the polyline through (px, py): each segment
    sampled at one point a pixel of its longer side."""
    if px.size == 1:
        return px, py
    steps = np.maximum(np.ceil(np.maximum(np.abs(np.diff(px)), np.abs(np.diff(py)))),
                       1).astype(np.int64)
    seg = np.repeat(np.arange(px.size - 1), steps)
    t = (np.arange(steps.sum()) - np.repeat(np.cumsum(steps) - steps, steps)) / steps[seg]
    return (np.append(px[seg] + t * (px[seg + 1] - px[seg]), px[-1]),
            np.append(py[seg] + t * (py[seg + 1] - py[seg]), py[-1]))


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
    xs, ys = _polyline(px, py)
    img[np.rint(ys).astype(np.int64), np.rint(xs).astype(np.int64)] = 0
    return img


def write_line_png(path: str, y, ylabel: str = '') -> None:
    """Write :func:`line_image` of ``y`` to ``path`` as a PNG titled
    ``ylabel``."""
    with open(path, 'wb') as f:
        f.write(encode_png(line_image(y), ylabel))


def pyplot():
    """matplotlib's ``pyplot`` on the ``Agg`` backend, or None where
    matplotlib is not installed (a :class:`Figure` is then written by this
    module). A command asks once and draws every figure the same way."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def rgb(color: str) -> tuple:
    """``'#rrggbb'`` as an (r, g, b) tuple."""
    return tuple(int(color.lstrip('#')[i:i + 2], 16) for i in (0, 2, 4))


def _floats(v) -> np.ndarray:
    return np.asarray(v, np.float64).ravel()


@dataclass
class Mark:
    """One mark of a panel. ``kind``: 'line', 'points', 'bars', 'band'
    (``y`` to ``y2``), 'hist' (``data``: one array or a list, ``bins``),
    'pie' (``y`` the values), 'box' (``data``: a list of arrays)."""
    kind: str
    x: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    y2: Optional[np.ndarray] = None
    data: Optional[list] = None
    colors: Sequence[str] = ('#000000',)
    labels: Optional[Sequence[str]] = None
    label: Optional[str] = None
    width: float = 0.8
    bins: int = 10
    linewidth: float = 2.0
    alpha: float = 1.0
    size: float = 3.0
    marker: bool = False

    def as_bars(self) -> List['Mark']:
        """The bars a 'hist', 'pie' or 'box' mark is drawn as without
        matplotlib."""
        if self.kind == 'hist':
            data = [_floats(d) for d in self.data]
            both = np.concatenate(data) if data else np.zeros(0)
            edges = np.histogram_bin_edges(both[np.isfinite(both)], self.bins)
            step = (edges[1] - edges[0]) / len(data)
            return [Mark('bars', x=edges[:-1] + (k + 0.5) * step,
                         y=np.histogram(d[np.isfinite(d)], edges)[0].astype(np.float64),
                         colors=(self.colors[k % len(self.colors)],), width=step)
                    for k, d in enumerate(data)]
        if self.kind == 'pie':
            y = _floats(self.y)
            return [Mark('bars', x=np.arange(y.size, dtype=np.float64), y=y / y.sum(),
                         colors=self.colors)]
        if self.kind == 'box':
            five = [np.percentile(_floats(d), [0, 25, 50, 75, 100]) if len(d)
                    else np.zeros(5) for d in self.data]
            return [Mark('bars', x=6.0 * g + np.arange(5, dtype=np.float64), y=f,
                         colors=self.colors) for g, f in enumerate(five)]
        return [self]


@dataclass
class Panel:
    """One panel of a :class:`Figure`: its marks, title and axis labels."""
    marks: List[Mark] = field(default_factory=list)
    title: str = ''
    xlabel: str = ''
    ylabel: str = ''
    legend: bool = False
    xticks: Optional[Sequence[str]] = None   # category names under bars at 0, 1, ...
    xtick_rotation: float = 0.0

    def line(self, x, y, color: str = '#000000', label=None, linewidth=2.0, alpha=1.0,
             marker=False):
        self.marks.append(Mark('line', x=_floats(x), y=_floats(y), colors=(color,),
                               label=label, linewidth=linewidth, alpha=alpha, marker=marker))

    def points(self, x, y, color: str = '#000000', label=None, size=3.0, alpha=0.25):
        self.marks.append(Mark('points', x=_floats(x), y=_floats(y), colors=(color,),
                               label=label, size=size, alpha=alpha))

    def bars(self, x, heights, color: str = '#000000', width=0.8):
        self.marks.append(Mark('bars', x=_floats(x), y=_floats(heights), colors=(color,),
                               width=width))

    def band(self, x, lo, hi, color: str = '#000000', alpha=0.25):
        self.marks.append(Mark('band', x=_floats(x), y=_floats(lo), y2=_floats(hi),
                               colors=(color,), alpha=alpha))

    def hist(self, data, bins: int, colors: Sequence[str], labels=None):
        """``data`` one array, or a list of arrays drawn side by side on
        shared bins."""
        many = isinstance(data, (list, tuple)) and len(data) and np.ndim(data[0]) == 1
        self.marks.append(Mark('hist', data=list(data) if many else [data], bins=bins,
                               colors=tuple(colors), labels=labels))

    def pie(self, values, labels: Sequence[str], colors=('#346beb',)):
        self.marks.append(Mark('pie', y=_floats(values), labels=list(labels),
                               colors=tuple(colors)))

    def box(self, data: list, labels: Sequence[str], colors=('#346beb',)):
        self.marks.append(Mark('box', data=[_floats(d) for d in data], labels=list(labels),
                               colors=tuple(colors)))

    def _describe(self) -> str:
        return ' | '.join(s for s in (self.title, self.xlabel and f'x: {self.xlabel}',
                                      self.ylabel and f'y: {self.ylabel}') if s)


class Figure:
    """``rows`` x ``cols`` panels in a figure of ``figsize`` inches, titled
    ``title``; ``facecolor`` and ``grid`` (a colour, or None) style it."""

    def __init__(self, rows: int = 1, cols: int = 1, figsize=(5, 4), title: str = '',
                 dpi: int = 120, facecolor: str = '#ffffff', grid: Optional[str] = None):
        self.rows, self.cols, self.figsize, self.title = rows, cols, figsize, title
        self.dpi, self.facecolor, self.grid = dpi, facecolor, grid
        self.panels = [Panel() for _ in range(rows * cols)]

    def __getitem__(self, i: int) -> Panel:
        return self.panels[i]

    def save(self, path: str, plt=None) -> None:
        """Write the figure to ``path``: with matplotlib's ``pyplot`` when it
        is given, else through :meth:`image`."""
        if plt is None:
            with open(path, 'wb') as f:
                f.write(encode_png(self.image(), self.title, '\n'.join(
                    p._describe() for p in self.panels if p.marks)))
        else:
            self._save_matplotlib(plt, path)

    # -- without matplotlib -------------------------------------------------

    def image(self) -> np.ndarray:
        """The figure as an RGB image [H, W, 3] uint8."""
        w = max(int(self.figsize[0] * PX_PER_INCH) // self.cols, 80)
        h = max(int(self.figsize[1] * PX_PER_INCH) // self.rows, 60)
        img = np.empty((h * self.rows, w * self.cols, 3), np.uint8)
        img[:] = rgb(self.facecolor)
        for i, panel in enumerate(self.panels):
            if panel.marks:
                r, c = divmod(i, self.cols)
                _draw_panel(img[r * h:(r + 1) * h, c * w:(c + 1) * w], panel)
        return img

    # -- with matplotlib ----------------------------------------------------

    def _save_matplotlib(self, plt, path: str) -> None:
        fig, axes = plt.subplots(self.rows, self.cols, figsize=self.figsize, squeeze=False)
        fig.patch.set_facecolor(self.facecolor)
        for ax, panel in zip(axes.flat, self.panels):
            if not panel.marks:
                ax.set_visible(False)
                continue
            ax.set_facecolor(self.facecolor)
            if self.grid is not None:
                for spine in ('top', 'right'):
                    ax.spines[spine].set_visible(False)
                for spine in ('left', 'bottom'):
                    ax.spines[spine].set_color(self.grid)
                ax.grid(True, color=self.grid, linewidth=0.6, alpha=0.8)
                ax.set_axisbelow(True)
            for m in panel.marks:
                _mpl_mark(ax, m, panel)
            ax.set_title(panel.title, fontsize=8 if self.rows * self.cols > 1 else 10)
            ax.set_xlabel(panel.xlabel, fontsize=8)
            ax.set_ylabel(panel.ylabel, fontsize=8)
            ax.tick_params(labelsize=7)
            if panel.xticks is not None:
                ax.set_xticks(range(len(panel.xticks)), panel.xticks,
                              rotation=panel.xtick_rotation,
                              ha='right' if panel.xtick_rotation else 'center')
            if panel.legend:
                ax.legend(fontsize=7)
        if self.title:
            fig.suptitle(self.title, fontsize=11)
        fig.tight_layout()
        fig.savefig(path, dpi=self.dpi, facecolor=self.facecolor)
        plt.close(fig)


def _mpl_mark(ax, m: Mark, panel: Panel) -> None:
    c = m.colors[0]
    if m.kind == 'line':
        ax.plot(m.x, m.y, color=c, linewidth=m.linewidth, alpha=m.alpha, label=m.label,
                marker='o' if m.marker else None)
    elif m.kind == 'points':
        ax.scatter(m.x, m.y, s=m.size, alpha=m.alpha, color=c, label=m.label)
    elif m.kind == 'bars':
        ax.bar(m.x, m.y, width=m.width, color=c)
    elif m.kind == 'band':
        ax.fill_between(m.x, m.y, m.y2, color=c, alpha=m.alpha)
    elif m.kind == 'hist':
        many = len(m.data) > 1
        ax.hist(m.data if many else m.data[0], bins=m.bins,
                color=list(m.colors[:len(m.data)]) if many else c,
                label=m.labels, edgecolor='black' if many else None)
    elif m.kind == 'pie':
        ax.pie(m.y, labels=m.labels, autopct='%1.1f%%')
    elif m.kind == 'box':
        ax.boxplot(m.data, tick_labels=m.labels)
    else:
        raise ValueError(f'unknown mark {m.kind!r}')


def _draw_panel(img: np.ndarray, panel: Panel) -> None:
    """Rasterize ``panel``'s marks into ``img`` (a view of the figure) inside
    a frame, its data scaled to fill it."""
    h, w = img.shape[:2]
    x0, x1, y0, y1 = 10, w - 6, 6, h - 10
    img[[y0, y1], x0:x1 + 1] = FRAME
    img[y0:y1 + 1, [x0, x1]] = FRAME
    marks = [b for m in panel.marks for b in m.as_bars()]
    xs, ys = [], []
    for m in marks:
        if m.kind == 'bars':
            xs += [m.x - m.width / 2, m.x + m.width / 2]
            ys += [m.y, np.zeros(1)]
        else:
            xs.append(m.x)
            ys += [m.y] + ([m.y2] if m.y2 is not None else [])
    xs, ys = np.concatenate(xs), np.concatenate(ys)
    xs, ys = xs[np.isfinite(xs)], ys[np.isfinite(ys)]
    if not xs.size or not ys.size:
        return

    def lims(v):
        lo, hi = float(v.min()), float(v.max())
        pad = (hi - lo) * 0.03 or max(abs(lo) * 0.5, 0.5)
        return lo - pad, hi + pad

    (ax0, ax1), (ay0, ay1) = lims(xs), lims(ys)

    def px(v):
        return x0 + 1 + (v - ax0) * (x1 - x0 - 2) / (ax1 - ax0)

    def py(v):
        return y1 - 1 - (v - ay0) * (y1 - y0 - 2) / (ay1 - ay0)

    def ink(cols, rows, color, alpha=1.0):
        keep = np.isfinite(cols) & np.isfinite(rows)
        c = np.clip(np.rint(cols[keep]).astype(np.int64), x0 + 1, x1 - 1)
        r = np.clip(np.rint(rows[keep]).astype(np.int64), y0 + 1, y1 - 1)
        if alpha >= 1.0:
            img[r, c] = color
        else:
            img[r, c] = np.rint(img[r, c] * (1 - alpha) + np.asarray(color) * alpha)

    for m in marks:
        color = rgb(m.colors[0])
        if m.kind == 'bars':
            for xc, hgt in zip(m.x, m.y):
                if not np.isfinite(hgt):
                    continue
                c0, c1 = (int(np.rint(px(xc - m.width / 2 * s))) for s in (1, -1))
                r0, r1 = sorted(int(np.rint(py(v))) for v in (0.0, hgt))
                img[max(r0, y0 + 1):min(r1, y1 - 1) + 1,
                    max(c0, x0 + 1):max(min(c1, x1 - 1), c0 + 1)] = color
        elif m.kind == 'band':
            order = np.argsort(m.x)
            cols = np.arange(int(np.ceil(px(m.x.min()))), int(np.floor(px(m.x.max()))) + 1)
            vx = ax0 + (cols - x0 - 1) * (ax1 - ax0) / (x1 - x0 - 2)
            lo = py(np.interp(vx, m.x[order], m.y[order]))
            hi = py(np.interp(vx, m.x[order], m.y2[order]))
            for c, a, b in zip(cols, np.minimum(lo, hi), np.maximum(lo, hi)):
                rows = np.arange(int(np.rint(a)), int(np.rint(b)) + 1)
                ink(np.full(rows.size, float(c)), rows.astype(np.float64), color, m.alpha)
        elif m.kind == 'points':
            for dc in (0, 1):
                for dr in (0, 1):
                    ink(px(m.x) + dc, py(m.y) + dr, color, max(m.alpha, 0.5))
        else:
            finite = np.isfinite(m.x) & np.isfinite(m.y)
            if finite.sum() >= 1:
                ink(*_polyline(px(m.x[finite]), py(m.y[finite])), color, m.alpha)
            if m.marker:
                for dc in (-1, 0, 1):
                    for dr in (-1, 0, 1):
                        ink(px(m.x) + dc, py(m.y) + dr, color)
