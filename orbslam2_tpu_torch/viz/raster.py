"""A small RGB canvas in numpy: the drawing the live viewer needs, without
matplotlib.

- `Canvas`: dots (filled or hollow, of a radius and colour, alpha-blended),
  line segments, arrows, square markers, text in a fixed 5x7 bitmap font
  for printable ASCII, a gray image as background, rectangles;
- `View`: a world-to-pixel transform with equal aspect over a square plot
  area, which either fits the drawn elements' bounding box with a margin
  (as matplotlib's autoscale does) or shows `center +- span`.

Host code on numpy arrays: every primitive takes a batch of elements and
stamps them with one fancy-indexed write.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# 5x7 glyphs of the printable ASCII characters 32..126, five columns of
# seven bits each (bit 0 the top row), as the classic LCD character ROMs
_FONT_HEX = (
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12" "2313086462"
    "3649552250" "0005030000" "001c224100" "0041221c00" "082a1c2a08" "08083e0808"
    "0050300000" "0808080808" "0060600000" "2010080402" "3e5149453e" "00427f4000"
    "4261514946" "2141454b31" "1814127f10" "2745454539" "3c4a494930" "0171090503"
    "3649494936" "064949291e" "0036360000" "0056360000" "0814224100" "1414141414"
    "0041221408" "0201510906" "324979413e" "7e1111117e" "7f49494936" "3e41414122"
    "7f4141221c" "7f49494941" "7f09090101" "3e41415132" "7f0808087f" "00417f4100"
    "2040413f01" "7f08142241" "7f40404040" "7f0204027f" "7f0408107f" "3e4141413e"
    "7f09090906" "3e4151215e" "7f09192946" "4649494931" "01017f0101" "3f4040403f"
    "1f2040201f" "7f2018207f" "6314081463" "0304780403" "6151494543" "007f414100"
    "0204081020" "0041417f00" "0402010204" "4040404040" "0001020400" "2054545478"
    "7f48444438" "3844444420" "384444487f" "3854545418" "087e090102" "081454543c"
    "7f08040478" "00447d4000" "2040443d00" "007f102844" "00417f4000" "7c04180478"
    "7c08040478" "3844444438" "7c14141408" "081414187c" "7c08040408" "4854545420"
    "043f444020" "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"
    "4464544c44" "0008364100" "00007f0000" "0041360800" "08082a1c08")
GLYPH_W, GLYPH_H, ADVANCE = 5, 7, 6


def _glyphs() -> np.ndarray:
    """[95, 7, 5] bool: the font as row-major bitmaps."""
    cols = np.frombuffer(bytes.fromhex(_FONT_HEX), np.uint8).reshape(95, GLYPH_W)
    return ((cols[:, None, :] >> np.arange(GLYPH_H)[None, :, None]) & 1).astype(bool)


_GLYPHS = _glyphs()


def _disk(radius: float, inner: float = -1.0):
    """(dy, dx) offsets of the pixels whose centres lie within `radius` and
    beyond `inner` of the origin: a filled disk, or a ring."""
    r = int(np.ceil(radius))
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    d = np.hypot(dy, dx)
    keep = (d <= radius + 0.5) & (d > inner)
    return dy[keep], dx[keep]


def rgb(color) -> np.ndarray:
    """A colour as a float32 RGB triple from a "#rrggbb" string or a
    sequence of 0..255 values."""
    if isinstance(color, str):
        return np.array([int(color[i:i + 2], 16) for i in (1, 3, 5)], np.float32)
    return np.asarray(color, np.float32)


class Canvas:
    """An RGB image of `height` x `width`, drawn on in float32 and read out
    as u8 by `pixels()`."""

    def __init__(self, width: int, height: int, background="#ffffff"):
        self.width, self.height = int(width), int(height)
        self.px = np.empty((self.height, self.width, 3), np.float32)
        self.px[:] = rgb(background)

    # ------------------------------------------------------------ stamping
    def _blend(self, rows, cols, color, alpha: float) -> None:
        """Blend `color` into the pixels (rows, cols) once each (an overlap
        of several elements counts once), clipped to the canvas."""
        rows = np.asarray(rows).reshape(-1)
        cols = np.asarray(cols).reshape(-1)
        keep = (rows >= 0) & (rows < self.height) & (cols >= 0) & (cols < self.width)
        if not keep.any():
            return
        mask = np.zeros((self.height, self.width), bool)
        mask[rows[keep], cols[keep]] = True
        c = rgb(color)
        if alpha >= 1.0:
            self.px[mask] = c
        else:
            self.px[mask] = self.px[mask] * (1.0 - alpha) + c * alpha

    def _stamp(self, x, y, offsets, color, alpha: float) -> None:
        """The pixel offsets (dy, dx) placed at every point (x, y)."""
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        ok = np.isfinite(x) & np.isfinite(y)
        cx = np.floor(x[ok]).astype(np.int64)
        cy = np.floor(y[ok]).astype(np.int64)
        dy, dx = offsets
        self._blend(cy[:, None] + dy[None, :], cx[:, None] + dx[None, :], color, alpha)

    # ----------------------------------------------------------- primitives
    def dots(self, x, y, radius: float, color, alpha: float = 1.0,
             filled: bool = True, edge: float = 1.0) -> None:
        """Discs (or rings of width `edge`) of `radius` px at pixel (x, y)."""
        offsets = _disk(radius) if filled else _disk(radius, radius - edge)
        self._stamp(x, y, offsets, color, alpha)

    def squares(self, x, y, half: int, color, alpha: float = 1.0) -> None:
        """Filled squares of side 2 * half + 1 px centred at (x, y)."""
        dy, dx = np.mgrid[-half:half + 1, -half:half + 1]
        self._stamp(x, y, (dy.ravel(), dx.ravel()), color, alpha)

    def segments(self, x0, y0, x1, y1, color, alpha: float = 1.0,
                 width: float = 1.0) -> None:
        """Line segments from (x0, y0) to (x1, y1), sampled every half
        pixel, `width` px wide."""
        x0, y0, x1, y1 = (np.atleast_1d(np.asarray(v, np.float64)) for v in (x0, y0, x1, y1))
        ok = np.isfinite(x0) & np.isfinite(y0) & np.isfinite(x1) & np.isfinite(y1)
        x0, y0, x1, y1 = x0[ok], y0[ok], x1[ok], y1[ok]
        if not len(x0):
            return
        # the part of a segment far outside the canvas is never sampled
        lim = 4.0 * (self.width + self.height)
        x0, y0, x1, y1 = (np.clip(v, -lim, lim) for v in (x0, y0, x1, y1))
        n = np.maximum(np.ceil(2.0 * np.hypot(x1 - x0, y1 - y0)).astype(np.int64), 1) + 1
        seg = np.repeat(np.arange(len(n)), n)
        first = np.cumsum(n) - n
        t = (np.arange(n.sum()) - first[seg]) / np.maximum(n[seg] - 1, 1)
        xs = x0[seg] + t * (x1 - x0)[seg]
        ys = y0[seg] + t * (y1 - y0)[seg]
        offsets = _disk(max(width, 1.0) / 2.0 - 0.5) if width > 1.0 else (
            np.zeros(1, np.int64), np.zeros(1, np.int64))
        self._stamp(xs, ys, offsets, color, alpha)

    def polyline(self, x, y, color, alpha: float = 1.0, width: float = 1.0) -> None:
        x, y = np.asarray(x), np.asarray(y)
        if len(x) >= 2:
            self.segments(x[:-1], y[:-1], x[1:], y[1:], color, alpha, width)

    def arrows(self, x0, y0, x1, y1, color, head: float = 6.0, width: float = 1.0) -> None:
        """Arrows from (x0, y0) to heads at (x1, y1): the shaft and two
        strokes of `head` px at 25 degrees either side of it."""
        x0, y0, x1, y1 = (np.atleast_1d(np.asarray(v, np.float64)) for v in (x0, y0, x1, y1))
        self.segments(x0, y0, x1, y1, color, width=width)
        ang = np.arctan2(y0 - y1, x0 - x1)
        for side in (-1.0, 1.0):
            a = ang + side * np.radians(25.0)
            self.segments(x1, y1, x1 + head * np.cos(a), y1 + head * np.sin(a), color,
                          width=width)

    def rect(self, left: int, top: int, right: int, bottom: int, color) -> None:
        """The outline of a rectangle, corners inclusive."""
        xs, ys = [left, right, right, left], [top, top, bottom, bottom]
        self.segments(xs, ys, xs[1:] + xs[:1], ys[1:] + ys[:1], color)

    def fill(self, left: int, top: int, right: int, bottom: int, color) -> None:
        self.px[max(top, 0):bottom, max(left, 0):right] = rgb(color)

    def image(self, gray: np.ndarray, left: int = 0, top: int = 0) -> None:
        """A gray image (0..255) as the background at (left, top)."""
        g = np.clip(np.asarray(gray, np.float32), 0, 255)
        h = min(g.shape[0], self.height - top)
        w = min(g.shape[1], self.width - left)
        self.px[top:top + h, left:left + w] = g[:h, :w, None]

    def text(self, x: int, y: int, s: str, color, scale: int = 1,
             anchor: str = "left") -> None:
        """`s` in the 5x7 font with its top-left corner at (x, y), each font
        pixel `scale` px square; anchor "right" or "center" aligns (x, y)
        with the end or the middle of the line instead. Characters outside
        printable ASCII draw as '?'."""
        width = text_width(s, scale)
        x = x - (width if anchor == "right" else width // 2 if anchor == "center" else 0)
        codes = np.array([ord(c) if 32 <= ord(c) <= 126 else ord("?") for c in s]) - 32
        if not len(codes):
            return
        k, r, c = np.nonzero(_GLYPHS[codes])
        rows = (y + r * scale)[:, None, None] + np.arange(scale)[None, :, None]
        cols = (x + k * ADVANCE * scale + c * scale)[:, None, None] + np.arange(scale)[None, None, :]
        rows, cols = np.broadcast_arrays(rows, cols)
        self._blend(rows, cols, color, 1.0)

    def pixels(self) -> np.ndarray:
        """The canvas as [H, W, 3] u8."""
        return np.clip(np.round(self.px), 0, 255).astype(np.uint8)


def text_width(s: str, scale: int = 1) -> int:
    return max(len(s) * ADVANCE - 1, 0) * scale


@dataclass(frozen=True)
class View:
    """World (a, b) -> pixel (x, y) over a square plot area of `size` px
    whose top-left pixel is (left, top): x grows with a, y shrinks with b,
    one scale for both (equal aspect). The visible world square is
    [a0, a0 + extent] x [b0, b0 + extent]."""

    a0: float
    b0: float
    extent: float
    left: int
    top: int
    size: int

    @classmethod
    def fit(cls, a, b, left: int, top: int, size: int, margin: float = 0.05) -> "View":
        """The square that holds every finite (a, b), grown by `margin` of
        its side on each side (matplotlib's default margins), the shorter
        axis centred. An empty or single-point set shows a unit square."""
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        ok = np.isfinite(a) & np.isfinite(b)
        if not ok.any():
            return cls(-0.5, -0.5, 1.0, left, top, size)
        a, b = a[ok], b[ok]
        lo_a, hi_a, lo_b, hi_b = a.min(), a.max(), b.min(), b.max()
        side = max(hi_a - lo_a, hi_b - lo_b)
        side = side if side > 0 else 1.0
        extent = side * (1.0 + 2.0 * margin)
        return cls(0.5 * (lo_a + hi_a) - extent / 2, 0.5 * (lo_b + hi_b) - extent / 2,
                   extent, left, top, size)

    @classmethod
    def centered(cls, ca: float, cb: float, span: float, left: int, top: int,
                 size: int) -> "View":
        """`center +- span` on both axes (the viewer's follow mode)."""
        return cls(ca - span, cb - span, 2.0 * span, left, top, size)

    @property
    def scale(self) -> float:
        """Pixels per world unit."""
        return self.size / self.extent

    def to_px(self, a, b):
        """Pixel coordinates (x, y) of world (a, b): the world square's
        corner (a0, b0 + extent) at the area's top-left corner (left, top)
        of pixel (left, top), so pixel (i, j) spans [i, i + 1)."""
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return (self.left + (a - self.a0) * self.scale,
                self.top + (self.b0 + self.extent - b) * self.scale)

    def limits(self):
        """((a_min, a_max), (b_min, b_max)) of the visible square."""
        return ((self.a0, self.a0 + self.extent), (self.b0, self.b0 + self.extent))


def nice_ticks(lo: float, hi: float, n: int = 6) -> np.ndarray:
    """About `n` round tick values (1, 2 or 5 times a power of ten) in [lo, hi]."""
    if not (np.isfinite(lo) and np.isfinite(hi)) or hi <= lo:
        return np.zeros(0)
    raw = (hi - lo) / n
    mag = 10.0 ** np.floor(np.log10(raw))
    step = mag * min((s for s in (1.0, 2.0, 5.0, 10.0) if s * mag >= raw), default=10.0)
    first = np.ceil(lo / step) * step
    return np.arange(first, hi + step * 1e-9, step)
