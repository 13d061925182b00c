"""PNG decoding and encoding without OpenCV: stdlib zlib plus numpy.

The dataset readers of the JAX package decode images with cv2.imread; the
port runs where OpenCV is not installed, so it decodes the PNGs of the TUM,
KITTI and EuRoC layouts itself and returns what cv2.imread returns:

- read_png(path) is cv2.imread(path, IMREAD_GRAYSCALE): 8-bit gray. Colour
  is converted as libpng's rgb_to_gray does for OpenCV (coefficients 0.299
  and 0.587 in 1/32768 units, truncated; a pixel with equal channels keeps
  its value), alpha is dropped, 16-bit gray keeps its high byte.
- read_png(path, unchanged=True) is cv2.imread(path, IMREAD_UNCHANGED):
  gray as 2-D u8 or u16 (the TUM depth maps), colour as BGR or BGRA u8,
  gray with alpha as BGRA.

Read: colour types gray, RGB, gray-alpha and RGBA at 8 bits, gray at 16
bits, all five scanline filters, no interlace. Anything else (palette
images, 16-bit colour, Adam7, a bad CRC) raises ValueError. Ancillary chunks
are skipped; no gamma is applied.

write_png(dest, img) encodes u8 gray [H,W], u8 RGB [H,W,3] or u16 gray
[H,W] (every scanline unfiltered) to a path or a binary file-like object:
the dataset directories of chip_smoke.py and the live viewer's renders.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
# libpng's fixed-point rgb_to_gray weights for (0.299, 0.587), as OpenCV asks
# for them (png_set_rgb_to_gray(png, 1, 0.299, 0.587)): 29900 * 32768 // 1e5
# and 58700 * 32768 // 1e5, blue taking the rest of 32768
_RGB_TO_GRAY = (9797, 19234, 3737)


def _chunks(data: bytes, path):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: chunk {kind!r} is truncated or has a bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec 9.2) on the inflated bytes."""
    if raw.size != height * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = raw.reshape(height, stride + 1)
    kinds = rows[:, 0].astype(np.int32)
    if (kinds > 4).any():
        raise ValueError("PNG scanline filter type out of range")
    if (kinds <= 2).all():
        return _unfilter_rows(rows[:, 1:], kinds, bpp)
    return _unfilter_diagonals(rows[:, 1:], kinds, bpp)


def _unfilter_rows(filt: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """None, Sub and Up only: a byte needs the row above and, for Sub, a
    running sum of its lane, so each row is a few whole-row steps."""
    out = np.empty(filt.shape, np.uint8)
    prev = np.zeros(filt.shape[1], np.uint8)
    for r, kind in enumerate(kinds):
        row = filt[r]
        if kind == 1:
            row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            row = row + prev  # u8 arithmetic wraps modulo 256
        out[r] = prev = row
    return out


def _unfilter_diagonals(rows: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Any filters: a byte depends on its left, upper and upper-left
    neighbours (Average and Paeth), so the pixels are rebuilt one
    anti-diagonal at a time, every row's own filter applied by selection.
    The diagonals are the columns of a skewed copy (pixel (r, c) at
    [r, r + c]), so that each step reads slices."""
    height, stride = rows.shape
    width = stride // bpp
    r_of, c_of = np.indices((height, width))
    filt = np.zeros((height, height + width - 1, bpp), np.int32)
    filt[r_of, r_of + c_of] = rows.reshape(height, width, bpp)
    # out[r + 1, d + 2] is pixel (r, d - r); row 0, columns 0 and 1, and
    # every cell off the image read as zero
    out = np.zeros((height + 1, height + width + 1, bpp), np.int32)
    kind = [(kinds == k)[:, None] for k in range(5)]
    for d in range(height + width - 1):
        lo, hi = max(0, d - width + 1), min(d, height - 1) + 1
        a, b, ul = out[lo + 1:hi + 1, d + 1], out[lo:hi, d + 1], out[lo:hi, d]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        k = [m[lo:hi] for m in kind]
        pred = (k[1] * a + k[2] * b + k[3] * ((a + b) >> 1) + k[4] * paeth)
        out[lo + 1:hi + 1, d + 2] = (filt[lo:hi, d] + pred) & 0xFF
    return out[r_of + 1, r_of + c_of + 2].astype(np.uint8).reshape(height, stride)


def read_png(path, unchanged: bool = False) -> np.ndarray:
    """Decode a PNG as cv2.imread(path, IMREAD_GRAYSCALE), or with
    `unchanged` as cv2.imread(path, IMREAD_UNCHANGED) (module docstring).
    Raises FileNotFoundError for a missing file, ValueError for a PNG it
    does not read."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(path)
    header, idat = None, []
    for kind, body in _chunks(path.read_bytes(), path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if colour not in _CHANNELS or (depth, colour) not in {
            (8, 0), (8, 2), (8, 4), (8, 6), (16, 0)}:
        raise ValueError(f"{path}: colour type {colour} at {depth} bits is not read")
    if compression or filtering or interlace:
        raise ValueError(f"{path}: interlaced or non-standard PNG is not read")
    ch, nbytes = _CHANNELS[colour], depth // 8
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(data, height, width * ch * nbytes, ch * nbytes)
    if depth == 16:
        gray16 = px.reshape(height, width, 2).astype(np.uint16)
        gray16 = (gray16[..., 0] << 8) | gray16[..., 1]
        return gray16 if unchanged else (gray16 >> 8).astype(np.uint8)
    px = px.reshape(height, width, ch)
    if unchanged:
        if colour == 0:
            return px[..., 0].copy()
        if colour == 4:  # gray and alpha -> BGRA
            return np.ascontiguousarray(px[..., [0, 0, 0, 1]])
        return np.ascontiguousarray(px[..., [2, 1, 0, 3][:ch]])
    if colour in (0, 4):
        return px[..., 0].copy()
    rgb = px[..., :3].astype(np.int32)
    rc, gc, bc = _RGB_TO_GRAY
    gray = (rc * rgb[..., 0] + gc * rgb[..., 1] + bc * rgb[..., 2]) >> 15
    same = (rgb[..., 0] == rgb[..., 1]) & (rgb[..., 0] == rgb[..., 2])
    return np.where(same, rgb[..., 0], gray).astype(np.uint8)


def write_png(dest, img: np.ndarray) -> None:
    """Encode a u8 gray or RGB image or a u16 gray one as a PNG into `dest`,
    a path or a binary file-like object (module docstring)."""
    img = np.asarray(img)
    if not ((img.dtype == np.uint8 and (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)))
            or (img.dtype == np.uint16 and img.ndim == 2)):
        raise ValueError(f"write_png: {img.dtype} image of shape {img.shape} is not "
                         "u8 gray, u8 RGB or u16 gray")
    h, w = img.shape[:2]
    colour = 0 if img.ndim == 2 else 2
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = rows.view(np.uint8).reshape(h, -1)
    raw = np.hstack([np.zeros((h, 1), np.uint8), rows]).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))
    if hasattr(dest, "write"):
        dest.write(data)
    else:
        Path(dest).write_bytes(data)
