"""PNG files on the standard library's ``zlib`` and numpy: the port's own
reader and writer, so that its data pipeline needs no image library (imageio,
PIL or cv2).

Reading (``read_png``): 8-bit gray -> uint8 [H, W]; 16-bit gray -> uint16
[H, W]; RGB -> uint8 [H, W, 3]; RGBA -> its RGB (alpha dropped); palette
(1-, 2-, 4- or 8-bit indices) -> RGB through PLTE, as imageio returns a
palette image. Every chunk's CRC is checked and the five row filters (None,
Sub, Up, Average, Paeth) are undone. Anything else (interlaced files, gray
with alpha, 16-bit colour, gray below 8 bits) raises with the file's name;
so does a JPEG, whose decoding is not ported.

Writing (``write_png``): uint8 gray, uint16 gray, RGB or RGBA, deflated by
``zlib`` at ``level``; every row with filter 0 (None) unless ``filters``
names others, row y taking ``filters[y % len(filters)]`` (so a file that
needs Average and Paeth undone can be made without another encoder); written
to a temporary name and moved into place.

Sub and Up run on whole rows. Average and Paeth depend on the byte one pixel
to the left as well as on the row above, so a file that uses them (as most
encoders' adaptive filtering does) is undone one anti-diagonal at a time:
H + W - 1 numpy steps a file.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SUFFIXES = (".jpg", ".jpeg")
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}   # colour type -> samples a pixel


class PNGError(ValueError):
    pass


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise PNGError(f"{path}: chunk {kind!r} is truncated or fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise PNGError(f"{path}: no IEND chunk")


def _skewed(s: np.ndarray, height: int, width: int) -> np.ndarray:
    """The [height, width, bpp] view of the wavefront buffer ``s`` [T + 1,
    height + 1, bpp] in which pixel (y, x) sits at s[x + y + 1, y + 1]."""
    st = s.strides
    return np.lib.stride_tricks.as_strided(s[1:, 1:], (height, width, s.shape[2]),
                                           (st[0] + st[1], st[0], st[2]))


def _unfilter_wavefront(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo any mix of the five filters, rows uint8 [H, 1 + stride] -> uint8
    [H, stride]. Byte (y, x) needs (y, x - bpp), (y - 1, x) and (y - 1, x -
    bpp), so the pixels on one anti-diagonal x + y = t depend only on earlier
    ones: H + W - 1 numpy steps, each over one diagonal (a column of ``s``,
    contiguous), in place of H x stride steps in Python."""
    height = rows.shape[0]
    kinds = rows[:, 0]
    line = rows[:, 1:].reshape(height, -1, bpp)
    width = line.shape[1]
    s = np.zeros((width + height, height + 1, bpp), np.int16)
    _skewed(s, height, width)[...] = line
    use = [np.broadcast_to((kinds == k)[:, None], (height, bpp)) for k in range(4)]
    zero = np.zeros((height, bpp), np.int16)
    for t in range(width + height - 1):
        lo, hi = max(0, t - width + 1), min(height, t + 1)
        a, b = s[t, lo + 1:hi + 1], s[t, lo:hi]          # left, up
        c = s[t - 1, lo:hi] if t else zero[lo:hi]        # up-left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        np.copyto(pred, (a + b) >> 1, where=use[3][lo:hi])
        np.copyto(pred, b, where=use[2][lo:hi])
        np.copyto(pred, a, where=use[1][lo:hi])
        np.copyto(pred, 0, where=use[0][lo:hi])
        cur = s[t + 1, lo + 1:hi + 1]
        cur += pred
        cur &= 255
    return _skewed(s, height, width).astype(np.uint8).reshape(height, -1)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo each scanline's filter; returns uint8 [height, stride]. Rows of
    None, Sub and Up only are undone a row at a time, whole rows in numpy;
    a file with any Average or Paeth row a diagonal at a time."""
    if len(raw) < height * (stride + 1):
        raise PNGError(f"{path}: image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    if rows[:, 0].max(initial=0) > 4:
        y = int(np.argmax(rows[:, 0] > 4))
        raise PNGError(f"{path}: row {y} has the unknown filter {rows[y, 0]}")
    if rows[:, 0].max(initial=0) > 2:
        return _unfilter_wavefront(rows, bpp)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = line.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8).reshape(-1)
        else:
            cur = line + prior
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """The image in the PNG file ``path`` as a numpy array (see the module's
    docstring for the forms and their arrays)."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if path.lower().endswith(JPEG_SUFFIXES) or data[:2] == b"\xff\xd8":
        raise NotImplementedError(f"{path}: JPEG decoding is not ported to tdnet_tpu_torch yet")
    if data[:8] != SIGNATURE:
        raise PNGError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise PNGError(f"{path}: no IHDR or no IDAT chunk")
    width, height, depth, ctype, _, _, interlace = header
    supported = (ctype == 0 and depth in (8, 16)) or (ctype in (2, 6) and depth == 8) or (
        ctype == 3 and depth in (1, 2, 4, 8))
    if not supported or interlace:
        raise PNGError(f"{path}: PNG of colour type {ctype}, bit depth {depth}"
                       f"{', interlaced' if interlace else ''} is not supported")
    channels = _CHANNELS[ctype]
    bits = width * channels * depth
    stride, bpp = (bits + 7) // 8, max(1, channels * depth // 8)
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, stride, bpp, path)
    if ctype == 3:
        if palette is None:
            raise PNGError(f"{path}: palette image without a PLTE chunk")
        index = np.unpackbits(rows, axis=1)[:, :width * depth] if depth < 8 else rows
        if depth < 8:
            weights = 1 << np.arange(depth - 1, -1, -1)
            index = (index.reshape(height, width, depth) * weights).sum(-1)
        if index.max(initial=0) >= len(palette):
            raise PNGError(f"{path}: palette index out of range")
        return palette[index]
    if depth == 16:
        return rows.view(">u2").reshape(height, width).astype(np.uint16)
    img = rows.reshape(height, width, channels)
    if channels == 1:
        return img[..., 0]
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> np.ndarray:
    """The scanlines uint8 [H, stride] filtered, row y by ``filters[y %
    len(filters)]``, each prefixed with its filter byte: the forward filters
    of the PNG spec, every row at once (they read only unfiltered bytes)."""
    kinds = np.resize(np.asarray(filters, np.uint8), len(rows))
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filters are 0-4, not {tuple(filters)}")
    x = rows.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left, upleft = np.zeros_like(x), np.zeros_like(x)
    left[:, bpp:], upleft[:, bpp:] = x[:, :-bpp], up[:, :-bpp]
    pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    pred = np.choose(kinds[:, None], preds)
    return np.concatenate([kinds[:, None], ((x - pred) & 255).astype(np.uint8)], axis=1)


def write_png(path: str, img: np.ndarray, level: int = 6, filters=(0,)) -> None:
    """Write ``img`` (uint8 [H, W], uint16 [H, W], uint8 [H, W, 3] or
    [H, W, 4]) as a PNG, deflate ``level``, row y filtered by
    ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    a = np.asarray(img)
    if a.ndim == 2 and a.dtype in (np.uint8, np.uint16):
        ctype, depth = 0, 8 * a.dtype.itemsize
    elif a.ndim == 3 and a.dtype == np.uint8 and a.shape[2] in (3, 4):
        ctype, depth = (2 if a.shape[2] == 3 else 6), 8
    else:
        raise PNGError(f"{path}: cannot write an array of shape {a.shape} and dtype {a.dtype}")
    h, w = a.shape[:2]
    body = a.astype(">u2") if depth == 16 else a
    bpp = (a.shape[2] if a.ndim == 3 else 1) * depth // 8
    raw = _filter_rows(body.reshape(h, -1).view(np.uint8), bpp, filters)
    data = (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
