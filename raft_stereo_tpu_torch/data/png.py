"""A small PNG codec on the standard library's `zlib`: the port's PNG path
when the native IO core (native_io.py) is not built, and its PNG writer.

`read_png` decodes non-interlaced 8- and 16-bit gray, gray+alpha, RGB and
RGBA with the five row filters, into PIL's array layout: (H, W) for gray,
(H, W, C) otherwise; 16-bit gray as uint16, 16-bit multichannel as the
high byte of each sample in uint8, as PIL reads them (`full_depth=True`
keeps every 16-bit sample, as cv2's IMREAD_ANYDEPTH does, which the KITTI
flow reader needs). Palette, sub-byte and interlaced files raise
`PNGFormatError`.

`write_png` writes uint8 or uint16 arrays of 1 to 4 channels with filter
type 0 on every row, so that this decoder reads its own files with numpy
alone; the Sub and Up filters decode vectorized too, Average and Paeth run
a loop over the pixels of each row (files written by other encoders).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class PNGFormatError(ValueError):
    """A PNG this codec does not decode (palette, sub-byte, interlaced) or
    a malformed file."""


def _chunks(data: bytes, path: str):
    if data[:8] != SIGNATURE:
        raise PNGFormatError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise PNGFormatError(f"{path}: truncated {kind!r} chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise PNGFormatError(f"{path}: no IEND chunk")


def _paeth_row(x: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(x.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(x: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(x.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    kinds = rows[:, 0]
    data = rows[:, 1:]
    if not (kinds <= 4).all():
        raise PNGFormatError(f"{path}: bad filter type {int(kinds.max())}")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    r = 0
    while r < h:
        kind = kinds[r]
        if kind == 0:
            # A run of unfiltered rows is a copy.
            end = r + 1
            while end < h and kinds[end] == 0:
                end += 1
            out[r:end] = data[r:end]
            r = end
            prev = out[r - 1]
            continue
        x = data[r]
        if kind == 1:  # Sub: a running sum per byte of a pixel
            row = np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row = x + prev
        elif kind == 3:
            row = _average_row(x, prev, bpp)
        else:
            row = _paeth_row(x, prev, bpp)
        out[r] = row
        prev = out[r]
        r += 1
    return out


def read_png(path: str, full_depth: bool = False) -> np.ndarray:
    """Decode `path` (see the module docstring for the layout)."""
    with open(path, "rb") as f:
        data = f.read()
    header = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGFormatError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16) or interlace != 0:
        raise PNGFormatError(
            f"{path}: unsupported PNG (bit depth {depth}, color type {color}, interlace {interlace}); "
            "the codec reads non-interlaced 8- and 16-bit gray, gray+alpha, RGB and RGBA")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise PNGFormatError(f"{path}: corrupt image data: {e}") from e
    if raw.size != h * (w * bpp + 1):
        raise PNGFormatError(f"{path}: image data holds {raw.size} bytes, expected {h * (w * bpp + 1)}")
    img = _unfilter(raw, h, w * bpp, bpp, path)
    if depth == 16:
        img = img.reshape(h, w * channels, 2)
        if channels == 1 or full_depth:
            img = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
        else:
            img = img[..., 0].copy()
    img = img.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path: str, array: np.ndarray, level: int = 6) -> None:
    """Write a uint8 or uint16 (H, W) or (H, W, C) array, C in 1..4 (gray,
    gray+alpha, RGB, RGBA), with filter type 0 on every row."""
    a = np.asarray(array)
    if a.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or not 1 <= a.shape[2] <= 4:
        raise ValueError(f"write_png takes (H, W) or (H, W, C<=4), got {a.shape}")
    h, w, c = a.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    depth = 16 if a.dtype == np.uint16 else 8
    body = a.astype(">u2") if depth == 16 else a
    rows = np.ascontiguousarray(body).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    out = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    out += _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b"")
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(out)
    os.replace(tmp, path)
