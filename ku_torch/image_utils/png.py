"""A small PNG writer and reader on the standard library (``zlib`` and
``struct``), so that the examples write and read images where matplotlib is
absent.

It handles 8-bit, non-interlaced images in gray (color type 0), gray +
alpha (4), RGB (2) and RGBA (6), every row filter on reading and filter 0
on writing; anything else (palettes, 16-bit, interlacing) raises
``ValueError``. Pixels are uint8 arrays (H, W) or (H, W, C); a float image
is taken as [0, 1] and stored as round(255·x), clipped.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS_OF = {0: 1, 4: 2, 2: 3, 6: 4}
_TYPE_OF = {c: t for t, c in _CHANNELS_OF.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _to_uint8(image) -> np.ndarray:
    """uint8 pixels of an image (float images are taken as [0, 1])."""
    a = np.asarray(image)
    if a.dtype == np.uint8:
        return a
    if np.issubdtype(a.dtype, np.floating):
        return np.clip(np.rint(a * 255.0), 0, 255).astype(np.uint8)
    return np.clip(a, 0, 255).astype(np.uint8)


def write_png(path: str, image) -> None:
    """Write (H, W) or (H, W, C) pixels, C in 1..4, as an 8-bit PNG."""
    a = _to_uint8(image)
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _TYPE_OF:
        raise ValueError(f"PNG pixels must be (H, W) or (H, W, 1..4), got {a.shape}")
    h, w, c = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _TYPE_OF[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (1, 3, 4):
            # Each byte depends on the one bpp before it: walk the pixels.
            cur = np.zeros(stride, np.int32)
            for i in range(0, stride, bpp):
                left = cur[i - bpp:i] if i else np.zeros(bpp, np.int32)
                up = prev[i:i + bpp]
                if kind == 1:
                    pred = left
                elif kind == 3:
                    pred = (left + up) // 2
                else:
                    up_left = prev[i - bpp:i] if i else np.zeros(bpp, np.int32)
                    pred = _paeth(left, up, up_left)
                cur[i:i + bpp] = (line[i:i + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """The pixels of an 8-bit PNG as uint8, (H, W) for gray, (H, W, C)
    otherwise."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS_OF or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray / gray+alpha / RGB / RGBA "
                         f"PNGs are read (bit depth {depth}, color type {ctype}, "
                         f"interlace {interlace})")
    c = _CHANNELS_OF[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    pixels = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    return pixels[..., 0] if c == 1 else pixels
