"""8-bit grayscale PNG writer on the standard library (``zlib`` and
``struct``), so the sweep's projection PNGs need no image package.

One IDAT chunk holds the zlib stream of the rows, each behind filter byte
0 (None); the pixels a decoder returns are the uint8 array given.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)


def write_png_gray(path: str, img_u8: np.ndarray) -> None:
    """Write a (H, W) uint8 image as an 8-bit grayscale PNG (color type 0,
    bit depth 8)."""
    img = np.ascontiguousarray(img_u8, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError(f"write_png_gray takes a (H, W) image, got shape {img.shape}")
    h, w = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    ihdr = struct.pack(">2I5B", w, h, 8, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def read_png_gray(path: str) -> np.ndarray:
    """Read back an 8-bit grayscale, non-interlaced PNG whose rows all use
    filter 0, as ``write_png_gray`` writes them -> (H, W) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, shape = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + payload) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">2I5B", payload)
            if (depth, color, interlace) != (8, 0, 0):
                raise ValueError(f"{path}: not an 8-bit grayscale non-interlaced PNG")
            shape = (h, w)
        elif kind == b"IDAT":
            idat += payload
        pos += 12 + n
    h, w = shape
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row uses a filter other than 0")
    return rows[:, 1:].copy()
