"""8-bit grayscale and RGBA PNG writers on the standard library (``zlib``
and ``struct``), so the sweep's and the datagen's PNGs need no image
package.

One IDAT chunk holds the zlib stream of the rows, each behind filter byte
0 (None); the pixels a decoder returns are the uint8 array given.

``write_png_colormap`` writes what ``matplotlib.pyplot.imsave(path, img)``
writes for a 2-D image with its defaults: the image scaled to its own min
and max, mapped through viridis' 256 colours, RGBA with alpha 255.
``VIRIDIS_RGB`` is matplotlib's table as its colormap gives it in bytes
(``matplotlib.colormaps["viridis"](np.arange(256), bytes=True)``), taken
once from matplotlib 3.10.8; the card has no matplotlib.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"

VIRIDIS_RGB = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163"
    "47126547146647156747166947186a48196b481a6c481c6e481d6f481e70482071482172"
    "482273482374472575472676472777472878472a79472b7a472c7b462d7c462f7c46307d"
    "46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c89"
    "3c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c"
    "365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d"
    "31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e"
    "277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24868d23878d23888d"
    "23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a982"
    "24aa8225ab8126ac8127ad8028ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a"
    "32b57a33b67935b77836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be70"
    "45bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d052"
    "79d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f"
    "97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2b"
    "b7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51e"
    "f6e61ff8e621fae622fde724"
), np.uint8).reshape(256, 3)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)


def _write_png(path: str, img: np.ndarray, color: int) -> None:
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    ihdr = struct.pack(">2I5B", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png_gray(path: str, img_u8: np.ndarray) -> None:
    """Write a (H, W) uint8 image as an 8-bit grayscale PNG (color type 0,
    bit depth 8)."""
    img = np.ascontiguousarray(img_u8, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError(f"write_png_gray takes a (H, W) image, got shape {img.shape}")
    _write_png(path, img, 0)


def write_png_unit(path: str, img: np.ndarray) -> None:
    """A (H, W) image in [0, 1] as a grayscale PNG, each pixel
    uint8(clip(x, 0, 1) * 255): within one level of ``plt.imsave(path, img,
    cmap='gray', vmin=0, vmax=1)``."""
    write_png_gray(path, (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))


def write_png_rgba(path: str, rgba_u8: np.ndarray) -> None:
    """Write a (H, W, 4) uint8 image as an 8-bit RGBA PNG (color type 6)."""
    img = np.ascontiguousarray(rgba_u8, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 4:
        raise ValueError(f"write_png_rgba takes a (H, W, 4) image, got shape {img.shape}")
    _write_png(path, img, 6)


def colormap_rgba(img: np.ndarray) -> np.ndarray:
    """(H, W) -> (H, W, 4) uint8 as ``plt.imsave``'s defaults map it:
    (img - min) / (max - min) in img's dtype (0 where max == min), colour
    index floor(256 x) with 1.0 taken to 255, viridis, alpha 255."""
    x = np.array(img, copy=True)
    if x.dtype.kind != "f":
        x = x.astype(np.float64)
    lo, hi = x.min(), x.max()
    if hi == lo:
        x.fill(0)
    else:
        x -= lo
        x /= hi - lo
    x *= 256
    x[x == 256] = 255
    idx = np.clip(x, 0, 255).astype(np.int64)
    rgba = np.empty(img.shape + (4,), np.uint8)
    rgba[..., :3] = VIRIDIS_RGB[idx]
    rgba[..., 3] = 255
    return rgba


def write_png_colormap(path: str, img: np.ndarray) -> None:
    """``plt.imsave(path, img)`` for a 2-D image: viridis, autoscaled."""
    write_png_rgba(path, colormap_rgba(img))


def read_png_gray(path: str) -> np.ndarray:
    """Read back an 8-bit grayscale, non-interlaced PNG whose rows all use
    filter 0, as ``write_png_gray`` writes them -> (H, W) uint8."""
    return _read_png(path, 0)


def read_png_rgba(path: str) -> np.ndarray:
    """Read back an 8-bit RGBA PNG as ``write_png_rgba`` writes it -> (H,
    W, 4) uint8."""
    return _read_png(path, 6)


def _read_png(path: str, want_color: int) -> np.ndarray:
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
            if (depth, color, interlace) != (8, want_color, 0):
                raise ValueError(f"{path}: not an 8-bit non-interlaced PNG of color type "
                                 f"{want_color}")
            shape = (h, w) if color == 0 else (h, w, 4)
        elif kind == b"IDAT":
            idat += payload
        pos += 12 + n
    h = shape[0]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row uses a filter other than 0")
    return rows[:, 1:].reshape(shape).copy()
