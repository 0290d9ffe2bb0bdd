"""Image export.

A numpy copy of opengl_ray_tracing_framework_tpu/utils/image.py, equal
in what it computes (tests/test_torch_host.py checks the arrays byte for
byte): the JAX package cannot be imported without importing jax.

The reference saves frames via glReadPixels + stb PNG (SaveFrame,
src/core/Utility.h:19-30). Here: a dependency-free PNG writer (zlib is in
the standard library) plus helpers for the float->8-bit display conversion.
Row order: row 0 of the array is written as the *top* image row, so arrays
in (H, W, 3) with row 0 = top display directly; the renderer's row 0 is the
bottom scanline (GL convention), so callers flip — see save_render.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) uint8 or float in [0, 1]; row 0 = top."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to_uint8(img)
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)

    raw = b"".join(
        b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", header)
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(png)


def save_render(path: str, image) -> None:
    """Save a renderer output ((H, W, 3), row 0 = bottom scanline) as PNG,
    flipped vertically like stbi_flip_vertically_on_write (Utility.h:28)."""
    img = np.asarray(image)[::-1]
    write_png(path, img)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for round-trip tests (8-bit RGB, no interlace)."""
    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert depth == 8 and ctype == 2, "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw, np.uint8, stride, y * (stride + 1) + 1).copy()
        if ftype == 0:
            pass
        elif ftype == 1:
            for x in range(3, stride):
                line[x] = (line[x] + line[x - 3]) & 0xFF
        elif ftype == 2:
            line = (line + prev) & 0xFF
        elif ftype == 3:
            for x in range(stride):
                left = line[x - 3] if x >= 3 else 0
                line[x] = (line[x] + ((int(left) + int(prev[x])) >> 1)) & 0xFF
        elif ftype == 4:
            for x in range(stride):
                a = int(line[x - 3]) if x >= 3 else 0
                bq = int(prev[x])
                c = int(prev[x - 3]) if x >= 3 else 0
                p = a + bq - c
                pa, pb, pc = abs(p - a), abs(p - bq), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (bq if pb <= pc else c)
                line[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"unsupported filter {ftype}")
        out[y] = line
        prev = line
    return out.reshape(h, w, 3)
