"""Minimal PNG writer (no external imaging deps).

The reference displays frames in SFML windows; headless GPU hosts write
frames to disk instead. Plain zlib-deflated 8-bit RGB PNG.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0,1] float image -> uint8, clipping."""
    return (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255.0 + 0.5).astype(
        np.uint8
    )


def encode_png(img: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode an (H, W, 3) float [0,1] or uint8 array as PNG bytes.

    ``compress_level`` 1 is the live-preview setting (utils/viewer.py:
    encode speed beats size on localhost streams)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    h, w, c = arr.shape
    assert c == 3, f"expected RGB, got {arr.shape}"

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body)
        )

    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))
    return b"".join(
        [
            b"\x89PNG\r\n\x1a\n",
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
            chunk(b"IDAT", zlib.compress(raw, compress_level)),
            chunk(b"IEND", b""),
        ]
    )


def write_png(path: str | Path, img: np.ndarray) -> None:
    """Write an (H, W, 3) float [0,1] or uint8 array as a PNG file."""
    Path(path).write_bytes(encode_png(img))


def read_png(path: str | Path) -> np.ndarray:
    """Decode a PNG written by `write_png` (8-bit RGB, one IDAT chunk,
    filter 0 on every row) back to an (H, W, 3) uint8 array."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunks[tag] = data[pos + 8:pos + 8 + length]
        pos += 12 + length
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, ctype) != (8, 2):
        raise ValueError(f"{path}: not 8-bit RGB")
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows use a PNG filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()
