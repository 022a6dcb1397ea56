"""Minimal PNG writer (standard library only).

The JAX package writes frames with OpenCV. The port writes them with
``zlib`` and ``struct`` so that rendering needs no image library:
8-bit RGB, no interlace, filter type 0 (None) on every row.
"""

import struct
import zlib

import numpy as np

__all__ = ["encode_png", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(image: np.ndarray) -> bytes:
    """The PNG file of an (H, W, 3) uint8 RGB image, as bytes."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("a PNG takes an (H, W, 3) uint8 array, got "
                         f"{image.dtype} {image.shape}")
    height, width = image.shape[:2]
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    rows = np.zeros((height, 1 + 3 * width), np.uint8)
    rows[:, 1:] = image.reshape(height, 3 * width)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """Writes an (H, W, 3) uint8 RGB image to ``path`` as PNG."""
    data = encode_png(image)
    with open(path, "wb") as handle:
        handle.write(data)
