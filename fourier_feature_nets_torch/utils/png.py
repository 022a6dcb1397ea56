"""Minimal PNG writer and reader (NumPy and the standard library).

The JAX package reads and writes images with OpenCV, which the card's
machine does not have. The port writes them with ``zlib`` and
``struct``: 8-bit RGB, no interlace, filter type 0 (None) on every row.
It reads 8-bit grey, RGB and RGBA PNGs without interlace, with any of
the five row filters (OpenCV's writer picks one a row); any other
format raises ``ValueError`` naming it.
"""

import struct
import zlib

import numpy as np

__all__ = ["decode_png", "encode_png", "read_png", "write_png"]

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


# channels of the colour types the reader takes
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha",
                6: "RGBA"}


def _unfilter_row(kind: int, row: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One scanline with its filter undone (PNG spec, section 9)."""
    if kind == 0:
        return row
    if kind == 1:       # Sub: a running sum of each channel, mod 256
        return np.cumsum(row.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if kind == 2:       # Up
        return row + prior
    if kind not in (3, 4):
        raise ValueError(f"PNG row filter {kind} is not a PNG filter type")
    # Average and Paeth read the pixel to the left: one byte at a time
    out = row.astype(np.int64).tolist()
    up = prior.astype(np.int64).tolist()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 3:
            out[i] = (out[i] + (left + up[i]) // 2) & 0xFF
            continue
        corner = up[i - bpp] if i >= bpp else 0
        estimate = left + up[i] - corner
        to_left = abs(estimate - left)
        to_up = abs(estimate - up[i])
        to_corner = abs(estimate - corner)
        if to_left <= to_up and to_left <= to_corner:
            predictor = left
        elif to_up <= to_corner:
            predictor = up[i]
        else:
            predictor = corner
        out[i] = (out[i] + predictor) & 0xFF
    return np.asarray(out, np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of a PNG file's bytes: (H, W, C) uint8, C = 1 (grey),
    3 (RGB) or 4 (RGBA), channels in the file's (RGB) order."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (no PNG signature)")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"PNG colour type {color} "
                         f"({_COLOR_NAMES.get(color, 'unknown')}) is not "
                         "read: 8-bit grey, RGB and RGBA only")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not read: 8-bit grey, "
                         "RGB and RGBA only")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not read")
    bpp = _CHANNELS[color]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, not "
                         f"{height * (stride + 1)}")
    rows = raw.reshape(height, stride + 1)
    pixels = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        prior = pixels[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:],
                                          prior, bpp)
    return pixels.reshape(height, width, bpp)


def read_png(path: str) -> np.ndarray:
    """:func:`decode_png` of the file at ``path``."""
    with open(path, "rb") as handle:
        return decode_png(handle.read())
