"""A Motion-JPEG MP4 writer and reader with the standard library.

The JAX package writes its videos with ``cv2.VideoWriter`` and the
``mp4v`` fourcc (MPEG-4 Part 2 frames); the card's machine has no
OpenCV, so the port writes each frame as a baseline JPEG
(:func:`..utils.jpeg.encode_jpeg`, quality 95) into an MP4 (ISO BMFF)
file laid out as FFmpeg lays out MJPEG in MP4: ``ftyp``, ``mdat`` (the
JPEGs back to back), then ``moov`` with one video track whose ``mp4v``
sample entry carries an ``esds`` of objectTypeIndication 0x6C (JPEG).
Every sample is a sync sample (no ``stss``), the samples are one chunk
(one ``stco`` offset, 32 bits: a file past 4 GB raises), and every
frame has the same duration: the track's timescale is the frame rate's
exact fraction (``Fraction(framerate).limit_denominator(1001)``) times
1024, as FFmpeg's 10240 for 10 fps.

    writer = VideoWriter("orbit.mp4", 20, (width, height))
    writer.write(rgb_uint8)          # (height, width, 3)
    writer.release()
    framerate, (width, height), jpegs = read_mp4(path)
"""

import struct
from fractions import Fraction
from typing import List, Tuple

import numpy as np

from .jpeg import encode_jpeg

__all__ = ["VideoWriter", "read_mp4"]

_UNITY = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
_MOVIE_TIMESCALE = 1000


def _box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I4s", len(body) + 8, kind) + body


def _full_box(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags), *payload)


def _descriptor(tag: int, payload: bytes) -> bytes:
    """An MPEG-4 descriptor with FFmpeg's 4-byte length."""
    size = len(payload)
    return bytes([tag, 0x80 | (size >> 21) & 0x7F, 0x80 | (size >> 14) & 0x7F,
                  0x80 | (size >> 7) & 0x7F, size & 0x7F]) + payload


def _timing(framerate: float) -> Tuple[int, int]:
    """(timescale, sample delta) of a frame rate: its exact fraction
    where it has a small one, times 1024."""
    rate = Fraction(float(framerate)).limit_denominator(1001)
    if rate <= 0:
        raise ValueError(f"framerate must be positive, got {framerate}")
    return rate.numerator * 1024, rate.denominator * 1024


class VideoWriter:
    """``cv2.VideoWriter(path, fourcc, framerate, (width, height))`` for
    RGB uint8 frames, written as Motion-JPEG in MP4 whatever the path's
    suffix (the JAX package writes ``mp4v`` into any name)."""

    def __init__(self, path: str, framerate: float, size: Tuple[int, int],
                 quality: int = 95):
        self.width, self.height = (int(v) for v in size)
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"bad frame size {size}")
        self.timescale, self.delta = _timing(framerate)
        self.quality = quality
        self.path = path
        self.sizes: List[int] = []
        self._file = open(path, "wb")
        ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 512),
                    b"isom", b"iso2", b"mp41")
        self._file.write(ftyp)
        self._mdat_at = len(ftyp)
        self._file.write(struct.pack(">I4s", 8, b"mdat"))

    def write(self, frame: np.ndarray) -> None:
        """Appends one (height, width, 3) uint8 RGB frame."""
        if self._file is None:
            raise ValueError("write after release")
        frame = np.asarray(frame)
        if (frame.shape != (self.height, self.width, 3)
                or frame.dtype != np.uint8):
            raise ValueError(
                f"expected a ({self.height}, {self.width}, 3) uint8 frame, "
                f"got {frame.shape} {frame.dtype}")
        data = encode_jpeg(frame, self.quality)
        if self._mdat_at + 8 + sum(self.sizes) + len(data) >= 2 ** 32:
            raise ValueError("an MP4 past 4 GB needs 64-bit chunk offsets, "
                             "which this writer does not write")
        self._file.write(data)
        self.sizes.append(len(data))

    def release(self) -> None:
        """Sizes ``mdat``, appends ``moov`` and closes the file; a writer
        that got no frame removes its file, as a video without frames is
        no video."""
        if self._file is None:
            return
        handle, self._file = self._file, None
        if not self.sizes:
            import os
            handle.close()
            os.remove(self.path)
            return
        mdat_size = 8 + sum(self.sizes)
        handle.seek(self._mdat_at)
        handle.write(struct.pack(">I", mdat_size))
        handle.seek(0, 2)
        handle.write(self._moov(self._mdat_at + 8))
        handle.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()

    def _moov(self, data_offset: int) -> bytes:
        count = len(self.sizes)
        media_duration = count * self.delta
        duration = round(media_duration * _MOVIE_TIMESCALE / self.timescale)
        seconds = media_duration / self.timescale
        bitrate = int(sum(self.sizes) * 8 / seconds)
        mvhd = _full_box(b"mvhd", 0, 0, struct.pack(
            ">IIIIIH10x", 0, 0, _MOVIE_TIMESCALE, duration, 0x10000, 0x100),
            _UNITY, bytes(24), struct.pack(">I", 2))
        tkhd = _full_box(b"tkhd", 0, 3, struct.pack(
            ">IIIIIQHHHH", 0, 0, 1, 0, duration, 0, 0, 0, 0, 0),
            _UNITY, struct.pack(">II", self.width << 16, self.height << 16))
        mdhd = _full_box(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, self.timescale, media_duration, 0x55C4, 0))
        hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"),
                         b"VideoHandler\x00")
        vmhd = _full_box(b"vmhd", 0, 1, bytes(8))
        dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                       _full_box(b"url ", 0, 1)))
        decoder = _descriptor(4, struct.pack(
            ">BB3sII", 0x6C, 0x11, max(self.sizes).to_bytes(3, "big"),
            bitrate, bitrate))
        esds = _full_box(b"esds", 0, 0, _descriptor(
            3, struct.pack(">HB", 1, 0) + decoder + _descriptor(6, b"\x02")))
        entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                     struct.pack(">HHIIIH", self.width, self.height,
                                 0x480000, 0x480000, 0, 1),
                     bytes(32), struct.pack(">Hh", 0x18, -1), esds)
        stbl = _box(
            b"stbl",
            _full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry),
            _full_box(b"stts", 0, 0, struct.pack(">III", 1, count,
                                                 self.delta)),
            _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, count, 1)),
            _full_box(b"stsz", 0, 0, struct.pack(f">II{count}I", 0, count,
                                                 *self.sizes)),
            _full_box(b"stco", 0, 0, struct.pack(">II", 1, data_offset)))
        minf = _box(b"minf", vmhd, dinf, stbl)
        trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)


def _children(data: bytes, start: int, end: int) -> dict:
    """The boxes between ``start`` and ``end``: type -> (body start,
    body end), the first of each type."""
    boxes = {}
    while start + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, start)
        if size < 8:
            raise ValueError(f"malformed box {kind!r} at {start}")
        boxes.setdefault(kind, (start + 8, start + size))
        start += size
    return boxes


def read_mp4(path: str) -> Tuple[float, Tuple[int, int], List[bytes]]:
    """(frame rate, (width, height), the samples' bytes) of an MP4 with
    one video track in one chunk, as :class:`VideoWriter` writes it."""
    with open(path, "rb") as handle:
        data = handle.read()
    node = _children(data, 0, len(data))
    for kind in (b"moov", b"trak", b"mdia"):
        node = _children(data, *node[kind])
    timescale = struct.unpack_from(">I", data, node[b"mdhd"][0] + 12)[0]
    stbl = _children(data, *_children(data, *node[b"minf"])[b"stbl"])
    entry = stbl[b"stsd"][0] + 8
    width, height = struct.unpack_from(">HH", data, entry + 8 + 24)
    delta = struct.unpack_from(">I", data, stbl[b"stts"][0] + 12)[0]
    size, count = struct.unpack_from(">II", data, stbl[b"stsz"][0] + 4)
    sizes = ([size] * count if size else
             struct.unpack_from(f">{count}I", data, stbl[b"stsz"][0] + 12))
    chunks = struct.unpack_from(">I", data, stbl[b"stco"][0] + 4)[0]
    if chunks != 1:
        raise ValueError(f"expected the samples in one chunk, got {chunks}")
    offset = struct.unpack_from(">I", data, stbl[b"stco"][0] + 8)[0]
    ends = np.cumsum([0, *sizes]) + offset
    samples = [data[int(a):int(b)] for a, b in zip(ends[:-1], ends[1:])]
    return timescale / delta, (width, height), samples
