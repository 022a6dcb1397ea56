"""The port's NumPy JPEG encoder (``utils/jpeg.py``) against OpenCV's:
``cv2.imdecode`` reads its files, whose PSNR against the source is within
0.5 dB of ``cv2.imencode`` at quality 95 (OpenCV's default) on a
rendered frame, a smooth image and a noisy one; its quantization and
Huffman tables are OpenCV's, byte for byte; any size encodes."""

import cv2
import numpy as np
import pytest

from fourier_feature_nets_torch.cameras import Resolution
from fourier_feature_nets_torch.models import NeRF
from fourier_feature_nets_torch.render import Raycaster, RaySampler
from fourier_feature_nets_torch.utils import orbit
from fourier_feature_nets_torch.utils.jpeg import ZIGZAG, encode_jpeg

PSNR_GAP_DB = 0.5


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _decode(data: bytes) -> np.ndarray:
    image = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert image is not None
    return image[..., ::-1]


def _cv2_jpeg(image: np.ndarray) -> bytes:
    ok, data = cv2.imencode(".jpg", np.ascontiguousarray(image[..., ::-1]))
    assert ok
    return data.tobytes()


def _segments(data: bytes) -> dict:
    """{marker: [payload, ...]} of the header segments up to SOS."""
    assert data[:2] == b"\xff\xd8"
    out, pos = {}, 2
    while True:
        marker = int.from_bytes(data[pos:pos + 2], "big")
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        out.setdefault(marker, []).append(data[pos + 4:pos + 2 + length])
        pos += 2 + length
        if marker == 0xFFDA:
            return out


def _rendered_frame() -> np.ndarray:
    import torch
    model = NeRF(3, 64, 6.0, 6, 2.0, 3, [1], True,
                 generator=torch.Generator().manual_seed(5))
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]), 2,
                    40.0, Resolution(96, 80), 3.0)
    sampler = RaySampler(np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32),
                         cameras, 16)
    return Raycaster(model).render_frame(sampler, 1)


def _smooth() -> np.ndarray:
    yy, xx = np.mgrid[0:240, 0:320]
    return np.stack([128 + 100 * np.sin(xx / 37.0),
                     128 + 90 * np.cos(yy / 23.0),
                     (xx + yy) / 560.0 * 255], -1).astype(np.uint8)


def _noisy() -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (120, 136, 3), dtype=np.uint8)


@pytest.mark.parametrize("source", ["rendered", "smooth", "noisy"])
def test_psnr_within_half_db_of_cv2(source):
    image = {"rendered": _rendered_frame, "smooth": _smooth,
             "noisy": _noisy}[source]()
    assert image.std() > 1.0
    ours = _decode(encode_jpeg(image))
    ref = _decode(_cv2_jpeg(image))
    assert ours.shape == image.shape
    assert abs(_psnr(ours, image) - _psnr(ref, image)) <= PSNR_GAP_DB


def test_markers_and_tables_are_cv2s():
    image = _smooth()
    data = encode_jpeg(image)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    ours, ref = _segments(data), _segments(_cv2_jpeg(image))
    assert ours[0xFFE0][0][:5] == b"JFIF\x00"
    # quality 95's quantization tables and the Annex K Huffman tables,
    # byte for byte as OpenCV writes them
    assert b"".join(ours[0xFFDB]) == b"".join(ref[0xFFDB])
    assert b"".join(ours[0xFFC4]) == b"".join(ref[0xFFC4])
    # baseline, 8 bits, 240 x 320, Y 2x2 (4:2:0), Cb and Cr 1x1
    assert ours[0xFFC0] == ref[0xFFC0]
    assert ours[0xFFC0][0] == (b"\x08\x00\xf0\x01\x40\x03"
                               b"\x01\x22\x00\x02\x11\x01\x03\x11\x01")
    assert ours[0xFFDA] == ref[0xFFDA]


def test_zigzag_is_the_jpeg_scan():
    assert list(ZIGZAG[:10]) == [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]
    assert sorted(ZIGZAG) == list(range(64)) and ZIGZAG[-1] == 63


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (17, 9), (33, 65),
                                   (100, 31)])
def test_odd_sizes(shape):
    rng = np.random.default_rng(sum(shape))
    image = np.clip(rng.normal(128, 40, (*shape, 3)), 0, 255).astype(
        np.uint8)
    ours = _decode(encode_jpeg(image))
    ref = _decode(_cv2_jpeg(image))
    assert ours.shape == (*shape, 3)
    assert _psnr(ours, image) >= _psnr(ref, image) - PSNR_GAP_DB


def test_byte_stuffing_and_flat_blocks():
    """A white image codes many 0xFF bytes, each followed by a stuffed
    0x00; a flat image codes only DC terms and EOBs."""
    for value in (255, 0, 128):
        image = np.full((48, 40, 3), value, np.uint8)
        out = _decode(encode_jpeg(image))
        assert np.abs(out.astype(int) - value).max() <= 1


def test_rejects_bad_input():
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((4, 4, 3), np.float32))
