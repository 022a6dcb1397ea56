"""The port's NumPy JPEG encoder and decoder (``utils/jpeg.py``) against
OpenCV's.

The encoder: ``cv2.imdecode`` reads its files, whose PSNR against the
source is within 0.5 dB of ``cv2.imencode`` at quality 95 (OpenCV's
default) on a rendered frame, a smooth image and a noisy one; its
quantization and Huffman tables are OpenCV's, byte for byte; any size
encodes.

The decoder: within 1 of ``cv2.imread`` (BGR -> RGB) on every pixel of
the files ``cv2.imwrite`` writes at qualities 50, 75 and 95, in 4:4:4,
4:2:2 and 4:2:0, grey, at odd sizes, with a restart interval and under
each EXIF orientation; at least 99.9% of the pixels exact (on these
images it is bit for bit: 100%). The encoder's own files decode within
1 of ``cv2.imdecode``; ``PixelDataset`` reads a ``.jpg`` as the JAX
package's does."""

import struct

import cv2
import numpy as np
import pytest

from fourier_feature_nets_torch.cameras import Resolution
from fourier_feature_nets_torch.models import NeRF
from fourier_feature_nets_torch.render import Raycaster, RaySampler
from fourier_feature_nets_torch.utils import orbit
from fourier_feature_nets_torch.utils.jpeg import (
    ZIGZAG,
    decode_jpeg,
    encode_jpeg,
)

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


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111}


def _photo(shape, seed=0) -> np.ndarray:
    """Smooth colour gradients under noise, (H, W, 3) uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    base = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 11.0)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(
        np.uint8)


def _imwrite(path, image, *params) -> str:
    """``cv2.imwrite`` of an RGB (or grey) image; returns the path."""
    if image.ndim == 3:
        image = image[..., ::-1]
    assert cv2.imwrite(str(path), np.ascontiguousarray(image), list(params))
    return str(path)


def read_jpeg(path) -> np.ndarray:
    with open(path, "rb") as handle:
        return decode_jpeg(handle.read())


def _assert_reads_as_cv2(path):
    ours = read_jpeg(path)
    ref = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999
    return ours


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("shape", [(37, 53), (64, 48), (9, 8)])
def test_decoder_reads_as_cv2_imread(tmp_path, quality, sampling, shape):
    path = _imwrite(tmp_path / "a.jpg", _photo(shape, quality),
                    cv2.IMWRITE_JPEG_QUALITY, quality,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling])
    _assert_reads_as_cv2(path)


def test_decoder_reads_grey_and_restart_intervals(tmp_path):
    grey = cv2.cvtColor(_photo((41, 30)), cv2.COLOR_RGB2GRAY)
    out = _assert_reads_as_cv2(_imwrite(tmp_path / "g.jpg", grey))
    assert (out[..., 0] == out[..., 1]).all() and (
        out[..., 0] == out[..., 2]).all()
    for interval in (1, 3):
        path = _imwrite(tmp_path / f"r{interval}.jpg", _photo((45, 70)),
                        cv2.IMWRITE_JPEG_RST_INTERVAL, interval)
        assert b"\xff\xdd" in open(path, "rb").read()
        _assert_reads_as_cv2(path)


def _exif(orientation: int, order: str) -> bytes:
    """An APP1 segment of one IFD holding the orientation tag."""
    mark = b"II" if order == "<" else b"MM"
    tiff = (mark + struct.pack(order + "HI", 42, 8)
            + struct.pack(order + "H", 1)
            + struct.pack(order + "HHIH2x", 0x0112, 3, 1, orientation)
            + struct.pack(order + "I", 0))
    payload = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


@pytest.mark.parametrize("orientation", range(1, 9))
def test_decoder_applies_exif_orientation(tmp_path, orientation):
    path = _imwrite(tmp_path / "o.jpg", _photo((24, 40)))
    data = open(path, "rb").read()
    order = "<" if orientation % 2 else ">"
    spliced = tmp_path / "oriented.jpg"
    spliced.write_bytes(data[:2] + _exif(orientation, order) + data[2:])
    out = _assert_reads_as_cv2(str(spliced))
    assert out.shape == ((40, 24, 3) if orientation >= 5 else (24, 40, 3))


@pytest.mark.parametrize("source", ["rendered", "smooth", "noisy"])
def test_decoder_reads_the_encoders_files(source):
    image = {"rendered": _rendered_frame, "smooth": _smooth,
             "noisy": _noisy}[source]()
    data = encode_jpeg(image)
    diff = np.abs(decode_jpeg(data).astype(int) - _decode(data).astype(int))
    assert diff.max() <= 1


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` past SOF0's marker set to
    ``value`` (offset 1: the marker's own kind)."""
    at = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[at + offset] = value
    return bytes(out)


@pytest.mark.parametrize("offset, value, message", [
    (1, 0xC2, "progressive"), (1, 0xC9, "arithmetic"), (1, 0xC3, "lossless"),
    (4, 12, "12-bit"), (9, 4, "CMYK")])
def test_decoder_names_what_it_does_not_read(offset, value, message):
    data = _cv2_jpeg(_photo((16, 16)))
    with pytest.raises(ValueError, match=message):
        decode_jpeg(_patched(data, 0xC0, offset, value))


def test_decoder_refuses_cv2_progressive_files(tmp_path):
    path = _imwrite(tmp_path / "p.jpg", _photo((16, 24)),
                    cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    with pytest.raises(ValueError, match="progressive"):
        read_jpeg(path)
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG....")


@pytest.mark.parametrize("color_space", ["RGB", "YCrCb"])
def test_pixel_dataset_reads_jpeg_as_jax(tmp_path, color_space):
    """``PixelDataset.load`` of a ``.jpg`` (crop, INTER_AREA, colour
    space) against the JAX package's on the same file, at the PNG
    path's tolerances (tests/test_torch_regression_clis.py)."""
    import torch

    from fourier_feature_nets_torch.datasets import PixelDataset
    from fourier_feature_nets_tpu.datasets.pixel_dataset import (
        PixelDataset as JaxPixelDataset,
    )
    path = _imwrite(tmp_path / "photo.jpg", _photo((44, 36), 4))
    ref = JaxPixelDataset.create(path, color_space, 32)
    ours = PixelDataset.create(path, color_space, 32)
    for name in ("train_uv", "val_uv"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for name in ("train_color", "val_color"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1.01 / 255, rtol=0)
    assert int(np.abs(ours.image.astype(int)
                      - ref.image.astype(int)).max()) <= 2
    colors = torch.rand(32, 32, 3, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(ours.to_image(colors),
                                  ref.to_image(colors.numpy()))


def test_pixel_dataset_names_an_unread_format(tmp_path):
    from fourier_feature_nets_torch.datasets import PixelDataset
    path = tmp_path / "image.gif"
    path.write_bytes(b"GIF89a" + bytes(32))
    with pytest.raises(ValueError, match="GIF"):
        PixelDataset.create(str(path), "RGB", 8)
