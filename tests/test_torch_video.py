"""The port's Motion-JPEG MP4 writer (``utils/video.py``), its bilinear
resize and ``cli/near_orbit.py``, against OpenCV and the JAX package.

The CPU machine's OpenCV reads video through FFmpeg: ``cv2.VideoCapture``
reads every port MP4 back with its frame count, size and frame rate,
and each frame within JPEG tolerance of its source (PSNR >= 35 dB on
smooth images). The port's own reader and decoder read every sample of
the ``mdat`` too, within 35 dB of the source and within 1 of
``cv2.imdecode`` of the sample."""

import os
import struct

import cv2
import numpy as np
import pytest

from fourier_feature_nets_torch.cli import near_orbit as port_near_orbit
from fourier_feature_nets_torch.utils.image import resize_linear
from fourier_feature_nets_torch.utils.jpeg import decode_jpeg, encode_jpeg
from fourier_feature_nets_torch.utils.video import VideoWriter, read_mp4

MIN_PSNR_DB = 35.0


def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def read_capture(path):
    """(frames as RGB, frame count, (width, height), fps) through
    ``cv2.VideoCapture``."""
    capture = cv2.VideoCapture(str(path))
    assert capture.isOpened()
    meta = (int(capture.get(cv2.CAP_PROP_FRAME_COUNT)),
            (int(capture.get(cv2.CAP_PROP_FRAME_WIDTH)),
             int(capture.get(cv2.CAP_PROP_FRAME_HEIGHT))),
            capture.get(cv2.CAP_PROP_FPS))
    frames = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame[..., ::-1])
    capture.release()
    return frames, *meta


def assert_mp4_holds(path, frames, framerate, min_psnr=MIN_PSNR_DB):
    """Both readers read ``frames`` back from the MP4 at ``path``: each
    sample is the port's JPEG of its frame byte for byte, which the
    port's decoder reads within 1 of libjpeg (``cv2.imdecode``); FFmpeg's
    and the port's decodes are within ``min_psnr`` of the frame (None,
    for frames whose detail 4:2:0 chroma cannot keep at 35 dB: FFmpeg's
    decode within 20 dB of libjpeg's, as FFmpeg upsamples the chroma by
    repeating it where libjpeg interpolates, which on a saturated
    one-pixel checker moves whole levels)."""
    height, width = frames[0].shape[:2]
    decoded, count, size, fps = read_capture(path)
    assert (count, size, len(decoded)) == (len(frames), (width, height),
                                           len(frames))
    assert fps == pytest.approx(framerate, rel=1e-6)
    rate, (w, h), samples = read_mp4(str(path))
    assert rate == pytest.approx(framerate, rel=1e-9)
    assert (w, h, len(samples)) == (width, height, len(frames))
    for ours, sample, source in zip(decoded, samples, frames):
        assert sample == encode_jpeg(source)
        # the port's decoder reads each sample within 1 of libjpeg's
        # (cv2.imdecode; FFmpeg's MJPEG decoder rounds otherwise)
        mine = decode_jpeg(sample)
        ref = cv2.imdecode(np.frombuffer(sample, np.uint8),
                           cv2.IMREAD_COLOR)[..., ::-1]
        assert np.abs(mine.astype(int) - ref.astype(int)).max() <= 1
        if min_psnr is None:
            assert psnr(ours, ref) >= 20.0
        else:
            assert psnr(ours, source) >= min_psnr
            assert psnr(mine, source) >= min_psnr


def smooth_frames(count, height, width, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    frames = []
    for _ in range(count):
        a, b, c = rng.uniform(20, 60, 3)
        frames.append(np.stack([128 + 100 * np.sin(xx / a),
                                128 + 90 * np.cos(yy / b),
                                128 + 80 * np.sin((xx + yy) / c)],
                               -1).astype(np.uint8))
    return frames


@pytest.mark.parametrize("framerate", [10, 10.0, 5, 29.97, 20])
@pytest.mark.parametrize("size", [(48, 32), (37, 21)], ids=["even", "odd"])
def test_writer_round_trips_through_cv2(tmp_path, framerate, size):
    width, height = size
    frames = smooth_frames(4, height, width)
    path = tmp_path / "video.mp4"
    with VideoWriter(str(path), framerate, size) as writer:
        for frame in frames:
            writer.write(frame)
    assert_mp4_holds(path, frames, framerate)


def _boxes(data, start, end):
    out = []
    while start < end:
        size, kind = struct.unpack_from(">I4s", data, start)
        out.append((kind, start, start + size))
        start += size
    return out


def test_layout_is_ffmpegs_mjpeg_in_mp4(tmp_path):
    """ftyp, mdat, moov; one mp4v sample entry with an esds of object
    type 0x6C (JPEG); one stts entry (every frame the same duration, 10
    fps as 10240 / 1024); one chunk whose offset is the mdat's data;
    no stss (every sample a sync sample)."""
    path = tmp_path / "v.mp4"
    writer = VideoWriter(str(path), 10, (16, 8))
    for frame in smooth_frames(3, 8, 16):
        writer.write(frame)
    writer.release()
    data = path.read_bytes()
    top = _boxes(data, 0, len(data))
    assert [k for k, _, _ in top] == [b"ftyp", b"mdat", b"moov"]
    assert data.index(b"esds") < data.index(b"stts")
    esds = data.index(b"esds")
    assert data[esds:esds + 40].find(bytes([0x04, 0x80, 0x80, 0x80, 0x0D,
                                            0x6C, 0x11])) > 0
    assert b"mp4v" in data and b"stss" not in data
    stts = data.index(b"stts") + 4
    assert struct.unpack_from(">IIII", data, stts) == (0, 1, 3, 1024)
    mdhd = data.index(b"mdhd") + 4
    assert struct.unpack_from(">I", data, mdhd + 12)[0] == 10240
    stco = data.index(b"stco") + 4
    assert struct.unpack_from(">II", data, stco + 4) == (
        1, top[1][1] + 8)


def test_writer_rejects_bad_frames_and_writes_no_empty_video(tmp_path):
    path = tmp_path / "v.mp4"
    writer = VideoWriter(str(path), 5, (16, 8))
    with pytest.raises(ValueError, match=r"\(8, 16, 3\) uint8"):
        writer.write(np.zeros((16, 8, 3), np.uint8))
    with pytest.raises(ValueError):
        writer.write(np.zeros((8, 16, 3), np.float32))
    writer.release()
    assert not path.exists()
    with pytest.raises(ValueError, match="after release"):
        writer.write(np.zeros((8, 16, 3), np.uint8))
    with pytest.raises(ValueError):
        VideoWriter(str(path), 0, (16, 8))


@pytest.mark.parametrize("src, dst", [((24, 24), (16, 16)),
                                      ((24, 24), (64, 64)),
                                      ((37, 53), (20, 31)),
                                      ((37, 53), (100, 90)),
                                      ((5, 9), (40, 33))])
@pytest.mark.parametrize("channels", [None, 3, 4])
def test_linear_resize_is_within_one_of_cv2(src, dst, channels):
    rng = np.random.default_rng(7)
    shape = src if channels is None else src + (channels,)
    image = rng.integers(0, 256, shape, dtype=np.uint8)
    ours = resize_linear(image, dst[1], dst[0])
    ref = cv2.resize(image, (dst[1], dst[0]))
    assert ours.shape == ref.shape
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.95


@pytest.fixture(scope="module")
def portrait_npz(tmp_path_factory):
    """A scene NPZ whose RGBA images are portrait (20 wide, 28 high):
    the centre crop on the long axis and the alpha premultiplication
    both act."""
    from fourier_feature_nets_tpu.datasets.synthetic import (
        generate_synthetic_dataset,
    )
    root = tmp_path_factory.mktemp("near")
    scene = np.load(generate_synthetic_dataset(
        str(root / "scene.npz"), resolution=28, split_counts=(6, 1, 1),
        volume_side=16, num_samples=64))
    images = scene["images"][:, :, 4:24].copy()
    images[..., 3] = np.linspace(60, 255, 20).astype(np.uint8)[None, None]
    path = str(root / "portrait.npz")
    np.savez(path, images=images, extrinsics=scene["extrinsics"],
             split_counts=scene["split_counts"])
    return path


def test_near_orbit_matches_jax(portrait_npz, tmp_path):
    """The same frames chosen, cropped, premultiplied and resized: each
    port frame within JPEG tolerance of the JAX CLI's frame before its
    MPEG-4 encode (``cv2.resize`` of the same crop), and both MP4s read
    back by ``cv2.VideoCapture`` with the same count, size and rate."""
    from fourier_feature_nets_tpu.cli import near_orbit as jax_near_orbit
    argv = ["--num-frames", "6", "--resolution", "32", "--framerate", "8"]
    ours, ref = tmp_path / "port.mp4", tmp_path / "jax.mp4"
    assert port_near_orbit.main([portrait_npz, str(ours), *argv]) == 0
    jax_near_orbit.main([portrait_npz, str(ref), *argv])
    port_frames, *port_meta = read_capture(ours)
    jax_frames, *jax_meta = read_capture(ref)
    # 20 x 28 scaled to a height of 32, then its square: 22 x 22
    side = port_near_orbit.Resolution(20, 28).scale_to_height(32).square()
    assert (side.width, side.height) == (22, 22)
    assert port_meta == jax_meta == [6, (22, 22), 8.0]

    # the JAX CLI's frames before its encode
    from fourier_feature_nets_tpu.cameras import Resolution
    from fourier_feature_nets_tpu.utils.camera_paths import orbit
    data = np.load(portrait_npz)
    cameras = orbit(np.array([0, 1, 0], np.float32),
                    np.array([0, 0, -1], np.float32), 6, 40,
                    Resolution(22, 22), 3.0)
    positions = np.stack([c.position[0] for c in cameras])
    train = data["extrinsics"][:6, :3, 3]
    index = np.square(positions[:, None] - train[None]).sum(-1).argmin(-1)
    expected, frames = [], []
    for i in index:
        image = data["images"][i, 4:24] / 255
        image = (image[..., :3] * image[..., 3:] * 255).astype(np.uint8)
        expected.append(cv2.resize(image, (22, 22)))
        frames.append(port_near_orbit.nearest_frame(data["images"][i], side))
        assert np.abs(frames[-1].astype(int)
                      - expected[-1].astype(int)).max() <= 1
    assert_mp4_holds(ours, frames, 8.0)
    for frame, source, theirs in zip(port_frames, expected, jax_frames):
        assert psnr(frame, source) >= psnr(theirs, source) - 1.0


def test_near_orbit_frame_rules():
    """Landscape crops columns, portrait rows; RGB passes unscaled."""
    landscape = np.zeros((10, 16, 3), np.uint8)
    landscape[:, 3:13] = 200
    frame = port_near_orbit.nearest_frame(
        landscape, port_near_orbit.Resolution(10, 10))
    assert (frame == 200).all()
    rgba = np.full((8, 8, 4), 255, np.uint8)
    rgba[..., 3] = 128
    frame = port_near_orbit.nearest_frame(rgba,
                                          port_near_orbit.Resolution(8, 8))
    assert (frame == int(255 * (128 / 255))).all()
    assert os.path.basename(port_near_orbit.__file__) == "near_orbit.py"
