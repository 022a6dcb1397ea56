"""The port's render server against the JAX package's (mirrors
tests/test_render_server.py) on a small NeRF, through real sockets: the
endpoints, the encodings, the MJPEG stream, the latency stats, the
dispatcher's FIFO across clients, and ``cli/serve.py`` as a process.

Tolerances: a raw frame equals the port's direct render bit for bit, a
PNG decodes to it bit for bit, and raw frames are within +-1 of the JAX
server's, as every frame test of the port.
"""

import json
import os
import re
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import zlib

import cv2
import jax
import numpy as np
import pytest

from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_torch.render import RaySampler as TorchRaySampler
from fourier_feature_nets_torch.render.server import RenderServer, serve
from fourier_feature_nets_torch.utils import look_at_extrinsics
from fourier_feature_nets_tpu.cameras import Resolution
from fourier_feature_nets_tpu.models import NeRF, save_model
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.render import Raycaster, RaySampler
from fourier_feature_nets_tpu.render.server import (
    RenderServer as JaxRenderServer,
)
from fourier_feature_nets_tpu.render.server import serve as jax_serve
from fourier_feature_nets_tpu.utils.camera_paths import orbit

RES = 20
SAMPLES = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(num_layers=2, num_channels=32, max_log_scale_pos=4.0,
              num_freq_pos=5, max_log_scale_view=2.0, num_freq_view=3,
              skips=[1], include_inputs=True)
BOUNDS = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _start(http):
    threading.Thread(target=http.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{http.server_address[1]}"


@pytest.fixture(scope="module")
def nerf():
    model = NeRF(**CONFIG)
    params = model.init(jax.random.PRNGKey(4))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    return model, params, params_from_jax(TorchNeRF(**CONFIG), flat)


@pytest.fixture(scope="module")
def cameras():
    return orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]), 3,
                 40.0, Resolution(RES, RES), 3.0)


@pytest.fixture(scope="module")
def server_url(nerf, cameras):
    sampler = TorchRaySampler(BOUNDS, cameras, SAMPLES)
    render_server = RenderServer(TorchRaycaster(nerf[2]), sampler,
                                 chunk_size=128)
    render_server.warmup()
    http = serve(render_server, "127.0.0.1", _free_port())
    yield _start(http), render_server
    http.shutdown()
    http.server_close()
    render_server.close()


@pytest.fixture(scope="module")
def jax_url(nerf, cameras):
    model, params, _ = nerf
    render_server = JaxRenderServer(Raycaster(model), params,
                                    RaySampler(BOUNDS, cameras, SAMPLES),
                                    chunk_size=128)
    http = jax_serve(render_server, "127.0.0.1", _free_port())
    yield _start(http)
    http.shutdown()
    http.server_close()
    render_server.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as response:
        return response.read(), response.headers


def _raw(body):
    return np.frombuffer(body, np.uint8).reshape(RES, RES, 3)


def _post_pose(url, payload):
    request = urllib.request.Request(url + "/pose",
                                     data=json.dumps(payload).encode(),
                                     method="POST")
    with urllib.request.urlopen(request, timeout=120) as response:
        return response.read(), response.headers


def test_info(server_url):
    url, _ = server_url
    info = json.loads(_get(url + "/info")[0])
    assert info["num_cameras"] == 3
    assert info["height"] == RES and info["width"] == RES
    assert info["model_type"] == "nerf"
    assert info["fused"] is False and info["culling"] is False
    assert info["pose_endpoint"] is True


def test_frame_raw_matches_direct_render(server_url):
    url, render_server = server_url
    body, headers = _get(url + "/frame?camera=1&format=raw")
    assert headers["Content-Type"] == "application/octet-stream"
    direct = render_server.raycaster.render_frame(render_server.sampler, 1,
                                                  chunk_size=128)
    np.testing.assert_array_equal(_raw(body), direct)
    assert direct.any()


@pytest.mark.parametrize("camera", [0, 1, 2])
def test_frame_raw_within_one_of_jax_server(server_url, jax_url, camera):
    url, _ = server_url
    ours = _raw(_get(f"{url}/frame?camera={camera}&format=raw")[0])
    ref = _raw(_get(f"{jax_url}/frame?camera={camera}&format=raw")[0])
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def _png_pixels(body):
    """The RGB pixels of an 8-bit, filter-0 PNG, read with zlib."""
    pos, idat = 8, b""
    while pos < len(body):
        length = int.from_bytes(body[pos:pos + 4], "big")
        if body[pos + 4:pos + 8] == b"IDAT":
            idat += body[pos + 8:pos + 8 + length]
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(RES, -1)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(RES, RES, 3)


def test_frame_png(server_url):
    url, _ = server_url
    body, headers = _get(url + "/frame?camera=0")
    assert headers["Content-Type"] == "image/png"
    raw = _raw(_get(url + "/frame?camera=0&format=raw")[0])
    np.testing.assert_array_equal(_png_pixels(body), raw)
    decoded = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(decoded[..., ::-1], raw)


def test_frame_jpg(server_url):
    url, _ = server_url
    body, headers = _get(url + "/frame?camera=2&format=jpg")
    assert headers["Content-Type"] == "image/jpeg"
    assert body[:2] == b"\xff\xd8" and body[-2:] == b"\xff\xd9"
    decoded = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    assert decoded.shape == (RES, RES, 3)


def test_stream_and_stats(server_url):
    url, _ = server_url
    body = urllib.request.urlopen(url + "/stream.mjpeg?count=4",
                                  timeout=120).read()
    assert body.count(b"--ffnframe") == 4
    assert body.count(b"Content-Type: image/jpeg") == 4
    for part in body.split(b"--ffnframe")[1:]:
        jpeg = part.split(b"\r\n\r\n", 1)[1][:-2]
        assert cv2.imdecode(np.frombuffer(jpeg, np.uint8),
                            cv2.IMREAD_COLOR).shape == (RES, RES, 3)
    stats = json.loads(_get(url + "/stats")[0])
    assert stats["frames"] >= 4
    assert stats["fps"] > 0
    assert stats["p99_ms"] >= stats["p50_ms"]
    assert sum(stats["histogram_ms"].values()) == stats["frames"]


def test_pose_endpoint_matches_rig_frame(server_url):
    """POST /pose with a rig camera's calibration == GET /frame."""
    url, render_server = server_url
    camera = render_server.sampler.cameras[2]
    body, _ = _post_pose(url, {
        "extrinsics": np.asarray(camera.extrinsics).tolist(),
        "intrinsics": np.asarray(camera.intrinsics).tolist(),
        "format": "raw"})
    direct, _ = _get(url + "/frame?camera=2&format=raw")
    np.testing.assert_array_equal(_raw(body), _raw(direct))


def test_pose_endpoint_bad_body_500(server_url):
    url, _ = server_url
    request = urllib.request.Request(url + "/pose",
                                     data=b"{\"extrinsics\": 3}",
                                     method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(request, timeout=120)
    assert err.value.code == 500


def test_close_rejects_new_requests(server_url):
    """close() drains the dispatcher; later submits fail at once."""
    _, render_server = server_url
    extra = RenderServer(render_server.raycaster, render_server.sampler,
                         chunk_size=128)
    assert extra.frame(0).shape == (RES, RES, 3)
    extra.close()
    extra.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        extra.frame(0)


def test_unknown_path_404(server_url):
    url, _ = server_url
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(url + "/nope")
    assert err.value.code == 404
    request = urllib.request.Request(url + "/frame", data=b"{}",
                                     method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(request, timeout=120)
    assert err.value.code == 404


def test_viewer_page(server_url):
    url, _ = server_url
    body, headers = _get(url + "/")
    assert headers["Content-Type"].startswith("text/html")
    page = body.decode()
    assert "/pose" in page and "/stream.mjpeg" in page


def test_viewer_pose_math_matches_camera_paths():
    """The viewer's JavaScript pose (replicated in NumPy) equals the
    port's ``look_at_extrinsics`` at the same orbit position."""
    for az, alt, dist in ((0.6, 0.45, 4.0), (-2.2, -0.8, 2.5),
                          (3.1, 0.0, 6.0)):
        p = np.array([dist * np.sin(az) * np.cos(alt), dist * np.sin(alt),
                      dist * np.cos(az) * np.cos(alt)])
        f = p / np.linalg.norm(p)
        up = np.array([0.0, 1.0, 0.0])
        r = np.cross(up, f)
        r = r / np.linalg.norm(r)
        tu = np.cross(f, r)
        js = np.eye(4)
        js[:3, 0], js[:3, 1], js[:3, 2], js[:3, 3] = r, -tu, -f, p
        np.testing.assert_allclose(js, look_at_extrinsics(p, up),
                                   atol=1e-12)


def test_viewer_pose_renders_within_one_of_jax(server_url, jax_url):
    """A pose the viewer would send renders within +-1 of the JAX
    server's (the rig's intrinsics by default)."""
    url, _ = server_url
    p = np.array([2.0, 1.0, 2.5])
    payload = {"extrinsics": look_at_extrinsics(
        p, np.array([0.0, 1.0, 0.0])).tolist(), "format": "raw"}
    ours = _raw(_post_pose(url, payload)[0])
    ref = _raw(_post_pose(jax_url, payload)[0])
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    assert ours.any()


def test_concurrent_clients(server_url):
    """Simultaneous clients all get their camera's frame (FIFO)."""
    url, render_server = server_url
    expected = {c: render_server.frame(c) for c in range(3)}
    results, errors = {}, []

    def fetch(i):
        camera = i % 3
        try:
            body, _ = _get(f"{url}/frame?camera={camera}&format=raw")
            results[i] = (camera, _raw(body))
        except Exception as error:  # noqa: BLE001 - collected
            errors.append(error)

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(12)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=300)
    assert not errors
    assert len(results) == 12
    for camera, image in results.values():
        np.testing.assert_array_equal(image, expected[camera])


def test_looping_stream_does_not_starve_frame_clients(server_url):
    """A ``loop=1`` stream submits one frame at a time, so a frame
    request issued while it runs completes."""
    url, _ = server_url
    stream = urllib.request.urlopen(url + "/stream.mjpeg?loop=1",
                                    timeout=120)
    try:
        stream.read(100)
        done = threading.Event()

        def fetch():
            _get(url + "/frame?camera=0&format=raw")
            done.set()

        threading.Thread(target=fetch, daemon=True).start()
        assert done.wait(timeout=120), \
            "frame request starved by looping stream"
    finally:
        stream.close()


def test_stats_concurrent_with_rendering(server_url):
    """stats() reads the latency deque while the resolver appends."""
    _, render_server = server_url
    errors = []
    done = threading.Event()

    def poll_stats():
        while not done.is_set():
            try:
                render_server.stats()
            except Exception as error:  # noqa: BLE001 - collected
                errors.append(error)
                return

    poller = threading.Thread(target=poll_stats, daemon=True)
    poller.start()
    try:
        for _ in range(3):
            for frame in render_server.frames(range(3)):
                assert frame is not None
    finally:
        done.set()
        poller.join(timeout=30)
    assert not errors, errors


def test_serve_cli_serves_a_frame(nerf, tmp_path):
    """``python -m fourier_feature_nets_torch.cli.serve`` on the CPU at
    ``--preset fast`` (a culled density-grid frame): it names its port,
    answers /info and a raw frame, and stops on SIGTERM."""
    model, params, _ = nerf
    checkpoint = str(tmp_path / "nerf.npz")
    save_model(model, params, checkpoint)
    env = dict(os.environ, PYTHONPATH=ROOT)
    process = subprocess.Popen(
        [sys.executable, "-m", "fourier_feature_nets_torch.cli.serve",
         checkpoint, "16", "--device", "cpu", "--port", "0",
         "--num-frames", "4", "--preset", "fast"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = ""
        while "serving" not in line:
            line = process.stdout.readline()
            assert line, process.stderr.read()
        url = re.search(r"(http://\S+)", line).group(1)
        info = json.loads(_get(url + "/info")[0])
        assert info["culling"] is True and info["num_cameras"] == 4
        body, _ = _get(url + "/frame?camera=3&format=raw")
        assert np.frombuffer(body, np.uint8).size == 16 * 16 * 3
    finally:
        process.terminate()
        assert process.wait(timeout=60) == 0


def test_serve_cli_data_parallel_serves(nerf, tmp_path):
    """``cli.serve --data-parallel`` on two gloo ranks started with
    torchrun's variables: rank 0 serves HTTP and broadcasts each frame,
    rank 1 follows and renders its slab; a rig frame and a pose frame
    equal the same frames rendered in one process within 1, and
    SIGTERM to rank 0 ends both ranks."""
    import torch

    from fourier_feature_nets_torch.cameras import Resolution as PortResolution
    from fourier_feature_nets_torch.cli import orbit_video as orbit_cli
    from fourier_feature_nets_torch.models import load_model as port_load
    from fourier_feature_nets_torch.render import Raycaster as PortCaster
    from fourier_feature_nets_torch.render.server import RenderServer
    from fourier_feature_nets_torch.utils import orbit as port_orbit

    model, params, _ = nerf
    checkpoint = str(tmp_path / "nerf.npz")
    save_model(model, params, checkpoint)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = [checkpoint, "16", "--device", "cpu", "--num-frames", "4",
            "--preset", "fast"]
    processes = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank))
        processes.append(subprocess.Popen(
            [sys.executable, "-m", "fourier_feature_nets_torch.cli.serve",
             *argv, "--port", "0", "--data-parallel"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        line = ""
        while "serving" not in line:
            line = processes[0].stdout.readline()
            assert line, processes[0].stderr.read()
        url = re.search(r"(http://\S+)", line).group(1)
        frame = np.frombuffer(_get(url + "/frame?camera=3&format=raw")[0],
                              np.uint8).reshape(16, 16, 3)
        cameras = port_orbit(orbit_cli.VECTORS["y+"], orbit_cli.VECTORS["z-"],
                             4, 40, PortResolution(16, 16), 4)
        pose = np.frombuffer(_post_pose(url, {
            "extrinsics": cameras[1].extrinsics.tolist(),
            "format": "raw"})[0], np.uint8).reshape(16, 16, 3)
    finally:
        processes[0].terminate()
        codes = [p.wait(timeout=120) for p in processes]
    assert codes == [0, 0], [p.stderr.read()[-2000:] for p in processes]
    assert "joined" in processes[1].stdout.read()

    # the same frames in one process, without the mesh
    args = orbit_cli._parse_args([*argv[:2], "unused", *argv[2:]])
    local = port_load(checkpoint)
    sampler = orbit_cli.build_render_sampler(
        args, local, cameras, np.diag([2.0, 2.0, 2.0, 1.0]).astype(
            np.float32))
    server = RenderServer(PortCaster(local, compute_dtype=torch.bfloat16),
                          sampler)
    try:
        for ours, ref in ((frame, server.frame(3)),
                          (pose, server.frame_pose(cameras[1].extrinsics))):
            assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
            assert ref.any()
    finally:
        server.close()
