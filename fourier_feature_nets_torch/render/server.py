"""Persistent render server.

Port of ``fourier_feature_nets_tpu/render/server.py``: a model stays
resident on the device and frames are served over HTTP (standard
library ``http.server``, a thread per request). One dispatcher thread
owns the device and drains a FIFO queue of frame requests; a resolver
thread copies each finished frame to the host in dispatch order, so a
frame's copy and encode overlap the next frame's work.

Endpoints:

- ``GET /``: the browser viewer (drag to orbit, wheel to zoom; it
  sends ``POST /pose`` requests, at most 2 in flight, and switches to
  the MJPEG orbit stream with one click);
- ``GET /info``: the rig and model, as JSON;
- ``GET /frame?camera=i&format=png``: one rig frame (``png``, ``jpg``
  or ``raw`` uint8 bytes);
- ``POST /pose``: one frame of any camera pose, from a JSON body
  ``{"extrinsics": 4x4, "intrinsics"?: 3x3, "format"?: "png"}``
  (intrinsics default to the rig's);
- ``GET /stream.mjpeg?start=0&count=N&loop=1``: a multipart MJPEG
  stream of rig frames, two requests in flight;
- ``GET /stats``: the latency histogram and percentiles of the last
  4096 frames, as JSON.

An unknown path answers 404, a failed request 500 with the error's
text. PNGs come from the port's standard-library writer
(``utils/png.py``) and JPEGs from its NumPy encoder (``utils/jpeg.py``,
OpenCV's quality 95 and 4:2:0): the card's machine has no OpenCV.

The dispatcher calls ``Raycaster.render_frame_async`` or
``render_frame_pose_async``, which return the frame as a device uint8
tensor. A culled frame reads its hit count on the host (ROADMAP.md,
queue 3), so the dispatcher waits for each culled frame's probe before
it queues the frame's model chunks: frames overlap in their copy and
encode, not in their probe.

Under a data-parallel mesh (``serve --data-parallel``) every frame is a
collective of all ranks: rank 0 runs the HTTP server and the
dispatcher, which broadcasts each frame request (a rig camera, or a
pose's extrinsics and intrinsics) before it renders its slab; the
other ranks loop in :func:`follow`, render their slabs of each
broadcast frame, and leave when :meth:`RenderServer.close` broadcasts
the end.
"""

import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..utils.jpeg import encode_jpeg
from ..utils.png import encode_png

__all__ = ["RenderServer", "follow", "serve"]

_STOP = ("stop", None)


class _Request:
    """One frame request in flight through the dispatcher."""

    __slots__ = ("dispatch", "event", "result", "error")

    def __init__(self, dispatch):
        self.dispatch = dispatch
        self.event = threading.Event()
        self.result = None
        self.error = None


class RenderServer:
    """Model-resident frame renderer with latency accounting.

    A single dispatcher thread owns the device and drains a FIFO request
    queue across clients; a resolver thread copies the frames to the
    host in dispatch order. Streams submit one frame at a time (two in
    flight), so a looping MJPEG stream shares the device with concurrent
    ``/frame`` and ``/pose`` clients."""

    def __init__(self, raycaster, sampler, chunk_size: int = 16384,
                 cull_empty: bool = True, early_term: float = 0.0,
                 early_split: int = 0, mesh=None):
        """Constructor.

        Args:
            raycaster: the :class:`~.raycaster.Raycaster` of the model.
            sampler: the rig's sampler, on the model's device.
            chunk_size / cull_empty / early_term / early_split: the
                frame's options (:meth:`Raycaster.render_frame_async`).
            mesh: a data-parallel mesh, whose other ranks run
                :func:`follow` with the same model, sampler and
                options; this is rank 0.
        """
        self.raycaster = raycaster
        self.sampler = sampler
        self.chunk_size = chunk_size
        self.cull_empty = cull_empty
        self.early_term = early_term
        self.early_split = early_split
        self.mesh = mesh
        self.num_cameras = sampler.num_cameras
        self.resolution = (sampler.image_height, sampler.image_width)
        self._latencies = deque(maxlen=4096)
        # guards stats()' read against the resolver's appends
        self._latency_lock = threading.Lock()
        self._queue = queue.SimpleQueue()
        self._fetch_queue = queue.SimpleQueue()
        self._submit_lock = threading.Lock()
        self._stopped = False
        self._last_resolve = 0.0
        self._dispatcher = threading.Thread(target=self._run_dispatch,
                                            daemon=True)
        self._resolver = threading.Thread(target=self._run_resolve,
                                          daemon=True)
        self._dispatcher.start()
        self._resolver.start()

    def _run_dispatch(self):
        if self.mesh is not None and self.mesh.device.type == "cuda":
            import torch
            torch.cuda.set_device(self.mesh.device)
        while True:
            request = self._queue.get()
            if request.dispatch is None:  # close()
                if self.mesh is not None:
                    self.mesh.broadcast_object(_STOP)
                self._fetch_queue.put((request, None, 0.0))
                return
            start = time.perf_counter()
            try:
                frame = request.dispatch()
            except Exception as error:  # surfaced to the client
                request.error = error
                request.event.set()
                continue
            self._fetch_queue.put((request, frame, start))

    def _run_resolve(self):
        while True:
            request, frame, start = self._fetch_queue.get()
            if request.dispatch is None:  # close()'s sentinel
                request.event.set()
                return
            try:
                request.result = frame.cpu().numpy()
            except Exception as error:
                request.error = error
            now = time.perf_counter()
            # in steady state the time between resolves (throughput);
            # for an isolated request, dispatch to host copy
            with self._latency_lock:
                self._latencies.append(now - max(start, self._last_resolve))
            self._last_resolve = now
            request.event.set()

    def _submit(self, dispatch) -> _Request:
        # under the lock, so no request lands behind close()'s sentinel
        with self._submit_lock:
            if self._stopped:
                raise RuntimeError("render server is closed")
            request = _Request(dispatch)
            self._queue.put(request)
        return request

    @staticmethod
    def _wait(request) -> np.ndarray:
        request.event.wait()
        if request.error is not None:
            raise request.error
        return request.result

    def close(self):
        """Stops the dispatcher and resolver threads, after any pending
        frame; later requests raise ``RuntimeError``."""
        with self._submit_lock:
            if self._stopped:
                return
            self._stopped = True
            sentinel = _Request(None)
            self._queue.put(sentinel)
        sentinel.event.wait()

    def _collective(self, request):
        """The dispatcher's render: the request is broadcast to the
        other ranks of a mesh first."""
        if self.mesh is not None:
            self.mesh.broadcast_object(request)
        return _render_request(self, request)

    def _dispatch(self, camera: int):
        return self._collective(("camera", camera))

    def warmup(self) -> float:
        """Renders frame 0 (the weight pack and the first launches) and
        returns its seconds; its latency is dropped from the stats."""
        start = time.perf_counter()
        self.frame(0)
        with self._latency_lock:
            self._latencies.clear()
        return time.perf_counter() - start

    def frame(self, camera: int) -> np.ndarray:
        """Renders one rig frame; returns it as an (H, W, 3) uint8
        host array."""
        return self._wait(self._submit(lambda: self._dispatch(camera)))

    def frame_pose(self, extrinsics, intrinsics=None) -> np.ndarray:
        """Renders one frame of any camera pose: ``extrinsics`` is the
        4x4 camera-to-world matrix, ``intrinsics`` default to the rig's
        first camera's (``Raycaster.render_frame_pose_async``)."""
        if intrinsics is None:
            intrinsics = self.sampler.cameras[0].intrinsics
        camera = _pose_camera(self.sampler, extrinsics, intrinsics)
        request = ("pose", (camera.extrinsics, camera.intrinsics))
        return self._wait(self._submit(lambda: self._collective(request)))

    def frames(self, cameras):
        """Yields the frames of ``cameras`` with two requests in flight,
        so other clients' requests interleave (FIFO)."""
        in_flight = deque()
        for camera in cameras:
            in_flight.append(
                self._submit(lambda c=camera: self._dispatch(c)))
            if len(in_flight) >= 2:
                yield self._wait(in_flight.popleft())
        while in_flight:
            yield self._wait(in_flight.popleft())

    def stats(self) -> dict:
        """The latency histogram (10 ms bins), percentiles and FPS."""
        with self._latency_lock:
            lat = np.asarray(self._latencies, np.float64)
        if lat.size == 0:
            return {"frames": 0}
        ms = lat * 1e3
        edges = np.arange(0, np.ceil(ms.max() / 10) * 10 + 10, 10)
        counts, _ = np.histogram(ms, bins=edges)
        return {
            "frames": int(lat.size),
            "mean_ms": float(ms.mean()),
            "p50_ms": float(np.percentile(ms, 50)),
            "p90_ms": float(np.percentile(ms, 90)),
            "p99_ms": float(np.percentile(ms, 99)),
            "fps": float(1e3 / ms.mean()),
            "histogram_ms": {
                f"{int(lo)}-{int(hi)}": int(n)
                for lo, hi, n in zip(edges[:-1], edges[1:], counts)
                if n
            },
        }


# The viewer: drag to orbit, wheel to zoom. Its pose follows
# utils.camera_paths.look_at_extrinsics (a camera on a sphere looking at
# the origin, y up, OpenCV's x flip), the rig's convention.
_VIEWER_HTML = """<!DOCTYPE html>
<html><head><title>fourier_feature_nets_torch viewer</title><style>
body { background: #111; color: #ccc; font-family: monospace;
       display: flex; flex-direction: column; align-items: center; }
img { image-rendering: pixelated; border: 1px solid #444;
      cursor: grab; touch-action: none; }
#bar { margin: 8px; }
button { background: #222; color: #ccc; border: 1px solid #555;
         font-family: monospace; padding: 4px 10px; cursor: pointer; }
</style></head><body>
<div id="bar">
  <button id="mode">stream orbit</button>
  <span id="status">free camera: drag to orbit, wheel to zoom</span>
</div>
<img id="view" width="512" height="512" draggable="false">
<script>
const view = document.getElementById('view');
const status_el = document.getElementById('status');
let az = 0.6, alt = 0.45, dist = 4.0, streaming = false;
// Up to 2 pose requests in flight: the server's dispatcher thread
// pipelines across queued requests (frame k+1 computes while frame
// k's device->host fetch runs), so a serial await leaves the
// accelerator idle during every fetch. Sequence-guarded so a
// stale response never replaces a newer frame.
let inflight = 0, dirty = true, seq = 0, shown = 0;

function pose() {
  const ca = Math.cos(az), sa = Math.sin(az);
  const cl = Math.cos(alt), sl = Math.sin(alt);
  const p = [dist * sa * cl, dist * sl, dist * ca * cl];
  const n = Math.hypot(...p);
  const f = p.map(v => v / n);            // camera +z through camera
  const up = [0, 1, 0];
  let r = [up[1] * f[2] - up[2] * f[1],
           up[2] * f[0] - up[0] * f[2],
           up[0] * f[1] - up[1] * f[0]];
  const rn = Math.hypot(...r);
  r = r.map(v => v / rn);
  const tu = [f[1] * r[2] - f[2] * r[1],
              f[2] * r[0] - f[0] * r[2],
              f[0] * r[1] - f[1] * r[0]];
  // columns (right, -true_up, -forward, position): the x-flip
  return [[r[0], -tu[0], -f[0], p[0]],
          [r[1], -tu[1], -f[1], p[1]],
          [r[2], -tu[2], -f[2], p[2]],
          [0, 0, 0, 1]];
}

async function refresh() {
  if (inflight >= 2 || streaming) { return; }
  inflight += 1; dirty = false;
  const my = ++seq;
  const t0 = performance.now();
  try {
    const resp = await fetch('/pose', {method: 'POST',
      body: JSON.stringify({extrinsics: pose(), format: 'jpg'})});
    if (!resp.ok) {
      status_el.textContent = 'server error: ' + await resp.text();
      inflight -= 1; return;
    }
    const blob = await resp.blob();
    if (my > shown) {  // never let a stale frame overwrite a newer one
      shown = my;
      const url = URL.createObjectURL(blob);
      const old = view.src;
      view.src = url;
      if (old.startsWith('blob:')) { URL.revokeObjectURL(old); }
      status_el.textContent = `pose ${(performance.now() - t0).toFixed(0)} ms` +
        `  az ${az.toFixed(2)} alt ${alt.toFixed(2)} dist ${dist.toFixed(2)}`;
    }
  } catch (e) { status_el.textContent = 'error: ' + e; }
  inflight -= 1;
  if (dirty) { refresh(); }
}

let drag = null;
view.addEventListener('pointerdown', e => {
  drag = [e.clientX, e.clientY]; view.setPointerCapture(e.pointerId);
});
view.addEventListener('pointermove', e => {
  if (!drag || streaming) { return; }
  az -= (e.clientX - drag[0]) * 0.01;
  alt = Math.min(1.4, Math.max(-1.4, alt + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY];
  dirty = true; refresh();
});
view.addEventListener('pointerup', () => { drag = null; });
view.addEventListener('wheel', e => {
  if (streaming) { return; }
  e.preventDefault();
  dist = Math.min(12, Math.max(1.2, dist * (1 + e.deltaY * 0.001)));
  dirty = true; refresh();
}, {passive: false});

document.getElementById('mode').addEventListener('click', () => {
  streaming = !streaming;
  document.getElementById('mode').textContent =
    streaming ? 'free camera' : 'stream orbit';
  if (streaming) {
    status_el.textContent = 'streaming the precompiled orbit rig';
    view.src = '/stream.mjpeg?loop=1';
  } else {
    status_el.textContent = 'free camera: drag to orbit, wheel to zoom';
    view.src = ''; dirty = true; refresh();
  }
});

fetch('/info').then(r => r.json()).then(info => {
  view.width = Math.max(info.width, 256);
  view.height = Math.max(info.height, 256);
  refresh();
});
</script></body></html>
"""

def encode_image(image: np.ndarray, fmt: str):
    """(MIME type, bytes) of a frame in ``fmt``: ``raw`` uint8 bytes,
    ``jpg``/``jpeg`` or ``png`` (any other name)."""
    if fmt == "raw":
        return "application/octet-stream", image.tobytes()
    if fmt in ("jpg", "jpeg"):
        return "image/jpeg", encode_jpeg(image)
    return "image/png", encode_png(image)


def _make_handler(server: RenderServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code, content_type, body):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, payload):
            self._send(200, "application/json",
                       json.dumps(payload).encode())

        def _send_image(self, image, fmt):
            self._send(200, *encode_image(image, fmt))

        def do_POST(self):  # noqa: N802 (http.server API)
            url = urlparse(self.path)
            try:
                if url.path == "/pose":
                    length = int(self.headers.get("Content-Length", 0))
                    request = json.loads(self.rfile.read(length))
                    extrinsics = np.asarray(request["extrinsics"],
                                            np.float32)
                    intrinsics = request.get("intrinsics")
                    if intrinsics is not None:
                        intrinsics = np.asarray(intrinsics, np.float32)
                    image = server.frame_pose(extrinsics, intrinsics)
                    self._send_image(image, request.get("format", "png"))
                else:
                    self._send(404, "text/plain", b"not found")
            except (BrokenPipeError, ConnectionResetError):
                pass
            except Exception as error:  # surfaced to the client
                self._send(500, "text/plain", str(error).encode())

        def do_GET(self):  # noqa: N802 (http.server API)
            url = urlparse(self.path)
            query = {k: v[-1] for k, v in parse_qs(url.query).items()}
            try:
                if url.path == "/":
                    self._send(200, "text/html; charset=utf-8",
                               _VIEWER_HTML.encode())
                elif url.path == "/info":
                    self._send_json({
                        "num_cameras": server.num_cameras,
                        "height": server.resolution[0],
                        "width": server.resolution[1],
                        "model_type": server.raycaster.model.model_type,
                        "fused": server.raycaster.fused,
                        "culling": server.cull_empty and hasattr(
                            server.sampler, "_probe_cdf_geometry"),
                        "pose_endpoint": True,
                    })
                elif url.path == "/stats":
                    self._send_json(server.stats())
                elif url.path == "/frame":
                    camera = int(query.get("camera", 0))
                    fmt = query.get("format", "png")
                    self._send_image(server.frame(camera), fmt)
                elif url.path == "/stream.mjpeg":
                    self._stream(query)
                else:
                    self._send(404, "text/plain", b"not found")
            except (BrokenPipeError, ConnectionResetError):
                pass
            except Exception as error:  # surfaced to the client
                self._send(500, "text/plain", str(error).encode())

        def _stream(self, query):
            start = int(query.get("start", 0))
            count = int(query.get("count", server.num_cameras))
            loop = int(query.get("loop", 0))
            boundary = "ffnframe"
            self.send_response(200)
            self.send_header(
                "Content-Type",
                f"multipart/x-mixed-replace; boundary={boundary}")
            self.end_headers()

            def cameras():
                while True:
                    for i in range(count):
                        yield (start + i) % server.num_cameras
                    if not loop:
                        return

            try:
                for image in server.frames(cameras()):
                    payload = encode_jpeg(image)
                    self.wfile.write(
                        f"--{boundary}\r\nContent-Type: image/jpeg\r\n"
                        f"Content-Length: {len(payload)}\r\n\r\n".encode())
                    self.wfile.write(payload)
                    self.wfile.write(b"\r\n")
            except Exception:   # noqa: BLE001
                # the status line is on the wire already: a 500 would
                # corrupt the body, so the stream just ends (a client
                # gone, or close() mid-stream)
                pass

    return Handler


def follow(raycaster, sampler, mesh, chunk_size: int = 16384,
           cull_empty: bool = True, early_term: float = 0.0,
           early_split: int = 0) -> int:
    """A follower rank of ``serve --data-parallel``: joins each frame
    that rank 0's :class:`RenderServer` broadcasts, rendering its slab,
    until the server closes; returns the number of frames joined. The
    model, sampler and options must be rank 0's."""
    from types import SimpleNamespace
    frames = SimpleNamespace(raycaster=raycaster, sampler=sampler,
                             chunk_size=chunk_size, cull_empty=cull_empty,
                             early_term=early_term, early_split=early_split,
                             mesh=mesh)
    count = 0
    while True:
        request = mesh.broadcast_object()
        if tuple(request) == _STOP:
            return count
        _render_request(frames, request)
        count += 1


def _pose_camera(sampler, extrinsics, intrinsics):
    from ..cameras import CameraInfo, Resolution
    rig = sampler.cameras[0]
    return CameraInfo.create("pose", Resolution(*rig.resolution),
                             intrinsics, extrinsics)


def _render_request(frames, request):
    """A ``("camera", index)`` or ``("pose", (extrinsics, intrinsics))``
    request rendered as a device uint8 frame with ``frames``' raycaster,
    sampler and options (a :class:`RenderServer`'s, or a follower's);
    under a mesh every rank runs it."""
    kind, value = request
    options = dict(chunk_size=frames.chunk_size,
                   cull_empty=frames.cull_empty,
                   early_term=frames.early_term,
                   early_split=frames.early_split, mesh=frames.mesh)
    if kind == "camera":
        return frames.raycaster.render_frame_async(frames.sampler, value,
                                                   **options)
    return frames.raycaster.render_frame_pose_async(
        frames.sampler, _pose_camera(frames.sampler, *value), **options)


def serve(server: RenderServer, host: str = "127.0.0.1",
          port: int = 8765) -> ThreadingHTTPServer:
    """The HTTP server of ``server`` (call its ``serve_forever``, and
    ``shutdown`` to stop it)."""
    return ThreadingHTTPServer((host, port), _make_handler(server))
