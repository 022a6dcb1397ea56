"""Kind ``serve``: frames of free camera poses served by the program's
``RenderServer`` in process, to ``clients`` client threads in a closed
loop: each sends its next request as soon as its last frame is on the
host, as the viewer's and the MJPEG streams' clients do.

Set-up seeds the model, builds the server on the orbit rig's occupancy
sampler and serves one pose (the weight pack, the kernel's build, every
shape a frame uses). The window's requests take the poses of a lattice
on the sphere in an order drawn from the seed, one a request; each is
timed from the client's call to the host array that
``RenderServer.frame_pose`` returns. The clients send no request after
``--seconds``, and those in flight are waited for. ``serve_frame_ms`` is
the window's seconds over the frames that reached a client in it;
``frame_p95_ms`` is the 95th percentile of every request the window
sent. A traced run then serves ``trace_seconds`` more under the tracer.

The check renders a sample of the window's requests, drawn from the
seed, with the plain reference and compares each pixel.
"""

import sys
import threading

import numpy as np
import torch

from ..families import family
from ..traffic.generator import orbit_rig, sphere_poses
from ..weights import seeded_flat
from .common import Check, compute_dtype, frame_gaps, now, sync, worst
from .orbit import FrameReference, cameras_of, program_sampler, \
    window_counts

__all__ = ["Cell", "TINY"]

# the CPU tests' cut of a serve mix
TINY = {"resolution": 24, "num_cameras": 4, "num_samples": 8,
        "chunk_size": 64, "pose_count": 64, "clients": 4,
        "drain_seconds": 60.0, "check_requests": 2, "trace_seconds": 0.5,
        "occupancy": {"resolution": 8, "probe_resolution": 4}}


class Cell:
    """One run of a ``serve`` cell."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, configs):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.kept = {}
        self.traced = []
        self.next_request = 0
        count = mix["pose_count"]
        self.k, self.e = sphere_poses(mix, count, seed)
        # the check keeps the requests of the least draws
        self.draws = np.random.default_rng(seed).random(count)

    def setup(self) -> None:
        from fourier_feature_nets_torch.render import Raycaster
        from fourier_feature_nets_torch.render.server import RenderServer
        generator = torch.Generator(self.device).manual_seed(self.seed)
        self.flat = seeded_flat(self.cfg, generator, self.device)
        model = family(self.cfg).program(self.cfg, self.flat, self.device)
        rig_k, rig_e = orbit_rig(self.mix)
        cameras = cameras_of(rig_k, rig_e, self.mix["resolution"])
        sampler = program_sampler(model, self.mix, cameras, self.device)
        raycaster = Raycaster(model, compute_dtype=compute_dtype(self.cfg))
        self.server = RenderServer(raycaster, sampler,
                                   chunk_size=self.mix["chunk_size"])
        self.server.frame_pose(self.e[-1], self.k[-1])
        sync(self.device)

    def _keep(self, request: int, pose: int, image) -> None:
        """Keeps ``image`` while ``request``'s draw is among the
        ``check_requests`` least of the window's (under the lock)."""
        if len(self.kept) < self.mix["check_requests"]:
            self.kept[request] = (pose, image)
            return
        worst = max(self.kept, key=lambda r: self.draws[r % len(self.draws)])
        if self.draws[request % len(self.draws)] < \
                self.draws[worst % len(self.draws)]:
            del self.kept[worst]
            self.kept[request] = (pose, image)

    def _loop(self, seconds: float, keep: bool) -> dict:
        """The closed loop for ``seconds``, then until every request sent
        has its frame or ``drain_seconds`` have passed."""
        lock = threading.Lock()
        count = len(self.draws)
        latency, served, failed = [], [], [0]
        start = now()
        end = start + seconds

        def client():
            while True:
                with lock:
                    if now() >= end:
                        return
                    request = self.next_request
                    self.next_request += 1
                pose = request % count
                sent = now()
                try:
                    image = self.server.frame_pose(self.e[pose],
                                                   self.k[pose])
                except Exception as error:  # counted, and the loop goes on
                    print(f"request failed: {error!r}", file=sys.stderr)
                    with lock:
                        failed[0] += 1
                    continue
                done = now()
                with lock:
                    latency.append(done - sent)
                    served.append((pose, done <= end))
                    if keep:
                        self._keep(request, pose, image)

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(self.mix["clients"])]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=max(0.0, end + self.mix["drain_seconds"]
                                    - now()))
        with lock:
            lost = sum(thread.is_alive() for thread in threads)
            return {"start": start, "latency": list(latency),
                    "served": list(served), "failed": failed[0] + lost,
                    "elapsed": now() - start}

    def window(self, seconds: float, tracer) -> dict:
        run = self._loop(seconds, keep=True)
        self.window_seconds = seconds
        self.windowed = [pose for pose, in_window in run["served"]
                         if in_window]
        ms = np.asarray(run["latency"]) * 1e3
        p95 = float(np.percentile(ms, 95)) if ms.size else float("inf")
        print(f"serve: {len(ms)} requests from {self.mix['clients']} "
              f"clients, {len(self.windowed)} served in the window, latency "
              f"p50 {np.percentile(ms, 50) if ms.size else float('inf'):.3f}"
              f" ms, p95 {p95:.3f} ms", file=sys.stderr)
        attempted, failed = len(run["latency"]) + run["failed"], run["failed"]
        if tracer.enabled:
            tracer.start()
            traced = self._loop(self.mix["trace_seconds"], keep=False)
            tracer.stop()
            self.traced = [pose for pose, _ in traced["served"]]
            attempted += len(traced["latency"]) + traced["failed"]
            failed += traced["failed"]
        frame_ms = (seconds * 1e3 / len(self.windowed) if self.windowed
                    else float("inf"))
        return {"start": run["start"], "attempted": attempted,
                "failed": failed,
                "metrics": {"serve_frame_ms": (frame_ms, "ms"),
                            "frame_p95_ms": (p95, "ms")}}

    def release(self) -> None:
        self.server.close()
        self.server = None

    def reference(self, quant=None) -> FrameReference:
        return FrameReference(self.cfg, self.flat, self.mix, self.k, self.e,
                              self.device, quant)

    def check(self, limits: dict) -> list:
        reference = self.reference()
        values = worst(frame_gaps(image, *reference.frame(pose))
                       for pose, image in self.kept.values())
        self._reference = reference
        return [Check(name, values.get(name, float("inf")), limit)
                for name, limit in limits.items()]

    def counts(self) -> dict:
        reference = getattr(self, "_reference", None) or self.reference()
        return window_counts(self.cfg, self.mix, reference.drawn,
                             self.traced, self.windowed, self.window_seconds)

    def control(self) -> dict:
        """The readings of the program and of the fp8 control on the
        checked requests."""
        reference = self.reference()
        control = self.reference("fp8")
        rows = {"program": [], "control": []}
        for pose, image in self.kept.values():
            truth, drawn = reference.frame(pose)
            rows["program"].append(frame_gaps(image, truth, drawn))
            rows["control"].append(frame_gaps(control.frame(pose)[0], truth,
                                              drawn))
        return {side: worst(values) for side, values in rows.items()}
