"""Kind ``orbit``: the frames of an orbit, rendered back to back as
``orbit_video`` renders them, each copied to the host.

Set-up seeds the model's weights on the device, builds the rig, the
program's occupancy sampler from the mix's occupancy source and its
``Raycaster``, and renders one frame (the weight pack, the kernel's
build and every shape a frame uses). The window then renders the
cameras in orbit order through ``Raycaster.render_frame_async``, one
frame ahead, copying the previous frame to the host; ``frame_ms`` is
the window's seconds over the frames that reached the host in it. A
traced run then renders ``trace_frames`` more under the tracer.

The occupancy grid comes from the mix's ``occupancy["source"]``:
``"model"`` (the default), the model's own density at the grid's cell
centres, which the program computes through ``from_model`` and the
reference from its own model; or ``"cloud"``, a fixed point cloud that
the harness rasterises (``traffic.generator.cloud_grid``) and hands to
both: to the program's ``OccupancyGridSampler`` constructor and to the
reference's ``Occupancy``.

The check renders a sample of the window's cameras, drawn from the
seed, with the plain reference from the same weights and compares each
pixel of the 8-bit frames (``common.frame_gaps``): the mean gap over
the frame, and over the pixels the reference draws or where the frames
differ; the cell's limits name the ones compared.
"""

import numpy as np
import torch

from ..families import family
from ..reference.frame import effective_stride, frame_hits, render_frame
from ..reference.geometry import Occupancy, density_grid, rig_tables
from ..traffic.generator import cloud_grid, orbit_rig
from ..weights import seeded_flat
from .common import (Check, add_bounds, compute_dtype, frame_gaps, now,
                     pick, sync, worst)

__all__ = ["Cell", "FrameReference", "TINY", "window_counts",
           "program_sampler", "reference_grid"]

# the CPU tests' cut of an orbit mix
TINY = {"resolution": 24, "num_cameras": 4, "num_samples": 8,
        "chunk_size": 64, "check_frames": 2, "trace_frames": 3,
        "occupancy": {"resolution": 8, "probe_resolution": 4}}
SOURCES = ("model", "cloud")


def occupancy_source(mix: dict) -> str:
    """The mix's occupancy source; raises on one this kind lacks."""
    source = mix["occupancy"].get("source", "model")
    if source not in SOURCES:
        raise ValueError(f"occupancy source {source!r}: one of {SOURCES}")
    return source


def reference_grid(model, mix: dict, device) -> torch.Tensor:
    """The reference's (R, R, R) 0/1 occupancy grid of the mix's source:
    the density of ``model`` (the reference's), or the cloud's."""
    occ, scale = mix["occupancy"], mix["box_scale"]
    if occupancy_source(mix) == "cloud":
        return torch.from_numpy(cloud_grid(occ, scale)).to(device)
    return density_grid(model, occ["resolution"], scale,
                        occ["alpha_threshold"])


class FrameReference:
    """The plain reference's frames of a rig, from the same weights."""

    def __init__(self, cfg: dict, flat: torch.Tensor, mix: dict, k, e,
                 device, quant=None):
        self.mix, self.quant = mix, quant
        self.model = family(cfg).reference(cfg, flat, device)
        occ = mix["occupancy"]
        scale = mix["box_scale"]
        grid = reference_grid(self.model, mix, device)
        self.occupancy = Occupancy(grid, scale, occ["num_probes"],
                                   occ["empty_weight"],
                                   occ["probe_resolution"])
        self.lo = torch.full((3,), -scale, device=device)
        self.hi = torch.full((3,), scale, device=device)
        self.ray_m, self.positions = rig_tables(k, e, device)
        rig_k, rig_e = orbit_rig(mix)
        self.stride = effective_stride(
            mix["probe_subsample"], occ["resolution"], scale,
            float(rig_k[:, 0, 0].min()),
            float(np.linalg.norm(rig_e[:, :3, 3], axis=-1).max()))

    def frame(self, camera: int):
        """((H, W, 3) uint8 host frame, (H, W) bool host mask of the rays
        it draws) of rig camera ``camera``."""
        size = self.mix["resolution"]
        image, drawn = render_frame(
            self.model, self.occupancy, self.ray_m[camera],
            self.positions[camera], size, size, self.mix["num_samples"],
            self.stride, self.lo, self.hi, self.quant)
        return image.cpu().numpy(), drawn.cpu().numpy()

    def drawn(self, camera: int) -> int:
        """The rays the culled frame of ``camera`` draws."""
        size = self.mix["resolution"]
        return int(frame_hits(self.occupancy, self.ray_m[camera],
                              self.positions[camera], size, size,
                              self.stride, self.lo, self.hi).sum())


def frame_counts(cfg: dict, mix: dict, drawn) -> dict:
    """Model operations and the kernels' bounds (the family's
    ``forward_bounds``) of frames that draw ``drawn`` rays each, in chunks
    of ``chunk_size`` rays."""
    counts = family(cfg).counts
    samples, chunk = mix["num_samples"], mix["chunk_size"]
    flops, bounds = 0, {}
    for rays in drawn:
        flops += rays * samples * counts.forward_flops(cfg)
        for start in range(0, rays, chunk):
            add_bounds(bounds, counts.forward_bounds(
                cfg, min(chunk, rays - start) * samples))
    return {"model_flops": flops, "bounds": bounds}


def window_counts(cfg: dict, mix: dict, drawn, traced, windowed,
                  window_seconds: float) -> dict:
    """The per-layer readers' counts: the traced frames' (``units``, the
    kernels' bounds) and the window's model operations, for frames of the
    cameras or poses ``traced`` and ``windowed``; ``drawn(c)`` is the rays
    that ``c``'s culled frame draws."""
    rays = {c: drawn(c) for c in set(traced) | set(windowed)}
    slice_ = frame_counts(cfg, mix, [rays[c] for c in traced])
    window = frame_counts(cfg, mix, [rays[c] for c in windowed])
    return dict(slice_["bounds"], units=len(traced),
                window_model_flops=window["model_flops"],
                window_seconds=window_seconds)


def program_sampler(model, mix: dict, cameras, device,
                    stratified: bool = False):
    """The program's occupancy sampler of the mix's source: the model's
    density grid (``from_model``), or the cloud's grid through the
    constructor that ``from_model`` and ``from_tree`` end in."""
    from fourier_feature_nets_torch.render import OccupancyGridSampler
    occ, scale = mix["occupancy"], mix["box_scale"]
    shared = {"bounds": np.diag([2 * scale] * 3 + [1.0]).astype(np.float32),
              "empty_weight": occ["empty_weight"],
              "num_probes": occ["num_probes"],
              "probe_resolution": occ["probe_resolution"], "device": device,
              "stratified": stratified}
    if occupancy_source(mix) == "cloud":
        return OccupancyGridSampler(cloud_grid(occ, scale), scale, cameras,
                                    mix["num_samples"], **shared)
    return OccupancyGridSampler.from_model(
        model, cameras, mix["num_samples"],
        grid_resolution=occ["resolution"],
        alpha_threshold=occ["alpha_threshold"], scale=scale, **shared)


def cameras_of(k, e, size: int):
    from fourier_feature_nets_torch.cameras import CameraInfo, Resolution
    return [CameraInfo.create(f"cam{i}", Resolution(size, size), ki, ei)
            for i, (ki, ei) in enumerate(zip(k, e))]


class Cell:
    """One run of an ``orbit`` cell."""


    def __init__(self, cfg: dict, mix: dict, seed: int, device, configs):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.frames = {}
        self.next_camera = 0

    def setup(self) -> None:
        from fourier_feature_nets_torch.render import Raycaster
        generator = torch.Generator(self.device).manual_seed(self.seed)
        self.flat = seeded_flat(self.cfg, generator, self.device)
        model = family(self.cfg).program(self.cfg, self.flat, self.device)
        self.k, self.e = orbit_rig(self.mix)
        cameras = cameras_of(self.k, self.e, self.mix["resolution"])
        self.sampler = program_sampler(model, self.mix, cameras, self.device)
        self.raycaster = Raycaster(model, compute_dtype=compute_dtype(self.cfg))
        self._render(0).cpu()
        sync(self.device)

    def _render(self, camera: int):
        mix = self.mix
        return self.raycaster.render_frame_async(
            self.sampler, camera, chunk_size=mix["chunk_size"],
            probe_subsample=mix["probe_subsample"])

    def _frames(self, stop):
        """Renders the orbit from the next camera, one frame ahead, until
        ``stop(frames launched, seconds)``; (cameras, start, seconds)."""
        count, cameras = len(self.k), []
        start = now()
        camera, launched = self.next_camera, 1
        pending = self._render(camera)
        while True:
            done = stop(launched, now() - start)
            if not done:
                following = self._render((camera + 1) % count)
                launched += 1
            self.frames[camera] = pending.cpu().numpy()
            cameras.append(camera)
            if done:
                break
            camera, pending = (camera + 1) % count, following
        self.next_camera = (camera + 1) % count
        return cameras, start, now() - start

    def window(self, seconds: float, tracer) -> dict:
        self.windowed, start, self.window_seconds = self._frames(
            lambda launched, elapsed: elapsed >= seconds)
        if tracer.enabled:
            tracer.start()
            self.traced = self._frames(
                lambda launched, elapsed:
                launched >= self.mix["trace_frames"])[0]
            tracer.stop()
        done = len(self.windowed)
        return {"start": start, "attempted": done, "failed": 0,
                "metrics": {"frame_ms": (self.window_seconds * 1e3 / done,
                                         "ms")}}

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        self.raycaster = self.sampler = None

    def reference(self, quant=None) -> FrameReference:
        return FrameReference(self.cfg, self.flat, self.mix, self.k, self.e,
                              self.device, quant)

    def _checked(self) -> list:
        return pick(self.seed, self.frames, self.mix["check_frames"])

    def check(self, limits: dict) -> list:
        reference = self.reference()
        values = worst(frame_gaps(self.frames[c], *reference.frame(c))
                       for c in self._checked())
        self._reference = reference
        return [Check(name, values.get(name, float("inf")), limit)
                for name, limit in limits.items()]

    def counts(self) -> dict:
        """The traced frames' and the window's work, from the reference's
        culling."""
        reference = getattr(self, "_reference", None) or self.reference()
        return window_counts(self.cfg, self.mix, reference.drawn,
                             self.traced, self.windowed, self.window_seconds)

    def control(self) -> dict:
        """The readings of the program and of the fp8 control on the
        checked frames."""
        reference = self.reference()
        control = self.reference("fp8")
        rows = {"program": [], "control": []}
        for c in self._checked():
            truth, drawn = reference.frame(c)
            rows["program"].append(frame_gaps(self.frames[c], truth, drawn))
            rows["control"].append(frame_gaps(control.frame(c)[0], truth,
                                              drawn))
        return {side: worst(values) for side, values in rows.items()}
