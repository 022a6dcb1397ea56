"""Ray sampling for rendering and training.

Port of ``fourier_feature_nets_tpu/render/ray_sampler.py``:
``RaySamples``, the per-camera calibration tables, the gather-free ray
geometry (``camera_ray_geometry``, ``pose_ray_geometry``,
``sample_camera_rays``), the lazy per-ray tables of the training path,
index sampling (``sample``) with stratified jitter and near/far
annealing, ``to_valid``, ``rays_for_camera`` and ``to_image``. Focus
sampling (an opacity model) is not ported yet (ROADMAP.md, queue 1,
item 1).
"""

import functools
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..cameras import CameraInfo, raycast_grid
from ..ops import (
    anneal_near_far,
    bounds_min_max,
    per_ray_uniform,
    ray_aabb_near_far,
    uniform_t_values,
)
from ..utils.errors import not_ported

__all__ = ["RaySamples", "RaySampler", "RayTables"]


class RaySamples(NamedTuple):
    """Point samples along rays, grouped (num_rays, num_samples).
    ``rays`` holds the global ray index of each row (camera-major,
    row-major pixel order)."""

    positions: torch.Tensor
    view_directions: torch.Tensor
    t_values: torch.Tensor
    rays: Optional[torch.Tensor]


class RayTables(NamedTuple):
    """Per-ray geometry of every camera pixel, in global ray order.
    ``valid`` (rays that hit the volume) stays on the host for index
    filtering; invalid rays get near 1 and far 2."""

    starts: torch.Tensor       # (num_rays, 3)
    directions: torch.Tensor   # (num_rays, 3)
    near: torch.Tensor         # (num_rays,)
    far: torch.Tensor          # (num_rays,)
    valid: np.ndarray          # (num_rays,) bool


class RaySampler:
    """Samples points along camera rays cast into a bounded volume."""

    def __init__(self, bounds: np.ndarray, cameras: List[CameraInfo],
                 num_samples: int, device="cpu", stratified: bool = False,
                 anneal_start: float = 0.5, num_anneal_steps: int = 0,
                 opacity_model=None):
        """Constructor.

        Args:
            bounds: (4, 4) transform from the unit cube to the render
                volume.
            cameras: scene cameras (all same resolution).
            num_samples: samples per ray.
            device: where the calibration tables and samples live.
            stratified: jitter each sample within its bin when
                :meth:`sample` is given a key.
            anneal_start/num_anneal_steps: near/far annealing schedule
                of :meth:`sample` (``num_anneal_steps`` 0 disables it).
            opacity_model: focus sampling; not ported, must be None.
        """
        if opacity_model is not None:
            raise not_ported("focus sampling (an opacity model)",
                             "Focus sampling")
        self.device = torch.device(device)
        self.bounds = np.asarray(bounds, np.float32)
        self.stratified = stratified
        self.anneal_start = anneal_start
        self.num_anneal_steps = num_anneal_steps
        lo, hi = bounds_min_max(bounds)
        self.bounds_min = torch.from_numpy(lo).to(self.device)
        self.bounds_max = torch.from_numpy(hi).to(self.device)
        self.image_width, self.image_height = cameras[0].resolution
        self.rays_per_camera = self.image_width * self.image_height
        self.num_cameras = len(cameras)
        self.num_rays = self.num_cameras * self.rays_per_camera
        self.num_samples = num_samples
        self.cameras = cameras

        # the direction of pixel (x, y) is linear in the pixel
        # coordinates, d = M @ [x, y, 1] with M = R @ K^-1, so a frame's
        # ray geometry is computed from two small tables per camera
        ray_m = np.stack([
            camera.extrinsics[:3, :3] @ np.linalg.inv(camera.intrinsics)
            for camera in cameras])
        self.cam_ray_m = torch.from_numpy(
            ray_m.astype(np.float32)).to(self.device)
        self.cam_positions = torch.from_numpy(np.stack(
            [camera.position[0] for camera in cameras]).astype(np.float32)
        ).to(self.device)

    @functools.cached_property
    def ray_tables(self) -> RayTables:
        """The per-ray tables, built on first use: whole-frame rendering
        computes its geometry from the calibration tables and never
        needs them."""
        ray = raycast_grid(self.cameras)
        starts = torch.from_numpy(ray.origin.astype(np.float32)).to(
            self.device)
        directions = torch.from_numpy(ray.direction.astype(np.float32)).to(
            self.device)
        nf = ray_aabb_near_far(starts, directions, self.bounds_min,
                               self.bounds_max)
        return RayTables(starts, directions,
                         torch.where(nf.valid, nf.near, 1.0),
                         torch.where(nf.valid, nf.far, 2.0),
                         nf.valid.cpu().numpy())

    def sample(self, idx: torch.Tensor, step: Optional[int] = None,
               rng: Optional[int] = None) -> RaySamples:
        """Samples the rays with global indices ``idx``.

        Args:
            idx: (R,) int64 global ray indices (should be valid rays).
            step: training step; None disables annealing (eval).
            rng: integer key of :func:`~..ops.per_ray_uniform`; with a
                stratified sampler it draws the jitter, else ignored.

        Returns:
            RaySamples with (R, num_samples) geometry.
        """
        idx = torch.as_tensor(idx, device=self.device)
        tables = self.ray_tables
        return self._sample_geometry(tables.starts[idx],
                                     tables.directions[idx],
                                     tables.near[idx], tables.far[idx], idx,
                                     step, rng)

    def camera_ray_geometry(self, camera: int, offsets: torch.Tensor):
        """Ray geometry for pixel ``offsets`` of one rig camera.

        Returns:
            (starts, directions, near, far, valid) of shape (R, 3) /
            (R,).
        """
        return self.pose_ray_geometry(self.cam_ray_m[camera],
                                      self.cam_positions[camera], offsets)

    def pose_ray_geometry(self, ray_m: torch.Tensor, position: torch.Tensor,
                          offsets: torch.Tensor):
        """Ray geometry for pixel ``offsets`` of any camera pose given by
        its calibration: ``ray_m = R @ K^-1`` and the world position.
        Invalid rays get near 1 and far 2 so downstream math stays
        finite.

        Returns:
            (starts, directions, near, far, valid), as
            :meth:`camera_ray_geometry`.
        """
        x = (offsets % self.image_width).float()
        y = torch.div(offsets, self.image_width, rounding_mode="floor").float()
        d = (x[:, None] * ray_m[:, 0] + y[:, None] * ray_m[:, 1]
             + ray_m[:, 2])
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        starts = position.expand(d.shape)
        nf = ray_aabb_near_far(starts, d, self.bounds_min, self.bounds_max)
        near = torch.where(nf.valid, nf.near, 1.0)
        far = torch.where(nf.valid, nf.far, 2.0)
        return starts, d, near, far, nf.valid

    def sample_camera_rays(self, camera: int, offsets: torch.Tensor):
        """Samples the rays of pixel ``offsets`` of one camera.

        Returns:
            (RaySamples, valid) — valid marks rays hitting the volume.
        """
        starts, directions, near, far, valid = self.camera_ray_geometry(
            camera, offsets)
        idx = camera * self.rays_per_camera + offsets
        return self._sample_geometry(starts, directions, near, far,
                                     idx), valid

    def _sample_geometry(self, starts, directions, near, far, idx,
                         step=None, rng=None):
        if step is not None and self.num_anneal_steps > 0:
            near, far = anneal_near_far(near, far, step, self.anneal_start,
                                        self.num_anneal_steps)
        jitter = None
        if self.stratified and rng is not None:
            jitter = per_ray_uniform(rng, step or 0, idx, self.num_samples,
                                     salt=0)
        t_values = uniform_t_values(near, far, self.num_samples, jitter)
        positions = (starts[:, None, :]
                     + t_values[..., None] * directions[:, None, :])
        view_directions = directions[:, None, :].expand(positions.shape)
        return RaySamples(positions, view_directions, t_values, idx)

    def to_valid(self, idx) -> np.ndarray:
        """Filters host ray indices to those intersecting the volume."""
        idx = np.asarray(idx)
        return idx[self.ray_tables.valid[idx]]

    def _valid_for_camera(self, camera: int) -> np.ndarray:
        start = camera * self.rays_per_camera
        return self.to_valid(np.arange(start, start + self.rays_per_camera))

    def rays_for_camera(self, camera: int) -> RaySamples:
        """Deterministic samples of one camera's valid rays."""
        idx = torch.from_numpy(self._valid_for_camera(camera))
        return self.sample(idx.to(self.device))

    def __len__(self) -> int:
        """Total number of rays (valid or not)."""
        return self.num_rays

    def to_image(self, camera: int, colors: np.ndarray,
                 color_space: str = "RGB") -> np.ndarray:
        """Scatters one camera's valid-ray colors into an (H, W, 3)
        uint8 image; invalid rays render black."""
        if color_space != "RGB":
            raise not_ported(f"color space {color_space!r}",
                             "Remaining models, data, CLIs and parallel")
        idx = self._valid_for_camera(camera) - camera * self.rays_per_camera
        pixels = np.zeros((self.rays_per_camera, 3), np.float32)
        pixels[idx] = np.asarray(colors)
        pixels = pixels.reshape(self.image_height, self.image_width, 3)
        return (pixels * 255).astype(np.uint8)
