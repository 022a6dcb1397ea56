"""Ray sampling for whole-frame rendering.

Port of the render path of ``fourier_feature_nets_tpu/render/ray_sampler.py``:
``RaySamples``, the per-camera calibration tables, the gather-free ray
geometry (``camera_ray_geometry``, ``pose_ray_geometry``,
``sample_camera_rays``) and deterministic uniform sample placement.
Focus sampling, stratified jitter, annealing and the per-ray tables of
the training path are not ported yet (ROADMAP.md, queue 1).
"""

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..cameras import CameraInfo
from ..ops import bounds_min_max, ray_aabb_near_far, uniform_t_values

__all__ = ["RaySamples", "RaySampler"]


class RaySamples(NamedTuple):
    """Point samples along rays, grouped (num_rays, num_samples).
    ``rays`` holds the global ray index of each row (camera-major,
    row-major pixel order)."""

    positions: torch.Tensor
    view_directions: torch.Tensor
    t_values: torch.Tensor
    rays: Optional[torch.Tensor]


class RaySampler:
    """Samples points along camera rays cast into a bounded volume."""

    def __init__(self, bounds: np.ndarray, cameras: List[CameraInfo],
                 num_samples: int, device="cpu"):
        """Constructor.

        Args:
            bounds: (4, 4) transform from the unit cube to the render
                volume.
            cameras: scene cameras (all same resolution).
            num_samples: samples per ray.
            device: where the calibration tables and samples live.
        """
        self.device = torch.device(device)
        lo, hi = bounds_min_max(bounds)
        self.bounds_min = torch.from_numpy(lo).to(self.device)
        self.bounds_max = torch.from_numpy(hi).to(self.device)
        self.image_width, self.image_height = cameras[0].resolution
        self.rays_per_camera = self.image_width * self.image_height
        self.num_cameras = len(cameras)
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

    def _sample_geometry(self, starts, directions, near, far, idx):
        t_values = uniform_t_values(near, far, self.num_samples)
        positions = (starts[:, None, :]
                     + t_values[..., None] * directions[:, None, :])
        view_directions = directions[:, None, :].expand(positions.shape)
        return RaySamples(positions, view_directions, t_values, idx)
