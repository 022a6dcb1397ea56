"""Ray sampling for rendering and training.

Port of ``fourier_feature_nets_tpu/render/ray_sampler.py``:
``RaySamples``, the per-camera calibration tables, the gather-free ray
geometry (``camera_ray_geometry``, ``pose_ray_geometry``,
``sample_camera_rays``) and that of any camera pose
(``pose_calibration``, ``sample_pose_rays``), the lazy per-ray tables of the training path,
index sampling (``sample``) with stratified jitter and near/far
annealing, focus sampling (half the samples drawn from per-ray CDFs of
an opacity model's density), ``to_valid``, ``rays_for_camera`` and
``to_image``. The JAX package's iid-quantile ablation switch
(``FFN_TPU_IID_FOCUS_QUANTILES``) is not ported: focus quantiles are
always stratified.
"""

import functools
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..cameras import CameraInfo, raycast_grid
from ..models.module import query_model
from ..ops import (
    anneal_near_far,
    batch_linspace,
    bounds_min_max,
    determine_cdf,
    inverse_cdf_t_values,
    merge_sorted,
    per_ray_uniform,
    ray_aabb_near_far,
    uniform_t_values,
)
from ..utils.color import ycrcb_to_rgb

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
                 opacity_model=None, batch_size: int = 4096):
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
            opacity_model: an ``nn.Module`` whose last output channel's
                softplus is the density of focus sampling: it is swept
                once over every ray at construction, and half the
                samples of each ray are then drawn from the ray's CDF.
                None samples uniformly.
            batch_size: rays per batch of the opacity sweep (raised to
                65,536, as the JAX package sweeps).
        """
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

        self.opacity_model = opacity_model
        self.batch_size = batch_size
        self.focus_sampling = opacity_model is not None
        if self.focus_sampling:
            self.num_focus_samples = num_samples - num_samples // 2
            self.cdfs = self._precompute_cdfs()
        else:
            self.num_focus_samples = 0
            self.cdfs = None

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

    def _cdfs_for_geometry(self, starts, directions, near,
                           far) -> torch.Tensor:
        """Focus CDFs of explicit ray geometry: the opacity model's
        softplus density (its last output channel, in f32, without
        grad) on a ``num_focus_samples`` linspace over [near, far], on
        the model's device.

        Returns:
            (R, num_focus_samples - 1) CDFs on the sampler's device.
        """
        model = self.opacity_model
        device = next(model.parameters()).device
        starts, directions, near, far = (
            x.to(device) for x in (starts, directions, near, far))
        t_values = batch_linspace(near, far, self.num_focus_samples)
        positions = (starts[:, None, :]
                     + t_values[..., None] * directions[:, None, :])
        views = directions[:, None, :].expand(positions.shape)
        with torch.no_grad():
            logits = query_model(model, positions.reshape(-1, 3),
                                 views.reshape(-1, 3))[:, -1]
        opacity = F.softplus(logits).reshape(-1, self.num_focus_samples)
        return determine_cdf(t_values, opacity).to(self.device)

    def _precompute_cdfs(self) -> torch.Tensor:
        """Sweeps the opacity model over every ray of the rig, in
        batches of ``max(batch_size, 65536)`` rays.

        Returns:
            (num_rays, num_focus_samples - 1) CDFs on the sampler's
            device.
        """
        tables = self.ray_tables
        sweep = max(self.batch_size, 65536)
        return torch.cat([
            self._cdfs_for_geometry(tables.starts[start:start + sweep],
                                    tables.directions[start:start + sweep],
                                    tables.near[start:start + sweep],
                                    tables.far[start:start + sweep])
            for start in range(0, self.num_rays, sweep)])

    def sample(self, idx: torch.Tensor, step: Optional[int] = None,
               rng: Optional[int] = None) -> RaySamples:
        """Samples the rays with global indices ``idx``.

        Args:
            idx: (R,) int64 global ray indices (should be valid rays).
            step: training step (an int, or a 0-d int64 tensor on the
                sampler's device inside a CUDA graph); None disables
                annealing (eval).
            rng: integer key of :func:`~..ops.per_ray_uniform` (or a 0-d
                int64 tensor, as ``step``); with a stratified sampler it
                draws the jitter, else ignored.

        Returns:
            RaySamples with (R, num_samples) geometry.
        """
        idx = torch.as_tensor(idx, device=self.device)
        tables = self.ray_tables
        return self._sample_geometry(tables.starts[idx],
                                     tables.directions[idx],
                                     tables.near[idx], tables.far[idx], idx,
                                     step, rng)

    def camera_ray_geometry(self, camera, offsets: torch.Tensor):
        """Ray geometry for pixel ``offsets`` of one rig camera, an int
        or a 0-d int64 device tensor (read with no host copy, as a CUDA
        graph's draws are).

        Returns:
            (starts, directions, near, far, valid) of shape (R, 3) /
            (R,).
        """
        if isinstance(camera, torch.Tensor):
            row = camera.reshape(1)
            return self.pose_ray_geometry(
                self.cam_ray_m.index_select(0, row)[0],
                self.cam_positions.index_select(0, row)[0], offsets)
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

    @staticmethod
    def pose_calibration(camera: CameraInfo, device="cpu"):
        """``(ray_m, position)``, the calibration of one
        :class:`CameraInfo` that :meth:`pose_ray_geometry` takes: f32
        tensors on ``device``, equal to the rig tables' rows for a rig
        camera."""
        ray_m = (camera.extrinsics[:3, :3]
                 @ np.linalg.inv(camera.intrinsics)).astype(np.float32)
        position = camera.position[0].astype(np.float32)
        return (torch.from_numpy(ray_m).to(device),
                torch.from_numpy(position).to(device))

    def sample_pose_rays(self, ray_m: torch.Tensor, position: torch.Tensor,
                         offsets: torch.Tensor, step=None, rng=None):
        """:meth:`sample_camera_rays` for any camera pose, given by its
        calibration (:meth:`pose_calibration`). The pixel offset is the
        ray id of the jitter's key (a free pose has no global ray
        index). A focus sampler computes the rays' CDFs on the fly
        (:meth:`_cdfs_for_geometry`): its precomputed tables cover only
        the rig's pixels.

        Returns:
            (RaySamples, valid) — valid marks rays hitting the volume.
        """
        starts, directions, near, far, valid = self.pose_ray_geometry(
            ray_m, position, offsets)
        cdf_rows = None
        if self.focus_sampling:
            cdf_rows = self._cdfs_for_geometry(starts, directions, near, far)
        return self._sample_geometry(starts, directions, near, far, offsets,
                                     step, rng, cdf_rows=cdf_rows), valid

    def sample_camera_rays(self, camera, offsets: torch.Tensor, step=None,
                           rng=None):
        """Samples the rays of pixel ``offsets`` of one camera (an int or
        a 0-d int64 device tensor); ``step`` and ``rng`` as in
        :meth:`sample`, keyed by the global ray ids.

        Returns:
            (RaySamples, valid) — valid marks rays hitting the volume.
        """
        starts, directions, near, far, valid = self.camera_ray_geometry(
            camera, offsets)
        idx = camera * self.rays_per_camera + offsets
        return self._sample_geometry(starts, directions, near, far, idx,
                                     step, rng), valid

    def _sample_geometry(self, starts, directions, near, far, idx,
                         step=None, rng=None, cdf_rows=None):
        """Samples explicit ray geometry; a focus sampler reads the
        rays' CDFs from ``cdf_rows`` or, without them, from its table
        at ``idx``."""
        near0, far0 = near, far   # pre-anneal bounds: the CDF's domain
        if step is not None and self.num_anneal_steps > 0:
            near, far = anneal_near_far(near, far, step, self.anneal_start,
                                        self.num_anneal_steps)
        num_uniform = (self.num_samples // 2 if self.focus_sampling
                       else self.num_samples)
        jitter = focus_quantiles = None
        if self.stratified and rng is not None:
            key_step = 0 if step is None else step
            jitter = per_ray_uniform(rng, key_step, idx, num_uniform,
                                     salt=0)
            if self.focus_sampling:
                u = per_ray_uniform(rng, key_step, idx,
                                    self.num_focus_samples, salt=1)
                strata = torch.arange(self.num_focus_samples,
                                      dtype=u.dtype, device=u.device)
                focus_quantiles = (strata + u) / self.num_focus_samples
        t_values = uniform_t_values(near, far, num_uniform, jitter)
        if self.focus_sampling:
            if cdf_rows is None:
                cdf_rows = self.cdfs[idx]
            focus_t = inverse_cdf_t_values(
                near0, far0, cdf_rows, self.num_focus_samples,
                self.num_focus_samples, focus_quantiles)
            t_values = merge_sorted(t_values, focus_t)
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
        uint8 image; invalid rays render black, and ``YCrCb`` colors are
        converted to RGB."""
        idx = self._valid_for_camera(camera) - camera * self.rays_per_camera
        pixels = np.zeros((self.rays_per_camera, 3), np.float32)
        pixels[idx] = np.asarray(colors)
        pixels = pixels.reshape(self.image_height, self.image_width, 3)
        pixels = (pixels * 255).astype(np.uint8)
        if color_space == "YCrCb":
            pixels = ycrcb_to_rgb(pixels)
        return pixels
