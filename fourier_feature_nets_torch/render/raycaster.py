"""Volumetric raycaster: the inference half.

Port of the render path of ``fourier_feature_nets_tpu/render/raycaster.py``:
``_composite``, ``Raycaster.render``/``batched_render`` and the
whole-frame renderer ``render_frame``/``render_frame_async`` with
empty-space culling. The JAX package compiles a frame into one
``lax.scan`` over ray chunks; here the chunk loop is a Python loop of
eager PyTorch ops, and the NeRF query goes through the fused Hopper
kernel (:mod:`..kernels.fused_nerf`) on a CUDA device.

Training, pose rendering, early termination and the data-parallel mesh
are not ported yet (ROADMAP.md, queue 1).
"""

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.fused_nerf import fused_nerf_apply, prepare_fused_nerf
from ..ops import calculate_blend_weights
from .ray_sampler import RaySampler, RaySamples

__all__ = ["Raycaster", "RenderResult"]


class RenderResult(NamedTuple):
    """Per-ray render outputs (``datasets/ray_dataset.py::RenderResult``
    in the JAX package)."""

    color: torch.Tensor
    alpha: torch.Tensor
    depth: Optional[torch.Tensor]


def _composite(color_o: torch.Tensor, t_values: torch.Tensor,
               include_depth: bool) -> RenderResult:
    """Emission-absorption compositing of raw model logits: sigmoid
    color, softplus opacity, alpha without the absorbing tail sample,
    depth at the highest-weight sample (the last one where alpha <
    0.1)."""
    num_samples = t_values.shape[-1]
    color = torch.sigmoid(color_o[..., :3])
    opacity = F.softplus(color_o[..., 3])

    weights = calculate_blend_weights(t_values, opacity)
    output_color = torch.sum(weights[..., None] * color, dim=-2)
    leading = weights[..., :-1]
    output_alpha = torch.sum(leading, dim=-1)

    if include_depth:
        cutoff = torch.argmax(leading, dim=-1)
        cutoff = torch.where(output_alpha < 0.1, num_samples - 1, cutoff)
        output_depth = torch.gather(t_values, -1, cutoff[..., None])[..., 0]
    else:
        output_depth = None
    return RenderResult(output_color, output_alpha, output_depth)


class Raycaster:
    """Renders rays through a radiance field."""

    def __init__(self, model, compute_dtype: Optional[torch.dtype] = None,
                 fused: Optional[bool] = None):
        """Constructor.

        Args:
            model: the radiance-field ``nn.Module``; its device is the
                render device.
            compute_dtype: optional matmul dtype for the MLP (e.g.
                torch.bfloat16); None keeps full f32.
            fused: route NeRF queries through the fused kernel's
                wrapper. None (default) = on for a NeRF on a CUDA
                device, off elsewhere. With True on the CPU the wrapper
                runs the kernel's plain twin.
        """
        self.model = model
        self.compute_dtype = compute_dtype
        is_nerf = getattr(model, "model_type", None) == "nerf"
        if fused is None:
            fused = next(model.parameters()).is_cuda
        self.fused = bool(fused) and is_nerf
        self._fused_weights = None
        self._fused_key = None

    def _get_fused_weights(self):
        """The kernel's weight pack, built once per parameter state:
        the key holds each parameter's version counter, which an
        in-place update bumps."""
        key = (self.compute_dtype,
               tuple(p._version for p in self.model.parameters()))
        if self._fused_key != key:
            dtype = (self.compute_dtype if self.compute_dtype is not None
                     else torch.float32)
            self._fused_weights = prepare_fused_nerf(self.model, dtype)
            self._fused_key = key
        return self._fused_weights

    def _query(self, positions: torch.Tensor,
               views: torch.Tensor) -> torch.Tensor:
        """(N, 3) positions and views -> (N, 4) logits."""
        if self.fused:
            return fused_nerf_apply(self._get_fused_weights(),
                                    positions.contiguous(),
                                    views.contiguous())
        return self.model(positions, views, compute_dtype=self.compute_dtype)

    @torch.no_grad()
    def render(self, ray_samples: RaySamples,
               include_depth: bool = False) -> RenderResult:
        """Renders ray samples through the model."""
        num_rays, num_samples = ray_samples.t_values.shape
        positions = ray_samples.positions.reshape(-1, 3)
        views = ray_samples.view_directions.reshape(-1, 3)
        color_o = self._query(positions, views)
        color_o = color_o.reshape(num_rays, num_samples, 4)
        return _composite(color_o, ray_samples.t_values, include_depth)

    def batched_render(self, samples: RaySamples, batch_size: int,
                       include_depth: bool) -> RenderResult:
        """Renders arbitrarily many rays in chunks of ``batch_size``;
        returns host NumPy arrays."""
        num_rays = samples.positions.shape[0]
        colors, alphas, depths = [], [], []
        for start in range(0, num_rays, batch_size):
            chunk = RaySamples(samples.positions[start:start + batch_size],
                               samples.view_directions[start:start
                                                       + batch_size],
                               samples.t_values[start:start + batch_size],
                               None)
            result = self.render(chunk, include_depth)
            colors.append(result.color)
            alphas.append(result.alpha)
            if include_depth:
                depths.append(result.depth)
        color = torch.cat(colors).cpu().numpy()
        alpha = torch.cat(alphas).cpu().numpy()
        depth = torch.cat(depths).cpu().numpy() if include_depth else None
        return RenderResult(color, alpha, depth)

    @staticmethod
    def _safe_probe_subsample(sampler, stride: int) -> int:
        """Clamps the cull-probe stride to 1 when occupancy cells are
        too small on screen for the coarse raster to stay conservative.

        The stride-s raster culls a ray only when its probe and every
        3x3-dilated coarse neighbor miss, a superset of the exact
        per-ray test only while an occupied cell spans several coarse
        probes; require a >= 3*s pixel cell span (estimated from the
        rig's calibration) before subsampling."""
        if stride <= 1 or not hasattr(sampler, "_grid_resolution"):
            return stride
        cell = 2.0 * sampler._grid_scale / sampler._grid_resolution
        focal = min(float(c.intrinsics[0, 0]) for c in sampler.cameras)
        distance = max(float(np.linalg.norm(c.position[0]))
                       for c in sampler.cameras)
        span_px = focal * cell / max(distance, 1e-6)
        return stride if span_px >= 3.0 * stride else 1

    def _render_rays(self, sampler: RaySampler, camera: int,
                     offsets: torch.Tensor) -> torch.Tensor:
        """(R,) pixel offsets of one camera -> (R, 3) colors."""
        rays, _ = sampler.sample_camera_rays(camera, offsets)
        return self.render(rays).color

    @staticmethod
    def _compute_hit(sampler, camera: int, probe_subsample: int):
        """Probe phase of the culled frame: which of the frame's rays
        touch occupied space. With ``probe_subsample`` s > 1 only every
        s-th pixel in each image axis is probed and the coarse hit
        raster is 3x3 max-dilated before upsampling: a ray is culled
        only when its probe and every neighboring coarse probe miss."""
        height, width = sampler.image_height, sampler.image_width
        device = sampler.device
        offsets = torch.arange(sampler.rays_per_camera, device=device)
        _, _, _, _, valid = sampler.camera_ray_geometry(camera, offsets)
        if probe_subsample > 1:
            s = probe_subsample
            coarse_h = -(-height // s)
            coarse_w = -(-width // s)
            cy = torch.clamp(torch.arange(coarse_h, device=device) * s,
                             max=height - 1)
            cx = torch.clamp(torch.arange(coarse_w, device=device) * s,
                             max=width - 1)
            coarse_off = (cy[:, None] * width + cx[None, :]).reshape(-1)
            cs, cd, cn, cf, cvalid = sampler.camera_ray_geometry(
                camera, coarse_off)
            _, _, hit_c = sampler._probe_cdf_geometry(cs, cd, cn, cf)
            grid = (hit_c & cvalid).reshape(1, 1, coarse_h, coarse_w)
            dilated = F.max_pool2d(grid.float(), 3, stride=1, padding=1) > 0
            fine = dilated[0, 0].repeat_interleave(s, 0).repeat_interleave(
                s, 1)[:height, :width]
            hit = fine.reshape(-1)
        else:
            starts, dirs, near, far, _ = sampler.camera_ray_geometry(
                camera, offsets)
            _, _, hit = sampler._probe_cdf_geometry(starts, dirs, near, far)
        return hit & valid

    @torch.no_grad()
    def render_frame_async(self, sampler: RaySampler, camera: int,
                           chunk_size: int = 16384,
                           cull_empty: bool = True,
                           probe_subsample: int = 2) -> torch.Tensor:
        """Renders one camera frame and returns it as an (H, W, 3) uint8
        tensor on the render device, without a host copy.

        With ``cull_empty`` and a sampler that probes occupancy
        (:class:`OccupancyGridSampler`), rays whose probes all miss are
        never sent to the model and render black. Invalid rays (missing
        the volume) render black.
        """
        camera = camera % sampler.num_cameras
        rays_per_cam = sampler.rays_per_camera
        device = sampler.device
        cull = cull_empty and hasattr(sampler, "_probe_cdf_geometry")
        if cull:
            probe_subsample = self._safe_probe_subsample(sampler,
                                                         probe_subsample)
            mask = self._compute_hit(sampler, camera, probe_subsample)
            # the stable partition: hit rays in pixel order. nonzero()
            # reads the hit count on the host, once per frame; the JAX
            # package instead keeps a fixed chunk count and skips empty
            # chunks with lax.cond
            ray_offsets = torch.nonzero(mask).reshape(-1)
        else:
            ray_offsets = torch.arange(rays_per_cam, device=device)
            mask = sampler.camera_ray_geometry(camera, ray_offsets)[4]
        colors = torch.zeros(rays_per_cam, 3, device=device)
        for start in range(0, ray_offsets.shape[0], chunk_size):
            chunk = ray_offsets[start:start + chunk_size]
            colors[chunk] = self._render_rays(sampler, camera, chunk)
        colors = torch.where(mask[:, None], colors, 0.0)
        image = torch.clamp(colors, 0.0, 1.0).reshape(
            sampler.image_height, sampler.image_width, 3)
        return (image * 255.0).to(torch.uint8)   # truncates, as the JAX frame

    def render_frame(self, sampler: RaySampler, camera: int,
                     chunk_size: int = 16384, cull_empty: bool = True,
                     probe_subsample: int = 2) -> np.ndarray:
        """:meth:`render_frame_async`, copied to a host (H, W, 3) uint8
        array."""
        return self.render_frame_async(sampler, camera, chunk_size,
                                       cull_empty,
                                       probe_subsample).cpu().numpy()
