"""Occupancy-grid accelerated ray sampling.

Port of ``density_grid_from_model`` and ``OccupancyGridSampler`` from
``fourier_feature_nets_tpu/render/occupancy_sampler.py``. A dense 0/1
occupancy volume (here from the model's own density field) places
samples by

  1. probing P uniform depths along each ray,
  2. building a per-ray CDF weighted by probe occupancy,
  3. inverse-transform sampling the per-ray budget from that CDF.

The JAX package's default probe reads a max-pooled ``probe_resolution``
cubed table through a one-hot matmul, because dynamic gathers are slow
on a TPU. Here the probe is a gather from the SAME max-pooled table, so
the hit sets match the JAX default (``probe_mode="matmul"``) exactly.
"""

from typing import List, Optional

import numpy as np
import torch

from ..cameras import CameraInfo
from ..ops.sampling import batch_linspace, inverse_cdf_from_bins
from .ray_sampler import RaySampler, RaySamples

__all__ = ["density_grid_from_model", "OccupancyGridSampler"]


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def density_grid_from_model(model, resolution: int = 64,
                            scale: float = 1.0,
                            alpha_threshold: float = 1e-3) -> np.ndarray:
    """Occupancy volume from a model's own density field.

    Evaluates opacity at the (R, R, R) cell centers in f32 on the
    model's device and thresholds per-cell alpha
    ``1 - exp(-softplus(sigma) * cell)``.
    """
    device = _model_device(model)
    centers = (np.arange(resolution) + 0.5) / resolution * 2 - 1
    centers = centers * scale
    zz, yy, xx = np.meshgrid(centers, centers, centers, indexing="ij")
    points = torch.from_numpy(
        np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.float32)
    ).to(device)
    with torch.no_grad():
        out = model(points, torch.zeros_like(points))
        sigma = torch.nn.functional.softplus(out[:, 3])
        cell = 2.0 * scale / resolution
        alpha = 1.0 - torch.exp(-sigma * cell)
    return (alpha > alpha_threshold).float().cpu().numpy().reshape(
        resolution, resolution, resolution)


class OccupancyGridSampler(RaySampler):
    """RaySampler that concentrates samples in occupied space using a
    dense occupancy volume (see :meth:`from_model`)."""

    def __init__(self, occupancy_grid: np.ndarray, grid_scale: float,
                 cameras: List[CameraInfo], num_samples: int,
                 num_probes: int = 32, empty_weight: float = 1e-2,
                 bounds: Optional[np.ndarray] = None,
                 probe_resolution: int = 32, device="cpu"):
        """Constructor.

        Args:
            occupancy_grid: (R, R, R) 0/1 volume over [-scale, scale]^3,
                indexed [z, y, x].
            grid_scale: half side of the volume the grid covers.
            cameras: scene cameras.
            num_samples: samples per ray.
            num_probes: uniform depth probes per ray for the CDF.
            empty_weight: relative mass of unoccupied probes.
            bounds: render volume; defaults to the grid's cube.
            probe_resolution: side of the max-pooled table the probes
                read (clamped to the grid resolution).
            device: where the tables and samples live.
        """
        if bounds is None:
            side = 2 * grid_scale
            bounds = np.diag([side, side, side, 1.0]).astype(np.float32)
        super().__init__(bounds, cameras, num_samples, device)
        self.num_probes = num_probes
        self.empty_weight = empty_weight
        self._grid_scale = float(grid_scale)
        grid = np.asarray(occupancy_grid, np.float32)
        self._probe_target = min(probe_resolution, int(grid.shape[0]))
        self.set_occupancy_grid(grid)

    def set_occupancy_grid(self, grid: np.ndarray) -> None:
        """(Re)installs the occupancy volume and its max-pooled probe
        table (max-pooling only ever grows occupancy)."""
        grid = np.asarray(grid, np.float32)
        grid_resolution = int(grid.shape[0])
        self._grid_resolution = grid_resolution
        self.occupancy = torch.from_numpy(grid).to(self.device)

        side = min(self._probe_target, grid_resolution)
        factor = grid_resolution // side
        side = grid_resolution // factor
        coarse = grid.reshape(side, factor, side, factor,
                              side, factor).max((1, 3, 5))
        self._probe_resolution = side
        # flat cell id = (z * side + y) * side + x
        self.probe_table = torch.from_numpy(
            np.ascontiguousarray(coarse.reshape(-1))).to(self.device)

    @classmethod
    def from_model(cls, model, cameras: List[CameraInfo], num_samples: int,
                   grid_resolution: int = 64,
                   alpha_threshold: float = 1e-3,
                   empty_weight: float = 0.1,
                   scale: float = 1.0,
                   bounds: Optional[np.ndarray] = None,
                   **kwargs) -> "OccupancyGridSampler":
        """Sampler guided by the model's own density field, with its
        tables on the model's device. ``empty_weight`` defaults higher
        than for an octree grid (0.1 vs 1e-2): density grids are exact
        where the model is, and starving empty bins was the measured
        failure mode of over-concentration."""
        grid = density_grid_from_model(model, grid_resolution, scale,
                                       alpha_threshold)
        kwargs.setdefault("device", _model_device(model))
        return cls(grid, scale, cameras, num_samples,
                   empty_weight=empty_weight, bounds=bounds, **kwargs)

    def _occupancy_at(self, points: torch.Tensor) -> torch.Tensor:
        """Occupancy of the max-pooled table at (..., 3) world points."""
        side = self._probe_resolution
        flat_pts = points.reshape(-1, 3)
        cell = torch.clamp(
            ((flat_pts / self._grid_scale + 1.0) * 0.5 * side)
            .to(torch.int64), 0, side - 1)
        flat = (cell[:, 2] * side + cell[:, 1]) * side + cell[:, 0]
        return self.probe_table[flat].reshape(points.shape[:-1])

    def _probe_cdf_geometry(self, starts, directions, near, far):
        """Probes occupancy along explicit ray geometry.

        Returns:
            (edges, cdf, hit): (R, P+1) probe bin edges, (R, P+1)
            occupancy-weighted CDF over them, and an (R,) bool marking
            rays whose probes touched any occupied cell (the
            empty-space-culling signal).
        """
        edges = batch_linspace(near, far, self.num_probes + 1)
        mids = 0.5 * (edges[..., :-1] + edges[..., 1:])
        probe_pos = (starts[:, None, :]
                     + mids[..., None] * directions[:, None, :])
        occ = self._occupancy_at(probe_pos)
        hit = occ.amax(dim=-1) > 0

        lengths = edges[..., 1:] - edges[..., :-1]
        weights = lengths * (occ + self.empty_weight) + 1e-12
        cdf = torch.cumsum(weights, dim=-1)
        cdf = cdf / cdf[..., -1:]
        cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
        return edges, cdf, hit

    def t_from_cdf(self, edges: torch.Tensor,
                   cdf: torch.Tensor) -> torch.Tensor:
        """The per-ray sample budget at evenly spaced CDF quantiles."""
        return inverse_cdf_from_bins(edges, cdf, self.num_samples)

    def _sample_geometry(self, starts, directions, near, far, idx,
                         step=None, rng=None):
        # deterministic render-time placement: no jitter or annealing
        edges, cdf, _ = self._probe_cdf_geometry(starts, directions,
                                                 near, far)
        t_values = self.t_from_cdf(edges, cdf)
        positions = (starts[:, None, :]
                     + t_values[..., None] * directions[:, None, :])
        view_directions = directions[:, None, :].expand(positions.shape)
        return RaySamples(positions, view_directions, t_values, idx)
