"""Occupancy-grid accelerated ray sampling.

Port of ``occupancy_grid_from_tree``, ``density_grid_from_model`` and
``OccupancyGridSampler`` from
``fourier_feature_nets_tpu/render/occupancy_sampler.py``. A dense 0/1
occupancy volume (rasterized from an octree, :meth:`from_tree`, or from
the model's own density field, :meth:`from_model`) places samples by

  1. probing P uniform depths along each ray,
  2. building a per-ray CDF weighted by probe occupancy,
  3. inverse-transform sampling the per-ray budget from that CDF.

The JAX package's default probe reads a max-pooled ``probe_resolution``
cubed table through a one-hot matmul, because dynamic gathers are slow
on a TPU. Here the probe is a gather from the SAME max-pooled table, so
the CDF weights match the JAX default (``probe_mode="matmul"``) exactly.
``probe_mode="gather"`` reads the exact ``grid_resolution`` grid instead,
and ``trilinear`` interpolates it (``F.grid_sample`` in 3-D, border
clamping, ``align_corners=False``, the clamping of the JAX package's
``grid_sample_3d`` and of the port's ``Voxels``); their CDF weights are
the JAX modes' too.
The culling signal (``hit``) is conservative at cell faces: a probe
within ``FACE_DELTA`` cells of a face also counts the occupancy of the
cell across it, so a ray's flag does not turn on how its f32 geometry
was rounded (the JAX package computes it in one XLA program, the port
op by op); off such probes it is the gather of the table the mode reads
(the max-pooled one by default, the exact grid with ``"gather"``). With
``trilinear`` a probe counts when any cell within one of its own is
occupied: every cell its interpolation can weigh, however the probe's
position rounds (a superset of the JAX flag, ``occupancy > 0``).
A stratified sampler
draws one jittered CDF quantile per stratum when :meth:`sample` is
given a key, as occupancy-guided training does. Refreshing the grid at
its resolution rewrites the tables in place
(:meth:`OccupancyGridSampler.set_occupancy_grid`), so a CUDA graph
that captured a step through this sampler reads the new grid.
"""

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..cameras import CameraInfo
from ..models.module import query_model
from ..octree import OcTree
from ..ops.sampling import (
    batch_linspace,
    inverse_cdf_from_bins,
    per_ray_uniform,
)
from .ray_sampler import RaySampler, RaySamples

__all__ = ["FACE_DELTA", "occupancy_grid_from_tree", "density_grid_from_model",
           "OccupancyGridSampler"]

# How close (in cells of the probe table) a probe must lie to a cell face
# for the hit flag to count the cell across it too: 10x the largest gap
# measured between the JAX package's and the port's f32 probe positions
# on the same rays (1e-5 cells).
FACE_DELTA = 1e-4


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def occupancy_grid_from_tree(tree: OcTree, resolution: int = 64,
                             dilate: int = 1) -> np.ndarray:
    """Rasterizes octree occupancy into a dense (R, R, R) 0/1 volume,
    indexed [z, y, x]: cell centers are point-queried against the tree
    (C++ library), then occupancy grows by ``dilate`` cells in every
    direction so surfaces near cell borders are never missed."""
    coords = (np.arange(resolution) + 0.5) / resolution * 2 - 1
    coords = coords * tree.scale
    zz, yy, xx = np.meshgrid(coords, coords, coords, indexing="ij")
    points = np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.float32)
    occupied = (tree.query(points) >= 0).astype(np.float32)
    grid = occupied.reshape(resolution, resolution, resolution)

    for _ in range(dilate):
        padded = np.pad(grid, 1)
        grown = grid.copy()
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    grown = np.maximum(
                        grown,
                        padded[1 + dz:1 + dz + resolution,
                               1 + dy:1 + dy + resolution,
                               1 + dx:1 + dx + resolution])
        grid = grown
    return grid


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
        out = query_model(model, points, torch.zeros_like(points))
        sigma = F.softplus(out[:, 3])
        cell = 2.0 * scale / resolution
        alpha = 1.0 - torch.exp(-sigma * cell)
    return (alpha > alpha_threshold).float().cpu().numpy().reshape(
        resolution, resolution, resolution)


def _neighbour_masks(table: np.ndarray) -> np.ndarray:
    """(side^3,) int32 masks of a (side, side, side) probe table: bit
    ``(dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)`` of a cell is set when the
    cell at offset (dz, dy, dx), each in {-1, 0, 1}, is occupied (an
    offset out of the table reads the cell itself, as a clamped index
    does)."""
    side = table.shape[0]
    padded = np.pad(table > 0, 1, mode="edge")
    masks = np.zeros((side, side, side), np.int32)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                bit = np.int32(1 << (dz * 9 + dy * 3 + dx))
                masks |= np.where(padded[dz:dz + side, dy:dy + side,
                                         dx:dx + side], bit, np.int32(0))
    return masks.reshape(-1)


def _face_queries() -> np.ndarray:
    """(27,) int32: for a point's steps (sz, sy, sx), each in {-1, 0, 1}
    (the face it is near on that axis, if any), at index ``(sz + 1) * 9 +
    (sy + 1) * 3 + (sx + 1)``, the neighbour-mask bits of the cells it
    reads: every offset in {0, sz} x {0, sy} x {0, sx}."""
    queries = np.zeros(27, np.int32)
    for sz in (-1, 0, 1):
        for sy in (-1, 0, 1):
            for sx in (-1, 0, 1):
                for dz in {0, sz}:
                    for dy in {0, sy}:
                        for dx in {0, sx}:
                            queries[(sz + 1) * 9 + (sy + 1) * 3 + sx + 1] |= (
                                1 << ((dz + 1) * 9 + (dy + 1) * 3 + dx + 1))
    return queries


_FACE_QUERIES = _face_queries()


class OccupancyGridSampler(RaySampler):
    """RaySampler that concentrates samples in occupied space using a
    dense occupancy volume (see :meth:`from_tree` and
    :meth:`from_model`)."""

    def __init__(self, occupancy_grid: np.ndarray, grid_scale: float,
                 cameras: List[CameraInfo], num_samples: int,
                 num_probes: int = 32, empty_weight: float = 1e-2,
                 bounds: Optional[np.ndarray] = None,
                 probe_resolution: int = 32, device="cpu",
                 stratified: bool = False, trilinear: bool = False,
                 probe_mode: str = "matmul"):
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
            stratified: jitter the CDF quantiles when :meth:`sample` is
                given a key (occupancy-guided training).
            trilinear: interpolate the grid's occupancy (8 reads a
                probe) instead of reading a cell; overrides
                ``probe_mode``.
            probe_mode: "matmul" (the JAX package's default) reads the
                max-pooled table, "gather" the exact grid.
        """
        if probe_mode not in ("matmul", "gather"):
            raise ValueError(f"probe_mode {probe_mode!r}: 'matmul' or "
                             "'gather'")
        if bounds is None:
            side = 2 * grid_scale
            bounds = np.diag([side, side, side, 1.0]).astype(np.float32)
        super().__init__(bounds, cameras, num_samples, device,
                         stratified=stratified)
        self.num_probes = num_probes
        self.empty_weight = empty_weight
        self.trilinear = trilinear
        self.probe_mode = probe_mode
        self._grid_scale = float(grid_scale)
        grid = np.asarray(occupancy_grid, np.float32)
        self._probe_target = min(probe_resolution, int(grid.shape[0]))
        self.set_occupancy_grid(grid)

    def set_occupancy_grid(self, grid: np.ndarray) -> None:
        """(Re)installs the occupancy volume, its max-pooled probe table
        (max-pooling only ever grows occupancy) and the neighbour masks
        of the table the hit flag reads (the max-pooled one, or the grid
        in the ``"gather"`` and ``trilinear`` modes).

        A grid of the installed resolution is copied into the existing
        tensors, which keep their storage: a CUDA graph captured
        through this sampler reads the new occupancy at its next replay
        (the counterpart of the JAX package's refresh without a
        recompile). Another resolution allocates new tensors, which a
        captured graph does not see."""
        grid = np.asarray(grid, np.float32)
        grid_resolution = int(grid.shape[0])
        side = min(self._probe_target, grid_resolution)
        factor = grid_resolution // side
        side = grid_resolution // factor
        coarse = grid.reshape(side, factor, side, factor,
                              side, factor).max((1, 3, 5))
        # flat cell id = (z * side + y) * side + x
        table = np.ascontiguousarray(coarse.reshape(-1))
        exact = self.trilinear or self.probe_mode == "gather"
        neighbours = torch.from_numpy(_neighbour_masks(grid if exact
                                                       else coarse))
        occupancy = getattr(self, "occupancy", None)
        if occupancy is not None and occupancy.shape == grid.shape:
            occupancy.copy_(torch.from_numpy(grid))
            self.probe_table.copy_(torch.from_numpy(table))
            self.neighbour_table.copy_(neighbours)
            return
        self._grid_resolution = grid_resolution
        self._probe_resolution = side
        self._hit_resolution = grid_resolution if exact else side
        self.occupancy = torch.from_numpy(grid).to(self.device)
        self.probe_table = torch.from_numpy(table).to(self.device)
        self.neighbour_table = neighbours.to(self.device)
        self._face_queries = torch.from_numpy(_FACE_QUERIES).to(self.device)

    @classmethod
    def from_tree(cls, tree: OcTree, cameras: List[CameraInfo],
                  num_samples: int, grid_resolution: int = 64,
                  num_probes: int = 32, empty_weight: float = 1e-2,
                  bounds: Optional[np.ndarray] = None,
                  probe_resolution: int = 32,
                  device="cpu", **kwargs) -> "OccupancyGridSampler":
        """Sampler guided by an octree (e.g. ``voxelize_model``'s),
        rasterized at ``grid_resolution`` over the tree's cube, with the
        JAX constructor's defaults; ``kwargs`` go to the constructor."""
        grid = occupancy_grid_from_tree(tree, grid_resolution)
        return cls(grid, tree.scale, cameras, num_samples,
                   num_probes=num_probes, empty_weight=empty_weight,
                   bounds=bounds, probe_resolution=probe_resolution,
                   device=device, **kwargs)

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

    def _cells(self, points: torch.Tensor,
               side: Optional[int] = None) -> torch.Tensor:
        """(..., 3) world points -> their (N, 3) f32 coordinates in
        cells of a table of ``side`` cells an axis (default: the probe
        table's)."""
        side = self._probe_resolution if side is None else side
        return (points.reshape(-1, 3) / self._grid_scale + 1.0) * 0.5 * side

    def _table_at(self, x: torch.Tensor, y: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
        """The probe table at (N,) int64 cell indices, each clamped."""
        side = self._probe_resolution
        x, y, z = (torch.clamp(c, 0, side - 1) for c in (x, y, z))
        return self.probe_table[(z * side + y) * side + x]

    def _occupancy_at(self, points: torch.Tensor) -> torch.Tensor:
        """The CDF's occupancy at (..., 3) world points: of the cell each
        point's f32 position truncates into, in the max-pooled table or
        (``"gather"``) the grid; or (``trilinear``) the grid
        interpolated."""
        shape = points.shape[:-1]
        if self.trilinear:
            coords = (points / self._grid_scale).reshape(1, 1, 1, -1, 3)
            return F.grid_sample(self.occupancy[None, None], coords,
                                 mode="bilinear", padding_mode="border",
                                 align_corners=False).reshape(shape)
        if self.probe_mode == "gather":
            res = self._grid_resolution
            cell = torch.clamp(self._cells(points, res).to(torch.int64), 0,
                               res - 1)
            x, y, z = cell.unbind(-1)
            return self.occupancy.reshape(-1)[
                (z * res + y) * res + x].reshape(shape)
        cell = self._cells(points, self._probe_resolution).to(torch.int64)
        return self._table_at(*cell.unbind(-1)).reshape(shape)

    def _occupied_near(self, points: torch.Tensor) -> torch.Tensor:
        """The hit flag's occupancy at (..., 3) world points: whether a
        cell within ``FACE_DELTA`` of each point is occupied. On an axis
        where a point lies that close to a face, the cell across it
        counts too (up to 8 cells at a corner); elsewhere only the
        point's own cell, :meth:`_occupancy_at`'s. One read of the own
        cell's neighbour mask (:func:`_neighbour_masks`) and one of the
        query mask of the faces the point is near (``_FACE_QUERIES``).
        The table is the max-pooled one, or the grid in the ``"gather"``
        and ``trilinear`` modes; with ``trilinear`` every cell within one
        of the point's own counts (any bit of its neighbour mask)."""
        side = self._hit_resolution
        cell = self._cells(points, side)
        own = cell.to(torch.int64)
        if self.trilinear:
            x, y, z = torch.clamp(own, 0, side - 1).unbind(-1)
            return (self.neighbour_table[(z * side + y) * side + x]
                    != 0).reshape(points.shape[:-1])
        frac = cell - own
        # -1 / +1 on an axis where the point is within FACE_DELTA of the
        # lower / upper face of its cell, then kept inside the table
        step = ((frac > 1.0 - FACE_DELTA).to(torch.int64)
                - (frac < FACE_DELTA).to(torch.int64))
        across = torch.clamp(own + step, 0, side - 1)
        own = torch.clamp(own, 0, side - 1)
        step = across - own + 1
        x, y, z = own.unbind(-1)
        sx, sy, sz = step.unbind(-1)
        masks = self.neighbour_table[(z * side + y) * side + x]
        queries = self._face_queries[(sz * 3 + sy) * 3 + sx]
        return ((masks & queries) != 0).reshape(points.shape[:-1])

    def _probe_positions(self, starts, directions, near, far):
        """The probes of explicit ray geometry: (R, P+1) bin edges and
        the (R, P, 3) positions of the bin midpoints."""
        edges = batch_linspace(near, far, self.num_probes + 1)
        mids = 0.5 * (edges[..., :-1] + edges[..., 1:])
        return edges, (starts[:, None, :]
                       + mids[..., None] * directions[:, None, :])

    def _probe_cdf_geometry(self, starts, directions, near, far):
        """Probes occupancy along explicit ray geometry.

        Returns:
            (edges, cdf, hit): (R, P+1) probe bin edges, (R, P+1)
            occupancy-weighted CDF over them, and an (R,) bool marking
            rays with a probe in or within ``FACE_DELTA`` cells of an
            occupied cell (the empty-space-culling signal).
        """
        edges, probe_pos = self._probe_positions(starts, directions, near,
                                                 far)
        hit = self._occupied_near(probe_pos).amax(dim=-1) > 0
        return edges, self._cdf(edges, self._occupancy_at(probe_pos)), hit

    def _cdf(self, edges, occ):
        """(R, P+1) occupancy-weighted CDF over the probe bins."""
        lengths = edges[..., 1:] - edges[..., :-1]
        weights = lengths * (occ + self.empty_weight) + 1e-12
        cdf = torch.cumsum(weights, dim=-1)
        cdf = cdf / cdf[..., -1:]
        return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    def t_from_cdf(self, edges: torch.Tensor, cdf: torch.Tensor,
                   idx: Optional[torch.Tensor] = None, step=None,
                   rng=None) -> torch.Tensor:
        """The per-ray sample budget from a probe CDF: at evenly spaced
        quantiles, or, for a stratified sampler given a key, at one
        jittered quantile per stratum, ``(k + u) / n`` with ``u`` drawn
        by :func:`~..ops.per_ray_uniform` from the global ray ids
        ``idx`` (salt 2, as the JAX sampler keys it)."""
        jitter = None
        if self.stratified and rng is not None and idx is not None:
            jitter = per_ray_uniform(rng, 0 if step is None else step, idx,
                                     self.num_samples, salt=2)
        return inverse_cdf_from_bins(edges, cdf, self.num_samples,
                                     jitter=jitter)

    def _sample_geometry(self, starts, directions, near, far, idx,
                         step=None, rng=None, cdf_rows=None):
        # placement follows the probe CDF alone (no annealing, no focus
        # tables, so a free pose needs no table of the rig); the
        # quantiles are jittered only for a stratified sampler given a
        # key, as in training (:meth:`RaySampler.sample`)
        edges, probe_pos = self._probe_positions(starts, directions, near,
                                                 far)
        cdf = self._cdf(edges, self._occupancy_at(probe_pos))
        t_values = self.t_from_cdf(edges, cdf, idx, step, rng)
        positions = (starts[:, None, :]
                     + t_values[..., None] * directions[:, None, :])
        view_directions = directions[:, None, :].expand(positions.shape)
        return RaySamples(positions, view_directions, t_values, idx)
