"""Octree-guided ray sampling (empty-space skipping).

Port of ``fourier_feature_nets_tpu/render/octree_sampler.py``: rays are
marched through a sparse octree in torch on the sampler's device
(:func:`..octree.traversal.device_batch_intersect`), and each ray's
sample budget is drawn by inverse-transform sampling over the traversal
intervals, with occupied leaves weighted 1 / ``empty_weight`` over empty
space. The sampler has no occupancy probe, so ``render_frame`` does not
cull its frames.
"""

from typing import List, Optional

import numpy as np
import torch

from ..cameras import CameraInfo
from ..octree import OcTree
from ..octree.traversal import device_batch_intersect
from ..ops.sampling import (
    inverse_cdf_from_bins,
    per_ray_uniform,
    sample_positions,
)
from .ray_sampler import RaySampler, RaySamples

__all__ = ["OctreeRaySampler", "occupancy_t_values"]


def occupancy_t_values(t_stops: torch.Tensor, leaves: torch.Tensor,
                       num_samples: int, empty_weight: float = 1e-3,
                       quantiles: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Sample depths concentrated in occupied tree intervals.

    Args:
        t_stops: (R, L) interval entry depths from the tree tracer.
        leaves: (R, L) leaf index per interval (-1 = empty space).
        num_samples: samples per ray.
        empty_weight: relative sampling mass of empty intervals
            (nonzero so the renderer can still correct false negatives
            of the tree).
        quantiles: optional sorted (R, num_samples) quantiles in [0, 1];
            default is evenly spaced ones.

    Returns:
        (R, num_samples) sorted t values.
    """
    lengths = torch.clamp(t_stops[:, 1:] - t_stops[:, :-1], min=0.0)
    occupied = leaves[:, :-1] >= 0
    weights = lengths * torch.where(occupied, 1.0, empty_weight) + 1e-12
    cdf = torch.cumsum(weights, dim=-1)
    cdf = cdf / cdf[:, -1:]
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    return inverse_cdf_from_bins(t_stops, cdf, num_samples, quantiles)


class OctreeRaySampler(RaySampler):
    """RaySampler whose sample placement skips empty space using a
    sparse octree."""

    def __init__(self, tree: OcTree, cameras: List[CameraInfo],
                 num_samples: int, stratified: bool = False,
                 max_length: int = 64, empty_weight: float = 1e-3,
                 bounds: Optional[np.ndarray] = None, device="cpu"):
        """Constructor.

        Args:
            tree: occupancy octree (e.g. from ``voxelize_model``).
            cameras: scene cameras.
            num_samples: samples per ray.
            stratified: jitter the occupancy quantiles when
                :meth:`sample` is given a key.
            max_length: maximum tree intervals recorded per ray.
            empty_weight: relative mass of empty intervals.
            bounds: render volume transform; defaults to the tree's
                cube.
            device: where the tree's id tensors and the samples live.
        """
        if bounds is None:
            side = 2 * tree.scale
            bounds = np.diag([side, side, side, 1.0]).astype(np.float32)
        super().__init__(bounds, cameras, num_samples, device,
                         stratified=stratified)
        self.tree = tree
        self.max_length = max_length
        self.empty_weight = empty_weight
        self._node_index, self._leaf_index = tree.index_tensors(self.device)
        self._tree_scale = float(tree.scale)
        self._tree_depth = tree.depth

    def _sample_geometry(self, starts, directions, near, far, idx,
                         step=None, rng=None, cdf_rows=None):
        # no annealing or focus tables: placement comes from the tree, so
        # a free pose needs no table of the rig
        path = device_batch_intersect(
            self._node_index, self._leaf_index, starts, directions,
            scale=self._tree_scale, max_depth=self._tree_depth,
            max_length=self.max_length)
        quantiles = None
        if self.stratified and rng is not None:
            # keyed by ray id, not batch slot (ops.per_ray_uniform)
            jitter = per_ray_uniform(rng, step or 0, idx, self.num_samples)
            strata = torch.arange(self.num_samples, dtype=jitter.dtype,
                                  device=jitter.device)
            quantiles = (strata + jitter) / self.num_samples
        t_values = occupancy_t_values(path.t_stops, path.leaves,
                                      self.num_samples, self.empty_weight,
                                      quantiles)
        # clamp into the render volume's near/far
        t_values = torch.clamp(t_values, near[:, None], far[:, None])
        positions = sample_positions(starts, directions, t_values)
        view_directions = directions[:, None, :].expand(positions.shape)
        return RaySamples(positions, view_directions, t_values, idx)
