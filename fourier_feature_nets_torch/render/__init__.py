"""Ray samplers, the raycaster, the render server and distillation."""

from .distill import distill
from .occupancy_sampler import (
    OccupancyGridSampler,
    density_grid_from_model,
    occupancy_grid_from_tree,
)
from .octree_sampler import OctreeRaySampler
from .ray_sampler import RaySampler, RaySamples
from .raycaster import Raycaster, RenderResult
from .server import RenderServer

__all__ = ["OccupancyGridSampler", "OctreeRaySampler", "RaySampler",
           "RaySamples", "Raycaster", "RenderResult", "RenderServer",
           "density_grid_from_model", "distill", "occupancy_grid_from_tree"]
