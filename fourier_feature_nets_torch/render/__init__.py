"""Ray samplers and the raycaster of the render path."""

from .occupancy_sampler import (
    OccupancyGridSampler,
    density_grid_from_model,
    occupancy_grid_from_tree,
)
from .octree_sampler import OctreeRaySampler
from .ray_sampler import RaySampler, RaySamples
from .raycaster import Raycaster, RenderResult

__all__ = ["OccupancyGridSampler", "OctreeRaySampler", "RaySampler",
           "RaySamples", "Raycaster", "RenderResult",
           "density_grid_from_model", "occupancy_grid_from_tree"]
