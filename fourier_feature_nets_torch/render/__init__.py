"""Ray samplers and the raycaster of the render path."""

from .occupancy_sampler import OccupancyGridSampler, density_grid_from_model
from .ray_sampler import RaySampler, RaySamples
from .raycaster import Raycaster, RenderResult

__all__ = ["OccupancyGridSampler", "RaySampler", "RaySamples", "Raycaster",
           "RenderResult", "density_grid_from_model"]
