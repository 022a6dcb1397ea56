"""PyTorch port of ``fourier_feature_nets_tpu`` for NVIDIA Hopper GPUs.

The JAX package beside this one is the reference. The port imports
``torch`` and NumPy and never ``jax``; importing it needs no CUDA. Its
kernels (:mod:`.kernels`) are hand-written CUDA built at first use.
"""

from .models import NeRF, flagship_nerf, load_model, save_model
from .render import OccupancyGridSampler, Raycaster, RaySampler

__all__ = ["NeRF", "OccupancyGridSampler", "RaySampler", "Raycaster",
           "flagship_nerf", "load_model", "save_model"]
