"""Models of the port."""

from .module import Linear, linear_apply
from .nerf import NeRF, flagship_nerf
from .serialization import load_model, params_from_jax, params_to_jax, save_model

__all__ = ["Linear", "NeRF", "flagship_nerf", "linear_apply", "load_model",
           "params_from_jax", "params_to_jax", "save_model"]
