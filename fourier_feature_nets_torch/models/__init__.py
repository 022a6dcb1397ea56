"""Models of the port: the NeRF, the Fourier Feature MLP family, the
dense and factorized voxel fields and Instant-NGP's hash-grid NeRF."""

from .factorized import FactorizedVoxels
from .fourier import (
    MLP,
    BasicFourierMLP,
    FourierFeatureMLP,
    GaussianFourierMLP,
    PositionalFourierMLP,
)
from .hash_grid import HashGridNeRF, instant_ngp
from .module import Linear, linear_apply, mlp_apply, mlp_layers, query_model
from .nerf import NeRF, flagship_nerf
from .serialization import (
    build_model,
    load_model,
    load_torch_model,
    params_from_jax,
    params_to_jax,
    save_model,
    save_torch_model,
)
from .voxels import Voxels

__all__ = ["BasicFourierMLP", "FactorizedVoxels", "FourierFeatureMLP",
           "GaussianFourierMLP", "HashGridNeRF", "Linear", "MLP", "NeRF",
           "PositionalFourierMLP", "Voxels", "build_model", "flagship_nerf",
           "instant_ngp", "linear_apply", "load_model", "load_torch_model", "mlp_apply",
           "mlp_layers", "params_from_jax", "params_to_jax", "query_model",
           "save_model", "save_torch_model"]
