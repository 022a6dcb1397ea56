"""Plain PyTorch ops of the render path (the kernels live in
:mod:`fourier_feature_nets_torch.kernels`)."""

from .blend import calculate_blend_weights, exclusive_cumprod
from .encoding import encode_phases, positional_encoding_matrix
from .intersection import NearFar, bounds_min_max, ray_aabb_near_far
from .sampling import (
    anneal_near_far,
    batch_linspace,
    inverse_cdf_from_bins,
    per_ray_uniform,
    uniform_t_values,
    unit_linspace,
)

__all__ = [
    "NearFar",
    "anneal_near_far",
    "batch_linspace",
    "bounds_min_max",
    "calculate_blend_weights",
    "encode_phases",
    "exclusive_cumprod",
    "inverse_cdf_from_bins",
    "per_ray_uniform",
    "positional_encoding_matrix",
    "ray_aabb_near_far",
    "uniform_t_values",
    "unit_linspace",
]
