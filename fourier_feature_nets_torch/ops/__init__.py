"""Plain PyTorch ops of the render path (the kernels live in
:mod:`fourier_feature_nets_torch.kernels`)."""

from .blend import (
    blend_weights_prefix,
    blend_weights_suffix,
    calculate_blend_weights,
    exclusive_cumprod,
)
from .encoding import (
    basic_encoding_matrix,
    encode_phases,
    fourier_encode,
    gaussian_encoding_matrix,
    positional_encoding_matrix,
)
from .interpolation import interpolate_bilinear
from .intersection import NearFar, bounds_min_max, ray_aabb_near_far
from .metrics import mse, psnr, psnr_from_mse
from .sampling import (
    anneal_near_far,
    batch_linspace,
    determine_cdf,
    inverse_cdf_from_bins,
    inverse_cdf_t_values,
    merge_sorted,
    per_ray_uniform,
    sample_positions,
    uniform_t_values,
    unit_linspace,
)

__all__ = [
    "NearFar",
    "anneal_near_far",
    "basic_encoding_matrix",
    "batch_linspace",
    "blend_weights_prefix",
    "blend_weights_suffix",
    "bounds_min_max",
    "calculate_blend_weights",
    "determine_cdf",
    "encode_phases",
    "exclusive_cumprod",
    "fourier_encode",
    "gaussian_encoding_matrix",
    "inverse_cdf_from_bins",
    "interpolate_bilinear",
    "inverse_cdf_t_values",
    "merge_sorted",
    "mse",
    "per_ray_uniform",
    "positional_encoding_matrix",
    "psnr",
    "psnr_from_mse",
    "ray_aabb_near_far",
    "sample_positions",
    "uniform_t_values",
    "unit_linspace",
]
