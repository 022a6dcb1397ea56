"""Ray/AABB slab intersection.

Port of ``fourier_feature_nets_tpu/ops/intersection.py``: every ray
gets clamped near/far depths and a boolean ``valid`` mask, so shapes
stay static.
"""

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["NearFar", "ray_aabb_near_far", "bounds_min_max"]


class NearFar(NamedTuple):
    """Entry/exit depths and validity for each ray."""

    near: torch.Tensor
    far: torch.Tensor
    valid: torch.Tensor


def bounds_min_max(bounds: np.ndarray):
    """AABB corners of a unit cube transformed by ``bounds``: the
    images of (-0.5, -0.5, -0.5) and (0.5, 0.5, 0.5)."""
    bounds = np.asarray(bounds, np.float32)
    lo = bounds @ np.array([-0.5, -0.5, -0.5, 1], np.float32)
    hi = bounds @ np.array([0.5, 0.5, 0.5, 1], np.float32)
    return lo[:3], hi[:3]


def ray_aabb_near_far(starts: torch.Tensor, directions: torch.Tensor,
                      bounds_min: torch.Tensor, bounds_max: torch.Tensor,
                      min_near: float = 0.1) -> NearFar:
    """Intersects rays with an axis-aligned box via the slab method.

    Args:
        starts: (..., 3) ray origins.
        directions: (..., 3) ray directions (need not be normalized).
        bounds_min: (3,) minimum box corner.
        bounds_max: (3,) maximum box corner.
        min_near: valid rays have their near plane clamped to at least
            this value.

    Returns:
        NearFar with (...,) near, far and valid (near < far before
        clamping). x/0 gives +/-inf, which flows through the
        max-of-mins / min-of-maxes reduction. 0/0 (an origin on a slab
        plane with a zero direction component on that axis) marks the
        ray invalid, while near/far stay free of NaN.
    """
    t0 = (bounds_min - starts) / directions
    t1 = (bounds_max - starts) / directions
    degenerate = torch.any(torch.isnan(t0) | torch.isnan(t1), dim=-1)
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    near = torch.where(torch.isnan(near), -torch.inf, near)
    far = torch.where(torch.isnan(far), torch.inf, far)
    near = near.amax(dim=-1)
    far = far.amin(dim=-1)
    valid = (near < far) & ~degenerate
    near = torch.where(valid, torch.clamp(near, min=min_near), near)
    return NearFar(near, far, valid)
