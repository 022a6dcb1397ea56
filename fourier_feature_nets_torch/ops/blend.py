"""Volume-rendering blend weights.

Port of ``exclusive_cumprod`` and ``calculate_blend_weights`` from
``fourier_feature_nets_tpu/ops/blend.py``: the final sample's delta is
an effectively infinite 1e10, and transmittance is the exclusive
cumulative product of ``min(1, 1 - alpha + 1e-10)``.
"""

import torch

__all__ = ["calculate_blend_weights", "exclusive_cumprod"]


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative product along the last axis (first = 1)."""
    inclusive = torch.cumprod(x, dim=-1)
    one = torch.ones_like(inclusive[..., :1])
    return torch.cat([one, inclusive[..., :-1]], dim=-1)


def calculate_blend_weights(t_values: torch.Tensor,
                            opacity: torch.Tensor) -> torch.Tensor:
    """Per-sample blend weights ``alpha_i * T_i``.

    Args:
        t_values: (..., num_samples) sample depths along each ray.
        opacity: (..., num_samples) opacity (sigma) at each sample.

    Returns:
        (..., num_samples) blend weights, where ``T_i`` is the
        transmittance up to sample ``i``.
    """
    deltas = t_values[..., 1:] - t_values[..., :-1]
    max_dist = torch.full_like(deltas[..., :1], 1e10)
    deltas = torch.cat([deltas, max_dist], dim=-1)

    alpha = 1.0 - torch.exp(-(opacity * deltas))
    trans = torch.clamp(1.0 - alpha + 1e-10, max=1.0)
    return alpha * exclusive_cumprod(trans)
