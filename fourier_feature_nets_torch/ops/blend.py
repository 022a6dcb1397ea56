"""Volume-rendering blend weights.

Port of ``exclusive_cumprod``, ``calculate_blend_weights``,
``blend_weights_prefix`` and ``blend_weights_suffix`` from
``fourier_feature_nets_tpu/ops/blend.py``: the final sample's delta is
an effectively infinite 1e10, and transmittance is the exclusive
cumulative product of ``min(1, 1 - alpha + 1e-10)``. The prefix and
suffix split a ray's integral at a sample boundary for early ray
termination.
"""

import torch

__all__ = ["blend_weights_prefix", "blend_weights_suffix",
           "calculate_blend_weights", "exclusive_cumprod"]


class _PositiveCumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of an input with no zeros
    (the transmittance terms are at least 1e-10), differentiated as
    torch differentiates it when the input has no zero, without torch's
    host check for zeros: that check reads the device, which a captured
    CUDA graph (a train chunk) cannot."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        if x.shape[-1] == 1:
            return grad
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative product along the last axis (first = 1) of
    an input with no zeros.

    Also the plain twin of T1's scan kernel
    (:func:`..kernels.fused_ray_render.exclusive_cumprod_scan`), the
    port of the JAX package's lane scan ``_exclusive_cumprod_lanes``."""
    inclusive = (_PositiveCumprod.apply(x) if x.requires_grad
                 else torch.cumprod(x, dim=-1))
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


def blend_weights_prefix(t_values: torch.Tensor, opacity: torch.Tensor):
    """Blend weights of the first K samples of each ray and the
    transmittance after them.

    The prefix of a cumulative product is the same chain of multiplies,
    so the weights equal the first K of :func:`calculate_blend_weights`
    on the whole ray bit for bit.

    Args:
        t_values: (..., S) depths of all the ray's samples, S > K (the
            delta of sample K - 1 is ``t[K] - t[K-1]``).
        opacity: (..., K) opacity at the first K samples.

    Returns:
        (weights (..., K), trans_out (...,)): ``trans_out`` is the
        transmittance entering sample K.
    """
    k = opacity.shape[-1]
    deltas = t_values[..., 1:k + 1] - t_values[..., :k]
    alpha = 1.0 - torch.exp(-(opacity * deltas))
    terms = torch.clamp(1.0 - alpha + 1e-10, max=1.0)
    inclusive = torch.cumprod(terms, dim=-1)
    one = torch.ones_like(inclusive[..., :1])
    trans_in = torch.cat([one, inclusive[..., :-1]], dim=-1)
    return alpha * trans_in, inclusive[..., -1]


def blend_weights_suffix(t_values: torch.Tensor,
                         opacity: torch.Tensor) -> torch.Tensor:
    """Blend weights of the last K samples of each ray, not scaled by
    the transmittance entering them: the caller composites
    ``prefix_color + trans_out * suffix_color``
    (:func:`blend_weights_prefix`), which agrees with the unsplit
    integral to ULPs, not bit for bit. The last sample's delta is the
    1e10 pad.

    Args:
        t_values: (..., S) depths of all the ray's samples, S > K.
        opacity: (..., K) opacity at the last K samples.

    Returns:
        (..., K) unscaled suffix weights.
    """
    k = opacity.shape[-1]
    deltas = (t_values[..., -k + 1:] - t_values[..., -k:-1] if k > 1
              else t_values[..., :0])
    max_dist = torch.full_like(t_values[..., :1], 1e10)
    deltas = torch.cat([deltas, max_dist], dim=-1)
    alpha = 1.0 - torch.exp(-(opacity * deltas))
    trans = torch.clamp(1.0 - alpha + 1e-10, max=1.0)
    return alpha * exclusive_cumprod(trans)
