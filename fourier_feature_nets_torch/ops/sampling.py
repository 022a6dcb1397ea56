"""Ray sample placement.

Port of ``batch_linspace``, ``uniform_t_values`` and
``inverse_cdf_from_bins`` from ``fourier_feature_nets_tpu/ops/sampling.py``
for the deterministic render path. The TPU module brackets each
quantile with masked max/min reductions (``_monotone_bracket``) because
row gathers are slow there; here the bracket is ``torch.searchsorted``
plus two gathers, with the same semantics: "below" is the last edge
with ``cdf <= q``, "above" the next edge, clamped to the last one.
"""

import torch

__all__ = ["unit_linspace", "batch_linspace", "uniform_t_values",
           "inverse_cdf_from_bins"]


def unit_linspace(num: int, device=None) -> torch.Tensor:
    """``linspace(0, 1, num)`` in f32, bit-identical to the JAX
    package's ``jnp.linspace`` on the CPU backend (``iota * (1 / (num -
    1))`` with an exact endpoint). ``torch.linspace`` differs from it
    by an ulp at some sizes, which can move a sample across an
    occupancy cell border."""
    if num == 1:
        return torch.zeros(1, device=device)
    steps = torch.arange(num, dtype=torch.float32, device=device)
    steps = steps * (1.0 / (num - 1))
    steps[-1] = 1.0
    return steps


def batch_linspace(start: torch.Tensor, stop: torch.Tensor,
                   num_samples: int) -> torch.Tensor:
    """Vectorized linspace: (...,) bounds -> (..., num_samples) ramps."""
    steps = unit_linspace(num_samples, start.device)
    return start[..., None] + steps * (stop - start)[..., None]


def uniform_t_values(near: torch.Tensor, far: torch.Tensor,
                     num_samples: int) -> torch.Tensor:
    """Evenly spaced sample depths from near to far (the render path
    draws no stratified jitter).

    Returns:
        (R, num_samples) row-wise sorted t values.
    """
    return batch_linspace(near, far, num_samples)


def inverse_cdf_from_bins(t_edges: torch.Tensor, cdf: torch.Tensor,
                          num_samples: int,
                          quantiles: torch.Tensor = None) -> torch.Tensor:
    """Inverse-transform sampling over explicit bin edges.

    Args:
        t_edges: (R, B+1) monotonically increasing bin edges.
        cdf: (R, B+1) non-decreasing cumulative distribution at the
            edges (cdf[:, 0] == 0, cdf[:, -1] == 1).
        num_samples: samples to draw per ray.
        quantiles: optional (R, num_samples) quantiles in [0, 1];
            default is ``num_samples`` evenly spaced ones.

    Returns:
        (R, num_samples) t values, linearly interpolated within bins.
        The interpolation denominator is guarded by ``eps = 1e-9``.
    """
    num_rays = t_edges.shape[0]
    if quantiles is None:
        quantiles = unit_linspace(num_samples, cdf.device).expand(
            num_rays, num_samples)
    quantiles = quantiles.contiguous()
    last = cdf.shape[-1] - 1
    count = torch.searchsorted(cdf.contiguous(), quantiles, right=True)
    below = torch.clamp(count - 1, min=0)
    above = torch.clamp(count, max=last)
    cdf_i = torch.gather(cdf, -1, below)
    cdf_j = torch.gather(cdf, -1, above)
    t_i = torch.gather(t_edges, -1, below)
    t_j = torch.gather(t_edges, -1, above)
    denominator = cdf_j - cdf_i
    denominator = torch.where(denominator < 1e-9,
                              torch.ones_like(denominator), denominator)
    frac = (quantiles - cdf_i) / denominator
    return t_i + frac * (t_j - t_i)
