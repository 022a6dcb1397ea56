"""Ray sample placement.

Port of ``batch_linspace``, ``anneal_near_far``, ``uniform_t_values``
(with stratified jitter) and ``inverse_cdf_from_bins`` from
``fourier_feature_nets_tpu/ops/sampling.py``, and the port's own
counter-based generator :func:`per_ray_uniform`. The TPU module brackets each
quantile with masked max/min reductions (``_monotone_bracket``) because
row gathers are slow there; here the bracket is ``torch.searchsorted``
plus two gathers, with the same semantics: "below" is the last edge
with ``cdf <= q``, "above" the next edge, clamped to the last one.
"""

import torch

__all__ = ["unit_linspace", "batch_linspace", "anneal_near_far",
           "per_ray_uniform", "uniform_t_values", "inverse_cdf_from_bins"]

_MASK32 = 0xFFFFFFFF


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


def _mul32(x, c: int):
    """``x * c`` modulo 2**32 for 32-bit ``x`` (int or int64 tensor),
    split in 16-bit halves of ``c`` so no int64 product overflows."""
    low = x * (c & 0xFFFF)
    high = ((x * (c >> 16)) & 0xFFFF) << 16
    return (low + high) & _MASK32


def _mix32(x):
    """The ``lowbias32`` integer finalizer (a bijection on 32 bits)."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def per_ray_uniform(seed: int, step: int, idx: torch.Tensor,
                    num_samples: int, salt: int = 0) -> torch.Tensor:
    """Uniform [0, 1) draws keyed by GLOBAL ray index, not batch slot.

    A stateless hash of (seed, step, salt, ray id, sample index): the
    same on every device and for every batch layout, so re-sampling a
    ray in the same step draws the same jitter. The JAX package folds
    the same counters into a threefry key; the bits differ, the
    distribution does not.

    Args:
        seed: the epoch's integer key.
        step: training step.
        idx: (R,) integer global ray indices.
        num_samples: draws per ray.
        salt: distinguishes independent streams per call site.

    Returns:
        (R, num_samples) float32 uniforms with 24 random bits each.
    """
    key = _mix32(_mix32(_mix32(seed) ^ (step & _MASK32)) ^ (salt & _MASK32))
    ray = _mix32(_mix32(idx.to(torch.int64)) ^ key)
    lanes = torch.arange(num_samples, dtype=torch.int64, device=idx.device)
    bits = _mix32(ray[:, None] ^ _mix32(lanes + 0x9E3779B9)[None, :])
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def anneal_near_far(near: torch.Tensor, far: torch.Tensor, step: int,
                    anneal_start: float, num_anneal_steps: int):
    """Shrinks [near, far] toward its midpoint early in training; from
    ``step >= num_anneal_steps`` (or with no annealing) the bounds pass
    through unchanged. The blend factor is f32, as in the JAX package."""
    if num_anneal_steps <= 0 or step >= num_anneal_steps:
        return near, far
    progress = torch.tensor(step, dtype=torch.float32) / num_anneal_steps
    anneal = torch.clamp(progress, anneal_start, 1.0).to(near.device)
    midpoint = (near + far) * 0.5
    return (midpoint + (near - midpoint) * anneal,
            midpoint + (far - midpoint) * anneal)


def uniform_t_values(near: torch.Tensor, far: torch.Tensor,
                     num_samples: int,
                     jitter: torch.Tensor = None) -> torch.Tensor:
    """Evenly spaced sample depths from near to far, plus (with
    ``jitter``, (R, num_samples) uniforms in [0, 1)) stratified jitter
    of up to one bin width ``(far - near) / num_samples``; the output
    stays row-wise sorted.

    Returns:
        (R, num_samples) row-wise sorted t values.
    """
    t_values = batch_linspace(near, far, num_samples)
    if jitter is not None:
        scale = (far - near) / num_samples
        t_values = t_values + jitter * scale[..., None]
    return t_values


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
