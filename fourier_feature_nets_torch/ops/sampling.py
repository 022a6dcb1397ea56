"""Ray sample placement.

Port of ``batch_linspace``, ``anneal_near_far``, ``uniform_t_values``
(with stratified jitter), ``determine_cdf``, ``inverse_cdf_from_bins``,
``inverse_cdf_t_values`` and ``merge_sorted`` from
``fourier_feature_nets_tpu/ops/sampling.py``, and the port's own
counter-based generator :func:`per_ray_uniform`. The TPU module brackets each
quantile with masked max/min reductions (``_monotone_bracket``) because
row gathers are slow there; here the bracket is ``torch.searchsorted``
plus two gathers, with the same semantics: "below" is the last edge
with ``cdf <= q``, "above" the next edge, clamped to the last one. The
TPU module merges two sorted rows with a one-hot matmul because a
per-row sort is slow there; here :func:`merge_sorted` is ``torch.sort``.
"""

import torch

from .blend import calculate_blend_weights

__all__ = ["unit_linspace", "batch_linspace", "anneal_near_far",
           "per_ray_uniform", "uniform_t_values", "determine_cdf",
           "inverse_cdf_from_bins", "inverse_cdf_t_values", "merge_sorted",
           "sample_positions"]

_MASK32 = 0xFFFFFFFF


def unit_linspace(num: int, device=None) -> torch.Tensor:
    """``linspace(0, 1, num)`` in f32, bit-identical to the JAX
    package's ``jnp.linspace`` on the CPU backend (``iota * (1 / (num -
    1))`` with an exact endpoint). ``torch.linspace`` differs from it
    by an ulp at some sizes, which can move a sample across an
    occupancy cell border."""
    if num == 1:
        return torch.zeros(1, device=device)
    steps = torch.arange(num - 1, dtype=torch.float32, device=device)
    # the endpoint from a device fill, not a host scalar: this runs
    # inside captured CUDA graphs
    return torch.cat([steps * (1.0 / (num - 1)),
                      torch.ones(1, device=device)])


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
        step: training step. ``seed`` and ``step`` may be 0-d int64
            tensors on ``idx``'s device (a CUDA graph's counters): the
            hash is the same integer arithmetic, with no host read.
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


def anneal_near_far(near: torch.Tensor, far: torch.Tensor, step,
                    anneal_start: float, num_anneal_steps: int):
    """Shrinks [near, far] toward its midpoint early in training; from
    ``step >= num_anneal_steps`` (or with no annealing) the bounds pass
    through unchanged. The blend factor is f32, as in the JAX package.

    ``step`` is an int, or a 0-d integer tensor on ``near``'s device (a
    CUDA graph's step counter): then the pass-through is a
    ``torch.where`` with the same values, and nothing reads the step on
    the host."""
    if num_anneal_steps <= 0:
        return near, far
    traced = isinstance(step, torch.Tensor)
    if not traced:
        if step >= num_anneal_steps:
            return near, far
        step = torch.tensor(step)
    progress = step.to(torch.float32) / num_anneal_steps
    anneal = torch.clamp(progress, anneal_start, 1.0).to(near.device)
    midpoint = (near + far) * 0.5
    new_near = midpoint + (near - midpoint) * anneal
    new_far = midpoint + (far - midpoint) * anneal
    if traced:
        done = step >= num_anneal_steps
        return torch.where(done, near, new_near), torch.where(done, far,
                                                              new_far)
    return new_near, new_far


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


def determine_cdf(t_values: torch.Tensor,
                  opacity: torch.Tensor) -> torch.Tensor:
    """Per-ray CDF over depth from coarse opacity estimates: the blend
    weights with their first and last samples dropped, floored by
    +1e-5, a normalized cumulative sum with a zero prepended.

    Returns:
        (R, S - 1) for (R, S) inputs.
    """
    weights = calculate_blend_weights(t_values, opacity)
    weights = weights[..., 1:-1] + 1e-5
    cdf = torch.cumsum(weights, dim=-1)
    cdf = cdf / cdf[..., -1:]
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)


def _inverse_cdf_interp(grid: torch.Tensor, cdf: torch.Tensor,
                        quantiles: torch.Tensor, eps: float) -> torch.Tensor:
    """Maps quantiles through a discrete CDF over ``grid``: bracket each
    quantile by ``searchsorted(right=True)``, then interpolate linearly
    with an ``eps``-guarded denominator."""
    quantiles = quantiles.contiguous()
    last = cdf.shape[-1] - 1
    count = torch.searchsorted(cdf.contiguous(), quantiles, right=True)
    below = torch.clamp(count - 1, min=0)
    above = torch.clamp(count, max=last)
    cdf_i = torch.gather(cdf, -1, below)
    cdf_j = torch.gather(cdf, -1, above)
    t_i = torch.gather(grid, -1, below)
    t_j = torch.gather(grid, -1, above)
    denominator = cdf_j - cdf_i
    denominator = torch.where(denominator < eps,
                              torch.ones_like(denominator), denominator)
    frac = (quantiles - cdf_i) / denominator
    return t_i + frac * (t_j - t_i)


def _even_quantiles(num_rays: int, num_samples: int, device):
    return unit_linspace(num_samples, device).expand(num_rays, num_samples)


def inverse_cdf_from_bins(t_edges: torch.Tensor, cdf: torch.Tensor,
                          num_samples: int,
                          quantiles: torch.Tensor = None,
                          jitter: torch.Tensor = None) -> torch.Tensor:
    """Inverse-transform sampling over explicit bin edges.

    Args:
        t_edges: (R, B+1) monotonically increasing bin edges.
        cdf: (R, B+1) non-decreasing cumulative distribution at the
            edges (cdf[:, 0] == 0, cdf[:, -1] == 1).
        num_samples: samples to draw per ray.
        quantiles: optional (R, num_samples) quantiles in [0, 1];
            default is ``num_samples`` evenly spaced ones.
        jitter: optional (R, num_samples) uniforms ``u`` in [0, 1) for
            stratified quantiles ``(k + u) / num_samples``, one in each
            stratum ``k``, so the samples come out sorted (the JAX
            package's ``stratified_quantiles``); ``quantiles`` wins.

    Returns:
        (R, num_samples) t values, linearly interpolated within bins.
        The interpolation denominator is guarded by ``eps = 1e-9``.
    """
    if quantiles is None and jitter is not None:
        strata = torch.arange(num_samples, dtype=jitter.dtype,
                              device=jitter.device)
        quantiles = (strata + jitter) / num_samples
    elif quantiles is None:
        quantiles = _even_quantiles(t_edges.shape[0], num_samples,
                                    cdf.device)
    return _inverse_cdf_interp(t_edges, cdf, quantiles, eps=1e-9)


def inverse_cdf_t_values(near: torch.Tensor, far: torch.Tensor,
                         cdf: torch.Tensor, num_samples: int,
                         num_cdf_samples: int,
                         quantiles: torch.Tensor = None) -> torch.Tensor:
    """Inverse-transform sampling of depths from a per-ray CDF.

    The coarse grid is rebuilt as the CDF was built over it, the
    midpoints of a ``num_cdf_samples``-point linspace over [near, far];
    the quantiles map through the CDF by bracketing and linear
    interpolation, with the reference's ``eps = 1e-5`` guard
    (ray_sampler.py:348), not the bins' 1e-9.

    Args:
        near/far: (R,) the *unannealed* ray bounds the CDF was built on.
        cdf: (R, num_cdf_samples - 1) cumulative distribution.
        num_samples: focus samples to draw per ray.
        num_cdf_samples: resolution of the coarse grid of the CDF.
        quantiles: optional (R, num_samples) quantiles in [0, 1];
            default is ``num_samples`` evenly spaced ones. Sorted
            quantiles give sorted t values.

    Returns:
        (R, num_samples) t values.
    """
    t_values = batch_linspace(near, far, num_cdf_samples)
    t_values = 0.5 * (t_values[..., :-1] + t_values[..., 1:])
    if quantiles is None:
        quantiles = _even_quantiles(near.shape[0], num_samples, cdf.device)
    return _inverse_cdf_interp(t_values, cdf, quantiles, eps=1e-5)


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise sorted union of two (R, A) and (R, B) rows. Its values
    equal the JAX package's sort-free one-hot merge: ties are equal
    values, so their order does not show."""
    return torch.sort(torch.cat([a, b], dim=-1), dim=-1).values


def sample_positions(starts: torch.Tensor, directions: torch.Tensor,
                     t_values: torch.Tensor) -> torch.Tensor:
    """Expands rays into 3D sample positions: ``start + t * direction``.

    Args:
        starts: (R, 3) ray origins.
        directions: (R, 3) ray directions.
        t_values: (R, S) sample depths.

    Returns:
        (R, S, 3) positions.
    """
    return starts[:, None, :] + t_values[..., None] * directions[:, None, :]
