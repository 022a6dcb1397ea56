"""Parity of the port's ops with the JAX package's: intersection,
encoding, sampling and blend weights, on the same NumPy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourier_feature_nets_torch import ops as tops
from fourier_feature_nets_tpu import ops as jops
from fourier_feature_nets_tpu.ops import encoding as jenc
from fourier_feature_nets_tpu.ops import sampling as jsampling


def _rays(rng, num):
    starts = rng.uniform(-3, 3, (num, 3)).astype(np.float32)
    dirs = rng.normal(size=(num, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return starts, dirs


def test_bounds_min_max():
    bounds = np.diag([2.0, 3.0, 4.0, 1.0]).astype(np.float32)
    bounds[:3, 3] = [0.1, -0.2, 0.3]
    for a, b in zip(tops.bounds_min_max(bounds), jops.bounds_min_max(bounds)):
        np.testing.assert_array_equal(a, b)


def test_ray_aabb_near_far_matches_jax():
    rng = np.random.default_rng(1)
    starts, dirs = _rays(rng, 500)
    lo = np.array([-1, -1, -1], np.float32)
    hi = np.array([1, 1, 1], np.float32)
    ours = tops.ray_aabb_near_far(torch.from_numpy(starts),
                                  torch.from_numpy(dirs),
                                  torch.from_numpy(lo), torch.from_numpy(hi))
    ref = jops.ray_aabb_near_far(jnp.asarray(starts), jnp.asarray(dirs),
                                 jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    valid = np.asarray(ref.valid)
    assert valid.any() and not valid.all()
    np.testing.assert_allclose(ours.near.numpy()[valid],
                               np.asarray(ref.near)[valid], rtol=1e-6)
    np.testing.assert_allclose(ours.far.numpy()[valid],
                               np.asarray(ref.far)[valid], rtol=1e-6)


@pytest.mark.parametrize("start,direction", [
    # x/0 with the origin inside the slab: +-inf flows through
    ((0.5, 0.2, -3.0), (0.0, 0.0, 1.0)),
    # x/0 with the origin outside the slab: misses
    ((1.5, 0.2, -3.0), (0.0, 0.0, 1.0)),
    # 0/0: origin on the slab plane, zero direction on that axis
    ((1.0, 0.2, -3.0), (0.0, 0.0, 1.0)),
])
def test_ray_aabb_degenerate_rules(start, direction):
    s = np.array([start], np.float32)
    d = np.array([direction], np.float32)
    lo = np.full(3, -1, np.float32)
    hi = np.full(3, 1, np.float32)
    ours = tops.ray_aabb_near_far(torch.from_numpy(s), torch.from_numpy(d),
                                  torch.from_numpy(lo), torch.from_numpy(hi))
    ref = jops.ray_aabb_near_far(jnp.asarray(s), jnp.asarray(d),
                                 jnp.asarray(lo), jnp.asarray(hi))
    assert bool(ours.valid[0]) == bool(ref.valid[0])
    assert np.isfinite(ours.near.numpy()).all() == np.isfinite(
        np.asarray(ref.near)).all()
    if bool(ref.valid[0]):
        np.testing.assert_allclose(ours.near.numpy(), np.asarray(ref.near))
        np.testing.assert_allclose(ours.far.numpy(), np.asarray(ref.far))


@pytest.mark.parametrize("scale,num", [(9.0, 10), (3.0, 4), (5.5, 8)])
def test_positional_encoding_matrix(scale, num):
    np.testing.assert_array_equal(
        tops.positional_encoding_matrix(scale, num, 3),
        jenc.positional_encoding_matrix(scale, num, 3))


def test_encode_phases_is_exact_f32():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.5, 1.5, (300, 3)).astype(np.float32)
    enc = tops.positional_encoding_matrix(9.0, 10, 3)
    ours = tops.encode_phases(torch.from_numpy(x), torch.from_numpy(enc))
    expected = (x.astype(np.float64) @ enc.astype(np.float64)).astype(
        np.float32)
    np.testing.assert_array_equal(ours.numpy(), expected)


@pytest.mark.parametrize("num", [2, 8, 16, 33, 48, 49, 129])
def test_unit_linspace_bit_equal_to_jnp(num):
    np.testing.assert_array_equal(
        tops.unit_linspace(num).numpy(),
        np.asarray(jnp.linspace(0.0, 1.0, num, dtype=jnp.float32)))


def test_batch_linspace_matches_jax():
    rng = np.random.default_rng(3)
    near = rng.uniform(0.5, 2, 64).astype(np.float32)
    far = near + rng.uniform(0.1, 3, 64).astype(np.float32)
    ours = tops.batch_linspace(torch.from_numpy(near), torch.from_numpy(far),
                               33)
    ref = jops.batch_linspace(jnp.asarray(near), jnp.asarray(far), 33)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def _inverse_cdf_pair(edges, cdf, num, quantiles=None):
    ours = tops.inverse_cdf_from_bins(
        torch.from_numpy(edges), torch.from_numpy(cdf), num,
        quantiles=None if quantiles is None else torch.from_numpy(quantiles))
    ref = jsampling.inverse_cdf_from_bins(
        jnp.asarray(edges), jnp.asarray(cdf), num,
        quantiles=None if quantiles is None else jnp.asarray(quantiles))
    return ours.numpy(), np.asarray(ref)


def _random_cdf(rng, rays, bins, zero_share=0.0):
    weights = rng.uniform(0.01, 1, (rays, bins)).astype(np.float32)
    weights[rng.uniform(size=weights.shape) < zero_share] = 0.0
    weights[:, 0] += 1e-3
    cdf = np.cumsum(weights, -1)
    cdf = cdf / cdf[:, -1:]
    cdf = np.concatenate([np.zeros((rays, 1), np.float32), cdf], -1)
    edges = np.sort(rng.uniform(0.5, 4, (rays, bins + 1)), -1)
    return edges.astype(np.float32), cdf.astype(np.float32)


def test_inverse_cdf_even_quantiles():
    rng = np.random.default_rng(4)
    edges, cdf = _random_cdf(rng, 40, 32)
    ours, ref = _inverse_cdf_pair(edges, cdf, 48)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    assert (np.diff(ours, axis=-1) >= 0).all()


def test_inverse_cdf_flat_segments():
    """Empty bins repeat a CDF value; a quantile landing on the flat
    value must bracket the same edges as the masked max/min."""
    rng = np.random.default_rng(5)
    edges, cdf = _random_cdf(rng, 40, 16, zero_share=0.5)
    quantiles = np.concatenate(
        [cdf[:, 3:11], rng.uniform(0, 1, (40, 8)).astype(np.float32)], -1)
    quantiles = np.sort(quantiles, -1).astype(np.float32)
    ours, ref = _inverse_cdf_pair(edges, cdf, 16, quantiles)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_inverse_cdf_quantile_one_and_zero():
    rng = np.random.default_rng(6)
    edges, cdf = _random_cdf(rng, 8, 8)
    quantiles = np.tile(np.array([0.0, 0.5, 1.0], np.float32), (8, 1))
    ours, ref = _inverse_cdf_pair(edges, cdf, 3, quantiles)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours[:, -1], edges[:, -1], rtol=1e-6)
    np.testing.assert_allclose(ours[:, 0], edges[:, 0], rtol=1e-6)


def test_uniform_t_values_matches_jax():
    near = np.array([0.5, 1.0, 2.0], np.float32)
    far = np.array([1.5, 4.0, 2.5], np.float32)
    ours = tops.uniform_t_values(torch.from_numpy(near),
                                 torch.from_numpy(far), 8)
    ref = jops.uniform_t_values(jnp.asarray(near), jnp.asarray(far), 8)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)


def test_exclusive_cumprod():
    rng = np.random.default_rng(7)
    x = rng.uniform(0.5, 1, (5, 9)).astype(np.float32)
    np.testing.assert_allclose(
        tops.exclusive_cumprod(torch.from_numpy(x)).numpy(),
        np.asarray(jops.exclusive_cumprod(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("scale", [0.1, 3.0, 50.0])
def test_blend_weights_match_jax(scale):
    rng = np.random.default_rng(8)
    t = np.sort(rng.uniform(1, 4, (32, 16)), -1).astype(np.float32)
    opacity = (scale * rng.uniform(0, 1, (32, 16))).astype(np.float32)
    ours = tops.calculate_blend_weights(torch.from_numpy(t),
                                        torch.from_numpy(opacity))
    ref = jops.calculate_blend_weights(jnp.asarray(t), jnp.asarray(opacity))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)
