"""Focus sampling and the surface sweep of the port against the JAX
package: ``determine_cdf``, ``inverse_cdf_t_values`` and
``merge_sorted``; the focus sampler's CDFs, samples and frames; and
``Raycaster.extract_surface`` with the ``voxelize_model`` CLI."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fourier_feature_nets_torch.render.ray_sampler as port_module
import fourier_feature_nets_tpu.render.ray_sampler as jax_module
from fourier_feature_nets_torch import ops as port_ops
from fourier_feature_nets_torch.cli import voxelize_model as port_voxelize
from fourier_feature_nets_torch.datasets import ImageDataset as TorchDataset
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_torch.octree import OcTree as TorchTree
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_torch.render import RaySampler as TorchSampler
from fourier_feature_nets_tpu import ops as jax_ops
from fourier_feature_nets_tpu.cameras import Resolution
from fourier_feature_nets_tpu.datasets import ImageDataset
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
)
from fourier_feature_nets_tpu.models import NeRF, save_model
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.octree import OcTree
from fourier_feature_nets_tpu.render import Raycaster, RaySampler
from fourier_feature_nets_tpu.utils.camera_paths import orbit

CONFIG = dict(num_layers=2, num_channels=32, max_log_scale_pos=9.0,
              num_freq_pos=10, max_log_scale_view=3.0, num_freq_view=4,
              skips=[], include_inputs=True)
BOUNDS = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
# a volume that some rays of the rig miss
SMALL = np.diag([1.2, 1.2, 1.2, 1.0]).astype(np.float32)
# tests/test_torch_ops.py's tolerances
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def nerf():
    model = NeRF(**CONFIG)
    params = model.init(jax.random.PRNGKey(5))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    return model, params, params_from_jax(TorchNeRF(**CONFIG), flat)


@pytest.fixture(scope="module")
def rig():
    return orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]), 3,
                 40.0, Resolution(16, 16), 3.0)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def _sorted_t(rng, rays, samples):
    near = rng.uniform(1.0, 2.0, rays).astype(np.float32)
    far = near + rng.uniform(0.5, 2.0, rays).astype(np.float32)
    t = np.sort(rng.uniform(0, 1, (rays, samples)), -1).astype(np.float32)
    return near, far, near[:, None] + t * (far - near)[:, None]


def test_determine_cdf_matches_jax():
    rng = np.random.default_rng(0)
    _, _, t_values = _sorted_t(rng, 64, 12)
    opacity = rng.exponential(2.0, (64, 12)).astype(np.float32)
    opacity[:8] = 0.0                   # all-empty rays: the 1e-5 floor
    opacity[8:16, 3:] = 80.0            # opaque rays: flat tails
    ours = port_ops.determine_cdf(torch.from_numpy(t_values),
                                  torch.from_numpy(opacity))
    ref = jax_ops.determine_cdf(jnp.asarray(t_values), jnp.asarray(opacity))
    assert ours.shape == (64, 11)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert (ours[:, 0] == 0).all() and np.allclose(ours[:, -1], 1.0)


@pytest.mark.parametrize("case", ["random", "flat", "ties", "even"])
def test_inverse_cdf_t_values_matches_jax(case):
    rng = np.random.default_rng(1)
    num_rays, num_cdf, num = 48, 9, 7
    near, far, _ = _sorted_t(rng, num_rays, 2)
    weights = rng.exponential(1.0, (num_rays, num_cdf - 2))
    if case in ("flat", "ties"):
        weights[:, 2:5] = 0.0           # flat CDF segments
    cdf = np.cumsum(weights, -1)
    cdf = np.concatenate([np.zeros((num_rays, 1)), cdf / cdf[:, -1:]], -1)
    cdf = cdf.astype(np.float32)
    quantiles = np.sort(rng.uniform(0, 1, (num_rays, num)), -1)
    if case == "ties":
        # quantiles exactly on a flat segment's level and on the ends
        quantiles[:, 1] = cdf[:, 2]
        quantiles[:, 2] = cdf[:, 3]
        quantiles[:, 0] = 0.0
        quantiles[:, -1] = 1.0
        quantiles = np.sort(quantiles, -1)
    quantiles = None if case == "even" else quantiles.astype(np.float32)
    ours = port_ops.inverse_cdf_t_values(
        torch.from_numpy(near), torch.from_numpy(far), torch.from_numpy(cdf),
        num, num_cdf,
        None if quantiles is None else torch.from_numpy(quantiles))
    ref = jax_ops.inverse_cdf_t_values(
        jnp.asarray(near), jnp.asarray(far), jnp.asarray(cdf), num, num_cdf,
        quantiles=None if quantiles is None else jnp.asarray(quantiles))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert (np.diff(ours.numpy(), axis=-1) >= 0).all()


def test_merge_sorted_matches_jax():
    rng = np.random.default_rng(2)
    a = np.sort(rng.integers(0, 12, (40, 9)), -1).astype(np.float32) / 4
    # ties within each row and across the two rows
    b = np.sort(np.concatenate([a[:, ::3], rng.integers(0, 12, (40, 3)) / 4],
                               -1), -1).astype(np.float32)
    ours = port_ops.merge_sorted(torch.from_numpy(a), torch.from_numpy(b))
    ref = jax_ops.merge_sorted(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert ours.shape == (40, 15)


# ---------------------------------------------------------------------------
# the focus sampler
# ---------------------------------------------------------------------------

def _focus_pair(nerf, rig, num_samples=16, bounds=SMALL, **kwargs):
    model, params, port = nerf
    ref = RaySampler(bounds, rig, num_samples, kwargs.get("stratified",
                                                          False),
                     model, params, 4096,
                     kwargs.get("anneal_start", 0.5),
                     kwargs.get("num_anneal_steps", 0))
    ours = TorchSampler(bounds, rig, num_samples, "cpu",
                        opacity_model=port, **kwargs)
    return ours, ref


def test_focus_cdfs_match_jax(nerf, rig):
    ours, ref = _focus_pair(nerf, rig)
    assert ours.focus_sampling and ours.num_focus_samples == 8
    assert ours.cdfs.shape == (3 * 256, 7)
    np.testing.assert_allclose(ours.cdfs.numpy(), np.asarray(ref.cdfs),
                               rtol=1e-4, atol=1e-5)
    # a sweep split over batches gives the same rows
    ours.batch_size = 0
    assert torch.equal(ours._precompute_cdfs(), ours.cdfs)


def test_focus_camera_samples_match_jax(nerf, rig):
    ours, ref = _focus_pair(nerf, rig)
    offsets = np.arange(0, 256, 3)
    ref_rays, ref_valid = ref.sample_camera_rays(
        jnp.int32(2), jnp.asarray(offsets, jnp.int32))
    rays, valid = ours.sample_camera_rays(2, torch.from_numpy(offsets))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_allclose(rays.t_values.numpy(),
                               np.asarray(ref_rays.t_values), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(rays.positions.numpy(),
                               np.asarray(ref_rays.positions), rtol=1e-5,
                               atol=1e-5)
    assert (np.diff(rays.t_values.numpy(), axis=-1) >= 0).all()


def test_focus_stratified_samples_match_jax(nerf, rig, monkeypatch):
    """Stratified focus quantiles (k + u) / n and the uniform half's
    jitter, with the same uniforms injected into both samplers (the
    port's generator is not threefry), at an annealed step: the CDF
    keeps the pre-anneal near/far."""
    ours, ref = _focus_pair(nerf, rig, stratified=True, anneal_start=0.2,
                            num_anneal_steps=10)
    idx = ours.to_valid(np.arange(len(ours)))[::5]
    rng = np.random.default_rng(3)
    draws = {salt: rng.uniform(0, 1, (len(idx), 8)).astype(np.float32)
             for salt in (0, 1)}
    monkeypatch.setattr(
        jax_module, "per_ray_uniform",
        lambda key, ids, n, salt=0: jnp.asarray(draws[salt][:, :n]))
    monkeypatch.setattr(
        port_module, "per_ray_uniform",
        lambda seed, step, ids, n, salt=0: torch.from_numpy(
            draws[salt][:, :n]))
    ref_rays = ref.sample(jnp.asarray(idx), 3, jax.random.PRNGKey(0))
    rays = ours.sample(torch.from_numpy(idx), 3, 0)
    np.testing.assert_allclose(rays.t_values.numpy(),
                               np.asarray(ref_rays.t_values), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(rays.rays.numpy(), idx)


def test_focus_frame_matches_jax(nerf, rig):
    model, params, port = nerf
    ours, ref = _focus_pair(nerf, rig, num_samples=12, bounds=BOUNDS)
    expected = Raycaster(model).render_frame(params, ref, 1, chunk_size=80)
    frame = TorchRaycaster(port).render_frame(ours, 1, chunk_size=80)
    assert frame.shape == expected.shape == (16, 16, 3)
    assert np.abs(frame.astype(int) - expected.astype(int)).max() <= 1
    assert expected.any()


# ---------------------------------------------------------------------------
# the surface sweep and voxelize_model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    return generate_synthetic_dataset(path, resolution=16,
                                      split_counts=(3, 1, 1), volume_side=16,
                                      num_samples=64)


@pytest.fixture(scope="module")
def threshold(nerf, scene):
    """An alpha threshold that keeps about half of the random model's
    rays."""
    _, _, port = nerf
    data = TorchDataset.load(scene, "train", 16)
    idx = torch.from_numpy(data.index_pool())
    alpha = TorchRaycaster(port).render(data.sampler.sample(idx)).alpha
    return float(alpha.median())


def test_extract_surface_matches_jax(nerf, scene, threshold):
    model, params, port = nerf
    ref_data = ImageDataset.load(scene, "train", 16)
    data = TorchDataset.load(scene, "train", 16)
    ref_pos, ref_color = Raycaster(model).extract_surface(
        params, ref_data, 100, threshold)
    pos, color = TorchRaycaster(port).extract_surface(data, 100, threshold)
    assert pos.dtype == color.dtype == np.float32
    idx = ref_data.index_pool()
    assert 0 < len(ref_pos) < len(idx)

    # which pool rays each side keeps (both compact in pool order): the
    # same rays, except rays within 1e-4 of the threshold
    ref_alpha = Raycaster(model).batched_render(
        params, ref_data.sampler.sample(jnp.asarray(idx)), 512, False).alpha
    alpha = TorchRaycaster(port).render(
        data.sampler.sample(torch.from_numpy(idx))).alpha.numpy()
    ref_keep, keep = ref_alpha > threshold, alpha > threshold
    assert ref_keep.sum() == len(ref_pos) and keep.sum() == len(pos)
    near = np.abs(ref_alpha - threshold) <= 1e-4
    np.testing.assert_array_equal(keep[~near], ref_keep[~near])
    both = keep & ref_keep
    rows = (np.cumsum(keep) - 1)[both]
    ref_rows = (np.cumsum(ref_keep) - 1)[both]
    np.testing.assert_allclose(pos[rows], ref_pos[ref_rows], atol=1e-4)
    np.testing.assert_allclose(color[rows], ref_color[ref_rows], atol=1e-4)


def _leaf_jaccard(a, b) -> float:
    a, b = set(a.tolist()), set(b.tolist())
    return len(a & b) / len(a | b)


def test_voxelize_model_cli_matches_jax(nerf, scene, threshold, tmp_path,
                                        capsys):
    from fourier_feature_nets_tpu.cli import voxelize_model as jax_voxelize
    model, params, _ = nerf
    checkpoint = str(tmp_path / "nerf.npz")
    save_model(model, params, checkpoint)
    flags = ["--num-samples", "16", "--depth", "5", "--min-leaf-size", "2",
             "--alpha-threshold", str(threshold), "--batch-size", "128"]
    assert port_voxelize.main([checkpoint, scene, str(tmp_path / "port.npz"),
                               "--device", "cpu", "--fused"] + flags) == 0
    ours_out = capsys.readouterr().out
    assert jax_voxelize.main([checkpoint, scene, str(tmp_path / "jax.npz"),
                              "--no-fused"] + flags) == 0
    ref_out = capsys.readouterr().out
    counts = [int(re.search(r"voxelizing (\d+) surface points", out)
                  .group(1)) for out in (ours_out, ref_out)]
    assert counts[1] > 0 and abs(counts[0] - counts[1]) <= 2
    ours = TorchTree.load(str(tmp_path / "port.npz"))
    ref = OcTree.load(str(tmp_path / "jax.npz"))
    assert ours.scale == pytest.approx(ref.scale, abs=1e-4)
    assert ours.num_leaves > 1
    assert _leaf_jaccard(ours._leaf_index, ref._leaf_index) >= 0.99
    assert ours.leaf_data().shape[1] == 3


def test_voxelize_model_cli_without_surface(nerf, scene, tmp_path, capsys):
    model, params, _ = nerf
    checkpoint = str(tmp_path / "nerf.npz")
    save_model(model, params, checkpoint)
    assert port_voxelize.main([checkpoint, scene, str(tmp_path / "t.npz"),
                               "--device", "cpu", "--num-samples", "8",
                               "--alpha-threshold", "1.0"]) == 1
    assert "no surface points" in capsys.readouterr().out
