"""``ImageDataset.get_rays``, ``subsample_index`` and ``rays_for_camera``
against the JAX package on the CPU, with the small surface that came
with them: ``RaySamples.subset`` / ``.numpy`` / ``.to``,
``RenderResult.numpy``, ``ops.mse``, ``ops.psnr`` and
``ops.sample_positions``.

Held on a 24 px synthetic scene: the ray ids exactly, and the positions
and t values within atol 1e-6 (the sampler parity of
``test_torch_item7_paths.py``), in each of the five modes, with and
without a pixel subset, for an array and a scalar index; a stratified,
annealed draw with the same per-ray uniforms injected into both
samplers (the port's generator is not threefry), keyed by global ray id.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fourier_feature_nets_torch.render.ray_sampler as port_module
import fourier_feature_nets_tpu as ffn
import fourier_feature_nets_tpu.render.ray_sampler as jax_module
from fourier_feature_nets_torch import ops as port_ops
from fourier_feature_nets_torch.datasets import ImageDataset as TorchDataset
from fourier_feature_nets_torch.datasets import Mode as PortMode
from fourier_feature_nets_torch.datasets import RayDataset as PortRayDataset
from fourier_feature_nets_torch.render import RaySamples, RenderResult
from fourier_feature_nets_tpu import ops as jax_ops
from fourier_feature_nets_tpu.datasets import Mode as JaxMode
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
)

MODES = ["Center", "Sparse", "Dilate", "Patch", "Full"]
SUBSETS = {"all": None, "every-3rd": range(0, 24 * 24, 3),
           "band": range(5 * 24, 15 * 24)}
LOAD = dict(sparse_size=8, anneal_start=0.2, num_anneal_steps=10)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    return generate_synthetic_dataset(path, resolution=24,
                                      split_counts=(3, 1, 1),
                                      volume_side=16, num_samples=64)


def _pair(scene, mode, subset=None, stratified=False):
    ref = ffn.ImageDataset.load(scene, "train", 12, stratified=stratified,
                                **LOAD)
    ours = TorchDataset.load(scene, "train", 12, stratified=stratified,
                             **LOAD)
    ref.mode = JaxMode[mode]
    ours.mode = PortMode[mode]
    ref.subsample_index = subset
    ours.subsample_index = subset
    assert len(ours) == len(ref)
    return ref, ours


def _assert_samples(ours: RaySamples, ref):
    np.testing.assert_array_equal(ours.rays.numpy(), np.asarray(ref.rays))
    for name in ("positions", "view_directions", "t_values"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-6, err_msg=name)


def _local_ids(count, seed=0):
    """Dataset-local indices with repeats and out-of-order runs."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, count, size=min(count, 400))


@pytest.mark.parametrize("subset", sorted(SUBSETS))
@pytest.mark.parametrize("mode", MODES)
def test_get_rays_matches_jax(scene, mode, subset):
    ref, ours = _pair(scene, mode, SUBSETS[subset])
    idx = _local_ids(len(ref))
    expected = ref.get_rays(idx)
    got = ours.get_rays(idx)
    assert len(expected.rays) > 0
    _assert_samples(got, expected)
    if SUBSETS[subset] is not None:
        kept = set(SUBSETS[subset])
        assert all(int(ray) % (24 * 24) in kept for ray in got.rays)
        ours.subsample_index = None
        assert len(got.rays) < len(ours.get_rays(idx).rays)


@pytest.mark.parametrize("mode", MODES)
def test_get_rays_takes_a_scalar(scene, mode):
    ref, ours = _pair(scene, mode)
    pool = set(ours.index_pool().tolist())
    # the first local index that maps to a valid ray
    table = (np.arange(len(ours)) if mode == "Full"
             else ours._mode_index(PortMode[mode]))
    local = next(i for i, ray in enumerate(table) if int(ray) in pool)
    got = ours.get_rays(local)
    assert got.positions.shape == (1, 12, 3)
    _assert_samples(got, ref.get_rays(local))
    assert int(got.rays[0]) == int(table[local])
    assert ours.get_rays(np.int64(local)).rays.tolist() == [table[local]]


@pytest.mark.parametrize("subset", sorted(SUBSETS))
@pytest.mark.parametrize("mode", MODES)
def test_rays_for_camera_honours_the_subset(scene, mode, subset):
    ref, ours = _pair(scene, mode, SUBSETS[subset])
    for camera in range(ours.num_cameras):
        _assert_samples(ours.rays_for_camera(camera),
                        ref.rays_for_camera(camera))


def test_subsample_index_setter(scene):
    _, ours = _pair(scene, "Full")
    assert ours.subsample_index is None
    ours.subsample_index = np.array([3, 1, 3])
    assert ours.subsample_index == {1, 3}
    assert all(type(i) is int for i in ours.subsample_index)
    ours.subsample_index = None
    assert ours.subsample_index is None
    assert "get_rays" in PortRayDataset.__abstractmethods__


@pytest.mark.parametrize("mode", ["Center", "Full"])
def test_stratified_get_rays_with_injected_jitter(scene, mode, monkeypatch):
    """An annealed, stratified draw at step 3: the same uniforms, keyed
    by global ray id, go into both samplers."""
    ref, ours = _pair(scene, mode, SUBSETS["every-3rd"], stratified=True)
    rng = np.random.default_rng(3)
    table = {salt: rng.uniform(0, 1, (ours.sampler.num_rays, 12)).astype(
        np.float32) for salt in (0, 1)}
    monkeypatch.setattr(
        jax_module, "per_ray_uniform",
        lambda key, ids, n, salt=0: jnp.asarray(
            table[salt][np.asarray(ids)][:, :n]))
    monkeypatch.setattr(
        port_module, "per_ray_uniform",
        lambda seed, step, ids, n, salt=0: torch.from_numpy(
            table[salt][ids.numpy()][:, :n]))
    idx = _local_ids(len(ref), seed=1)
    expected = ref.get_rays(idx, 3, jax.random.PRNGKey(0))
    got = ours.get_rays(idx, 3, 0)
    _assert_samples(got, expected)
    # the jitter moved the samples off the deterministic grid
    plain = ours.get_rays(idx, 3)
    assert not torch.equal(plain.t_values, got.t_values)


# ---------------------------------------------------------------------------
# RaySamples, RenderResult and ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", ["mask", "ids", "slice"])
def test_ray_samples_subset_and_numpy(scene, index):
    ref, ours = _pair(scene, "Sparse")
    idx = _local_ids(len(ref))
    expected, got = ref.get_rays(idx), ours.get_rays(idx)
    count = len(got.rays)
    pick = {"mask": np.arange(count) % 3 == 1,
            "ids": np.array([count - 1, 0, 2, 2]),
            "slice": slice(2, 9)}[index]
    picked = got.subset(torch.as_tensor(pick) if index != "slice" else pick)
    _assert_samples(picked, expected.subset(pick))
    host = picked.numpy()
    assert all(isinstance(t, np.ndarray) for t in host)
    np.testing.assert_array_equal(host.t_values,
                                  np.asarray(expected.subset(pick).t_values))


def test_ray_samples_to_moves_every_tensor(scene):
    _, ours = _pair(scene, "Center")
    samples = ours.get_rays(np.arange(10))
    moved = samples.to("meta")
    assert all(t.device.type == "meta" for t in moved)
    assert [t.shape for t in moved] == [t.shape for t in samples]
    assert moved.rays.dtype == torch.int64
    empty = RaySamples(samples.positions, samples.view_directions,
                       samples.t_values, None)
    assert empty.to("cpu").rays is None
    assert empty.subset(slice(0, 2)).rays is None


def test_render_result_numpy():
    result = RenderResult(torch.ones(4, 3, requires_grad=True) * 0.5,
                          torch.zeros(4), None)
    host = result.numpy()
    jax_host = ffn.RenderResult(jnp.full((4, 3), 0.5), jnp.zeros(4),
                                None).numpy()
    np.testing.assert_array_equal(host.color, jax_host.color)
    np.testing.assert_array_equal(host.alpha, jax_host.alpha)
    assert host.depth is None and jax_host.depth is None


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    prediction = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    ours_mse = port_ops.mse(torch.from_numpy(prediction),
                            torch.from_numpy(target))
    ours_psnr = port_ops.psnr(torch.from_numpy(prediction),
                              torch.from_numpy(target))
    assert isinstance(ours_psnr, torch.Tensor)
    np.testing.assert_allclose(
        float(ours_mse), float(jax_ops.mse(prediction, target)), rtol=1e-6)
    np.testing.assert_allclose(
        float(ours_psnr), float(jax_ops.psnr(prediction, target)), rtol=1e-6)
    np.testing.assert_allclose(
        float(ours_psnr), float(port_ops.psnr_from_mse(float(ours_mse))),
        rtol=1e-6)


def test_sample_positions_matches_jax():
    rng = np.random.default_rng(4)
    starts = rng.normal(size=(32, 3)).astype(np.float32)
    directions = rng.normal(size=(32, 3)).astype(np.float32)
    t_values = np.sort(rng.uniform(1, 3, (32, 7)), -1).astype(np.float32)
    got = port_ops.sample_positions(torch.from_numpy(starts),
                                    torch.from_numpy(directions),
                                    torch.from_numpy(t_values))
    expected = jax_ops.sample_positions(starts, directions, t_values)
    assert got.shape == (32, 7, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-6,
                               atol=1e-6)
