"""Occupancy-guided training in the port against the JAX package (held
to tests/test_training.py's occupancy tests): the stratified occupancy
quantiles with the same uniforms injected into both samplers (t within
rtol 1e-5 / atol 1e-5, the sampler tests' tolerance), and ``fit``'s
guided phase (the step the density-grid sampler takes over, its sample
count, its in-place refreshes, the ``occupancy_mix`` anchor steps
through the base sampler, the ``occupancy_end`` tail, a resume into
the guided phase, the base sampler restored afterwards, also after an
error), each schedule equal to JAX's ``fit``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import fourier_feature_nets_torch.render.occupancy_sampler as port_occ
import fourier_feature_nets_tpu as ffn
import fourier_feature_nets_tpu.ops.sampling as jax_sampling
from fourier_feature_nets_torch.datasets import ImageDataset as TorchDataset
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_torch.render import RaySampler as TorchSampler
from fourier_feature_nets_tpu.cameras import Resolution
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
)
from fourier_feature_nets_tpu.models import NeRF
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.render.occupancy_sampler import (
    OccupancyGridSampler,
)
from fourier_feature_nets_tpu.utils.camera_paths import orbit

SMALL = dict(num_layers=2, num_channels=32, max_log_scale_pos=4.0,
             num_freq_pos=5, max_log_scale_view=2.0, num_freq_view=3,
             skips=[], include_inputs=True)
BOUNDS = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
FIT = dict(batch_size=64, learning_rate=1e-3, crop_steps=0, decay_rate=0.1,
           decay_steps=1000, occupancy_samples=6)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    return generate_synthetic_dataset(path, resolution=16,
                                      split_counts=(3, 1, 1),
                                      volume_side=16, num_samples=64)


def _pair(seed=0):
    model = NeRF(**SMALL)
    params = model.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    return model, params, params_from_jax(TorchNeRF(**SMALL), flat)


def _sphere_grid(resolution):
    c = (np.arange(resolution) + 0.5) / resolution * 2 - 1
    zz, yy, xx = np.meshgrid(c, c, c, indexing="ij")
    return (np.sqrt((xx - 0.3) ** 2 + yy ** 2 + zz ** 2) < 0.45).astype(
        np.float32)


def test_stratified_quantiles_match_jax(monkeypatch):
    """The same (rays, samples) uniforms injected into both samplers'
    ``per_ray_uniform`` (salt 2): the jittered quantiles ``(k + u) / n``
    place the same depths; without a key the samples are the even
    ones."""
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]), 2,
                    40.0, Resolution(20, 20), 3.0)
    grid = _sphere_grid(16)
    ref_sampler = OccupancyGridSampler(
        None, cameras, 12, stratified=True, num_probes=16, empty_weight=0.1,
        bounds=BOUNDS, occupancy_grid=grid, grid_scale=1.0)
    sampler = port_occ.OccupancyGridSampler(
        grid, 1.0, cameras, 12, num_probes=16, empty_weight=0.1,
        bounds=BOUNDS, stratified=True)
    idx = sampler.to_valid(np.arange(len(sampler)))
    np.testing.assert_array_equal(idx, ref_sampler.to_valid(
        np.arange(len(ref_sampler))))
    jitter = np.random.default_rng(6).uniform(0, 1, (len(idx), 12)).astype(
        np.float32)
    salts = []

    def jax_uniform(rng, ids, num, salt=0):
        salts.append(("jax", salt, num))
        return jnp.asarray(jitter)

    def port_uniform(seed, step, ids, num, salt=0):
        salts.append(("port", salt, num))
        return torch.from_numpy(jitter)

    monkeypatch.setattr(jax_sampling, "per_ray_uniform", jax_uniform)
    monkeypatch.setattr(port_occ, "per_ray_uniform", port_uniform)
    ref = ref_sampler.sample(jnp.asarray(idx), 5, jax.random.PRNGKey(0))
    ours = sampler.sample(torch.from_numpy(idx), 5, 11)
    assert salts == [("jax", 2, 12), ("port", 2, 12)]
    np.testing.assert_allclose(ours.t_values.numpy(),
                               np.asarray(ref.t_values), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ours.positions.numpy(),
                               np.asarray(ref.positions), rtol=1e-5,
                               atol=1e-5)
    assert (torch.diff(ours.t_values, dim=-1) >= 0).all()
    even = sampler.sample(torch.from_numpy(idx), 5, None)
    assert not torch.allclose(even.t_values, ours.t_values)
    np.testing.assert_allclose(
        even.t_values.numpy(),
        np.asarray(ref_sampler.sample(jnp.asarray(idx), 5, None).t_values),
        rtol=1e-5, atol=1e-5)


def test_refresh_keeps_the_tables_storage():
    """A grid of the same resolution is copied into the installed
    tensors (a captured graph reads it); another resolution replaces
    them."""
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]), 1,
                    40.0, Resolution(8, 8), 3.0)
    sampler = port_occ.OccupancyGridSampler(_sphere_grid(16), 1.0, cameras,
                                            8, bounds=BOUNDS)
    pointers = (sampler.occupancy.data_ptr(), sampler.probe_table.data_ptr())
    sampler.set_occupancy_grid(np.ones((16, 16, 16), np.float32))
    assert (sampler.occupancy.data_ptr(),
            sampler.probe_table.data_ptr()) == pointers
    assert bool(sampler.occupancy.all()) and bool(sampler.probe_table.all())
    sampler.set_occupancy_grid(np.ones((8, 8, 8), np.float32))
    assert sampler.occupancy.shape == (8, 8, 8)
    assert sampler._grid_resolution == 8


class _Probe:
    """Records, at each visualized step, whether the train sampler is
    the guided one and its sample count."""

    _interval = 1

    def __init__(self, dataset, guided_type):
        self.dataset = dataset
        self.guided_type = guided_type
        self.seen = []

    def visualize(self, step, render, act_render):
        sampler = self.dataset.sampler
        self.seen.append((step, isinstance(sampler, self.guided_type),
                          sampler.num_samples))


def _count_refreshes(monkeypatch, cls):
    refreshes = []
    original = cls.set_occupancy_grid

    def counting(self, grid):
        refreshes.append(grid.shape)
        return original(self, grid)

    monkeypatch.setattr(cls, "set_occupancy_grid", counting)
    return refreshes


@pytest.mark.parametrize("schedule", [
    dict(num_steps=16, report_interval=8, steps_per_call=2,
         occupancy_interval=4, occupancy_start=4),
    dict(num_steps=16, report_interval=8, steps_per_call=2,
         occupancy_interval=4, occupancy_start=4, occupancy_mix=2),
    dict(num_steps=18, report_interval=6, steps_per_call=3,
         occupancy_interval=3, occupancy_start=3, occupancy_end=12),
], ids=["guided", "mix", "tail"])
def test_guided_fit_schedule_matches_jax(scene, monkeypatch, capsys,
                                         schedule):
    """The guided sampler takes over, refreshes, anchors and hands back
    on the same steps as in JAX's ``fit``; the port's refreshes keep the
    grid's storage; the base sampler is back afterwards; the anchor
    steps sample through the base sampler."""
    model, params, port = _pair(2)
    jax_refreshes = _count_refreshes(monkeypatch, OccupancyGridSampler)
    port_refreshes = _count_refreshes(monkeypatch,
                                      port_occ.OccupancyGridSampler)
    train = ffn.ImageDataset.load(scene, "train", 8, stratified=True)
    base = train.sampler
    probe = _Probe(train, OccupancyGridSampler)
    _, jax_log = ffn.Raycaster(model).fit(
        params, train, ffn.ImageDataset.load(scene, "val", 8),
        visualizers=[probe], **FIT, **schedule)
    assert train.sampler is base
    jax_printed = capsys.readouterr().out

    port_train = TorchDataset.load(scene, "train", 8, stratified=True)
    port_base = port_train.sampler
    port_probe = _Probe(port_train, port_occ.OccupancyGridSampler)
    pointers = set()
    samplers = {"base": 0, "guided": 0}
    sample = TorchSampler.sample

    def spy(self, idx, step=None, rng=None):
        if isinstance(self, port_occ.OccupancyGridSampler):
            samplers["guided"] += 1
            pointers.add(self.occupancy.data_ptr())
        elif self is port_base and step is not None:
            samplers["base"] += 1
        return sample(self, idx, step, rng)

    monkeypatch.setattr(TorchSampler, "sample", spy)
    log = TorchRaycaster(port).fit(
        port_train, TorchDataset.load(scene, "val", 8),
        visualizers=[port_probe], **FIT, **schedule)
    printed = capsys.readouterr().out
    assert port_train.sampler is port_base
    assert port_probe.seen == probe.seen
    assert any(guided for _, guided, _ in port_probe.seen)
    assert {n for _, guided, n in port_probe.seen if guided} == {6}
    assert [e.step for e in log] == [e.step for e in jax_log]
    assert len(port_refreshes) == len(jax_refreshes) >= 2   # install, refresh
    assert len(pointers) == 1     # refreshed in place
    for message in ("Enabling occupancy-guided sampling",
                    "Restoring full sampling"):
        assert (message in printed) == (message in jax_printed)
    if schedule.get("occupancy_mix"):
        # base-sampler train steps after the guided sampler took over
        first_guided = min(s for s, guided, _ in port_probe.seen if guided)
        assert samplers["base"] > first_guided + 1


def test_resume_into_the_guided_phase(scene, tmp_path):
    """A checkpoint from before ``occupancy_start``: the resumed run
    turns the guided sampler on on schedule, and restores the base
    sampler at the end."""
    _, _, port = _pair(3)
    directory = str(tmp_path / "ckpts")
    common = dict(report_interval=6, steps_per_call=2,
                  checkpoint_dir=directory, checkpoint_interval=4, **FIT)
    train = TorchDataset.load(scene, "train", 8, stratified=True)
    val = TorchDataset.load(scene, "val", 8)
    base = train.sampler
    TorchRaycaster(port).fit(train, val, num_steps=7, **common)
    probe = _Probe(train, port_occ.OccupancyGridSampler)
    log = TorchRaycaster(_pair(4)[2]).fit(
        train, val, num_steps=15, resume=True, occupancy_interval=4,
        occupancy_start=10, visualizers=[probe], **common)
    guided = [step for step, on, _ in probe.seen if on]
    # the newest file is step 5's (windows [4, 5] covers 4): the resumed
    # run's first call is [6, 7]; after [10, 11] the guided sampler is
    # on, as the visualizers of step 11 see
    assert probe.seen[0][0] == 7
    assert guided and guided[0] == 11
    assert train.sampler is base
    assert log[0].step > 5


def test_sampler_restored_after_an_error(scene):
    """The ``finally`` of ``fit``: an error inside the guided phase
    still hands the dataset its own sampler back."""
    _, _, port = _pair(5)
    train = TorchDataset.load(scene, "train", 8, stratified=True)
    base = train.sampler

    class Failing:
        _interval = 1

        def visualize(self, step, render, act_render):
            if isinstance(train.sampler, port_occ.OccupancyGridSampler):
                raise RuntimeError("stop")

    with pytest.raises(RuntimeError, match="stop"):
        TorchRaycaster(port).fit(train, TorchDataset.load(scene, "val", 8),
                                 num_steps=10, report_interval=5,
                                 occupancy_interval=2, occupancy_start=2,
                                 visualizers=[Failing()], **FIT)
    assert train.sampler is base


def test_focus_sampler_rejects_occupancy_training(scene):
    _, _, port = _pair()
    opacity = _pair(1)[2]
    train = TorchDataset.load(scene, "train", 8, opacity_model=opacity)
    with pytest.raises(ValueError, match="focus"):
        TorchRaycaster(port).fit(train, TorchDataset.load(scene, "val", 8),
                                 num_steps=2, report_interval=2,
                                 occupancy_interval=2, **FIT)
