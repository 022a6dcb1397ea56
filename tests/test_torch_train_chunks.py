"""Several train steps a call (``steps_per_call``) in the port against
the JAX package's ``multi_step`` and ``fit``: the rays and the step of
each inner step, where a chunk wraps around the epoch's permutation,
are JAX's exactly; the steps at which ``fit`` reports, checkpoints and
visualizes are JAX's exactly, with the crop transition inside a chunk.
On the CPU a chunk is an eager loop; the CUDA graph that runs it on a
card is checked by ``chip_smoke.py`` and the card tests."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import fourier_feature_nets_torch.render.ray_sampler as port_sampler_module
import fourier_feature_nets_torch.utils.checkpoint as port_ckpt
import fourier_feature_nets_tpu as ffn
import fourier_feature_nets_tpu.render.ray_sampler as jax_sampler_module
import fourier_feature_nets_tpu.utils.checkpoint as jax_ckpt
from fourier_feature_nets_torch.datasets import ImageDataset as TorchDataset
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_torch.utils.optim import ClippedAdam
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
)
from fourier_feature_nets_tpu.models import NeRF
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.utils.optim import adam_init

SMALL = dict(num_layers=2, num_channels=32, max_log_scale_pos=4.0,
             num_freq_pos=5, max_log_scale_view=2.0, num_freq_view=3,
             skips=[], include_inputs=True)
BATCH = 64


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


def test_chunk_schedule_matches_jax_multi_step(scene, monkeypatch):
    """steps_per_call = 4 from an offset where the third and fourth
    inner steps wrap around ``len(perm) - batch + 1``: each inner
    step's ray ids and step equal those JAX's scan feeds its sampler."""
    model, params, port = _pair()
    jax_train = ffn.ImageDataset.load(scene, "train", 8)
    port_train = TorchDataset.load(scene, "train", 8)
    pool = jax_train.index_pool()
    np.testing.assert_array_equal(pool, port_train.index_pool())
    perm = np.random.default_rng(3).permutation(pool)
    modulo = len(perm) - BATCH + 1
    offset = ((modulo - 1) // BATCH - 1) * BATCH
    assert offset + 2 * BATCH >= modulo     # the chunk wraps

    seen = {"jax": [], "port": []}
    jax_sample = jax_sampler_module.RaySampler.sample
    port_sample = port_sampler_module.RaySampler.sample

    def record_jax(values, step):
        seen["jax"].append((np.asarray(values).copy(), int(step)))

    def jax_spy(self, idx, step=None, rng=None):
        jax.debug.callback(record_jax, idx, step)
        return jax_sample(self, idx, step, rng)

    def port_spy(self, idx, step=None, rng=None):
        seen["port"].append((idx.numpy().copy(), int(step)))
        return port_sample(self, idx, step, rng)

    monkeypatch.setattr(jax_sampler_module.RaySampler, "sample", jax_spy)
    monkeypatch.setattr(port_sampler_module.RaySampler, "sample", port_spy)
    jax_step = ffn.Raycaster(model)._make_train_step(
        jax_train, BATCH, 1e-3, 0.1, 1000, 0.0, steps_per_call=4)
    jax.block_until_ready(jax_step(
        params, adam_init(params), jnp.asarray(perm, jnp.int32),
        jnp.asarray(offset, jnp.int32), jnp.asarray(20, jnp.int32),
        jax.random.PRNGKey(1)))
    port_step = TorchRaycaster(port)._make_train_step(
        port_train, BATCH, 1e-3, 0.1, 1000,
        ClippedAdam(port.parameters(), 1e-3), steps_per_call=4)
    loss = port_step(torch.from_numpy(perm), offset, 20, 1)
    assert torch.isfinite(loss)

    assert [s for _, s in seen["port"]] == [s for _, s in seen["jax"]] == [
        20, 21, 22, 23]
    for (ours, _), (ref, _) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(ours, ref)
    starts = [int(np.flatnonzero(perm == ids[0])[0]) for ids, _ in
              seen["port"]]
    assert starts == [(offset + k * BATCH) % modulo for k in range(4)]
    assert starts[2] < offset


class _Recorder:
    """An AsyncCheckpointer stand-in that records the saved steps."""

    saved = []

    def __init__(self, directory, prefix="ckpt_", keep=3):
        pass

    def save(self, *args):
        type(self).saved.append(args[-2])

    def close(self):
        pass


class _Steps:
    _interval = 1

    def __init__(self):
        self.steps = []

    def visualize(self, step, render, act_render):
        self.steps.append(step)


@pytest.mark.parametrize("schedule", [
    dict(num_steps=20, crop_steps=10, report_interval=10, steps_per_call=5,
         checkpoint_interval=10),
    dict(num_steps=13, crop_steps=3, report_interval=4, steps_per_call=3,
         checkpoint_interval=3),
], ids=["crop-at-report", "crop-inside-chunk"])
def test_fit_reports_and_checkpoints_match_jax(scene, monkeypatch, capsys,
                                               schedule):
    """Reports (printed and logged), checkpoints and visualizer calls
    land on the steps JAX's ``fit`` gives them, with the crop removed
    inside a chunk and the epoch restarted after it."""
    model, params, port = _pair(1)
    common = dict(batch_size=BATCH, learning_rate=1e-3, decay_rate=0.1,
                  decay_steps=1000, checkpoint_dir="unused", **schedule)
    runs = {}
    for name, module in (("jax", jax_ckpt), ("port", port_ckpt)):
        _Recorder.saved = []
        monkeypatch.setattr(module, "AsyncCheckpointer", _Recorder)
        visualizer = _Steps()
        if name == "jax":
            _, log = ffn.Raycaster(model).fit(
                params, ffn.ImageDataset.load(scene, "train", 8),
                ffn.ImageDataset.load(scene, "val", 8),
                visualizers=[visualizer], **common)
        else:
            log = TorchRaycaster(port).fit(
                TorchDataset.load(scene, "train", 8),
                TorchDataset.load(scene, "val", 8),
                visualizers=[visualizer], **common)
        printed = capsys.readouterr().out.splitlines()
        runs[name] = {
            "reports": [int(line.split()[0]) for line in printed
                        if line[:1].isdigit()],
            "crop": [i for i, line in enumerate(printed)
                     if line.startswith("Removing center crop")],
            "log": [entry.step for entry in log],
            "checkpoints": list(_Recorder.saved),
            "visualized": visualizer.steps}
    assert runs["port"] == runs["jax"]
    assert runs["port"]["checkpoints"] and runs["port"]["crop"]
