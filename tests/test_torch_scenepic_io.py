"""The port's scenepic inspections (``scenepic_io.py`` and the three
``to_scenepic`` methods) against the JAX package's.

scenepic is installed on neither machine, so both packages run under
the recording stand-in ``tests/fake_scenepic.py`` (installed in
``sys.modules``, as ``tests/test_scenepic_io.py`` does), wrapped by
``tests/scenepic_recorder.py``; the recorded call sequences are equal
call by call: the names, the scalars and strings, and the arrays within
rtol 1e-5 / atol 1e-6 (the model scene's colours, which pass through
each package's f32 model, within rtol 1e-4 / atol 2e-4). Without
scenepic each entry point raises the JAX package's ImportError."""

import sys

import jax
import numpy as np
import pytest

import fourier_feature_nets_tpu as ffn
from fourier_feature_nets_torch.datasets import ImageDataset as TorchDataset
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_torch.scenepic_io import (
    camera_to_scenepic,
    dataset_to_scenepic,
    model_to_scenepic,
)
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
)
from fourier_feature_nets_tpu.models import NeRF
from fourier_feature_nets_tpu.models.serialization import _flatten
from scenepic_recorder import assert_same_calls, recording_scenepic

CONFIG = dict(num_layers=2, num_channels=32, max_log_scale_pos=3.0,
              num_freq_pos=4, max_log_scale_view=1.0, num_freq_view=2,
              skips=[1], include_inputs=True)


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "scene.npz"
    generate_synthetic_dataset(str(path), resolution=20,
                               split_counts=(3, 1, 1), volume_side=16,
                               num_samples=64)
    return str(path)


def _record(monkeypatch, build):
    module, log = recording_scenepic()
    with monkeypatch.context() as patch:
        patch.setitem(sys.modules, "scenepic", module)
        build()
    return log


def test_camera_calls_match_jax(scene_path, monkeypatch):
    jax_data = ffn.ImageDataset.load(scene_path, "train", 8)
    port_data = TorchDataset.load(scene_path, "train", 8)
    ref = _record(monkeypatch, lambda: jax_data.cameras[1].to_scenepic(
        0.1, 50))
    ours = _record(monkeypatch, lambda: port_data.cameras[1].to_scenepic(
        0.1, 50))
    assert [e[0] for e in ours] == [
        "Transforms.gl_world_to_camera", "Transforms.gl_projection",
        "Camera"]
    assert_same_calls(ours, ref)


def test_dataset_scene_calls_match_jax(scene_path, monkeypatch):
    jax_data = ffn.ImageDataset.load(scene_path, "train", 8)
    port_data = TorchDataset.load(scene_path, "train", 8)
    ref = _record(monkeypatch, jax_data.to_scenepic)
    ours = _record(monkeypatch, port_data.to_scenepic)
    assert len(ours) > 60
    assert_same_calls(ours, ref)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_model_scene_calls_match_jax(scene_path, monkeypatch, fused):
    """The model scene through each raycaster (the port's fused path on
    the CPU runs K1's twin)."""
    model = NeRF(**CONFIG)
    params = model.init(jax.random.PRNGKey(3))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    port = params_from_jax(TorchNeRF(**CONFIG), flat)
    jax_data = ffn.ImageDataset.load(scene_path, "train", 8)
    port_data = TorchDataset.load(scene_path, "train", 8)
    ref = _record(monkeypatch, lambda: ffn.Raycaster(model).to_scenepic(
        params, jax_data, num_cameras=2, resolution=6, num_samples=8))
    caster = TorchRaycaster(port, fused=fused)
    ours = _record(monkeypatch, lambda: caster.to_scenepic(
        port_data, num_cameras=2, resolution=6, num_samples=8))
    assert_same_calls(ours, ref, rtol=1e-4, atol=2e-4)


def test_entry_points_raise_without_scenepic(scene_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "scenepic", None)
    data = TorchDataset.load(scene_path, "train", 8)
    caster = TorchRaycaster(params_from_jax(TorchNeRF(**CONFIG), {
        k: np.asarray(v) for k, v in _flatten(NeRF(**CONFIG).init(
            jax.random.PRNGKey(0))).items()}))
    for call in (lambda: camera_to_scenepic(data.cameras[0]),
                 lambda: dataset_to_scenepic(data),
                 lambda: model_to_scenepic(caster, data),
                 data.to_scenepic, data.cameras[0].to_scenepic,
                 lambda: caster.to_scenepic(data)):
        with pytest.raises(ImportError, match="optional 'scenepic'"):
            call()
