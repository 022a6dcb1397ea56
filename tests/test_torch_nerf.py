"""The port's NeRF module and checkpoints against the JAX package's."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourier_feature_nets_torch.models import (
    NeRF as TorchNeRF,
    flagship_nerf as torch_flagship,
    load_model as torch_load,
    params_from_jax,
    params_to_jax,
    save_model as torch_save,
)
from fourier_feature_nets_tpu.models import NeRF, flagship_nerf
from fourier_feature_nets_tpu.models import load_model as jax_load
from fourier_feature_nets_tpu.models import save_model as jax_save
from fourier_feature_nets_tpu.models.serialization import _flatten

CONFIGS = {
    "skip2": dict(num_layers=4, num_channels=64, max_log_scale_pos=9.0,
                  num_freq_pos=10, max_log_scale_view=3.0, num_freq_view=4,
                  skips=[2], include_inputs=True),
    "noraw": dict(num_layers=3, num_channels=32, max_log_scale_pos=9.0,
                  num_freq_pos=10, max_log_scale_view=3.0, num_freq_view=4,
                  skips=[1], include_inputs=False),
    "noskip": dict(num_layers=3, num_channels=48, max_log_scale_pos=5.5,
                   num_freq_pos=8, max_log_scale_view=1.5, num_freq_view=2,
                   skips=[], include_inputs=True),
}


def _pair(config, seed=0):
    model = NeRF(**config)
    params = model.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    port = params_from_jax(TorchNeRF(**config), flat)
    return model, params, port


def _inputs(num, seed=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.5, 1.5, (num, 3)).astype(np.float32)
    views = rng.normal(size=(num, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    return pos, views


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_f32_matches_jax(name):
    model, params, port = _pair(CONFIGS[name])
    pos, views = _inputs(200)
    ref = np.asarray(model.apply(params, jnp.asarray(pos),
                                 jnp.asarray(views)))
    with torch.no_grad():
        ours = port(torch.from_numpy(pos), torch.from_numpy(views)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=2e-4)


def test_forward_bf16_matches_jax():
    model, params, port = _pair(CONFIGS["skip2"])
    pos, views = _inputs(200)
    ref = np.asarray(model.apply(params, jnp.asarray(pos),
                                 jnp.asarray(views),
                                 compute_dtype=jnp.bfloat16))
    with torch.no_grad():
        ours = port(torch.from_numpy(pos), torch.from_numpy(views),
                    compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(ours, ref, atol=0.05)
    np.testing.assert_allclose(ours, ref, atol=5e-3)


def test_structure_matches_jax_params():
    model, params, port = _pair(CONFIGS["skip2"])
    flat = params_to_jax(port)
    ref = {k: np.asarray(v) for k, v in _flatten(params).items()}
    assert sorted(flat) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(flat[key], ref[key])
    assert port.params_manifest == model.params_manifest
    assert port.num_pos_encoded == model.num_pos_encoded
    assert port.num_view_encoded == model.num_view_encoded


def test_flagship_configs_agree():
    assert torch_flagship().params_manifest == \
        flagship_nerf().params_manifest


def test_init_is_seeded_and_bounded():
    a = TorchNeRF(**CONFIGS["skip2"],
                  generator=torch.Generator().manual_seed(4))
    b = TorchNeRF(**CONFIGS["skip2"],
                  generator=torch.Generator().manual_seed(4))
    c = TorchNeRF(**CONFIGS["skip2"],
                  generator=torch.Generator().manual_seed(5))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        assert not torch.equal(pa, pc), name
    layer = a.layers[1]
    bound = 1.0 / np.sqrt(layer.in_features)
    assert layer.weight.abs().max() <= bound
    assert layer.bias.abs().max() <= bound
    # U(-b, b) has standard deviation b / sqrt(3)
    std = float(layer.weight.detach().std())
    assert abs(std - bound / np.sqrt(3)) < 0.1 * bound


def test_jax_checkpoint_loads_into_port(tmp_path):
    model, params, _ = _pair(CONFIGS["skip2"], seed=7)
    path = str(tmp_path / "jax.npz")
    jax_save(model, params, path)
    port = torch_load(path)
    pos, views = _inputs(64)
    ref = np.asarray(model.apply(params, jnp.asarray(pos),
                                 jnp.asarray(views)))
    with torch.no_grad():
        ours = port(torch.from_numpy(pos), torch.from_numpy(views)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=2e-4)


def test_port_checkpoint_loads_into_jax(tmp_path):
    port = TorchNeRF(**CONFIGS["noraw"],
                     generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "port.npz")
    torch_save(port, path)
    model, params = jax_load(path)
    assert model.params_manifest == port.params_manifest
    ref = params_to_jax(port)
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    assert sorted(flat) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(flat[key], ref[key])
    # and back again
    again = torch_load(path)
    for pa, pb in zip(port.parameters(), again.parameters()):
        assert torch.equal(pa, pb)


def test_train_state_checkpoint_loads(tmp_path):
    model, params, _ = _pair(CONFIGS["noskip"], seed=2)
    flat = {f"params/{k}": np.asarray(v)
            for k, v in _flatten(params).items()}
    flat["opt/mu/x"] = np.zeros(3, np.float32)
    manifest = {"type": "nerf", "params": model.params_manifest,
                "format": "ffn_tpu_train_state_v1"}
    path = str(tmp_path / "state.npz")
    with open(path, "wb") as handle:
        np.savez(handle, __manifest__=json.dumps(manifest), **flat)
    port = torch_load(path)
    np.testing.assert_array_equal(
        port.layers[0].weight.detach().numpy().T,
        np.asarray(params["layers"][0]["weight"]))


def test_params_from_jax_rejects_bad_shapes_and_keys():
    _, params, port = _pair(CONFIGS["skip2"])
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    wrong = dict(flat)
    wrong["layers/1/weight"] = wrong["layers/1/weight"][:-1]
    with pytest.raises(ValueError, match="layers/1/weight"):
        params_from_jax(port, wrong)
    extra = dict(flat, **{"layers/9/bias": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="layers/9/bias"):
        params_from_jax(port, extra)
    missing = dict(flat)
    del missing["color_out/bias"]
    with pytest.raises(KeyError, match="color_out/bias"):
        params_from_jax(port, missing)


def test_non_nerf_checkpoint_is_not_ported(tmp_path):
    """Every model type the JAX package has is ported now: a JAX voxels
    NPZ loads into the port's ``Voxels`` (its outputs are held in
    tests/test_torch_voxels.py). What the port still turns away is a
    checkpoint type neither package has, and the factorized field's
    reference ``.pt``, which neither package defines."""
    from fourier_feature_nets_torch.models import FactorizedVoxels
    from fourier_feature_nets_torch.models import Voxels as TorchVoxels
    from fourier_feature_nets_torch.models import save_torch_model
    from fourier_feature_nets_tpu.models import Voxels
    model = Voxels(4, 1.0)
    params = model.init(jax.random.PRNGKey(0))
    path = str(tmp_path / "vox.npz")
    jax_save(model, params, path)
    assert isinstance(torch_load(path), TorchVoxels)
    unknown = str(tmp_path / "unknown.npz")
    with open(unknown, "wb") as handle:
        np.savez(handle, __manifest__=json.dumps({"type": "mesh",
                                                  "params": {}}))
    with pytest.raises(ValueError, match="mesh"):
        torch_load(unknown)
    with pytest.raises(ValueError, match="no reference torch format"):
        save_torch_model(FactorizedVoxels(4, 1.0, rank=2),
                         str(tmp_path / "f.pt"))
