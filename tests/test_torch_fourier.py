"""The port's Fourier Feature MLP family against the JAX package's: the
encodes of the four variants, the model's outputs (d = 1, 2, 3) in f32
and bf16 and its weight gradients, NPZ and ``.pt`` checkpoints both
ways, a ``Raycaster.fit`` train step of a tiny FFN, and the activation
render."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fourier_feature_nets_tpu as ffn
from fourier_feature_nets_torch import models as port_models
from fourier_feature_nets_torch.ops import (
    basic_encoding_matrix,
    fourier_encode,
    gaussian_encoding_matrix,
    positional_encoding_matrix,
)
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_torch.render import RaySampler as TorchSampler
from fourier_feature_nets_tpu import models as jax_models
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
)
from fourier_feature_nets_tpu.cameras import Resolution
from fourier_feature_nets_tpu.ops import encoding as jax_encoding
from fourier_feature_nets_tpu.utils.camera_paths import orbit
from ffn_parity import fit_steps_match, flat as _flat

F32 = dict(rtol=1e-4, atol=1e-5)         # tests/test_models.py:82,152
BF16_ATOL = 0.05
GRAD = dict(rtol=2e-3, atol=2e-4)
VARIANTS = ("mlp", "basic", "positional", "gaussian")


def _jax_variant(kind, num_inputs, num_outputs, channels=32, layers=2,
                 embedding=48):
    if kind == "mlp":
        return jax_models.MLP(num_inputs, num_outputs, num_layers=layers,
                              num_channels=channels)
    if kind == "basic":
        return jax_models.BasicFourierMLP(num_inputs, num_outputs,
                                          num_layers=layers,
                                          num_channels=channels)
    if kind == "positional":
        return jax_models.PositionalFourierMLP(
            num_inputs, num_outputs, 6.0, num_layers=layers,
            num_channels=channels, embedding_size=embedding)
    return jax_models.GaussianFourierMLP(
        num_inputs, num_outputs, 10.0, num_layers=layers,
        num_channels=channels, embedding_size=embedding,
        rng=jax.random.PRNGKey(7))


def _pair(kind, num_inputs, num_outputs=3, seed=0, **kwargs):
    """A JAX FFN variant with its weights and the port's model built
    from its manifest and carrying the same weights and (a, B)."""
    model = _jax_variant(kind, num_inputs, num_outputs, **kwargs)
    params = model.init(jax.random.PRNGKey(seed))
    port = port_models.build_model("fourier", model.params_manifest)
    return model, params, port_models.params_from_jax(port, _flat(params))


def _inputs(num, num_inputs, seed=1):
    """Coordinates over [0, 2), the FFNs' input range."""
    return np.random.default_rng(seed).uniform(
        0, 2, (num, num_inputs)).astype(np.float32)


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", VARIANTS[1:])
@pytest.mark.parametrize("num_inputs", [1, 2, 3])
def test_encode_matches_jax(kind, num_inputs):
    """gamma(x) of each encoded variant, with JAX's (a, B) carried
    across: the f32 phase product, pi scale, cos block first."""
    model, _, port = _pair(kind, num_inputs)
    x = _inputs(300, num_inputs)
    ref = np.asarray(model.encode(jnp.asarray(x)))
    ours = port.encode(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (300, 2 * model.b_values.shape[1])
    np.testing.assert_allclose(ours, ref, **F32)


def test_mlp_variant_does_not_encode():
    model, _, port = _pair("mlp", 2)
    assert port.b_values is None and port.a_values is None
    x = torch.from_numpy(_inputs(10, 2))
    assert torch.equal(port.encode(x), x)
    assert port.params_manifest == model.params_manifest


@pytest.mark.parametrize("num_inputs", [1, 2, 3])
def test_encoding_matrices_match_jax(num_inputs):
    np.testing.assert_array_equal(
        basic_encoding_matrix(num_inputs),
        jax_encoding.basic_encoding_matrix(num_inputs))
    np.testing.assert_array_equal(
        positional_encoding_matrix(5.5, 8, num_inputs),
        jax_encoding.positional_encoding_matrix(5.5, 8, num_inputs))


def test_gaussian_matrix_draws_from_the_generator():
    """B ~ N(0, sigma) from a ``torch.Generator``: the same seed draws
    the same matrix, another seed another; its spread is sigma."""
    def draw(seed):
        return gaussian_encoding_matrix(
            torch.Generator().manual_seed(seed), 10.0, 2, 4096)
    first = draw(3)
    assert first.dtype == np.float32 and first.shape == (2, 4096)
    np.testing.assert_array_equal(first, draw(3))
    assert not np.array_equal(first, draw(4))
    assert abs(float(first.std()) - 10.0) < 0.3


def test_fourier_encode_amplitudes_and_scale():
    """``fourier_encode`` against the formula, with amplitudes and a
    scale of 1 (the NeRF's convention)."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    b = rng.normal(size=(3, 6)).astype(np.float32)
    a = rng.uniform(0.5, 2, 6).astype(np.float32)
    ref = np.asarray(jax_encoding.fourier_encode(
        jnp.asarray(x), jnp.asarray(b), jnp.asarray(a), scale=1.0))
    ours = fourier_encode(torch.from_numpy(x), torch.from_numpy(b),
                          torch.from_numpy(a), scale=1.0).numpy()
    np.testing.assert_allclose(ours, ref, **F32)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", VARIANTS)
@pytest.mark.parametrize("num_inputs", [1, 2, 3])
def test_outputs_match_jax(kind, num_inputs):
    model, params, port = _pair(kind, num_inputs)
    x = _inputs(400, num_inputs)
    ref = np.asarray(model.apply(params, jnp.asarray(x)))
    ours = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(ours, ref, **F32)
    ref_bf16 = np.asarray(model.apply(params, jnp.asarray(x),
                                      compute_dtype=jnp.bfloat16))
    ours_bf16 = port(torch.from_numpy(x),
                     compute_dtype=torch.bfloat16).detach().numpy()
    np.testing.assert_allclose(ours_bf16, ref_bf16, atol=BF16_ATOL)


def test_return_hidden_and_leading_axes_match_jax():
    """(H, W, 2) UVs in, (H, W, 3) out, with the last hidden layer."""
    model, params, port = _pair("gaussian", 2)
    uv = _inputs(48, 2).reshape(6, 8, 2)
    ref_out, ref_hidden = model.apply(params, jnp.asarray(uv),
                                      return_hidden=True)
    out, hidden = port(torch.from_numpy(uv), return_hidden=True)
    assert out.shape == (6, 8, 3) and hidden.shape == (6, 8, 32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **F32)
    np.testing.assert_allclose(hidden.detach().numpy(),
                               np.asarray(ref_hidden), **F32)


@pytest.mark.parametrize("kind", VARIANTS)
def test_weight_gradients_match_jax(kind):
    """The gradient of a random-cotangent loss at every weight."""
    model, params, port = _pair(kind, 3, 4)
    x = _inputs(256, 3)
    cot = np.random.default_rng(5).normal(size=(256, 4)).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(model.apply(p, jnp.asarray(x))
                                       * cot))(params)
    torch.sum(port(torch.from_numpy(x)) * torch.from_numpy(cot)).backward()
    ref = _flat(grads)
    named = port_models.serialization.named_parameters(port)
    assert sorted(named) == sorted(ref)
    for path, param in named.items():
        grad = port_models.serialization.to_jax_layout(
            path, param.grad.numpy())
        np.testing.assert_allclose(grad, ref[path], err_msg=path, **GRAD)


def test_variants_draw_from_the_generator():
    """The same seed builds the same model; the variants' manifests
    rebuild a ``FourierFeatureMLP`` with equal outputs."""
    def build():
        return port_models.GaussianFourierMLP(
            2, 3, 10.0, num_layers=2, num_channels=16, embedding_size=8,
            generator=torch.Generator().manual_seed(11))
    first, second = build(), build()
    x = torch.from_numpy(_inputs(20, 2))
    assert torch.equal(first(x), second(x))
    rebuilt = port_models.build_model("fourier", first.params_manifest)
    rebuilt.load_state_dict(first.state_dict())
    assert type(rebuilt) is port_models.FourierFeatureMLP
    assert torch.equal(rebuilt(x), first(x))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", VARIANTS)
def test_npz_checkpoints_load_both_ways(kind, tmp_path):
    model, params, port = _pair(kind, 2)
    x = _inputs(64, 2)
    jax_path = str(tmp_path / "jax.npz")
    jax_models.save_model(model, params, jax_path)
    loaded = port_models.load_model(jax_path)
    np.testing.assert_array_equal(loaded(torch.from_numpy(x)).detach(),
                                  port(torch.from_numpy(x)).detach())
    port_path = str(tmp_path / "port.npz")
    port_models.save_model(port, port_path)
    jax_model, jax_params = jax_models.load_model(port_path)
    assert jax_model.params_manifest == model.params_manifest
    np.testing.assert_array_equal(
        np.asarray(jax_model.apply(jax_params, jnp.asarray(x))),
        np.asarray(model.apply(params, jnp.asarray(x))))


@pytest.mark.parametrize("kind", ["mlp", "positional"])
def test_pt_checkpoints_load_both_ways(kind, tmp_path):
    """The reference's ``.pt``: the JAX package's file loads in the port
    and the port's in the JAX package, with equal outputs and the
    reference's keys."""
    model, params, port = _pair(kind, 2)
    x = _inputs(64, 2)
    jax_path = str(tmp_path / "jax.pt")
    jax_models.save_torch_model(model, params, jax_path)
    loaded = port_models.load_model(jax_path)
    np.testing.assert_array_equal(loaded(torch.from_numpy(x)).detach(),
                                  port(torch.from_numpy(x)).detach())
    port_path = str(tmp_path / "port.pth")
    port_models.save_torch_model(port, port_path)
    state = torch.load(port_path, weights_only=True)
    expected = torch.load(jax_path, weights_only=False)
    assert sorted(state) == sorted(expected)
    jax_model, jax_params = jax_models.load_model(port_path)
    np.testing.assert_array_equal(
        np.asarray(jax_model.apply(jax_params, jnp.asarray(x))),
        np.asarray(model.apply(params, jnp.asarray(x))))


def test_nerf_pt_checkpoints_load_both_ways(tmp_path):
    config = dict(num_layers=3, num_channels=32, max_log_scale_pos=4.0,
                  num_freq_pos=5, max_log_scale_view=2.0, num_freq_view=3,
                  skips=[1], include_inputs=True)
    model = jax_models.NeRF(**config)
    params = model.init(jax.random.PRNGKey(3))
    port = port_models.params_from_jax(port_models.NeRF(**config),
                                       _flat(params))
    rng = np.random.default_rng(4)
    pos = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    views = rng.normal(size=(64, 3)).astype(np.float32)
    jax_path = str(tmp_path / "jax.pt")
    jax_models.save_torch_model(model, params, jax_path)
    loaded = port_models.load_model(jax_path)
    assert torch.equal(loaded(torch.from_numpy(pos), torch.from_numpy(views)),
                       port(torch.from_numpy(pos), torch.from_numpy(views)))
    port_path = str(tmp_path / "port.pt")
    port_models.save_torch_model(port, port_path)
    _, jax_params = jax_models.load_model(port_path)
    for key, value in _flat(params).items():
        np.testing.assert_array_equal(_flat(jax_params)[key], value,
                                      err_msg=key)


# ---------------------------------------------------------------------------
# rendering and training through the raycaster
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    return generate_synthetic_dataset(path, resolution=16,
                                      split_counts=(3, 1, 1),
                                      volume_side=16, num_samples=64)


def test_fit_step_of_a_tiny_ffn_matches_jax(scene, monkeypatch):
    model, params, port = _pair("positional", 3, 4, channels=32,
                                embedding=24)
    fit_steps_match(scene, monkeypatch, model, params, port)


def test_render_activations_matches_jax():
    """The 8x8 grid of last-layer unit renders of one orbit camera,
    against JAX ``render_activations`` (uint8 within 1)."""
    model, params, port = _pair("gaussian", 3, 4, channels=64,
                                embedding=16)
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, -1.0]),
                    3, 40, Resolution(10, 10), 4)
    bounds = np.eye(4, dtype=np.float32) * 2
    jax_sampler = ffn.RaySampler(bounds, cameras, 12)
    port_sampler = TorchSampler(bounds, cameras, 12)
    ref = ffn.Raycaster(model).render_activations(params, jax_sampler, 4, 32)
    ours = TorchRaycaster(port).render_activations(port_sampler, 4, 32)
    assert ours.shape == ref.shape == (80, 80, 3) and ours.dtype == np.uint8
    assert int(np.abs(ours.astype(int) - ref.astype(int)).max()) <= 1
    assert ours.any()
