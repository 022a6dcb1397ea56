"""The fused NeRF kernel's plain twin against the JAX package's Pallas
kernels (interpret mode on the CPU) and the wrapper's contract. The
Hopper kernel itself is held against the twin on a card by
tests/test_torch_kernel_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourier_feature_nets_torch.kernels import fused_nerf as port
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_torch.render import Raycaster
from fourier_feature_nets_tpu.models import NeRF
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.ops.fused_nerf import (
    _fast_sincos,
    fused_nerf_apply,
    prepare_fused_nerf,
)
from fourier_feature_nets_tpu.ops.fused_nerf_fm import (
    fused_nerf_apply_fm,
    prepare_fused_nerf_fm,
)

BASE = dict(num_layers=4, num_channels=64, max_log_scale_pos=9.0,
            num_freq_pos=10, max_log_scale_view=3.0, num_freq_view=4,
            skips=[2], include_inputs=True)


def _pair(config, seed=0):
    model = NeRF(**config)
    params = model.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    return model, params, params_from_jax(TorchNeRF(**config), flat)


def _inputs(num, seed=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.5, 1.5, (num, 3)).astype(np.float32)
    views = rng.normal(size=(num, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    return pos, views


@pytest.fixture(scope="module")
def nerf():
    return _pair(BASE)


@pytest.fixture(scope="module")
def inputs():
    return _inputs(200)


def _twin(torch_model, dtype, pos, views):
    weights = port.prepare_fused_nerf(torch_model, dtype)
    with torch.no_grad():
        return port.fused_nerf_reference(weights, torch.from_numpy(pos),
                                         torch.from_numpy(views)).numpy()


@pytest.mark.parametrize("layout", ["rm", "fm"])
def test_twin_f32_matches_pallas(nerf, inputs, layout):
    model, params, torch_model = nerf
    pos, views = inputs
    if layout == "rm":
        weights = prepare_fused_nerf(model, params, dtype=jnp.float32)
        ref = fused_nerf_apply(model, weights, jnp.asarray(pos),
                               jnp.asarray(views), tile=128, interpret=True)
    else:
        weights = prepare_fused_nerf_fm(model, params, dtype=jnp.float32)
        ref = fused_nerf_apply_fm(model, weights, jnp.asarray(pos),
                                  jnp.asarray(views), tile=128,
                                  interpret=True)
    ours = _twin(torch_model, torch.float32, pos, views)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("layout", ["rm", "fm"])
def test_twin_bf16_matches_pallas(nerf, inputs, layout):
    model, params, torch_model = nerf
    pos, views = inputs
    if layout == "rm":
        weights = prepare_fused_nerf(model, params, dtype=jnp.bfloat16)
        ref = fused_nerf_apply(model, weights, jnp.asarray(pos),
                               jnp.asarray(views), tile=128, interpret=True)
    else:
        weights = prepare_fused_nerf_fm(model, params, dtype=jnp.bfloat16)
        ref = fused_nerf_apply_fm(model, weights, jnp.asarray(pos),
                                  jnp.asarray(views), tile=128,
                                  interpret=True)
    ours = _twin(torch_model, torch.bfloat16, pos, views)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=0.05)


def test_twin_ragged_batch_matches_pallas(nerf, inputs):
    model, params, torch_model = nerf
    pos, views = inputs[0][:77], inputs[1][:77]
    weights = prepare_fused_nerf(model, params, dtype=jnp.float32)
    ref = np.asarray(fused_nerf_apply(model, weights, jnp.asarray(pos),
                                      jnp.asarray(views), tile=128,
                                      interpret=True))
    ours = _twin(torch_model, torch.float32, pos, views)
    assert ours.shape == (77, 4)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("config", [
    dict(num_layers=2, num_channels=32, skips=[], include_inputs=False),
    dict(num_layers=3, num_channels=32, skips=[1, 2], include_inputs=True),
])
def test_twin_config_sweep_matches_jax_forward(config):
    """Structural axes (skip layout, raw-input concat) against the JAX
    model's own forward, at the JAX fused kernel's f32 tolerance."""
    full = dict(max_log_scale_pos=6.0, num_freq_pos=7,
                max_log_scale_view=2.0, num_freq_view=3, **config)
    model, params, torch_model = _pair(full, seed=5)
    pos, views = _inputs(96, seed=5)
    ref = np.asarray(model.apply(params, jnp.asarray(pos),
                                 jnp.asarray(views)))
    ours = _twin(torch_model, torch.float32, pos, views)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=2e-4)


def test_fast_sincos_matches_pallas_polynomial():
    x = np.linspace(-800, 800, 20001).astype(np.float32)
    sin, cos = port.fast_sincos(torch.from_numpy(x))
    ref_sin, ref_cos = _fast_sincos(jnp.asarray(x))
    np.testing.assert_allclose(sin.numpy(), np.asarray(ref_sin), atol=2e-6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(ref_cos), atol=2e-6)
    # and it is a good sin/cos over the encode's phase range
    np.testing.assert_allclose(sin.numpy(), np.sin(x.astype(np.float64)),
                               atol=1e-4)


def test_pack_layout(nerf):
    _, _, torch_model = nerf
    weights = port.prepare_fused_nerf(torch_model, torch.bfloat16)
    c = BASE["num_channels"]
    assert weights.pos_width == 64 and weights.view_width == 32
    shapes = [tuple(w.shape) for w, _ in weights.layers]
    assert shapes == [(64, c), (c, c), (c + 64, c), (c, c), (c, 16), (c, c),
                      (c + 32, c // 2), (c // 2, 16)]
    assert weights.weights.dtype == torch.bfloat16
    assert weights.biases.dtype == torch.float32
    assert weights.skips == (2,)
    # meta: header, then offsets matching the views
    assert list(weights.meta[:8]) == [4, c, 64, 32, 30, 12, 1, 1 << 2]
    offsets = weights.meta[8:8 + 8]
    for (w, _), off in zip(weights.layers, offsets):
        assert w.data_ptr() == (weights.weights.data_ptr()
                                + int(off) * w.element_size())
        assert int(off) % 256 == 0       # 32-byte aligned fragment loads
    # padding is zero and the live block is the (in, out) weight
    opacity_w, opacity_b = weights.layers[4]
    assert torch.count_nonzero(opacity_w[:, 1:]) == 0
    assert torch.count_nonzero(opacity_b[1:]) == 0
    first_w, _ = weights.layers[0]
    n_pos = torch_model.num_pos_encoded
    assert torch.count_nonzero(first_w[n_pos:]) == 0
    torch.testing.assert_close(
        first_w[:n_pos].float(),
        torch_model.layers[0].weight.detach().T.to(torch.bfloat16).float())


def test_cpu_wrapper_runs_twin_without_counting(nerf, inputs):
    _, _, torch_model = nerf
    weights = port.prepare_fused_nerf(torch_model, torch.float32)
    pos, views = map(torch.from_numpy, inputs)
    before = port.fused_nerf_apply.launches
    with torch.no_grad():
        out = port.fused_nerf_apply(weights, pos, views)
        twin = port.fused_nerf_reference(weights, pos, views)
    assert port.fused_nerf_apply.launches == before
    assert torch.equal(out, twin)


def test_wrapper_rejects_other_devices(nerf):
    _, _, torch_model = nerf
    weights = port.prepare_fused_nerf(torch_model, torch.float32)
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="no fused NeRF kernel"):
        port.fused_nerf_apply(weights, meta, meta)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "mismatch"])
def test_cuda_input_checks(nerf, bad):
    _, _, torch_model = nerf
    weights = port.prepare_fused_nerf(torch_model, torch.bfloat16)
    pos = torch.zeros(8, 3)
    views = torch.zeros(8, 3)
    if bad == "dtype":
        pos = pos.double()
    elif bad == "shape":
        pos = torch.zeros(8, 4)
    elif bad == "strided":
        pos = torch.zeros(3, 8).T
    else:
        views = torch.zeros(9, 3)
    with pytest.raises(ValueError):
        port._check_cuda_inputs(weights, pos, views)


def test_kernel_limits_are_checked():
    wide = TorchNeRF(num_layers=2, num_channels=48, max_log_scale_pos=3.0,
                     num_freq_pos=4, max_log_scale_view=1.0,
                     num_freq_view=2, skips=[], include_inputs=True)
    weights = port.prepare_fused_nerf(wide, torch.float32)
    with pytest.raises(ValueError, match="multiple of 32"):
        port._check_cuda_inputs(weights, torch.zeros(2, 3),
                                torch.zeros(2, 3))
    with pytest.raises(ValueError, match="layer 0"):
        port.prepare_fused_nerf(
            TorchNeRF(num_layers=2, num_channels=32, max_log_scale_pos=3.0,
                      num_freq_pos=4, max_log_scale_view=1.0,
                      num_freq_view=2, skips=[0], include_inputs=True))


def test_raycaster_repacks_after_in_place_update(nerf):
    _, _, torch_model = nerf
    model = TorchNeRF(**BASE)
    model.load_state_dict(torch_model.state_dict())
    caster = Raycaster(model, fused=True)
    first = caster._get_fused_weights()
    assert caster._get_fused_weights() is first
    with torch.no_grad():
        model.layers[0].bias.add_(1.0)
    second = caster._get_fused_weights()
    assert second is not first
    assert not torch.equal(first.biases, second.biases)
