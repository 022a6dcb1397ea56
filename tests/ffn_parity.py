"""Helpers of the FFN, voxel and regression parity tests
(``tests/test_torch_fourier.py``, ``test_torch_voxels.py``,
``test_torch_regression_clis.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fourier_feature_nets_torch.render.ray_sampler as port_sampler_module
import fourier_feature_nets_tpu as ffn
import fourier_feature_nets_tpu.render.ray_sampler as jax_sampler_module
from fourier_feature_nets_torch.datasets import ImageDataset as TorchDataset
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_torch.utils.optim import ClippedAdam
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.utils.optim import adam_init


def flat(params) -> dict:
    """A JAX params pytree as the flat ``{path: array}`` dict."""
    return {k: np.asarray(v) for k, v in _flatten(params).items()}


def inject_jitter(monkeypatch, jitter: np.ndarray) -> None:
    """Both samplers draw ``jitter`` (their generators differ by
    design)."""
    monkeypatch.setattr(jax_sampler_module, "per_ray_uniform",
                        lambda *args, **kwargs: jnp.asarray(jitter))
    monkeypatch.setattr(port_sampler_module, "per_ray_uniform",
                        lambda *args, **kwargs: torch.from_numpy(jitter))


def fit_steps_match(scene, monkeypatch, jax_model, params, port,
                    num_samples=8, batch=64, learning_rate=1e-3,
                    num_steps=2) -> None:
    """``num_steps`` train steps (``_make_train_step``) of the JAX
    raycaster and of the port's from the same weights, stratified with
    the same jitter injected and the clipped Adam between them: each
    step's loss agrees within rtol 1e-5."""
    jax_data = ffn.ImageDataset.load(scene, "train", num_samples,
                                     stratified=True)
    port_data = TorchDataset.load(scene, "train", num_samples,
                                  stratified=True)
    perm = np.random.default_rng(6).permutation(jax_data.index_pool())
    inject_jitter(monkeypatch, np.random.default_rng(7).uniform(
        0, 1, (batch, num_samples)).astype(np.float32))
    jax_step = ffn.Raycaster(jax_model)._make_train_step(
        jax_data, batch, learning_rate, 0.1, 1000, 0.0)
    state = adam_init(params)
    caster = TorchRaycaster(port)
    assert not caster.fused and not caster.fused_train
    port_step = caster._make_train_step(
        port_data, batch, learning_rate, 0.1, 1000,
        ClippedAdam(port.parameters(), learning_rate))
    for step in range(num_steps):
        params, state, loss = jax_step(params, state, jnp.asarray(perm),
                                       step * batch, step,
                                       jax.random.PRNGKey(0))
        ours = port_step(torch.from_numpy(perm), step * batch, step, 0)
        assert float(ours) == pytest.approx(float(loss), rel=1e-5), step
