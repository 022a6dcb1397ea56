"""Train-state checkpoints in the port against the JAX package: the
same NPZ format both ways (weights, Adam moments and step equal bit
for bit), the Adam state's mapping to JAX's ``AdamState`` (rtol 1e-5 /
atol 1e-7 of JAX's own after the same three steps, as
tests/test_torch_training.py holds the step itself), resumes across the
packages, a resume that continues at step + 1, and the background
writer's pruning."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import fourier_feature_nets_tpu as ffn
from fourier_feature_nets_torch.datasets import ImageDataset as TorchDataset
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax, params_to_jax
from fourier_feature_nets_torch.models.serialization import named_parameters
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_torch.utils import checkpoint as port_ckpt
from fourier_feature_nets_torch.utils.optim import ClippedAdam
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
)
from fourier_feature_nets_tpu.models import NeRF
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.utils import checkpoint as jax_ckpt
from fourier_feature_nets_tpu.utils.optim import adam_init, adam_update

SMALL = dict(num_layers=2, num_channels=32, max_log_scale_pos=4.0,
             num_freq_pos=5, max_log_scale_view=2.0, num_freq_view=3,
             skips=[], include_inputs=True)
FIT = dict(batch_size=64, learning_rate=1e-3, crop_steps=0,
           report_interval=4, decay_rate=0.1, decay_steps=1000)


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


def _random_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0, 0.05, p.shape).astype(np.float32)), params)


def _steps(model_pair, num_steps=3):
    """The same random gradients through JAX's ``adam_update`` and the
    port's ClippedAdam (weight decay, the clips, a decaying rate)."""
    _, params, port = model_pair
    state = adam_init(params)
    optimizer = ClippedAdam(port.parameters(), 1e-2, weight_decay=1e-3)
    named = named_parameters(port)
    for step in range(num_steps):
        grads = _random_grads(params, step)
        lr = 1e-2 * 0.5 ** (step / 10)
        params, state = adam_update(grads, state, params, lr,
                                    weight_decay=1e-3, clip_value=0.1,
                                    clip_norm=0.1)
        flat = {k: np.asarray(v) for k, v in _flatten(grads).items()}
        for path, p in named.items():
            g = torch.from_numpy(flat[path])
            p.grad = g.T.contiguous() if g.dim() == 2 else g
        optimizer.step(lr)
    return params, state, optimizer


def test_adam_state_maps_to_jax_adam_state():
    pair = _pair()
    _, state, optimizer = _steps(pair)
    step, mu, nu = optimizer.jax_state(named_parameters(pair[2]))
    assert step == int(state.step) == 3
    for ours, ref in ((mu, state.mu), (nu, state.nu)):
        ref = {k: np.asarray(v) for k, v in _flatten(ref).items()}
        assert sorted(ours) == sorted(ref)
        for key in ref:
            assert ours[key].shape == ref[key].shape, key
            np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5,
                                       atol=1e-7, err_msg=key)


def test_port_checkpoint_loads_in_jax(tmp_path):
    pair = _pair()
    _, _, optimizer = _steps(pair)
    port = pair[2]
    path = str(tmp_path / "ckpt_00000009.npz")
    port_ckpt.save_train_state(
        path, port, params_to_jax(port),
        port_ckpt.AdamState(*optimizer.jax_state(named_parameters(port))),
        9, seed=5)
    state = jax_ckpt.load_train_state(path)
    assert (state.step, state.seed) == (9, 5)
    assert type(state.model).__name__ == "NeRF"
    assert int(state.opt_state.step) == 3
    step, mu, nu = optimizer.jax_state(named_parameters(port))
    for ours, ref in ((params_to_jax(port), state.params),
                      (mu, state.opt_state.mu), (nu, state.opt_state.nu)):
        ref = {k: np.asarray(v) for k, v in _flatten(ref).items()}
        assert sorted(ours) == sorted(ref)
        for key in ref:
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    model, params, _ = _pair(1)
    state = adam_init(params)
    params, state = adam_update(_random_grads(params, 7), state, params, 1e-2)
    path = str(tmp_path / "ckpt_00000011.npz")
    jax_ckpt.save_train_state(path, model, jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, state), 11, seed=3)
    loaded = port_ckpt.load_train_state(path)
    assert (loaded.step, loaded.seed, loaded.opt_state.step) == (11, 3, 1)
    ref = {k: np.asarray(v) for k, v in _flatten(params).items()}
    for key, value in params_to_jax(loaded.model).items():
        np.testing.assert_array_equal(value, ref[key], err_msg=key)
    # into an optimizer and back out: the same arrays
    optimizer = ClippedAdam(loaded.model.parameters(), 1e-3)
    named = named_parameters(loaded.model)
    optimizer.load_jax_state(named, *loaded.opt_state)
    step, mu, nu = optimizer.jax_state(named)
    assert step == 1
    for ours, tree in ((mu, state.mu), (nu, state.nu)):
        for key, value in _flatten(tree).items():
            np.testing.assert_array_equal(ours[key], np.asarray(value))


def test_weights_only_file_is_not_a_train_state(tmp_path):
    from fourier_feature_nets_torch.models import save_model
    path = str(tmp_path / "model.npz")
    save_model(_pair()[2], path)
    with pytest.raises(ValueError, match="not a resumable"):
        port_ckpt.load_train_state(path)


def _fit(scene, torch_model, num_steps, checkpoint_dir, **kwargs):
    caster = TorchRaycaster(torch_model)
    return caster.fit(TorchDataset.load(scene, "train", 8),
                      TorchDataset.load(scene, "val", 8),
                      num_steps=num_steps, checkpoint_dir=checkpoint_dir,
                      **FIT, **kwargs)


def test_resume_continues_at_the_next_step(scene, tmp_path, capsys):
    """A port run checkpoints at steps 3 and 6; a resume with nothing
    left to run leaves the model equal to the newest file, and one that
    runs on starts at step 7."""
    directory = str(tmp_path / "ckpts")
    _fit(scene, _pair()[2], 6, directory, checkpoint_interval=3)
    assert sorted(os.listdir(directory)) == ["ckpt_00000003.npz",
                                             "ckpt_00000006.npz"]
    fresh = _pair(5)[2]
    assert _fit(scene, fresh, 6, directory, resume=True) == []
    state = port_ckpt.load_train_state(os.path.join(directory,
                                                    "ckpt_00000006.npz"))
    for key, value in params_to_jax(fresh).items():
        np.testing.assert_array_equal(value, state.params[key], err_msg=key)
    capsys.readouterr()
    log = _fit(scene, fresh, 8, directory, resume=True)
    printed = capsys.readouterr().out
    assert "ckpt_00000006.npz at step 7" in printed
    assert [line.split()[0] for line in printed.splitlines()
            if line.startswith("000")] == ["0000007", "0000008"]
    assert [entry.step for entry in log] == [8]


def test_resume_from_the_other_package(scene, tmp_path):
    """A checkpoint the JAX fit wrote resumes in the port's fit, and one
    the port's fit wrote resumes in the JAX fit, each at the weights of
    the file."""
    model, params, _ = _pair(2)
    jax_dir = str(tmp_path / "jax")
    train = ffn.ImageDataset.load(scene, "train", 8)
    val = ffn.ImageDataset.load(scene, "val", 8)
    ffn.Raycaster(model).fit(params, train, val, num_steps=4,
                             checkpoint_dir=jax_dir, checkpoint_interval=4,
                             **FIT)
    written = jax_ckpt.load_train_state(os.path.join(jax_dir,
                                                     "ckpt_00000004.npz"))
    port = _pair(3)[2]
    assert _fit(scene, port, 4, jax_dir, resume=True) == []
    ref = {k: np.asarray(v) for k, v in _flatten(written.params).items()}
    for key, value in params_to_jax(port).items():
        np.testing.assert_array_equal(value, ref[key], err_msg=key)

    port_dir = str(tmp_path / "port")
    _fit(scene, port, 2, port_dir, checkpoint_interval=2)
    ours = port_ckpt.load_train_state(os.path.join(port_dir,
                                                   "ckpt_00000002.npz"))
    resumed, log = ffn.Raycaster(model).fit(
        params, train, val, num_steps=2, checkpoint_dir=port_dir,
        resume=True, **FIT)
    assert log == []
    for key, value in _flatten(resumed).items():
        np.testing.assert_array_equal(np.asarray(value), ours.params[key],
                                      err_msg=key)


def test_async_writer_prunes_to_three_listed_files(tmp_path):
    """keep=3: the newest three survive, and a hand-written file that is
    not zero-padded is removed by its listed name."""
    port = _pair()[2]
    optimizer = ClippedAdam(port.parameters(), 1e-3)
    directory = str(tmp_path)
    port_ckpt.save_train_state(
        os.path.join(directory, "ckpt_7.npz"), port, params_to_jax(port),
        port_ckpt.AdamState(*optimizer.jax_state(named_parameters(port))), 7)
    with port_ckpt.AsyncCheckpointer(directory) as writer:
        for step in (10, 20, 30, 40):
            with torch.no_grad():
                port.layers[0].bias.fill_(float(step))
            writer.save(port, optimizer, step, seed=2)
            # one at a time: the queue keeps only the newest save
            writer.wait()
    assert sorted(os.listdir(directory)) == [
        "ckpt_00000020.npz", "ckpt_00000030.npz", "ckpt_00000040.npz"]
    state = port_ckpt.load_train_state(
        port_ckpt.latest_checkpoint(directory))
    assert (state.step, state.seed) == (40, 2)
    np.testing.assert_array_equal(state.params["layers/0/bias"],
                                  np.full(32, 40.0, np.float32))


def test_async_writer_latest_wins(tmp_path):
    port = _pair()[2]
    optimizer = ClippedAdam(port.parameters(), 1e-3)
    with port_ckpt.AsyncCheckpointer(str(tmp_path), keep=0) as writer:
        for step in range(1, 31):
            writer.save(port, optimizer, step)
    state = port_ckpt.load_train_state(
        port_ckpt.latest_checkpoint(str(tmp_path)))
    assert state.step == 30
