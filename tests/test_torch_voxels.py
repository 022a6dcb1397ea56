"""The port's voxel fields against the JAX package's: ``Voxels``
(``F.grid_sample`` against ``ops/grid_sample.py``, inside and beyond the
border, and its gradient against ``grid_sample_3d_fast``'s VJP) and
``FactorizedVoxels`` (gathers against the dense hat matmuls), their
NPZ, ``.pt`` and train-state checkpoints both ways, a ``Raycaster.fit``
train step of each, and the ``train_voxels`` and ``orbit_video`` CLIs
on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourier_feature_nets_torch import models as port_models
from fourier_feature_nets_torch.cli import orbit_video as torch_orbit
from fourier_feature_nets_torch.cli import train_voxels as port_train_voxels
from fourier_feature_nets_torch.cli import voxelize_model as port_voxelize
from fourier_feature_nets_torch.models.serialization import (
    named_parameters,
    params_to_jax,
    to_jax_layout,
)
from fourier_feature_nets_torch.utils import checkpoint as port_ckpt
from fourier_feature_nets_torch.utils.optim import ClippedAdam
from fourier_feature_nets_tpu import models as jax_models
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
)
from fourier_feature_nets_tpu.utils import checkpoint as jax_ckpt
from fourier_feature_nets_tpu.utils.optim import adam_init, adam_update
from ffn_parity import fit_steps_match, flat

F32 = dict(rtol=1e-4, atol=1e-5)         # tests/test_models.py:82,152
BF16_ATOL = 0.05
GRAD = dict(rtol=2e-3, atol=2e-4)


def _voxels(side=6, scale=1.5, seed=0):
    """JAX ``Voxels`` with a random grid (the init is zeros) and the
    port's with the same weights."""
    model = jax_models.Voxels(side, scale)
    params = model.init(None)
    rng = np.random.default_rng(seed)
    params["voxels"] = jnp.asarray(
        rng.normal(size=(side, side, side, 4)).astype(np.float32))
    params["bias"] = jnp.asarray(rng.normal(size=4).astype(np.float32))
    port = port_models.build_model("voxels", model.params_manifest)
    return model, params, port_models.params_from_jax(port, flat(params))


def _factorized(side=6, scale=1.5, rank=3, seed=0):
    model = jax_models.FactorizedVoxels(side, scale, rank=rank)
    params = model.init(jax.random.PRNGKey(seed))
    port = port_models.build_model("factorized_voxels",
                                   model.params_manifest)
    return model, params, port_models.params_from_jax(port, flat(params))


PAIRS = {"voxels": _voxels, "factorized_voxels": _factorized}


def _positions(num, extent, seed=1):
    return np.random.default_rng(seed).uniform(
        -extent, extent, (num, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(PAIRS))
@pytest.mark.parametrize("extent", [1.4, 3.0], ids=["inside", "beyond"])
def test_outputs_match_jax(kind, extent):
    """Inside the grid and beyond its border (scale 1.5: extent 3.0
    clamps), in f32 and bf16."""
    model, params, port = PAIRS[kind]()
    x = _positions(500, extent)
    ref = np.asarray(model.apply(params, jnp.asarray(x)))
    ours = port(torch.from_numpy(x)).detach().numpy()
    assert ours.shape == (500, 4)
    np.testing.assert_allclose(ours, ref, **F32)
    ref_bf16 = np.asarray(model.apply(params, jnp.asarray(x),
                                      compute_dtype=jnp.bfloat16))
    ours_bf16 = port(torch.from_numpy(x),
                     compute_dtype=torch.bfloat16).detach().numpy()
    np.testing.assert_allclose(ours_bf16, ref_bf16, atol=BF16_ATOL)


def test_cell_centers_and_border_are_exact():
    """At a cell center the grid value itself; beyond the border the
    border cell's (``padding_mode="border"``)."""
    model, params, port = _voxels(side=4, scale=1.0)
    grid = np.asarray(params["voxels"])        # (D, H, W, 4) = [z, y, x]
    bias = np.asarray(params["bias"])
    centers = (np.arange(4) + 0.5) / 4 * 2 - 1
    points = np.array([[centers[1], centers[2], centers[3]],
                       [5.0, -5.0, 0.0 + centers[0]]], np.float32)
    ours = port(torch.from_numpy(points)).detach().numpy()
    np.testing.assert_allclose(ours[0], grid[3, 2, 1] + bias, rtol=1e-6)
    np.testing.assert_allclose(ours[1], grid[0, 0, 3] + bias, rtol=1e-6)


@pytest.mark.parametrize("kind", sorted(PAIRS))
@pytest.mark.parametrize("extent", [1.4, 3.0], ids=["inside", "beyond"])
def test_weight_gradients_match_jax(kind, extent):
    """The gradient of a random-cotangent loss at every weight: for
    ``Voxels`` grid_sample's backward against the JAX package's
    ``grid_sample_3d_fast`` VJP (side <= 160), for the factorized field
    the gathers' backward against the hat matmuls' transposes."""
    model, params, port = PAIRS[kind]()
    x = _positions(400, extent)
    cot = np.random.default_rng(5).normal(size=(400, 4)).astype(np.float32)
    grads = flat(jax.grad(lambda p: jnp.sum(
        model.apply(p, jnp.asarray(x)) * cot))(params))
    torch.sum(port(torch.from_numpy(x)) * torch.from_numpy(cot)).backward()
    named = named_parameters(port)
    assert sorted(named) == sorted(grads)
    for path, param in named.items():
        np.testing.assert_allclose(to_jax_layout(path, param.grad.numpy()),
                                   grads[path], err_msg=path, **GRAD)


def test_dense_grid_matches_jax():
    model, params, port = _factorized()
    ref = np.asarray(model.dense_grid(params))
    ours = port.dense_grid().detach().numpy()
    assert ours.shape == ref.shape == (6, 6, 6, 4)
    np.testing.assert_allclose(ours, ref, **F32)


def test_factorized_init_draws_from_the_generator():
    def build(seed):
        return port_models.FactorizedVoxels(
            8, 1.0, rank=2, generator=torch.Generator().manual_seed(seed))
    first, second, third = build(1), build(1), build(2)
    for (name, a), b, c in zip(first.named_parameters(),
                               second.parameters(), third.parameters()):
        assert torch.equal(a, b), name
        if name != "bias":
            assert not torch.equal(a, c), name
    assert abs(float(first.plane_xy.detach().std()) - 0.1) < 0.02
    np.testing.assert_allclose(
        first.bias.detach().numpy(),
        np.asarray(jax_models.FactorizedVoxels(8, 1.0, 2).init(
            jax.random.PRNGKey(0))["bias"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_npz_checkpoints_load_both_ways(kind, tmp_path):
    model, params, port = PAIRS[kind]()
    x = _positions(64, 2.0)
    jax_path = str(tmp_path / "jax.npz")
    jax_models.save_model(model, params, jax_path)
    loaded = port_models.load_model(jax_path)
    assert type(loaded) is type(port)
    assert torch.equal(loaded(torch.from_numpy(x)), port(torch.from_numpy(x)))
    port_path = str(tmp_path / "port.npz")
    port_models.save_model(port, port_path)
    jax_model, jax_params = jax_models.load_model(port_path)
    assert jax_model.params_manifest == model.params_manifest
    for key, value in flat(params).items():
        np.testing.assert_array_equal(flat(jax_params)[key], value,
                                      err_msg=key)


def test_voxels_pt_checkpoints_load_both_ways(tmp_path):
    """The reference's layout: grid (1, 4, D, H, W), bias (1, 4)."""
    model, params, port = _voxels()
    jax_path = str(tmp_path / "jax.pt")
    jax_models.save_torch_model(model, params, jax_path)
    loaded = port_models.load_model(jax_path)
    for name in ("voxels", "bias"):
        assert torch.equal(getattr(loaded, name), getattr(port, name))
    port_path = str(tmp_path / "port.pt")
    port_models.save_torch_model(port, port_path)
    state = torch.load(port_path, weights_only=True)
    assert tuple(state["voxels"].shape) == (1, 4, 6, 6, 6)
    assert tuple(state["bias"].shape) == (1, 4)
    _, jax_params = jax_models.load_model(port_path)
    for key, value in flat(params).items():
        np.testing.assert_array_equal(flat(jax_params)[key], value,
                                      err_msg=key)


def test_factorized_pt_raises_in_both_packages(tmp_path):
    model, params, port = _factorized()
    with pytest.raises(ValueError, match="no reference torch format"):
        port_models.save_torch_model(port, str(tmp_path / "p.pt"))
    with pytest.raises(ValueError, match="no reference torch format"):
        jax_models.save_torch_model(model, params, str(tmp_path / "j.pt"))


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_train_state_checkpoints_load_both_ways(kind, tmp_path):
    """A resumable train state (weights and Adam moments in the JAX
    package's layouts: the grid and the planes channels-last) written
    by either package resumes in the other."""
    model, params, port = PAIRS[kind]()
    state = adam_init(params)
    optimizer = ClippedAdam(port.parameters(), 1e-2)
    named = named_parameters(port)
    for step in range(2):
        rng = np.random.default_rng(step)
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(
            size=p.shape).astype(np.float32)), params)
        params, state = adam_update(grads, state, params, 1e-2,
                                    clip_value=0.1, clip_norm=0.1)
        for path, value in flat(grads).items():
            named[path].grad = torch.tensor(
                np.ascontiguousarray(port_models.serialization
                                     .from_jax_layout(path, value)))
        optimizer.step(1e-2)
    port_path = str(tmp_path / "ckpt_00000002.npz")
    port_ckpt.save_train_state(
        port_path, port, params_to_jax(port),
        port_ckpt.AdamState(*optimizer.jax_state(named)), 2, seed=3)
    loaded = jax_ckpt.load_train_state(port_path)
    assert type(loaded.model) is type(model) and loaded.step == 2
    for ours, ref in ((loaded.params, params),
                      (loaded.opt_state.mu, state.mu),
                      (loaded.opt_state.nu, state.nu)):
        ours, ref = flat(ours), flat(ref)
        assert sorted(ours) == sorted(ref)
        for key in ref:
            np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)

    jax_path = str(tmp_path / "jax.npz")
    jax_ckpt.save_train_state(jax_path, model, params, state, 2, seed=3)
    resumed = port_ckpt.load_train_state(jax_path)
    assert type(resumed.model) is type(port)
    fresh = ClippedAdam(resumed.model.parameters(), 1e-2)
    fresh.load_jax_state(named_parameters(resumed.model),
                         *resumed.opt_state)
    step, mu, nu = fresh.jax_state(named_parameters(resumed.model))
    assert step == 2
    for ours, ref in ((params_to_jax(resumed.model), params),
                      (mu, state.mu), (nu, state.nu)):
        ref = flat(ref)
        for key in ref:
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


# ---------------------------------------------------------------------------
# training and the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    return generate_synthetic_dataset(path, resolution=16,
                                      split_counts=(3, 1, 1),
                                      volume_side=16, num_samples=64)


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_fit_step_of_a_voxel_field_matches_jax(scene, monkeypatch, kind):
    model, params, port = PAIRS[kind](side=8, scale=1.0)
    fit_steps_match(scene, monkeypatch, model, params, port,
                    learning_rate=1e-2)


_CLI = ["--device", "cpu", "--num-samples", "8", "--batch-size", "64",
        "--image-interval", "0", "--report-interval", "4"]


def _log_steps(results):
    with open(os.path.join(results, "log.txt")) as handle:
        rows = handle.read().split("\n\n", 1)[1].strip().splitlines()[1:]
    return [int(row.split("\t")[0]) for row in rows]


@pytest.mark.parametrize("flags", [[], ["--factorized-rank", "2"]],
                         ids=["dense", "factorized"])
def test_train_voxels_cli_on_cpu(scene, tmp_path, flags):
    out = str(tmp_path / "run")
    assert port_train_voxels.main([scene, "8", out, "--num-steps", "4",
                                   *_CLI, *flags]) == 0
    model = port_models.load_model(os.path.join(out, "voxels.npz"))
    expected = port_models.FactorizedVoxels if flags else port_models.Voxels
    assert type(model) is expected
    # half the extent of the scene's bounds, the JAX CLI's corrected form
    assert model.scale == 1.0 and model.side == 8
    assert os.path.exists(os.path.join(out, "voxels_best.npz"))
    assert _log_steps(out) == [0, 4]


def test_train_voxels_cli_resumes(scene, tmp_path, capsys):
    out = str(tmp_path / "run")
    assert port_train_voxels.main([scene, "8", out, "--num-steps", "4",
                                   "--checkpoint-interval", "4",
                                   *_CLI]) == 0
    assert os.path.exists(os.path.join(out, "checkpoints",
                                       "ckpt_00000004.npz"))
    assert port_train_voxels.main([scene, "8", out, "--num-steps", "8",
                                   "--resume", *_CLI]) == 0
    assert "Resumed from" in capsys.readouterr().out
    assert _log_steps(out) == [8]


def test_cli_defaults_to_cuda():
    assert port_train_voxels._parse_args(["d", "8", "o"]).device == "cuda"


def test_orbit_video_and_voxelize_take_a_voxel_checkpoint(scene, tmp_path):
    """orbit_video at its default sampler (focus sampling by the model
    itself, a model without views) and with --density-grid, and
    voxelize_model, on a JAX-written voxels checkpoint."""
    model, params, _ = _voxels(side=8, scale=1.0)
    path = str(tmp_path / "voxels.npz")
    jax_models.save_model(model, params, path)
    for flags in ([], ["--density-grid"]):
        frames = str(tmp_path / f"frames{len(flags)}")
        assert torch_orbit.main([path, "16", frames, "--device", "cpu",
                                 "--num-frames", "2", "--num-samples", "16",
                                 *flags]) == 0
        assert sorted(os.listdir(frames)) == ["frame_00000.png",
                                              "frame_00001.png"]
    tree = str(tmp_path / "tree.npz")
    assert port_voxelize.main([path, scene, tree, "--device", "cpu",
                               "--num-samples", "16", "--alpha-threshold",
                               "0.05"]) == 0
    assert os.path.exists(tree)
