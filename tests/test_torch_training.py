"""The port's training slice against the JAX package: the stratified
sampler's generator and annealing, the per-ray tables and ``sample``,
camera paths, the image dataset's pools and loss, the synthetic scene,
the clipped Adam step, one train step (fused and plain), a short fit
and the ``train_nerf`` CLI on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fourier_feature_nets_torch.render.ray_sampler as port_sampler_module
import fourier_feature_nets_tpu as ffn
import fourier_feature_nets_tpu.render.ray_sampler as jax_sampler_module
from fourier_feature_nets_torch import ops as port_ops
from fourier_feature_nets_torch.cameras import Resolution as TorchResolution
from fourier_feature_nets_torch.cli import train_nerf as port_train_nerf
from fourier_feature_nets_torch.datasets import ImageDataset as TorchDataset
from fourier_feature_nets_torch.datasets import Mode as TorchMode
from fourier_feature_nets_torch.datasets.synthetic import (
    generate_synthetic_dataset as torch_generate,
)
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import load_model as torch_load_model
from fourier_feature_nets_torch.models import params_from_jax, params_to_jax
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_torch.render import RaySampler as TorchSampler
from fourier_feature_nets_torch.utils import hemisphere as torch_hemisphere
from fourier_feature_nets_torch.utils.optim import ClippedAdam, exponential_lr
from fourier_feature_nets_tpu import ops as jax_ops
from fourier_feature_nets_tpu.cameras import Resolution
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset as jax_generate,
)
from fourier_feature_nets_tpu.models import NeRF
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.utils.camera_paths import hemisphere
from fourier_feature_nets_tpu.utils.optim import adam_init, adam_update

SMALL = dict(num_layers=4, num_channels=32, max_log_scale_pos=4.0,
             num_freq_pos=5, max_log_scale_view=2.0, num_freq_view=3,
             skips=[2], include_inputs=True)
BOUNDS = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The JAX package's synthetic scene at 24 px (3/1/1 cameras)."""
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    return jax_generate(path, resolution=24, split_counts=(3, 1, 1),
                        volume_side=16, num_samples=64)


def _pair(config=SMALL, seed=0):
    model = NeRF(**config)
    params = model.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    return model, params, params_from_jax(TorchNeRF(**config), flat)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

class TestPerRayUniform:
    """ops.per_ray_uniform: a stateless, layout-invariant generator
    (mirrors tests/test_ops.py::TestPerRayUniform)."""

    def test_range_and_moments(self):
        u = port_ops.per_ray_uniform(7, 3, torch.arange(20000), 8)
        assert u.dtype == torch.float32 and u.shape == (20000, 8)
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        assert abs(float(u.mean()) - 0.5) < 0.01
        assert abs(float(u.std()) - 12 ** -0.5) < 0.01

    def test_layout_invariant_and_deterministic(self):
        idx = torch.tensor([3, 1, 4, 1, 5, 9, 2, 6])
        full = port_ops.per_ray_uniform(7, 11, idx, 4)
        assert torch.equal(full, port_ops.per_ray_uniform(7, 11, idx, 4))
        perm = torch.tensor([5, 2, 0, 7, 1, 3, 4, 6])
        assert torch.equal(port_ops.per_ray_uniform(7, 11, idx[perm], 4),
                           full[perm])
        assert torch.equal(port_ops.per_ray_uniform(7, 11, idx[:4], 4),
                           full[:4])
        # the same ray id draws the same values wherever it sits
        assert torch.equal(full[1], full[3])

    def test_seed_step_salt_decorrelate(self):
        idx = torch.arange(8)
        base = port_ops.per_ray_uniform(7, 0, idx, 4)
        for other in (port_ops.per_ray_uniform(8, 0, idx, 4),
                      port_ops.per_ray_uniform(7, 1, idx, 4),
                      port_ops.per_ray_uniform(7, 0, idx, 4, salt=1)):
            assert not torch.equal(base, other)


@pytest.mark.parametrize("step", [0, 3, 9, 10, 20])
def test_anneal_near_far_matches_jax(step):
    rng = np.random.default_rng(1)
    near = rng.uniform(1, 2, 50).astype(np.float32)
    far = near + rng.uniform(0.5, 2, 50).astype(np.float32)
    ref = jax_ops.anneal_near_far(jnp.asarray(near), jnp.asarray(far), step,
                                  0.2, 10)
    ours = port_ops.anneal_near_far(torch.from_numpy(near),
                                    torch.from_numpy(far), step, 0.2, 10)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_jittered_t_values_match_jax():
    rng = np.random.default_rng(2)
    near = rng.uniform(1, 2, 40).astype(np.float32)
    far = near + 1.5
    jitter = rng.uniform(0, 1, (40, 16)).astype(np.float32)
    ref = jax_ops.uniform_t_values(jnp.asarray(near), jnp.asarray(far), 16,
                                   jitter=jnp.asarray(jitter))
    ours = port_ops.uniform_t_values(torch.from_numpy(near),
                                     torch.from_numpy(far), 16,
                                     torch.from_numpy(jitter))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    assert bool((ours[:, 1:] >= ours[:, :-1]).all())


def _camera_pairs(num=5):
    jax_cams = hemisphere(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                          num, 40.0, Resolution(12, 10), 3.2, pos_noise=0.05,
                          rng=np.random.default_rng(9))
    port_cams = torch_hemisphere(np.array([0.0, 1.0, 0.0]),
                                 np.array([0.0, 0.0, 1.0]), num, 40.0,
                                 TorchResolution(12, 10), 3.2, pos_noise=0.05,
                                 rng=np.random.default_rng(9))
    return jax_cams, port_cams


def test_hemisphere_matches_jax():
    jax_cams, port_cams = _camera_pairs()
    for a, b in zip(jax_cams, port_cams):
        np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
        np.testing.assert_array_equal(a.extrinsics, b.extrinsics)


def test_sampler_tables_and_jittered_sample_match_jax(monkeypatch):
    """The per-ray tables, and ``sample`` with the same jitter injected
    into both samplers (their generators differ by design), stratified
    and annealed."""
    jax_cams, port_cams = _camera_pairs()
    jax_sampler = ffn.RaySampler(BOUNDS, jax_cams, 16, stratified=True,
                                 anneal_start=0.2, num_anneal_steps=10)
    port_sampler = TorchSampler(BOUNDS, port_cams, 16, stratified=True,
                                anneal_start=0.2, num_anneal_steps=10)
    tables = port_sampler.ray_tables
    np.testing.assert_allclose(tables.starts.numpy(),
                               np.asarray(jax_sampler.starts), atol=1e-6)
    np.testing.assert_allclose(tables.directions.numpy(),
                               np.asarray(jax_sampler.directions), atol=1e-6)
    np.testing.assert_allclose(tables.near.numpy(),
                               np.asarray(jax_sampler.near), rtol=1e-5)
    np.testing.assert_allclose(tables.far.numpy(),
                               np.asarray(jax_sampler.far), rtol=1e-5)
    np.testing.assert_array_equal(tables.valid, jax_sampler.valid)
    assert len(port_sampler) == len(jax_sampler)

    idx = port_sampler.to_valid(np.arange(len(port_sampler)))
    np.testing.assert_array_equal(idx, jax_sampler.to_valid(
        np.arange(len(jax_sampler))))
    jitter = np.random.default_rng(4).uniform(
        0, 1, (len(idx), 16)).astype(np.float32)
    monkeypatch.setattr(jax_sampler_module, "per_ray_uniform",
                        lambda *args, **kwargs: jnp.asarray(jitter))
    monkeypatch.setattr(port_sampler_module, "per_ray_uniform",
                        lambda *args, **kwargs: torch.from_numpy(jitter))
    ref = jax_sampler.sample(jnp.asarray(idx), 3, jax.random.PRNGKey(0))
    ours = port_sampler.sample(torch.from_numpy(idx), 3, 0)
    np.testing.assert_allclose(ours.t_values.numpy(),
                               np.asarray(ref.t_values), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.positions.numpy(),
                               np.asarray(ref.positions), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ours.view_directions.numpy(),
                               np.asarray(ref.view_directions), atol=1e-6)
    np.testing.assert_array_equal(ours.rays.numpy(), idx)


def test_sampler_rejects_focus_sampling():
    """The sampler no longer rejects an opacity model: it focus-samples
    with it (tests/test_torch_focus.py holds the samples to JAX's)."""
    _, port_cams = _camera_pairs(2)
    _, _, port = _pair()
    sampler = TorchSampler(BOUNDS, port_cams, 16, stratified=True,
                           opacity_model=port)
    assert sampler.focus_sampling and sampler.num_focus_samples == 8
    assert sampler.cdfs.shape == (len(sampler), 7)
    idx = torch.from_numpy(sampler.to_valid(np.arange(len(sampler))))
    rays = sampler.sample(idx, 3, 11)
    assert rays.t_values.shape == (len(idx), 16)
    assert (torch.diff(rays.t_values, dim=-1) >= 0).all()


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

def test_synthetic_images_match_jax(scene, tmp_path):
    path = torch_generate(str(tmp_path / "port.npz"), resolution=24,
                          split_counts=(3, 1, 1), volume_side=16,
                          num_samples=64)
    with np.load(path) as ours, np.load(scene) as ref:
        assert sorted(ours.files) == sorted(ref.files)
        diff = np.abs(ours["images"].astype(int) - ref["images"].astype(int))
        assert diff.max() <= 1
        for key in ("intrinsics", "extrinsics", "bounds", "split_counts"):
            np.testing.assert_array_equal(ours[key], ref[key])


def test_image_dataset_pools_match_jax(scene):
    """Every mode's pool, the crop/sparse/patch/dilate indices (the
    dilation by scipy with OpenCV's elliptic stencil, the JAX package's
    by cv2) and the per-camera indices."""
    ref = ffn.ImageDataset.load(scene, "train", 16)
    ours = TorchDataset.load(scene, "train", 16)
    for name in ("crop_index", "sparse_index", "patch_index",
                 "dilate_index"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(ref, name), err_msg=name)
    assert ours.dilate_ranges == ref.dilate_ranges
    for mode in TorchMode:
        jax_mode = ffn.ImageDataset.Mode[mode.name]
        np.testing.assert_array_equal(ours.index_pool(mode),
                                      ref.index_pool(jax_mode),
                                      err_msg=mode.name)
        ours.mode, ref.mode = mode, jax_mode
        assert len(ours) == len(ref)
        for camera in range(ours.num_cameras):
            np.testing.assert_array_equal(ours.index_for_camera(camera),
                                          ref.index_for_camera(camera))
    np.testing.assert_allclose(ours.colors.numpy(), np.asarray(ref.colors))
    np.testing.assert_allclose(ours.alphas.numpy(), np.asarray(ref.alphas))


@pytest.mark.parametrize("mode", ["Full", "Dilate"])
def test_image_dataset_loss_matches_jax(scene, mode):
    ref = ffn.ImageDataset.load(scene, "train", 16)
    ours = TorchDataset.load(scene, "train", 16)
    ref.mode = ffn.ImageDataset.Mode[mode]
    ours.mode = TorchMode[mode]
    rng = np.random.default_rng(5)
    idx = ref.index_pool()[:200]
    color = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, 200).astype(np.float32)
    from fourier_feature_nets_torch.render import RenderResult
    from fourier_feature_nets_tpu.datasets.ray_dataset import (
        RenderResult as JaxRenderResult,
    )
    expected = float(ref.loss(jnp.asarray(idx), JaxRenderResult(
        jnp.asarray(color), jnp.asarray(alpha), None)))
    got = float(ours.loss(torch.from_numpy(idx), RenderResult(
        torch.from_numpy(color), torch.from_numpy(alpha), None)))
    assert got == pytest.approx(expected, rel=1e-6)


def test_missing_dataset_and_ycrcb_raise(scene, tmp_path):
    """A missing NPZ raises; YCrCb, once unported, now loads the JAX
    package's YCrCb colors (tests/test_torch_color_space.py holds the
    rest of it), and an unknown color space raises."""
    with pytest.raises(FileNotFoundError, match="does not download"):
        TorchDataset.load(str(tmp_path / "lego_400.npz"), "train", 16)
    ours = TorchDataset.load(scene, "train", 16, color_space="YCrCb")
    ref = ffn.ImageDataset.load(scene, "train", 16, color_space="YCrCb")
    np.testing.assert_array_equal(ours.colors.numpy(), np.asarray(ref.colors))
    with pytest.raises(ValueError, match="color space"):
        TorchDataset.load(scene, "train", 16, color_space="HSV")


# ---------------------------------------------------------------------------
# optimizer and train step
# ---------------------------------------------------------------------------

def test_clipped_adam_matches_adam_update():
    """torch Adam behind clip_grad_value_ then clip_grad_norm_ against
    the JAX package's pure-pytree update, over three steps with weight
    decay and a decaying learning rate."""
    rng = np.random.default_rng(3)
    init = {"a": rng.normal(size=(5, 4)).astype(np.float32),
            "b": rng.normal(size=7).astype(np.float32)}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    optimizer = ClippedAdam(params.values(), 1e-2, weight_decay=1e-3)
    jax_params = {k: jnp.asarray(v) for k, v in init.items()}
    state = adam_init(jax_params)
    for step in range(3):
        grads = {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32)
                 for k, v in init.items()}
        lr = exponential_lr(1e-2, step, 0.1, 5)
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        optimizer.step(lr)
        jax_params, state = adam_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, state, jax_params,
            lr, weight_decay=1e-3, clip_value=0.1, clip_norm=0.1)
        # f32 update arithmetic in another order: an ulp of the step
        for k in init:
            np.testing.assert_allclose(params[k].detach().numpy(),
                                       np.asarray(jax_params[k]), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_train_step_loss_and_grads_match_jax(scene, fused):
    """One unjittered step with stratified=False: the same ray ids give
    the same loss and parameter gradients as the JAX raycaster's
    ``_train_forward`` under ``jax.value_and_grad``, f32 (fused: the
    Pallas custom VJP in interpret mode vs the port's twins)."""
    model, params, torch_model = _pair()
    jax_data = ffn.ImageDataset.load(scene, "train", 16)
    port_data = TorchDataset.load(scene, "train", 16)
    idx = jax_data.index_pool()[::7][:64]

    jax_caster = ffn.Raycaster(model, fused_train=fused)
    rays = jax_data.sampler.sample(jnp.asarray(idx), None, None)
    loss, grads = jax.value_and_grad(lambda p: jax_data.loss(
        jnp.asarray(idx), jax_caster._train_forward(p, rays)))(params)

    caster = TorchRaycaster(torch_model, fused_train=fused)
    assert caster.fused_train == fused
    port_idx = torch.from_numpy(idx)
    port_loss = port_data.loss(port_idx, caster._train_forward(
        port_data.sampler.sample(port_idx)))
    port_loss.backward()
    assert float(port_loss.detach()) == pytest.approx(float(loss), rel=1e-5)
    ref = {k: np.asarray(v) for k, v in _flatten(grads).items()}
    for name, layer_param in _named_grads(torch_model).items():
        np.testing.assert_allclose(layer_param, ref[name], rtol=2e-3,
                                   atol=2e-4, err_msg=name)


def _named_grads(torch_model):
    grads = {}
    for i, layer in enumerate(torch_model.layers):
        grads[f"layers/{i}/weight"] = layer.weight.grad.numpy().T
        grads[f"layers/{i}/bias"] = layer.bias.grad.numpy()
    for head in ("opacity_out", "bottleneck", "hidden_view", "color_out"):
        layer = getattr(torch_model, head)
        grads[f"{head}/weight"] = layer.weight.grad.numpy().T
        grads[f"{head}/bias"] = layer.bias.grad.numpy()
    return grads


def test_params_to_jax_after_a_step_has_the_jax_tree(scene):
    """After a train step the port's parameters map onto the JAX params
    pytree leaf by leaf: the same names and shapes."""
    model, params, torch_model = _pair()
    data = TorchDataset.load(scene, "train", 16, stratified=True)
    caster = TorchRaycaster(torch_model, fused_train=True)
    step = caster._make_train_step(data, 64, 1e-3, 0.1, 1000,
                                   ClippedAdam(torch_model.parameters(),
                                               1e-3))
    before = params_to_jax(torch_model)
    perm = torch.from_numpy(data.index_pool())
    loss = step(perm, 0, 0, 1234)
    assert torch.isfinite(loss)
    after = params_to_jax(torch_model)
    ref = {k: np.asarray(v) for k, v in _flatten(params).items()}
    assert sorted(after) == sorted(ref)
    for key in ref:
        assert after[key].shape == ref[key].shape, key
        assert after[key].dtype == np.float32
        assert not np.array_equal(after[key], before[key]), key


# ---------------------------------------------------------------------------
# fit and CLI
# ---------------------------------------------------------------------------

def test_fit_tracks_the_jax_fit(scene):
    """30 steps through the port's fit (the fused path's twins) land
    within 0.5 dB val PSNR of the JAX package's fit (XLA autodiff) from
    the same initial weights (the check of tests/test_fused_train.py)."""
    model, params, torch_model = _pair(seed=1)
    kwargs = dict(batch_size=128, learning_rate=1e-3, num_steps=30,
                  crop_steps=0, report_interval=30, decay_rate=0.1,
                  decay_steps=250000)
    train = ffn.ImageDataset.load(scene, "train", num_samples=16)
    val = ffn.ImageDataset.load(scene, "val", num_samples=16)
    _, jax_log = ffn.Raycaster(model, fused_train=False).fit(params, train,
                                                             val, **kwargs)
    caster = TorchRaycaster(torch_model, fused_train=True)
    log = caster.fit(TorchDataset.load(scene, "train", num_samples=16),
                     TorchDataset.load(scene, "val", num_samples=16),
                     **kwargs)
    assert [e.step for e in log] == [e.step for e in jax_log] == [0, 30]
    assert log[-1].val_psnr > log[0].val_psnr
    assert log[-1].val_psnr == pytest.approx(jax_log[-1].val_psnr, abs=0.5)
    assert len(caster.step_ms) == 31


def test_train_nerf_cli_on_cpu(scene, tmp_path):
    out = str(tmp_path / "run")
    argv = [scene, out, "--device", "cpu", "--num-layers", "4",
            "--num-channels", "32", "--num-samples", "16", "--num-steps",
            "6", "--report-interval", "3", "--crop-steps", "2",
            "--batch-size", "64", "--image-interval", "3", "--fused"]
    assert port_train_nerf.main(argv) == 0
    for name in ("nerf.npz", "nerf_best.npz", "log.txt",
                 os.path.join("train", "s0000000_c000.png"),
                 os.path.join("val", "s0000000_c000.png")):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "log.txt")) as handle:
        rows = handle.read().split("\n\n", 1)[1].strip().splitlines()
    assert rows[0] == "step\ttimestamp\tpsnr_train\tpsnr_val"
    assert [int(r.split("\t")[0]) for r in rows[1:]] == [0, 3, 6]
    from fourier_feature_nets_torch.models import load_model
    assert load_model(os.path.join(out, "nerf.npz")).num_channels == 32


def test_train_nerf_cli_opacity_model(tmp_path, monkeypatch):
    """Three focus-sampled steps on the generated synthetic scene, with
    a trained checkpoint as the opacity model."""
    monkeypatch.setenv("FFN_TORCH_DATA_DIR", str(tmp_path / "data"))
    small = ["--device", "cpu", "--num-layers", "2", "--num-channels",
             "32", "--num-samples", "8", "--report-interval", "3",
             "--crop-steps", "0", "--batch-size", "64", "--image-interval",
             "0"]
    first = str(tmp_path / "first")
    assert port_train_nerf.main(["synthetic:16", first, "--num-steps", "1",
                                 *small]) == 0
    out = str(tmp_path / "focus")
    assert port_train_nerf.main(["synthetic:16", out, "--num-steps", "3",
                                 "--opacity-model",
                                 os.path.join(first, "nerf.npz"),
                                 *small]) == 0
    with open(os.path.join(out, "log.txt")) as handle:
        rows = handle.read().split("\n\n", 1)[1].strip().splitlines()
    assert [int(r.split("\t")[0]) for r in rows[1:]] == [0, 3]
    assert all(np.isfinite(float(v)) for r in rows[1:]
               for v in r.split("\t")[2:])


_CLI_SMALL = ["--device", "cpu", "--num-layers", "2", "--num-channels", "32",
              "--num-samples", "8", "--batch-size", "64", "--image-interval",
              "0", "--crop-steps", "0", "--report-interval", "4"]


# --data-parallel without a launcher is a mesh of this process alone (the
# gloo ranks: tests/test_torch_parallel.py); beside it --make-video
@pytest.mark.parametrize("flag", [["--make-video", "--data-parallel"],
                                  ["--data-parallel"]])
def test_train_nerf_cli_data_parallel_flags_run(scene, tmp_path, flag):
    """``--data-parallel`` trains on a mesh of one rank: the same model,
    bit for bit, as the run without it; with ``--make-video`` the orbit
    video's frames are written too."""
    small = [*_CLI_SMALL, "--num-steps", "4", "--num-frames", "2"]
    out = tmp_path / "dp"
    assert port_train_nerf.main([scene, str(out), *small, *flag]) == 0
    assert port_train_nerf.main([scene, str(tmp_path / "one"), *small,
                                 *flag[:-1]]) == 0
    ours = params_to_jax(torch_load_model(str(out / "nerf.npz")))
    ref = params_to_jax(torch_load_model(str(tmp_path / "one" / "nerf.npz")))
    for name, value in ref.items():
        np.testing.assert_array_equal(ours[name], value, err_msg=name)
    if "--make-video" in flag:
        assert sorted(os.listdir(out / "video")) == sorted(
            os.listdir(tmp_path / "one" / "video"))
        assert os.listdir(out / "video")


@pytest.mark.parametrize("flag", [["--resume"],
                                  ["--occupancy-interval", "2",
                                   "--occupancy-start", "2",
                                   "--occupancy-samples", "6"],
                                  ["--checkpoint-interval", "2"],
                                  ["--steps-per-call", "4"]],
                         ids=["resume", "occupancy", "checkpoint", "chunk"])
def test_train_nerf_cli_runs_ported_flags(scene, tmp_path, flag, capsys):
    """The flags that raised until their paths were ported now train on
    the CPU, each leaving its mark: a resume from the newest checkpoint,
    the occupancy-guided sampler, checkpoint files, chunked calls."""
    out = str(tmp_path / "run")
    if flag == ["--resume"]:
        assert port_train_nerf.main([scene, out, *_CLI_SMALL, "--num-steps",
                                     "4", "--checkpoint-interval", "2"]) == 0
        capsys.readouterr()
    assert port_train_nerf.main([scene, out, *_CLI_SMALL, "--num-steps", "8",
                                 *flag]) == 0
    printed = capsys.readouterr().out
    with open(os.path.join(out, "log.txt")) as handle:
        rows = handle.read().split("\n\n", 1)[1].strip().splitlines()
    steps = [int(r.split("\t")[0]) for r in rows[1:]]
    if flag == ["--resume"]:
        assert "ckpt_00000004.npz at step 5" in printed
        assert steps == [8]
    elif flag[0] == "--occupancy-interval":
        assert "Enabling occupancy-guided sampling (6 samples/ray)" in printed
        assert steps == [0, 4, 8]
    elif flag[0] == "--checkpoint-interval":
        assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == [
            "ckpt_00000004.npz", "ckpt_00000006.npz", "ckpt_00000008.npz"]
    else:
        assert "first call" in printed and "(4 steps)" in printed
        assert steps == [3, 7, 11]
