"""Distillation in the port against the JAX package (mirrors
tests/test_distill.py): the loss and gradients of a step, training, the
resume, the occupancy sampler, the CLI and the checkpoint format.

The step's draws (its camera, pixels and the sampler's stratified
jitter) are a stateless hash in the port and threefry in the JAX
package, so the parity tests inject the same draws into both. Tolerances:
one plain f32 step's loss within rtol 1e-5 of JAX's, its gradients within
the JAX suite's rtol 2e-3 / atol 2e-4; one fused step (bf16 packs, the
port's kernel twins against the Pallas kernels in interpret mode) within
rtol 1e-3, each leaf's gradient within 2e-2 of its largest; a resumed
run equals the uninterrupted one bit for bit on the CPU. The JAX
package's three known faults (ROADMAP.md, queue 3) are not held against
the port: its chunks are clamped to the steps that remain, a finished
resume returns no losses, and a resume checks the model and the seed.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fourier_feature_nets_torch.render.distill as port_distill
import fourier_feature_nets_tpu.ops.sampling as jax_sampling
from fourier_feature_nets_torch.cli import distill_model as port_cli
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import load_model as port_load_model
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_torch.models.serialization import (
    named_parameters,
    params_to_jax,
)
from fourier_feature_nets_torch.render import (
    OccupancyGridSampler as TorchOccupancy,
)
from fourier_feature_nets_torch.render import RaySampler as TorchRaySampler
from fourier_feature_nets_torch.utils.checkpoint import (
    load_train_state as port_load_train_state,
)
from fourier_feature_nets_tpu.cameras import Resolution
from fourier_feature_nets_tpu.models import NeRF, Voxels, save_model
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.render.distill import distill as jax_distill
from fourier_feature_nets_tpu.render.occupancy_sampler import (
    OccupancyGridSampler,
)
from fourier_feature_nets_tpu.utils.camera_paths import orbit
from fourier_feature_nets_tpu.utils.checkpoint import (
    load_train_state as jax_load_train_state,
)

# the JAX package's render/__init__ exports the function under the
# module's name
jax_distill_module = sys.modules["fourier_feature_nets_tpu.render.distill"]

TEACHER = dict(num_layers=3, num_channels=32, max_log_scale_pos=4.0,
               num_freq_pos=5, max_log_scale_view=2.0, num_freq_view=3,
               skips=[1], include_inputs=True)
STUDENT = dict(TEACHER, num_layers=2, num_channels=16)
BOUNDS = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
RAYS, SAMPLES = 48, 12
# the fused step against JAX's: the loss's relative gap, and per leaf
# max|port - jax| <= FUSED_GRAD_SHARE * max|jax| (the bf16 limit of
# tests/test_torch_train_kernel.py); readings 2.7e-5 and 3.3e-3 at most
FUSED_LOSS_RTOL = 1e-3
FUSED_GRAD_SHARE = 2e-2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cameras():
    return orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]), 3,
                 40.0, Resolution(16, 16), 3.0)


def _pair(config, seed, opacity=None):
    """A JAX NeRF, its params and the port's copy; ``opacity`` (bias,
    scale) sets the opacity head's bias and scales its weights, for a
    field whose density grid is partly occupied."""
    model = NeRF(**config)
    params = model.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    if opacity is not None:
        bias, scale = opacity
        flat["opacity_out/bias"] = np.full_like(flat["opacity_out/bias"],
                                                bias)
        flat["opacity_out/weight"] = flat["opacity_out/weight"] * scale
        params = dict(params)
        params["opacity_out"] = {
            "bias": jnp.asarray(flat["opacity_out/bias"]),
            "weight": jnp.asarray(flat["opacity_out/weight"])}
    return model, params, params_from_jax(TorchNeRF(**config), flat)


# about 29% of the teacher's 16^3 density grid is occupied at alpha 0.05
TEACHER_OPACITY = (-1.0, 10.0)


@pytest.fixture(scope="module")
def teacher():
    return _pair(TEACHER, 1, TEACHER_OPACITY)


def _samplers(kind, cameras, teacher):
    model, params, port = teacher
    if kind == "uniform":
        from fourier_feature_nets_tpu.render import RaySampler
        return (RaySampler(BOUNDS, cameras, SAMPLES, stratified=True),
                TorchRaySampler(BOUNDS, cameras, SAMPLES, stratified=True))
    kwargs = dict(stratified=True, grid_resolution=16, alpha_threshold=0.05,
                  scale=1.0, bounds=BOUNDS)
    return (OccupancyGridSampler.from_model(model, params, cameras, SAMPLES,
                                            **kwargs),
            TorchOccupancy.from_model(port, cameras, SAMPLES, **kwargs))


def _draws(seed=0):
    rng = np.random.default_rng(seed)
    camera = 1
    offsets = rng.integers(0, 256, RAYS)
    jitter = rng.uniform(0.0, 1.0, (RAYS, SAMPLES)).astype(np.float32)
    return camera, offsets, jitter


def _inject(monkeypatch, camera, offsets, jitter):
    """The same camera, pixels and jitter for both packages' step."""
    def jax_randint(key, shape, minval, maxval, *args, **kwargs):
        if shape == ():
            return jnp.int32(camera)
        return jnp.asarray(offsets, jnp.int32)

    def jax_uniform(rng, idx, num_samples, salt=0):
        return jnp.asarray(jitter[:, :num_samples])

    def port_uniform(seed, step, idx, num_samples, salt=0):
        return torch.from_numpy(jitter[:, :num_samples].copy())

    monkeypatch.setattr(jax.random, "randint", jax_randint)
    monkeypatch.setattr(jax_sampling, "per_ray_uniform", jax_uniform)
    import fourier_feature_nets_tpu.render.ray_sampler as jax_rs
    monkeypatch.setattr(jax_rs, "per_ray_uniform", jax_uniform)
    monkeypatch.setattr(
        port_distill, "draw_rays",
        lambda *args: (torch.tensor(camera), torch.from_numpy(offsets)))
    import fourier_feature_nets_torch.render.occupancy_sampler as port_occ
    import fourier_feature_nets_torch.render.ray_sampler as port_rs
    monkeypatch.setattr(port_occ, "per_ray_uniform", port_uniform)
    monkeypatch.setattr(port_rs, "per_ray_uniform", port_uniform)


def _one_step(cameras, teacher, kind, monkeypatch, fused):
    """One step of both packages under the same draws (``fused``: K1
    for the teacher, K1 + K2 for the student, bf16 packs; the Pallas
    kernels in interpret mode, the port's twins on the CPU): JAX's and
    the port's losses, and their gradients in JAX's layout."""
    _inject(monkeypatch, *_draws(3))
    jax_sampler, port_sampler = _samplers(kind, cameras, teacher)
    student_model, student_params, port_student = _pair(STUDENT, 2)
    model, params, port = teacher

    grads = []
    original = jax_distill_module.adam_update

    def capture(g, *args, **kwargs):
        jax.debug.callback(grads.append, g)
        return original(g, *args, **kwargs)

    monkeypatch.setattr(jax_distill_module, "adam_update", capture)
    _, ref_losses = jax_distill(model, params, student_model, jax_sampler, 1,
                                student_params=student_params,
                                batch_rays=RAYS, steps_per_call=1,
                                fused_teacher=fused, fused_student=fused)
    ref_grads = {k: np.asarray(v) for k, v in _flatten(grads[0]).items()}

    port_grads = {}

    class Capture(port_distill.ClippedAdam):
        def step(self, learning_rate):
            for path, p in named_parameters(port_student).items():
                g = p.grad.numpy()
                port_grads[path] = g.T if g.ndim == 2 else g
            super().step(learning_rate)

    monkeypatch.setattr(port_distill, "ClippedAdam", Capture)
    _, losses = port_distill.distill(port, port_student, port_sampler, 1,
                                     batch_rays=RAYS, steps_per_call=1,
                                     fused_teacher=fused,
                                     fused_student=fused)
    assert set(port_grads) == set(ref_grads)
    assert max(np.abs(g).max() for g in ref_grads.values()) > 1e-3
    return np.asarray(ref_losses), ref_grads, losses, port_grads


@pytest.mark.parametrize("kind", ["occupancy", "uniform"])
def test_one_step_loss_and_gradients_match_jax(cameras, teacher, kind,
                                               monkeypatch):
    ref_losses, ref_grads, losses, port_grads = _one_step(
        cameras, teacher, kind, monkeypatch, False)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for path, g in ref_grads.items():
        np.testing.assert_allclose(port_grads[path], g, rtol=2e-3, atol=2e-4,
                                   err_msg=path)


@pytest.mark.parametrize("kind", ["occupancy", "uniform"])
def test_fused_step_loss_and_gradients_match_jax(cameras, teacher, kind,
                                                 monkeypatch):
    """The fused step (the port's kernel twins against the Pallas
    kernels in interpret mode): the same bf16 packs, pack-to-parameter
    mapping, autograd glue and loss scaling."""
    ref_losses, ref_grads, losses, port_grads = _one_step(
        cameras, teacher, kind, monkeypatch, True)
    np.testing.assert_allclose(losses, ref_losses, rtol=FUSED_LOSS_RTOL)
    for path, g in ref_grads.items():
        share = np.abs(port_grads[path] - g).max() / np.abs(g).max()
        assert share <= FUSED_GRAD_SHARE, (path, share)


def test_occupancy_sampler_matches_jax(cameras, teacher, monkeypatch):
    """The CLI's sampler: the teacher's density grid and, under the same
    jitter, the stratified samples of a camera's rays."""
    camera, offsets, jitter = _draws(5)
    _inject(monkeypatch, camera, offsets, jitter)
    jax_sampler, port_sampler = _samplers("occupancy", cameras, teacher)
    np.testing.assert_array_equal(
        port_sampler.occupancy.numpy(),
        np.asarray(jax_sampler.occupancy).reshape(port_sampler.occupancy.shape))
    assert 0.0 < float(port_sampler.occupancy.mean()) < 1.0
    ref, ref_valid = jax_sampler.sample_camera_rays(
        jnp.int32(camera), jnp.asarray(offsets, jnp.int32),
        rng=jax.random.PRNGKey(0))
    ours, valid = port_sampler.sample_camera_rays(
        torch.tensor(camera), torch.from_numpy(offsets), 0, 7)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_allclose(ours.t_values.numpy(),
                               np.asarray(ref.t_values), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_loss_decreases(cameras, teacher, fused):
    """Plain, and through the kernels' plain twins on the CPU (K1 for
    the teacher, K1 + K2 for the student, bf16 packs)."""
    _, port_sampler = _samplers("occupancy", cameras, teacher)
    student = _pair(STUDENT, 2)[2]
    _, losses = port_distill.distill(teacher[2], student, port_sampler, 40,
                                     batch_rays=RAYS, steps_per_call=8,
                                     learning_rate=5e-3,
                                     fused_teacher=fused,
                                     fused_student=fused)
    assert losses.shape == (40,) and np.isfinite(losses).all()
    assert losses[-5:].mean() < 0.7 * losses[:5].mean()


def test_self_distillation_is_a_fixed_point(cameras, teacher):
    """A student that is the teacher sees zero loss and zero gradients,
    and Adam leaves it unchanged."""
    _, port_sampler = _samplers("uniform", cameras, teacher)
    student = _pair(TEACHER, 1, TEACHER_OPACITY)[2]
    before = params_to_jax(student)
    _, losses = port_distill.distill(teacher[2], student, port_sampler, 6,
                                     batch_rays=RAYS, steps_per_call=3,
                                     fused_teacher=False,
                                     fused_student=False)
    np.testing.assert_array_equal(losses, np.zeros(6, np.float32))
    for path, value in params_to_jax(student).items():
        np.testing.assert_array_equal(value, before[path])


def _run(cameras, teacher, tmp, num_steps, steps_per_call, resume=False,
         seed=7, config=STUDENT, interval=2):
    _, port_sampler = _samplers("occupancy", cameras, teacher)
    student = _pair(config, 2)[2]
    student, losses = port_distill.distill(
        teacher[2], student, port_sampler, num_steps, batch_rays=RAYS,
        steps_per_call=steps_per_call, seed=seed, fused_teacher=False,
        fused_student=False, checkpoint_dir=str(tmp),
        checkpoint_interval=interval, resume=resume)
    return params_to_jax(student), losses


def test_resumed_run_equals_uninterrupted(cameras, teacher, tmp_path):
    whole, whole_losses = _run(cameras, teacher, tmp_path / "a", 6, 2)
    _, first = _run(cameras, teacher, tmp_path / "b", 4, 2)
    resumed, rest = _run(cameras, teacher, tmp_path / "b", 6, 2,
                         resume=True)
    np.testing.assert_array_equal(np.concatenate([first, rest]),
                                  whole_losses)
    for path, value in whole.items():
        np.testing.assert_array_equal(resumed[path], value)


def test_resume_chunk_is_clamped_to_the_remaining_steps(cameras, teacher,
                                                         tmp_path):
    """A resume at step 4 of 7 with chunks of 3 runs 3 steps, not 6 (the
    JAX package clamps a chunk to ``num_steps``, not to the steps that
    remain), and lands where the uninterrupted run does."""
    whole, whole_losses = _run(cameras, teacher, tmp_path / "a", 7, 3,
                               interval=3)
    _run(cameras, teacher, tmp_path / "b", 4, 3, interval=3)
    resumed, rest = _run(cameras, teacher, tmp_path / "b", 7, 3,
                         resume=True, interval=3)
    assert rest.shape == (3,)
    np.testing.assert_array_equal(rest, whole_losses[4:])
    for path, value in whole.items():
        np.testing.assert_array_equal(resumed[path], value)
    assert port_load_train_state(
        str(tmp_path / "b" / "ckpt_00000007.npz")).step == 7


def test_finished_resume_returns_no_losses(cameras, teacher, tmp_path):
    done, _ = _run(cameras, teacher, tmp_path, 4, 2)
    again, losses = _run(cameras, teacher, tmp_path, 4, 2, resume=True)
    assert losses.shape == (0,)
    for path, value in done.items():
        np.testing.assert_array_equal(again[path], value)


def test_resume_checks_model_and_seed(cameras, teacher, tmp_path):
    _run(cameras, teacher, tmp_path, 2, 2)
    with pytest.raises(ValueError, match="not the student"):
        _run(cameras, teacher, tmp_path, 4, 2, resume=True,
             config=dict(STUDENT, num_channels=32))
    with pytest.raises(ValueError, match="seed"):
        _run(cameras, teacher, tmp_path, 4, 2, resume=True, seed=8)


def test_port_checkpoint_loads_in_jax(cameras, teacher, tmp_path):
    params, _ = _run(cameras, teacher, tmp_path, 4, 2)
    state = jax_load_train_state(str(tmp_path / "ckpt_00000004.npz"))
    assert state.step == 4 and state.seed == 7
    assert int(state.opt_state.step) == 4
    flat = {k: np.asarray(v) for k, v in _flatten(state.params).items()}
    assert set(flat) == set(params)
    for path, value in params.items():
        np.testing.assert_array_equal(flat[path], value)
    mu = _flatten(state.opt_state.mu)
    assert max(float(np.abs(np.asarray(v)).max()) for v in mu.values()) > 0


def _cli(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT,
               FFN_TORCH_DATA_DIR=str(tmp_path / "data"))
    return subprocess.run([sys.executable, "-m",
                           "fourier_feature_nets_torch.cli.distill_model",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)


def test_cli_distills_resumes_and_evaluates(teacher, tmp_path):
    """The CLI on the CPU: a hemisphere rig, checkpoints, a resume to
    the end, a finished resume (no IndexError), and ``--data
    synthetic:16 --eval-teacher``."""
    model, params, _ = teacher
    checkpoint = str(tmp_path / "teacher.npz")
    save_model(model, params, checkpoint)
    out = str(tmp_path / "out")
    common = [checkpoint, out, "--device", "cpu", "--student-layers", "2",
              "--student-channels", "16", "--batch-rays", "32",
              "--num-samples", "8", "--resolution", "16", "--num-cameras",
              "4", "--steps-per-call", "3", "--report-interval", "3",
              "--checkpoint-interval", "3"]
    done = _cli([*common, "--num-steps", "3"], tmp_path)
    assert done.returncode == 0, done.stderr
    done = _cli([*common, "--num-steps", "6", "--resume"], tmp_path)
    assert done.returncode == 0, done.stderr
    assert "at step 3" in done.stdout and "final loss" in done.stdout
    done = _cli([*common, "--num-steps", "6", "--resume"], tmp_path)
    assert done.returncode == 0, done.stderr
    assert "no steps left to run" in done.stdout
    with open(os.path.join(out, "distill_log.txt")) as handle:
        assert handle.read().startswith("step\tloss\n")
    student = port_load_model(os.path.join(out, "student.npz"))
    assert (student.num_layers, student.num_channels) == (2, 16)

    done = _cli([checkpoint, str(tmp_path / "data_out"), "--device", "cpu",
                 "--student-layers", "2", "--student-channels", "16",
                 "--batch-rays", "32", "--num-samples", "8", "--num-steps",
                 "2", "--steps-per-call", "2", "--data", "synthetic:16",
                 "--eval-teacher", "--uniform"], tmp_path)
    assert done.returncode == 0, done.stderr
    assert "student val PSNR" in done.stdout
    assert "teacher val PSNR" in done.stdout


def test_cli_defaults_and_non_nerf_teacher(tmp_path):
    from fourier_feature_nets_torch.cli.common import RECOMMENDED_STUDENT
    from fourier_feature_nets_tpu.cli.common import (
        RECOMMENDED_STUDENT as JAX_RECOMMENDED,
    )
    assert RECOMMENDED_STUDENT == JAX_RECOMMENDED == (6, 192)
    args = port_cli.build_parser().parse_args(["t.npz", "out"])
    assert (args.student_layers, args.student_channels) == (6, 192)
    assert args.device == "cuda" and args.fused is None
    # a voxel teacher distils (it raised before the port took any model
    # type): the student is a NeRF
    voxels = Voxels(side=4, scale=1.0)
    path = str(tmp_path / "voxels.npz")
    save_model(voxels, voxels.init(jax.random.PRNGKey(0)), path)
    out = tmp_path / "out"
    assert port_cli.main([path, str(out), "--device", "cpu",
                          "--student-layers", "2", "--student-channels",
                          "16", "--batch-rays", "16", "--num-samples", "8",
                          "--resolution", "8", "--num-cameras", "2",
                          "--num-steps", "2", "--steps-per-call", "2"]) == 0
    assert port_load_model(str(out / "student.npz")).model_type == "nerf"
