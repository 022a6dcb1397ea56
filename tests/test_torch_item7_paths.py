"""The port's smaller item-7 paths against the JAX package: distillation
from a voxel and an FFN teacher, ``interpolate_bilinear``, the
ray-sampling inspector, the occupancy sampler's ``trilinear`` and
``probe_mode="gather"`` modes, the focus sampler's iid-quantile switch,
the debug NaN switch and the package's top-level API.

Tolerances: one plain distill step's loss within rtol 1e-5 of JAX's
(the draws injected, as in tests/test_torch_distill.py);
``interpolate_bilinear`` atol 1e-6; the inspector's masks equal, its
deterministic t values within 1e-6; CDF weights within the JAX suite's
f32 rtol 1e-3 / atol 2e-4 (tests/test_fused_nerf.py:44); iid quantiles
with injected uniforms within 1e-6.
"""

import argparse
import importlib
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fourier_feature_nets_torch as port_api
import fourier_feature_nets_torch.render.ray_sampler as port_rs
import fourier_feature_nets_tpu as ffn
import fourier_feature_nets_tpu.render.ray_sampler as jax_rs
from fourier_feature_nets_torch import models as port_models
from fourier_feature_nets_torch.cli import distill_model as port_distill_cli
from fourier_feature_nets_torch.ops import interpolate_bilinear
from fourier_feature_nets_torch.render import (
    OccupancyGridSampler as TorchOccupancy,
)
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_torch.render import RaySampler as TorchSampler
from fourier_feature_nets_torch.utils.debug import (
    debug_nans_enabled,
    enable_debug_nans,
    profile,
)
from fourier_feature_nets_torch.utils.optim import ClippedAdam
from fourier_feature_nets_torch.utils.png import read_png
from fourier_feature_nets_tpu.cameras import Resolution
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
)
from fourier_feature_nets_tpu.ops.interpolation import (
    interpolate_bilinear as jax_interpolate_bilinear,
)
from fourier_feature_nets_tpu.render.distill import distill as jax_distill
from fourier_feature_nets_tpu.render.occupancy_sampler import (
    OccupancyGridSampler as JaxOccupancy,
)
from fourier_feature_nets_tpu.utils.camera_paths import orbit
from ffn_parity import flat
from test_torch_distill import RAYS, SAMPLES, STUDENT, _draws, _inject
from test_torch_distill import _pair as _nerf_pair

# the render package's ``distill`` is the function, not its module
port_distill = importlib.import_module(
    "fourier_feature_nets_torch.render.distill")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-3, atol=2e-4)
BOUNDS = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)


@pytest.fixture(scope="module")
def cameras():
    return orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]), 3,
                 40.0, Resolution(16, 16), 3.0)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    return generate_synthetic_dataset(path, resolution=16,
                                      split_counts=(3, 1, 1),
                                      volume_side=16, num_samples=64)


# ---------------------------------------------------------------------------
# distillation from any teacher
# ---------------------------------------------------------------------------

def _voxel_teacher():
    model = ffn.Voxels(side=8, scale=1.0)
    rng = np.random.default_rng(11)
    params = {"voxels": jnp.asarray(rng.normal(
                  0.0, 3.0, (8, 8, 8, 4)).astype(np.float32)),
              "bias": jnp.asarray(rng.normal(size=4).astype(np.float32))}
    port = port_models.build_model("voxels", model.params_manifest)
    return model, params, port_models.params_from_jax(port, flat(params))


def _ffn_teacher():
    model = ffn.PositionalFourierMLP(3, 4, 4.0, num_layers=2,
                                     num_channels=32, embedding_size=24)
    params = model.init(jax.random.PRNGKey(12))
    port = port_models.build_model("fourier", model.params_manifest)
    return model, params, port_models.params_from_jax(port, flat(params))


TEACHERS = {"voxels": _voxel_teacher, "ffn": _ffn_teacher}


@pytest.mark.parametrize("kind", sorted(TEACHERS))
def test_distill_step_from_a_non_nerf_teacher_matches_jax(kind, cameras,
                                                          monkeypatch):
    """One plain step from a voxel or an FFN teacher (queried without
    views) on the stratified uniform sampler the CLI gives it."""
    _inject(monkeypatch, *_draws(3))
    model, params, port = TEACHERS[kind]()
    student_model, student_params, port_student = _nerf_pair(STUDENT, 2)
    _, ref = jax_distill(model, params, student_model,
                         ffn.RaySampler(BOUNDS, cameras, SAMPLES,
                                        stratified=True), 1,
                         student_params=student_params, batch_rays=RAYS,
                         steps_per_call=1, fused_teacher=False,
                         fused_student=False)
    _, ours = port_distill.distill(
        port, port_student, TorchSampler(BOUNDS, cameras, SAMPLES,
                                         stratified=True), 1,
        batch_rays=RAYS, steps_per_call=1, fused_teacher=False,
        fused_student=False)
    assert float(ref[0]) > 1e-3
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-5)


def test_fused_teacher_flag_reaches_a_nerf_only(cameras):
    """``fused_teacher=True`` on a voxel teacher queries it plain: the
    same losses as without the flag."""
    _, _, port = _voxel_teacher()
    runs = []
    for fused in (False, True):
        student = _nerf_pair(STUDENT, 2)[2]
        runs.append(port_distill.distill(
            port, student, TorchSampler(BOUNDS, cameras, SAMPLES,
                                        stratified=True), 3,
            batch_rays=RAYS, steps_per_call=3, fused_teacher=fused,
            fused_student=False)[1])
    np.testing.assert_array_equal(runs[0], runs[1])


def test_cli_distills_a_voxel_teacher_fused(tmp_path, monkeypatch):
    """``--device cpu --fused`` on a voxel checkpoint: the student runs
    K1's and K2's twins (``fused_nerf_train_apply``), the teacher the
    plain query and never K1's wrapper, on the uniform sampler."""
    model, params, _ = _voxel_teacher()
    checkpoint = str(tmp_path / "voxels.npz")
    ffn.save_model(model, params, checkpoint)
    calls = {"teacher_k1": 0, "student_k1_k2": 0, "plain_query": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(port_distill, "fused_nerf_apply",
                        counting("teacher_k1", port_distill.fused_nerf_apply))
    monkeypatch.setattr(port_distill, "fused_nerf_train_apply",
                        counting("student_k1_k2",
                                 port_distill.fused_nerf_train_apply))
    monkeypatch.setattr(port_distill, "query_model",
                        counting("plain_query", port_distill.query_model))
    samplers = []

    def recording_sampler(*args, **kwargs):
        samplers.append(TorchSampler(*args, **kwargs))
        return samplers[-1]

    monkeypatch.setattr(port_distill_cli, "RaySampler", recording_sampler)
    out = str(tmp_path / "out")
    assert port_distill_cli.main([
        checkpoint, out, "--device", "cpu", "--fused", "--student-layers",
        "2", "--student-channels", "16", "--batch-rays", "32",
        "--num-samples", "8", "--resolution", "16", "--num-cameras", "4",
        "--num-steps", "4", "--steps-per-call", "2"]) == 0
    assert calls == {"teacher_k1": 0, "student_k1_k2": 4, "plain_query": 4}
    assert len(samplers) == 1 and samplers[0].stratified
    student = port_models.load_model(os.path.join(out, "student.npz"))
    assert student.model_type == "nerf"


# ---------------------------------------------------------------------------
# interpolate_bilinear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 5, 3), (1, 9, 2), (6, 1, 4)])
def test_interpolate_bilinear_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    grid = rng.normal(size=shape).astype(np.float32)
    points = rng.uniform(-0.1, 1.1, (200, 2)).astype(np.float32)
    points[:4] = [[-0.1, -0.1], [1.1, 1.1], [0.0, 1.0], [1.0, 0.0]]
    ours = interpolate_bilinear(torch.from_numpy(grid),
                                torch.from_numpy(points))
    ref = jax_interpolate_bilinear(jnp.asarray(grid), jnp.asarray(points))
    assert ours.shape == (200, shape[2])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_interpolate_bilinear_checks_shapes():
    with pytest.raises(ValueError):
        interpolate_bilinear(torch.zeros(4, 4), torch.zeros(3, 2))


# ---------------------------------------------------------------------------
# the ray-sampling inspector
# ---------------------------------------------------------------------------

def test_inspector_masks_match_the_jax_cli(scene, tmp_path):
    pytest.importorskip("cv2")
    pytest.importorskip("matplotlib")
    from fourier_feature_nets_torch.cli.inspect_ray_sampling import (
        main as port_main,
    )
    from fourier_feature_nets_tpu.cli.inspect_ray_sampling import (
        main as jax_main,
    )
    args = [scene, "--num-cameras", "2", "--num-samples", "12"]
    assert jax_main([args[0], str(tmp_path / "jax"), *args[1:]]) == 0
    assert port_main([args[0], str(tmp_path / "port"), *args[1:],
                      "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    masks = [n for n in names if n != "t_histogram.png"]
    assert {n.split("_")[0] for n in masks} == {"full", "sparse", "center",
                                                "dilate"}
    for name in masks:
        np.testing.assert_array_equal(read_png(str(tmp_path / "port" / name)),
                                      read_png(str(tmp_path / "jax" / name)),
                                      err_msg=name)
    histogram = read_png(str(tmp_path / "port" / "t_histogram.png"))
    assert histogram.shape == (400, 800, 3) and histogram.min() < 255


def test_inspector_t_values_match_jax(scene):
    """The histogram's t values (the first 256 rays of the pool), in the
    deterministic mode."""
    from fourier_feature_nets_torch.datasets import ImageDataset
    ref = ffn.ImageDataset.load(scene, "train", 12).sample_cameras(2, 12,
                                                                   False)
    ours = ImageDataset.load(scene, "train", 12).sample_cameras(2, 12, False)
    idx = ref.index_pool()[:256]
    np.testing.assert_array_equal(ours.index_pool()[:256], idx)
    ref_t = np.asarray(ref.sampler.sample(np.asarray(idx), 0, None).t_values)
    ours_t = ours.sampler.sample(torch.from_numpy(
        np.asarray(idx, np.int64)), 0, None).t_values.numpy()
    np.testing.assert_allclose(ours_t, ref_t, rtol=0, atol=1e-6)


def test_inspector_histogram_bars():
    from fourier_feature_nets_torch.cli.inspect_ray_sampling import (
        histogram_image,
    )
    values = np.concatenate([np.zeros(30), np.ones(10), [0.5]])
    image = histogram_image(values, bins=4, size=(20, 40))
    counts = np.histogram(values, bins=4)[0]
    heights = [int((image[:, 10 * i + 4] != 255).any(-1).sum())
               for i in range(4)]
    assert heights == [20, 0, round(20 / 30), round(200 / 30)]
    assert counts[0] == counts.max()


def test_inspector_runs_stratified_and_focused(scene, tmp_path):
    from fourier_feature_nets_torch.cli.inspect_ray_sampling import main
    model, params, _ = _voxel_teacher()
    opacity = str(tmp_path / "voxels.npz")
    ffn.save_model(model, params, opacity)
    out = tmp_path / "out"
    assert main([scene, str(out), "--device", "cpu", "--num-cameras", "2",
                 "--stratified", "--opacity-model", opacity]) == 0
    assert (out / "t_histogram.png").exists()
    assert len(list(out.glob("full_cam*.png"))) == 2


# ---------------------------------------------------------------------------
# the occupancy sampler's modes and the focus sampler's iid switch
# ---------------------------------------------------------------------------

def _grid(resolution=16, seed=3):
    """Scattered single cells, which the max-pooled table grows."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(resolution,) * 3) > 0.995).astype(np.float32)


def _samplers(cameras, **mode):
    grid = _grid()
    ref = JaxOccupancy(None, cameras, 16, occupancy_grid=grid,
                       grid_scale=1.0, probe_resolution=8, **mode)
    ours = TorchOccupancy(grid, 1.0, cameras, 16, probe_resolution=8,
                          **mode)
    return ref, ours


def _geometry(num=400, seed=5):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(-2.5, 2.5, (num, 3)).astype(np.float32)
    target = rng.uniform(-0.8, 0.8, (num, 3)).astype(np.float32)
    dirs = target - starts
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    near = np.full(num, 0.5, np.float32)
    far = np.full(num, 5.0, np.float32)
    return starts, dirs, near, far


MODES = {"trilinear": dict(trilinear=True), "gather":
         dict(probe_mode="gather"), "matmul": {}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_occupancy_modes_cdf_matches_jax(mode, cameras):
    """Each mode's CDF weights and deterministic samples on the same
    geometry, and a hit flag that holds every ray JAX's holds."""
    ref, ours = _samplers(cameras, **MODES[mode])
    geometry = _geometry()
    ref_edges, ref_cdf, ref_hit = ref._probe_cdf_geometry(
        *(jnp.asarray(g) for g in geometry))
    edges, cdf, hit = ours._probe_cdf_geometry(
        *(torch.from_numpy(g) for g in geometry))
    np.testing.assert_allclose(edges.numpy(), np.asarray(ref_edges), **F32)
    np.testing.assert_allclose(cdf.numpy(), np.asarray(ref_cdf), **F32)
    ref_hit = np.asarray(ref_hit)
    assert not (ref_hit & ~hit.numpy()).any()
    assert 0 < ref_hit.sum() < len(ref_hit)
    t = ours.t_from_cdf(edges, cdf)
    np.testing.assert_allclose(
        t.numpy(), np.asarray(ref.t_from_cdf(ref_edges, ref_cdf)), **F32)


def test_occupancy_gather_hit_is_within_the_default(cameras):
    """Max-pooling only grows occupancy: the exact grid's hit set is a
    subset of the max-pooled table's, and the trilinear flag holds every
    ray the exact grid's does."""
    geometry = [torch.from_numpy(g) for g in _geometry(2000, 9)]
    hits = {}
    for mode, kwargs in MODES.items():
        _, ours = _samplers(cameras, **kwargs)
        hits[mode] = ours._probe_cdf_geometry(*geometry)[2]
    assert not (hits["gather"] & ~hits["matmul"]).any()
    assert not (hits["gather"] & ~hits["trilinear"]).any()
    assert (hits["gather"] != hits["matmul"]).any()


def test_trilinear_clamps_as_voxels_and_jax(cameras):
    """Trilinear occupancy (``F.grid_sample``, border, align_corners
    False) at points inside and beyond the grid equals the port's Voxels
    opacity channel over the same grid and JAX's ``grid_sample_3d``."""
    ref, ours = _samplers(cameras, trilinear=True)
    points = np.random.default_rng(8).uniform(
        -1.6, 1.6, (500, 3)).astype(np.float32)
    occ = ours._occupancy_at(torch.from_numpy(points)).numpy()
    np.testing.assert_allclose(occ, np.asarray(ref._occupancy_at(
        jnp.asarray(points))), rtol=0, atol=1e-6)
    voxels = port_models.Voxels(16, 1.0)
    with torch.no_grad():
        voxels.voxels.zero_()
        voxels.voxels[0, 3] = torch.from_numpy(_grid())
        voxels.bias.zero_()
        opacity = voxels(torch.from_numpy(points))[:, 3].numpy()
    np.testing.assert_array_equal(occ, opacity)


def test_occupancy_modes_render_and_refresh(cameras):
    """A culled frame in each mode renders, and an in-place refresh of
    the grid keeps the tables' storage."""
    nerf = _nerf_pair(STUDENT, 2)[2]
    caster = TorchRaycaster(nerf)
    for mode in ("trilinear", "gather"):
        _, ours = _samplers(cameras, **MODES[mode])
        table = ours.neighbour_table
        ours.set_occupancy_grid(_grid(seed=4))
        assert ours.neighbour_table.data_ptr() == table.data_ptr()
        assert ours.neighbour_table.shape == (16 ** 3,)
        frame = caster.render_frame(ours, 1)
        assert frame.shape == (16, 16, 3) and frame.any()


def test_probe_mode_is_checked(cameras):
    with pytest.raises(ValueError, match="probe_mode"):
        TorchOccupancy(_grid(), 1.0, cameras, 8, probe_mode="onehot")


def test_iid_focus_quantiles_match_jax(cameras, monkeypatch):
    """With each package's switch set, a stratified focus sampler's fine
    quantiles are its uniforms sorted: the t values of the same injected
    uniforms within 1e-6 of JAX's, and not the stratified ones."""
    model, params, port = _nerf_pair(STUDENT, 2, (-1.0, 10.0))
    ref = ffn.RaySampler(BOUNDS, cameras, 16, True, model, params)
    ours = TorchSampler(BOUNDS, cameras, 16, "cpu", stratified=True,
                        opacity_model=port)
    idx = ours.to_valid(np.arange(len(ours)))[::7]
    rng = np.random.default_rng(6)
    draws = {salt: rng.uniform(0, 1, (len(idx), 8)).astype(np.float32)
             for salt in (0, 1)}
    monkeypatch.setattr(jax_rs, "per_ray_uniform",
                        lambda key, ids, n, salt=0: jnp.asarray(
                            draws[salt][:, :n]))
    monkeypatch.setattr(port_rs, "per_ray_uniform",
                        lambda seed, step, ids, n, salt=0: torch.from_numpy(
                            draws[salt][:, :n]))
    stratified = ours.sample(torch.from_numpy(idx), None, 0).t_values
    monkeypatch.setenv("FFN_TPU_IID_FOCUS_QUANTILES", "1")
    monkeypatch.setenv("FFN_TORCH_IID_FOCUS_QUANTILES", "1")
    ref_t = np.asarray(ref.sample(jnp.asarray(idx), None,
                                  jax.random.PRNGKey(0)).t_values)
    ours_t = ours.sample(torch.from_numpy(idx), None, 0).t_values
    np.testing.assert_allclose(ours_t.numpy(), ref_t, rtol=0, atol=1e-6)
    assert not torch.equal(ours_t, stratified)


# ---------------------------------------------------------------------------
# the debug switch
# ---------------------------------------------------------------------------

@pytest.fixture
def debug_nans():
    enable_debug_nans()
    yield
    enable_debug_nans(False)


def _nan_step(scene):
    """A plain fit step of a NeRF with one NaN weight."""
    from fourier_feature_nets_torch.datasets import ImageDataset
    dataset = ImageDataset.load(scene, "train", 8, stratified=True)
    nerf = _nerf_pair(STUDENT, 2)[2]
    with torch.no_grad():
        nerf.layers[0].weight[0, 0] = float("nan")
    caster = TorchRaycaster(nerf, fused=False, fused_train=False)
    step = caster._make_train_step(dataset, 32, 1e-3, 0.1, 1000,
                                   ClippedAdam(nerf.parameters(), 1e-3))
    perm = torch.from_numpy(np.asarray(dataset.index_pool(), np.int64))
    return lambda: step(perm, 0, 0, 0)


def test_nan_weight_raises_under_debug_nans(scene, debug_nans):
    assert debug_nans_enabled()
    step = _nan_step(scene)
    with pytest.raises(RuntimeError, match="nan"):
        step()


def test_nan_weight_trains_on_without_debug_nans(scene):
    assert not debug_nans_enabled()
    assert not np.isfinite(float(_nan_step(scene)()))


def test_graph_chunk_refuses_debug_nans(debug_nans):
    from fourier_feature_nets_torch.render.raycaster import _GraphChunk
    layer = torch.nn.Linear(2, 2)
    chunk = _GraphChunk(lambda inputs: None,
                        ClippedAdam(layer.parameters(), 1e-3,
                                    capturable=True), ("step",))
    with pytest.raises(ValueError, match="FFN_TORCH_DEBUG_NANS"):
        chunk(0)


def test_debug_nans_from_the_environment():
    code = ("import torch, fourier_feature_nets_torch; "
            "print(torch.is_anomaly_enabled(), "
            "torch.is_anomaly_check_nan_enabled())")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          check=True, env=dict(os.environ, PYTHONPATH=ROOT,
                                               FFN_TORCH_DEBUG_NANS="1"))
    assert done.stdout.strip() == "True True", done.stdout


def test_profile_writes_a_trace(tmp_path):
    with profile(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace.json").stat().st_size > 0


# ---------------------------------------------------------------------------
# the package's top-level API (tests/test_api_surface.py's first two)
# ---------------------------------------------------------------------------

REFERENCE_EXPORTS = [
    "CameraInfo", "Resolution", "MLP", "BasicFourierMLP",
    "FourierFeatureMLP", "PositionalFourierMLP", "GaussianFourierMLP",
    "NeRF", "Voxels", "ImageDataset", "PixelDataset", "SignalDataset",
    "RayDataset", "RaySampler", "RaySamples", "Raycaster", "OcTree",
    "calculate_blend_weights", "ETABar", "exponential_lr_decay",
    "hemisphere", "interpolate_bilinear", "load_model", "orbit",
    "ActivationVisualizer", "ComparisonVisualizer",
    "EvaluationVisualizer", "OrbitVideoVisualizer",
]


def test_reference_api_names_present():
    missing = [name for name in REFERENCE_EXPORTS
               if not hasattr(port_api, name)]
    assert not missing, f"missing reference API names: {missing}"


def test_framework_additions_present():
    for name in ["Mode", "RenderResult", "save_model",
                 "generate_synthetic_dataset", "Visualizer", "ops"]:
        assert hasattr(port_api, name), name


def test_every_jax_export_but_the_downloader():
    """The package's own exports: every JAX export, the downloader
    included since it was ported (the name predates that), and the
    port's two additions; every submodule's exports are held by
    ``test_every_jax_export_has_a_counterpart``."""
    names = set(ffn.__all__)
    assert "download_asset" in names
    assert names <= set(port_api.__all__)
    assert set(port_api.__all__) - names == {"flagship_nerf",
                                             "OccupancyGridSampler"}
    assert all(hasattr(port_api, name) for name in port_api.__all__)
    assert port_api.exponential_lr_decay is port_api.exponential_lr


# ---------------------------------------------------------------------------
# every JAX export and CLI flag has a counterpart in the port
# ---------------------------------------------------------------------------

JAX_DIR = os.path.join(ROOT, "fourier_feature_nets_tpu")

#: JAX modules whose names the port keeps in other modules, searched in
#: order (a JAX module missing here maps to the port module of its path).
MOVED = {
    "ops.fused_nerf": ["kernels.fused_nerf"],
    "ops.fused_nerf_train": ["kernels.fused_nerf_train",
                             "kernels.fused_nerf"],
    "ops.fused_ray_render": ["kernels.fused_ray_render"],
    "octree.device": ["octree.traversal"],
    "utils.optim": ["utils.optim", "utils.checkpoint"],
    "ops.fused_nerf_fm": [],
    "ops.fused_nerf_train_fm": [],
    "ops.grid_sample": [],
}

_FM = ("the feature-major layout split is dropped: the port has one "
       "kernel layout, and render/raycaster.py::resolve_fused picks the "
       "fused or the plain path")
_ADAM = ("the functional Adam of JAX pytrees: utils/optim.py::ClippedAdam "
         "(torch.optim.Adam behind clip_grad_value_ and clip_grad_norm_)")
_MODULE = ("a JAX model is a pure init/apply pair; a port model is an "
           "nn.Module that holds its parameters, built by nn.Linear")
_SHARDING = ("a JAX sharding; a port rank holds its own rows "
             "(parallel/mesh.py::shard_rays) and replicated weights "
             "(replicate)")
_GRID = "a Pallas grid sampler: the port's voxels call F.grid_sample"

#: JAX exports with no counterpart in the port, each with its reason.
EXCEPTIONS = {
    "Model": _MODULE, "linear_init": _MODULE, "mlp_init": _MODULE,
    "adam_init": _ADAM, "adam_update": _ADAM, "clip_gradients": _ADAM,
    "global_norm": _ADAM,
    "data_sharding": _SHARDING, "replicated_sharding": _SHARDING,
    "grid_sample_3d": _GRID, "grid_sample_3d_fast": _GRID,
    "FusedNeRFWeightsFM": _FM, "prepare_fused_nerf_fm": _FM,
    "fused_nerf_apply_fm": _FM, "pack_fused_nerf_fm": _FM,
    "fused_nerf_train_apply_fm": _FM, "model_statics_fm": _FM,
    "model_statics": ("the static model description of the TPU kernels' "
                      "layout: the port's packs (FusedNeRFWeights) carry "
                      "theirs"),
}


def _jax_modules(with_all: bool):
    """Dotted names (relative to the package, "" for it) of the JAX
    modules whose source has an ``__all__`` (or, without ``with_all``,
    of the CLIs that take arguments), read without importing them."""
    found = []
    for folder, _, files in os.walk(JAX_DIR):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(folder, name), JAX_DIR)
            dotted = rel[:-3].replace(os.sep, ".")
            dotted = dotted.removesuffix("__init__").rstrip(".")
            with open(os.path.join(folder, name)) as handle:
                source = handle.read()
            if with_all and re.search(r"^__all__\s*=", source, re.M):
                found.append(dotted)
            elif (not with_all and dotted.startswith("cli.")
                  and "parse_args(" in source):
                found.append(dotted)
    return sorted(found)


def _full(package, dotted):
    return f"{package}.{dotted}" if dotted else package


@pytest.mark.parametrize("module", _jax_modules(True),
                         ids=lambda module: module or "package")
def test_every_jax_export_has_a_counterpart(module):
    """Every name of the JAX module's ``__all__`` is in the port module
    of the same path, or of the one that took its place (``MOVED``), or
    is an ``EXCEPTIONS`` entry."""
    jax_mod = importlib.import_module(_full("fourier_feature_nets_tpu",
                                            module))
    targets = [importlib.import_module(_full("fourier_feature_nets_torch",
                                             name))
               for name in MOVED.get(module, [module])]
    missing = [name for name in jax_mod.__all__
               if not any(hasattr(target, name) for target in targets)
               and name not in EXCEPTIONS]
    assert not missing, f"{module}: no counterpart for {missing}"


def test_export_exceptions_are_needed():
    """Each exception names a JAX export that some port counterpart
    lacks, never one of this slice's names, and gives a reason."""
    lacking = set()
    for module in _jax_modules(True):
        jax_mod = importlib.import_module(_full("fourier_feature_nets_tpu",
                                                module))
        targets = [importlib.import_module(
            _full("fourier_feature_nets_torch", name))
            for name in MOVED.get(module, [module])]
        lacking |= {name for name in jax_mod.__all__
                    if not any(hasattr(t, name) for t in targets)}
    assert set(EXCEPTIONS) <= lacking, set(EXCEPTIONS) - lacking
    assert not {"download_asset", "ASSETS", "default_data_dir", "get_rays",
                "subsample_index"} & set(EXCEPTIONS)
    assert all(len(reason) > 20 for reason in EXCEPTIONS.values())


class _Parsed(Exception):
    pass


def _cli_flags(package, module, monkeypatch):
    """The option strings of the CLI's parser, taken from the parser its
    ``main`` builds (``parse_args`` raises before any work)."""
    parsers = []

    def capture(self, args=None, namespace=None):
        parsers.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    cli = importlib.import_module(f"{package}.{module}")
    with pytest.raises(_Parsed):
        cli.main([])
    return {flag for action in parsers[0]._actions
            for flag in action.option_strings}


@pytest.mark.parametrize("module", _jax_modules(False))
def test_every_jax_cli_flag_has_a_counterpart(module, monkeypatch):
    """Every ``--flag`` of the JAX CLI is a flag of the port CLI of the
    same name."""
    jax_flags = _cli_flags("fourier_feature_nets_tpu", module, monkeypatch)
    port_flags = _cli_flags("fourier_feature_nets_torch", module,
                            monkeypatch)
    assert "--help" in jax_flags
    missing = sorted(jax_flags - port_flags)
    assert not missing, f"{module}: the port lacks {missing}"
