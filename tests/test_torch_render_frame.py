"""The port's samplers, raycaster and orbit CLI against the JAX
package's, on the same cameras, occupancy grids and weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourier_feature_nets_torch.cli import common as torch_common
from fourier_feature_nets_torch.cli import orbit_video as torch_orbit
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_torch.render import (
    OccupancyGridSampler as TorchOccupancy,
    Raycaster as TorchRaycaster,
    RaySampler as TorchRaySampler,
    RaySamples as TorchRaySamples,
    density_grid_from_model as torch_density_grid,
)
from fourier_feature_nets_torch.utils import orbit as torch_orbit_path
from fourier_feature_nets_torch.utils import write_png
from face_probe import face_bound, gather_hit
from fourier_feature_nets_tpu.cameras import Resolution
from fourier_feature_nets_tpu.cli import common as jax_common
from fourier_feature_nets_tpu.models import NeRF, save_model
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.render import Raycaster, RaySampler
from fourier_feature_nets_tpu.render.occupancy_sampler import (
    OccupancyGridSampler,
    density_grid_from_model,
)
from fourier_feature_nets_tpu.utils.camera_paths import orbit

CONFIG = dict(num_layers=3, num_channels=32, max_log_scale_pos=9.0,
              num_freq_pos=10, max_log_scale_view=3.0, num_freq_view=4,
              skips=[1], include_inputs=True)
BOUNDS = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
# a volume that some rays of the 20 px rig miss
SMALL = np.diag([1.2, 1.2, 1.2, 1.0]).astype(np.float32)
UP = np.array([0.0, 1.0, 0.0])
FORWARD = np.array([0.0, 0.0, 1.0])


@pytest.fixture(scope="module")
def nerf():
    model = NeRF(**CONFIG)
    params = model.init(jax.random.PRNGKey(2))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    return model, params, params_from_jax(TorchNeRF(**CONFIG), flat)


@pytest.fixture(scope="module")
def cameras():
    return orbit(UP, FORWARD, 3, 40.0, Resolution(20, 20), 3.0)


def _sphere_grid(resolution, center=(0.3, 0.0, 0.0), radius=0.45):
    c = (np.arange(resolution) + 0.5) / resolution * 2 - 1
    zz, yy, xx = np.meshgrid(c, c, c, indexing="ij")
    dist = np.sqrt((xx - center[0]) ** 2 + (yy - center[1]) ** 2
                   + (zz - center[2]) ** 2)
    return (dist < radius).astype(np.float32)


def _occupancy_pair(cameras, grid, num_samples=12, num_probes=16):
    jax_sampler = OccupancyGridSampler(
        None, cameras, num_samples, num_probes=num_probes,
        empty_weight=0.1, bounds=BOUNDS, occupancy_grid=grid,
        grid_scale=1.0)
    port_sampler = TorchOccupancy(grid, 1.0, cameras, num_samples,
                                  num_probes=num_probes, empty_weight=0.1,
                                  bounds=BOUNDS)
    return jax_sampler, port_sampler


def _assert_frames_close(ours, ref, max_diff=1):
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= max_diff, diff.max()


def test_orbit_path_matches_jax():
    ours = torch_orbit_path(UP, FORWARD, 5, 40.0, Resolution(24, 24), 4.0)
    ref = orbit(UP, FORWARD, 5, 40.0, Resolution(24, 24), 4.0)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
        np.testing.assert_array_equal(a.extrinsics, b.extrinsics)


@pytest.mark.parametrize("camera", [0, 2])
def test_camera_ray_geometry_matches_jax(cameras, camera):
    ref = RaySampler(SMALL, cameras, 8).camera_ray_geometry(
        jnp.int32(camera), jnp.arange(400, dtype=jnp.int32))
    ours = TorchRaySampler(SMALL, cameras, 8).camera_ray_geometry(
        camera, torch.arange(400))
    for a, b in zip(ours[:4], ref[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(ours[4].numpy(), np.asarray(ref[4]))
    assert np.asarray(ref[4]).any() and not np.asarray(ref[4]).all()


def test_uniform_samples_match_jax(cameras):
    offsets = np.arange(0, 400, 3)
    ref, ref_valid = RaySampler(SMALL, cameras, 8).sample_camera_rays(
        jnp.int32(1), jnp.asarray(offsets, jnp.int32))
    ours, valid = TorchRaySampler(SMALL, cameras, 8).sample_camera_rays(
        1, torch.from_numpy(offsets))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    for name in ("positions", "view_directions", "t_values"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ours.rays.numpy(), np.asarray(ref.rays))


@pytest.mark.parametrize("resolution", [16, 64])
def test_probe_hit_set_identical_to_jax_matmul(cameras, resolution):
    """The gather reads the same max-pooled table as the JAX default
    one-hot-matmul probe, so on the same geometry its hit sets are
    identical (64^3 pools to 32^3; 16^3 is used as is); the culling
    flag, which also reads the cell across a face within FACE_DELTA, is
    a superset, equal to it off the face-bound rays."""
    grid = _sphere_grid(resolution)
    jax_sampler, port_sampler = _occupancy_pair(cameras, grid)
    assert jax_sampler.probe_mode == "matmul"
    assert port_sampler._probe_resolution == \
        jax_sampler._probe_resolution == min(resolution, 32)
    geometry = jax_sampler.camera_ray_geometry(
        jnp.int32(0), jnp.arange(400, dtype=jnp.int32))
    ref_edges, ref_cdf, ref_hit = jax_sampler._probe_cdf_geometry(
        *geometry[:4])
    ours = [torch.from_numpy(np.array(g)) for g in geometry[:4]]
    edges, cdf, hit = port_sampler._probe_cdf_geometry(*ours)
    np.testing.assert_array_equal(gather_hit(port_sampler, *ours).numpy(),
                                  np.asarray(ref_hit))
    assert np.asarray(ref_hit).any() and not np.asarray(ref_hit).all()
    # the culling flag (conservative at cell faces) adds only face-bound
    # rays to the gather's
    hit, ref_hit = hit.numpy(), np.asarray(ref_hit)
    bound = face_bound(port_sampler, *ours).numpy()
    assert (hit >= ref_hit).all()
    np.testing.assert_array_equal(hit[~bound], ref_hit[~bound])
    np.testing.assert_allclose(edges.numpy(), np.asarray(ref_edges),
                               rtol=1e-6)
    np.testing.assert_allclose(cdf.numpy(), np.asarray(ref_cdf), rtol=1e-5,
                               atol=1e-6)


def test_occupancy_samples_match_jax(cameras):
    jax_sampler, port_sampler = _occupancy_pair(cameras, _sphere_grid(16))
    offsets = np.arange(400)
    ref, _ = jax_sampler.sample_camera_rays(
        jnp.int32(2), jnp.asarray(offsets, jnp.int32))
    ours, _ = port_sampler.sample_camera_rays(2, torch.from_numpy(offsets))
    np.testing.assert_allclose(ours.t_values.numpy(),
                               np.asarray(ref.t_values), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ours.positions.numpy(),
                               np.asarray(ref.positions), rtol=1e-5,
                               atol=1e-5)


def _median_cell_alpha(port, resolution):
    """A threshold that splits the random model's cells in half."""
    c = (np.arange(resolution) + 0.5) / resolution * 2 - 1
    zz, yy, xx = np.meshgrid(c, c, c, indexing="ij")
    points = torch.from_numpy(
        np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.float32))
    with torch.no_grad():
        sigma = torch.nn.functional.softplus(
            port(points, torch.zeros_like(points))[:, 3])
    alpha = 1.0 - torch.exp(-sigma * 2.0 / resolution)
    return float(alpha.median())


def test_density_grid_matches_jax(nerf):
    model, params, port = nerf
    threshold = _median_cell_alpha(port, 16)
    ref = density_grid_from_model(model, params, 16,
                                  alpha_threshold=threshold)
    ours = torch_density_grid(port, 16, alpha_threshold=threshold)
    assert 0.3 < ref.mean() < 0.7
    np.testing.assert_array_equal(ours, ref)


def test_from_model_builds_the_same_sampler(nerf, cameras):
    model, params, port = nerf
    threshold = _median_cell_alpha(port, 16)
    ref = OccupancyGridSampler.from_model(model, params, cameras, 12,
                                          grid_resolution=16,
                                          alpha_threshold=threshold,
                                          bounds=BOUNDS)
    ours = TorchOccupancy.from_model(port, cameras, 12, grid_resolution=16,
                                     alpha_threshold=threshold,
                                     bounds=BOUNDS)
    assert ours.empty_weight == ref.empty_weight == 0.1
    np.testing.assert_array_equal(ours.probe_table.numpy(),
                                  np.asarray(ref.probe_table).reshape(-1)[
                                      :ours.probe_table.numel()])


def test_batched_render_matches_jax(nerf, cameras):
    model, params, port = nerf
    samples, _ = TorchRaySampler(BOUNDS, cameras, 8).sample_camera_rays(
        0, torch.arange(0, 400, 7))
    ref_samples, _ = RaySampler(BOUNDS, cameras, 8).sample_camera_rays(
        jnp.int32(0), jnp.arange(0, 400, 7, dtype=jnp.int32))
    ref = Raycaster(model).batched_render(params, ref_samples, 16,
                                          include_depth=True)
    ours = TorchRaycaster(port).batched_render(
        TorchRaySamples(samples.positions.contiguous(),
                        samples.view_directions.contiguous(),
                        samples.t_values, None), 16, include_depth=True)
    np.testing.assert_allclose(ours.color, ref.color, atol=1e-4)
    np.testing.assert_allclose(ours.alpha, ref.alpha, atol=1e-4)
    np.testing.assert_allclose(ours.depth, ref.depth, rtol=1e-5)


def test_unculled_frame_matches_jax(nerf, cameras):
    model, params, port = nerf
    ref = Raycaster(model).render_frame(
        params, RaySampler(SMALL, cameras, 8), 1, chunk_size=112)
    ours = TorchRaycaster(port).render_frame(
        TorchRaySampler(SMALL, cameras, 8), 1, chunk_size=112)
    _assert_frames_close(ours, ref)
    assert (ref == 0).all(-1).any()     # rays that miss the volume


@pytest.fixture(scope="module")
def culled_reference(nerf, cameras):
    model, params, _ = nerf
    jax_sampler, _ = _occupancy_pair(cameras, _sphere_grid(16))
    return Raycaster(model).render_frame(params, jax_sampler, 0,
                                         chunk_size=64)


@pytest.mark.parametrize("fused", [False, True])
def test_culled_frame_matches_jax(nerf, cameras, culled_reference, fused):
    """fused=True on the CPU runs the kernel's plain twin."""
    _, _, port = nerf
    _, port_sampler = _occupancy_pair(cameras, _sphere_grid(16))
    caster = TorchRaycaster(port, fused=fused)
    assert caster.fused == fused
    ours = caster.render_frame(port_sampler, 0, chunk_size=64)
    _assert_frames_close(ours, culled_reference)
    black = (culled_reference == 0).all(-1)
    assert black.any() and not black.all()


def test_culled_frame_keeps_hit_rays_of_unculled(nerf, cameras):
    _, _, port = nerf
    _, port_sampler = _occupancy_pair(cameras, _sphere_grid(16))
    caster = TorchRaycaster(port)
    culled = caster.render_frame(port_sampler, 0, chunk_size=50,
                                 probe_subsample=1)
    full = caster.render_frame(port_sampler, 0, cull_empty=False)
    hit = caster._compute_hit(port_sampler, 0, 1).reshape(20, 20).numpy()
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(culled[hit], full[hit])
    assert (culled[~hit] == 0).all()


def test_stride2_probe_raster_matches_jax(nerf):
    """A coarse grid keeps occupied cells several pixels wide, so both
    renderers keep the stride-2 dilated probe raster."""
    model, params, port = nerf
    rig = orbit(UP, FORWARD, 2, 40.0, Resolution(40, 40), 4.0)
    grid = _sphere_grid(4, center=(0.5, 0.0, 0.0), radius=0.6)
    jax_sampler, port_sampler = _occupancy_pair(rig, grid, num_samples=8,
                                                num_probes=8)
    assert Raycaster._safe_probe_subsample(jax_sampler, 2) == 2
    assert TorchRaycaster._safe_probe_subsample(port_sampler, 2) == 2
    ref = Raycaster(model).render_frame(params, jax_sampler, 1,
                                        chunk_size=256)
    ours = TorchRaycaster(port).render_frame(port_sampler, 1,
                                             chunk_size=256)
    _assert_frames_close(ours, ref)
    black = (ref == 0).all(-1)
    assert black.any() and not black.all()


def test_safe_probe_subsample_matches_jax(cameras):
    for resolution in (8, 16, 64):
        jax_sampler, port_sampler = _occupancy_pair(
            cameras, _sphere_grid(resolution))
        for stride in (1, 2, 3):
            assert (TorchRaycaster._safe_probe_subsample(port_sampler,
                                                         stride)
                    == Raycaster._safe_probe_subsample(jax_sampler, stride))
    assert TorchRaycaster._safe_probe_subsample(
        TorchRaySampler(BOUNDS, cameras, 8), 2) == 2


def test_bf16_fused_frame_close_to_jax_bf16(nerf, cameras, culled_reference):
    model, params, port = nerf
    jax_sampler, port_sampler = _occupancy_pair(cameras, _sphere_grid(16))
    ref = Raycaster(model, compute_dtype=jnp.bfloat16).render_frame(
        params, jax_sampler, 0, chunk_size=64)
    ours = TorchRaycaster(port, compute_dtype=torch.bfloat16,
                          fused=True).render_frame(port_sampler, 0,
                                                   chunk_size=64)
    _assert_frames_close(ours, ref)


def test_write_png_roundtrip(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (13, 21, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, image)
    decoded = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                           cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(decoded, image)
    with pytest.raises(ValueError):
        write_png(path, image.astype(np.float32))


@pytest.mark.parametrize("argv", [
    ["--preset", "fast"],
    ["--preset", "fast", "--num-samples", "32"],
    ["--preset", "fast", "--num-sam", "32", "--compute-dtype", "float32"],
    ["--preset", "quality", "--early-term", "0"],
    ["--no-focus"],
])
def test_presets_match_jax(argv):
    from fourier_feature_nets_tpu.cli.orbit_video import (
        _parse_args as jax_parse,
    )
    full = ["m.npz", "16", "out"] + argv
    ours = vars(torch_orbit._parse_args(full))
    ref = vars(jax_parse(full))
    for key, value in ref.items():
        assert ours[key] == value, key
    assert torch_common.RENDER_PRESETS == jax_common.RENDER_PRESETS


@pytest.fixture(scope="module")
def checkpoint(nerf, tmp_path_factory):
    model, params, _ = nerf
    path = str(tmp_path_factory.mktemp("ckpt") / "nerf.npz")
    save_model(model, params, path)
    return path


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """The files the CLI flags name: another model's checkpoint (for
    ``--opacity-model``) and bench.py's octree (for ``--octree``)."""
    from fourier_feature_nets_tpu.octree import OcTree
    root = tmp_path_factory.mktemp("cli_files")
    model = NeRF(**CONFIG)
    other = str(root / "other.npz")
    save_model(model, model.init(jax.random.PRNGKey(9)), other)
    rng = np.random.default_rng(1)
    cloud = np.concatenate([rng.normal([0.2, 0.0, 0.0], 0.2, (20000, 3)),
                            [[-1, -1, -1], [1, 1, 1]]]).astype(np.float32)
    tree = str(root / "tree.npz")
    OcTree.build_from_samples(cloud, depth=6, min_leaf_size=2).save(tree)
    return {"OTHER": other, "TREE": tree}


@pytest.mark.parametrize("flags", [
    ["--preset", "fast"],
    ["--no-focus", "--num-samples", "8"],
    ["--num-samples", "16"],              # the default: focus sampling
    ["--opacity-model", "OTHER", "--num-samples", "16"],
    ["--octree", "TREE", "--num-samples", "16"],
    ["--octree", "TREE", "--octree-mode", "traversal", "--num-samples",
     "16"],
])
def test_orbit_video_cli_matches_jax(checkpoint, cli_files, tmp_path, flags,
                                     capsys):
    cv2 = pytest.importorskip("cv2")
    from fourier_feature_nets_tpu.cli import orbit_video as jax_orbit
    flags = [cli_files.get(flag, flag) for flag in flags]
    common = [checkpoint, "16"]
    tail = ["--num-frames", "2"] + flags
    assert torch_orbit.main(common + [str(tmp_path / "port")] + tail
                            + ["--device", "cpu"]) == 0
    assert "2 frames of 16x16 on cpu" in capsys.readouterr().out
    assert jax_orbit.main(common + [str(tmp_path / "jax")] + tail) == 0
    for frame in range(2):
        name = f"frame_{frame:05d}.png"
        ours = cv2.imread(str(tmp_path / "port" / name))
        ref = cv2.imread(str(tmp_path / "jax" / name))
        assert ours.shape == (16, 16, 3)
        _assert_frames_close(ours, ref)
        assert ours.any()


@pytest.mark.parametrize("flags", [
    ["--density-grid", "--early-term", "0.01", "--num-samples", "16"],
    ["--preset", "quality"],
])
def test_orbit_video_cli_early_term_matches_jax(checkpoint, tmp_path, flags,
                                                capsys):
    """``--early-term`` and ``--preset quality`` (96 density-grid samples,
    early termination at 1e-2 after 48, bf16) run through both CLIs on
    the same checkpoint: every frame within +-1."""
    cv2 = pytest.importorskip("cv2")
    from fourier_feature_nets_tpu.cli import orbit_video as jax_orbit
    tail = ["--num-frames", "2", *flags]
    assert torch_orbit.main([checkpoint, "16", str(tmp_path / "port"), *tail,
                             "--device", "cpu"]) == 0
    assert "hit rays survived pass 1" in capsys.readouterr().out
    assert jax_orbit.main([checkpoint, "16", str(tmp_path / "jax"),
                           *tail]) == 0
    for frame in range(2):
        name = f"frame_{frame:05d}.png"
        ours = cv2.imread(str(tmp_path / "port" / name))
        ref = cv2.imread(str(tmp_path / "jax" / name))
        assert ours.shape == (16, 16, 3)
        _assert_frames_close(ours, ref)
        assert ours.any()


@pytest.mark.parametrize("flags", [
    ["--no-focus", "--chunked", "--mp4", "out.mp4"],
    ["--no-focus", "--data-parallel"],
    ["--no-focus", "--mp4", "out.mp4"],
])
def test_orbit_video_cli_mp4_and_data_parallel_match_jax(checkpoint,
                                                         tmp_path, flags):
    """``--mp4`` (with and without ``--chunked``) and ``--data-parallel``
    (a mesh of this process alone; JAX's takes its 8 virtual devices):
    every frame PNG within 1 of the JAX CLI's, and the MP4 read back by
    ``cv2.VideoCapture`` with JAX's frame count, size and rate, each
    sample the port's JPEG of its PNG (tests/test_torch_video.py)."""
    cv2 = pytest.importorskip("cv2")
    from fourier_feature_nets_tpu.cli import orbit_video as jax_orbit
    from fourier_feature_nets_torch.utils.png import read_png
    from test_torch_video import assert_mp4_holds, read_capture
    common = [checkpoint, "16"]
    tail = ["--num-frames", "3", "--num-samples", "8"]

    def named(side):
        return [str(tmp_path / f"{side}.mp4") if f == "out.mp4" else f
                for f in flags]

    assert torch_orbit.main(common + [str(tmp_path / "port")] + tail
                            + named("port") + ["--device", "cpu"]) == 0
    assert jax_orbit.main(common + [str(tmp_path / "jax")] + tail
                          + named("jax")) == 0
    frames = []
    for frame in range(3):
        name = f"frame_{frame:05d}.png"
        ours = cv2.imread(str(tmp_path / "port" / name))
        _assert_frames_close(ours, cv2.imread(str(tmp_path / "jax" / name)))
        assert ours.any()
        frames.append(read_png(str(tmp_path / "port" / name)))
    if "--mp4" in flags:
        _, *meta = read_capture(tmp_path / "jax.mp4")
        assert meta == [3, (16, 16), 20.0]
        assert_mp4_holds(tmp_path / "port.mp4", frames, 20, min_psnr=None)
