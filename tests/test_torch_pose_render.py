"""Frames of any camera pose and the chunked parity frame in the port,
against the JAX package (mirrors tests/test_pose_render.py).

A rig camera's pose renders the indexed frame bit for bit, and a novel
pose renders what a sampler built around that camera renders at its
index. Against JAX's ``render_frame_pose`` and ``render_image`` the
frames are uint8 within +-1, as every frame test of the port; a focus
sampler's rig pose is within +-1 of its indexed frame, since its CDFs are
computed on the fly from the pose geometry, not read from the rig's
table (the JAX suite's own limit there).
"""

import cv2
import jax
import numpy as np
import pytest
import torch

from fourier_feature_nets_torch.cli import orbit_video as torch_orbit
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_torch.octree import OcTree as TorchTree
from fourier_feature_nets_torch.render import (
    OccupancyGridSampler as TorchOccupancy,
)
from fourier_feature_nets_torch.render import OctreeRaySampler as TorchOctree
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_torch.render import RaySampler as TorchRaySampler
from fourier_feature_nets_tpu.cameras import Resolution
from fourier_feature_nets_tpu.cli import orbit_video as jax_orbit
from fourier_feature_nets_tpu.models import NeRF, save_model
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.octree import OcTree
from fourier_feature_nets_tpu.render import Raycaster, RaySampler
from fourier_feature_nets_tpu.render.occupancy_sampler import (
    OccupancyGridSampler,
)
from fourier_feature_nets_tpu.render.octree_sampler import OctreeRaySampler
from fourier_feature_nets_tpu.utils.camera_paths import orbit

CONFIG = dict(num_layers=2, num_channels=32, max_log_scale_pos=4.0,
              num_freq_pos=5, max_log_scale_view=2.0, num_freq_view=3,
              skips=[1], include_inputs=True)
BOUNDS = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
SAMPLERS = ["uniform", "focus", "occupancy", "octree"]


@pytest.fixture(scope="module")
def cameras():
    # four orbit cameras: the rig is the first three, the fourth a novel
    # pose
    return orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                 4, 40.0, Resolution(20, 20), 3.0)


@pytest.fixture(scope="module")
def nerf():
    model = NeRF(**CONFIG)
    params = model.init(jax.random.PRNGKey(3))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    return model, params, params_from_jax(TorchNeRF(**CONFIG), flat)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(2)
    points = rng.normal([0.3, 0.0, 0.0], 0.15, (4000, 3))
    anchors = np.array([[-1, -1, -1], [1, 1, 1]], np.float64)
    return np.concatenate([points, anchors]).astype(np.float32)


def _samplers(kind, cameras, nerf, cloud, num_samples=12):
    """(JAX sampler, port sampler) of ``kind`` over ``cameras``."""
    model, params, port = nerf
    if kind == "uniform":
        return (RaySampler(BOUNDS, cameras, num_samples),
                TorchRaySampler(BOUNDS, cameras, num_samples))
    if kind == "focus":
        return (RaySampler(BOUNDS, cameras, num_samples, False, model,
                           params),
                TorchRaySampler(BOUNDS, cameras, num_samples,
                                opacity_model=port))
    if kind == "occupancy":
        return (OccupancyGridSampler(OcTree.build_from_samples(cloud, 5, 2),
                                     cameras, num_samples,
                                     grid_resolution=16, num_probes=8,
                                     bounds=BOUNDS),
                TorchOccupancy.from_tree(
                    TorchTree.build_from_samples(cloud, 5, 2), cameras,
                    num_samples, grid_resolution=16, num_probes=8,
                    bounds=BOUNDS))
    return (OctreeRaySampler(OcTree.build_from_samples(cloud, 4, 2), cameras,
                             num_samples, bounds=BOUNDS),
            TorchOctree(TorchTree.build_from_samples(cloud, 4, 2), cameras,
                        num_samples, bounds=BOUNDS))


def _assert_close(ours, ref, max_diff=1):
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    diff = np.abs(ours.astype(int) - ref.astype(int)).max()
    assert diff <= max_diff, diff


def test_pose_calibration_matches_jax(cameras):
    ray_m, position = TorchRaySampler.pose_calibration(cameras[3])
    ref_m, ref_p = RaySampler.pose_calibration(cameras[3])
    np.testing.assert_array_equal(ray_m.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(position.numpy(), np.asarray(ref_p))
    sampler = TorchRaySampler(BOUNDS, cameras[:3], 8)
    for index in range(3):
        ray_m, position = TorchRaySampler.pose_calibration(cameras[index])
        assert torch.equal(ray_m, sampler.cam_ray_m[index])
        assert torch.equal(position, sampler.cam_positions[index])


@pytest.mark.parametrize("kind", SAMPLERS)
def test_pose_with_rig_camera_equals_indexed_frame(cameras, nerf, cloud,
                                                   kind):
    """A rig camera through the pose path renders the indexed frame: bit
    for bit, and within +-1 for a focus sampler (CDFs on the fly); the
    occupancy sampler's frames are culled and share one probe."""
    _, port_sampler = _samplers(kind, cameras[:3], nerf, cloud)
    caster = TorchRaycaster(nerf[2])
    for index in (0, 2):
        indexed = caster.render_frame(port_sampler, index, chunk_size=96)
        posed = caster.render_frame_pose(port_sampler, cameras[index],
                                         chunk_size=96)
        if kind == "focus":
            _assert_close(posed, indexed)
        else:
            np.testing.assert_array_equal(posed, indexed)
        assert indexed.any()
    # the calibration pair renders what the CameraInfo renders
    pair = TorchRaySampler.pose_calibration(cameras[1])
    np.testing.assert_array_equal(
        caster.render_frame_pose(port_sampler, pair, chunk_size=96),
        caster.render_frame_pose(port_sampler, cameras[1], chunk_size=96))


@pytest.mark.parametrize("kind", ["uniform", "focus"])
def test_novel_pose_equals_fresh_sampler(cameras, nerf, cloud, kind):
    """A pose outside the rig renders what a sampler built around that
    camera renders at its index: bit for bit uniformly, within +-1 with
    focus sampling (the fresh sampler reads its CDF table)."""
    _, rig = _samplers(kind, cameras[:3], nerf, cloud)
    _, fresh = _samplers(kind, cameras[3:], nerf, cloud)
    caster = TorchRaycaster(nerf[2])
    posed = caster.render_frame_pose(rig, cameras[3], chunk_size=112)
    ref = caster.render_frame(fresh, 0, chunk_size=112)
    if kind == "focus":
        _assert_close(posed, ref)
    else:
        np.testing.assert_array_equal(posed, ref)


@pytest.mark.parametrize("kind", SAMPLERS)
def test_render_frame_pose_matches_jax(cameras, nerf, cloud, kind):
    """``render_frame_pose`` of a novel pose within +-1 of JAX's, for
    uniform, focus (CDFs on the fly), culled occupancy and octree
    samplers."""
    model, params, port = nerf
    jax_sampler, port_sampler = _samplers(kind, cameras[:3], nerf, cloud)
    ref = Raycaster(model).render_frame_pose(params, jax_sampler, cameras[3],
                                             chunk_size=100)
    ours = TorchRaycaster(port).render_frame_pose(port_sampler, cameras[3],
                                                  chunk_size=100)
    _assert_close(ours, ref)
    assert ref.any()


def test_pose_resolution_mismatch_raises(cameras, nerf):
    bad = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                1, 40.0, Resolution(10, 10), 3.0)[0]
    sampler = TorchRaySampler(BOUNDS, cameras[:2], 8)
    with pytest.raises(ValueError, match="resolution"):
        TorchRaycaster(nerf[2]).render_frame_pose(sampler, bad)
    model, params, _ = nerf
    with pytest.raises(ValueError, match="resolution"):
        Raycaster(model).render_frame_pose(
            params, RaySampler(BOUNDS, cameras[:2], 8), bad)


@pytest.mark.parametrize("kind", ["uniform", "octree"])
def test_render_image_matches_jax(cameras, nerf, cloud, kind):
    """The chunked parity frame (``rays_for_camera``, ``batched_render``,
    ``to_image``) within +-1 of JAX's, and of the port's own whole
    frame."""
    model, params, port = nerf
    jax_sampler, port_sampler = _samplers(kind, cameras[:3], nerf, cloud)
    ref = Raycaster(model).render_image(params, jax_sampler, 4,
                                        batch_size=64)
    caster = TorchRaycaster(port)
    ours = caster.render_image(port_sampler, 4, batch_size=64)
    _assert_close(ours, ref)
    _assert_close(ours, caster.render_frame(port_sampler, 1, chunk_size=64))
    assert ours.any()


def test_orbit_video_chunked_matches_jax(nerf, tmp_path, capsys):
    """``orbit_video --chunked`` renders through ``render_image`` in both
    CLIs; the port warns, as the JAX CLI does, that ``--early-term`` is
    ignored there."""
    model, params, _ = nerf
    checkpoint = str(tmp_path / "nerf.npz")
    save_model(model, params, checkpoint)
    tail = ["--num-frames", "2", "--no-focus", "--num-samples", "12",
            "--chunked", "--early-term", "0.01"]
    assert torch_orbit.main([checkpoint, "16", str(tmp_path / "port"), *tail,
                             "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert "--early-term are ignored" in captured.err
    assert "2 frames of 16x16 on cpu" in captured.out
    assert jax_orbit.main([checkpoint, "16", str(tmp_path / "jax"),
                           *tail]) == 0
    for frame in range(2):
        name = f"frame_{frame:05d}.png"
        ours = cv2.imread(str(tmp_path / "port" / name))
        ref = cv2.imread(str(tmp_path / "jax" / name))
        _assert_close(ours, ref)
        assert ours.any()


def test_pose_culled_frame_reads_one_probe(cameras, nerf, cloud):
    """The pose path's culled frame counts its hit rays as the indexed
    frame does: one probe, shared."""
    _, port_sampler = _samplers("occupancy", cameras[:3], nerf, cloud)
    caster = TorchRaycaster(nerf[2])
    caster.render_frame(port_sampler, 1, chunk_size=64)
    indexed = dict(caster.frame_rays)
    caster.render_frame_pose(port_sampler, cameras[1], chunk_size=64)
    assert caster.frame_rays == indexed
    assert 0 < indexed["hit"] < port_sampler.rays_per_camera
    hit = TorchRaycaster._compute_hit(
        port_sampler, TorchRaySampler.pose_calibration(cameras[1]), 2)
    assert torch.equal(hit, TorchRaycaster._compute_hit(port_sampler, 1, 2))
