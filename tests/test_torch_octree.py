"""The port's octree against the JAX package's: the C++ build, query and
intersect, the torch traversal against JAX's ``device.py``, the NumPy
twins, pruning, NPZ files across the packages, the mesh sampling
functions, and the samplers built on a tree (the occupancy grid of
``OccupancyGridSampler.from_tree`` and ``OctreeRaySampler``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fourier_feature_nets_torch.octree.build as port_build
from fourier_feature_nets_torch.cli import mesh_to_octree as port_mesh_cli
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_torch.octree import OcTree as TorchTree
from fourier_feature_nets_torch.octree import host as port_host
from fourier_feature_nets_torch.octree import mesh as port_mesh
from fourier_feature_nets_torch.octree.traversal import (
    device_batch_intersect as torch_intersect,
    device_batch_query as torch_query,
)
from fourier_feature_nets_torch.render import (
    OccupancyGridSampler as TorchOccupancy,
    OctreeRaySampler as TorchOctreeSampler,
    Raycaster as TorchRaycaster,
    occupancy_grid_from_tree as torch_grid_from_tree,
)
from fourier_feature_nets_tpu.cameras import Resolution
from fourier_feature_nets_tpu.models import NeRF
from fourier_feature_nets_tpu.models.serialization import _flatten
from fourier_feature_nets_tpu.octree import OcTree
from fourier_feature_nets_tpu.octree import host as jax_host
from fourier_feature_nets_tpu.octree import mesh as jax_mesh
from fourier_feature_nets_tpu.octree.device import (
    device_batch_intersect,
    device_batch_query,
)
from fourier_feature_nets_tpu.ops.interpolation import interpolate_bilinear
from fourier_feature_nets_tpu.render import Raycaster
from fourier_feature_nets_tpu.render.occupancy_sampler import (
    OccupancyGridSampler,
    occupancy_grid_from_tree,
)
from fourier_feature_nets_tpu.render.octree_sampler import OctreeRaySampler
from fourier_feature_nets_tpu.utils.camera_paths import orbit
from face_probe import face_bound, gather_hit

CONFIG = dict(num_layers=2, num_channels=32, max_log_scale_pos=9.0,
              num_freq_pos=10, max_log_scale_view=3.0, num_freq_view=4,
              skips=[], include_inputs=True)
BOUNDS = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)


def _clusters(seed=7):
    """Two clusters and a shell: a cloud with clear sparse structure."""
    rng = np.random.default_rng(seed)
    a = rng.normal([0.5, 0.5, 0.5], 0.1, (2000, 3))
    b = rng.normal([-0.5, -0.2, 0.3], 0.15, (2000, 3))
    theta = rng.uniform(0, 2 * np.pi, 1000)
    phi = rng.uniform(0, np.pi, 1000)
    shell = 0.9 * np.stack([np.sin(phi) * np.cos(theta),
                            np.sin(phi) * np.sin(theta),
                            np.cos(phi)], -1)
    return np.concatenate([a, b, shell]).astype(np.float32)


def bench_cloud():
    """bench.py's headline cloud: 20,000 points about (0.2, 0, 0) and
    the two corners of the cube."""
    rng = np.random.default_rng(1)
    return np.concatenate([rng.normal([0.2, 0.0, 0.0], 0.2, (20000, 3)),
                           [[-1, -1, -1], [1, 1, 1]]]).astype(np.float32)


@pytest.fixture(scope="module")
def cloud():
    return _clusters()


@pytest.fixture(scope="module")
def trees(cloud):
    """(port, JAX) trees of the clusters with a 4-column payload."""
    data = np.concatenate([cloud, np.ones_like(cloud[:, :1])], -1)
    return (TorchTree.build_from_samples(cloud, 6, 4, data),
            OcTree.build_from_samples(cloud, 6, 4, data))


def _rays(num, seed=3):
    rng = np.random.default_rng(seed)
    starts = rng.normal(0.0, 0.3, (num, 3)).astype(np.float32)
    starts[:, 2] -= 3.0
    dirs = rng.normal(0.0, 0.2, (num, 3)).astype(np.float32)
    dirs[:, 2] = 1.0
    dirs[: num // 8, 0] = 0.0           # exact zeros take the 1e-8 guard
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return starts, dirs


def _assert_same_tree(ours, ref):
    np.testing.assert_array_equal(ours._node_index, ref._node_index)
    np.testing.assert_array_equal(ours._leaf_index, ref._leaf_index)
    assert ours.scale == ref.scale and ours.depth == ref.depth
    np.testing.assert_array_equal(ours.leaf_centers(), ref.leaf_centers())
    np.testing.assert_array_equal(ours.leaf_depths(), ref.leaf_depths())
    if ref.leaf_data() is None:
        assert ours.leaf_data() is None
    else:
        np.testing.assert_array_equal(ours.leaf_data(), ref.leaf_data())


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["clusters+data", "clusters", "bench",
                                   "scalar-data"])
def test_build_from_samples_matches_jax(which):
    points = bench_cloud() if which == "bench" else _clusters()
    data = None
    depth, min_leaf = (6, 2) if which == "bench" else (6, 4)
    if which == "clusters+data":
        data = np.concatenate([points, points[:, :1] ** 2], -1)
    elif which == "scalar-data":
        data = np.linspace(0.0, 1.0, len(points))
        depth = 4
    ours = TorchTree.build_from_samples(points, depth, min_leaf, data)
    ref = OcTree.build_from_samples(points, depth, min_leaf, data)
    _assert_same_tree(ours, ref)
    assert ours.num_leaves > 100 or which == "scalar-data"
    assert len(ours) == len(ref)


def test_numpy_twins_equal_the_library(cloud):
    data = np.concatenate([cloud, np.ones_like(cloud[:, :1])], -1)
    tree = TorchTree.build_from_samples(cloud, 5, 4, data)
    centered = cloud - 0.5 * (cloud.min(0) + cloud.max(0))
    nodes, leaves, leaf_data = port_host.build_from_samples_numpy(
        centered, 5, 4, data.astype(np.float64), tree.scale)
    np.testing.assert_array_equal(nodes, tree._node_index)
    np.testing.assert_array_equal(leaves, tree._leaf_index)
    np.testing.assert_allclose(leaf_data, tree.leaf_data(), rtol=1e-12)
    centers, depths = port_host.decode_ids_numpy(tree._leaf_index,
                                                 tree.scale)
    np.testing.assert_allclose(centers, tree.leaf_centers(), atol=1e-6)
    np.testing.assert_array_equal(depths, tree.leaf_depths())
    ref_centers, ref_depths = jax_host.decode_ids_numpy(tree._leaf_index,
                                                        tree.scale)
    np.testing.assert_array_equal(centers, ref_centers)
    np.testing.assert_array_equal(depths, ref_depths)


def test_query_matches_jax(trees):
    ours, ref = trees
    rng = np.random.default_rng(5)
    points = np.concatenate([rng.uniform(-1.2, 1.2, (4000, 3)),
                             ours.leaf_centers()]).astype(np.float32)
    expected = ref.query(points)
    np.testing.assert_array_equal(ours.query(points), expected)
    assert (expected >= 0).any() and (expected == -1).any()
    np.testing.assert_array_equal(ours.query(points[0]), expected[:1])


def test_intersect_matches_jax(trees):
    ours, ref = trees
    starts, dirs = _rays(256)
    path = ours.intersect(starts, dirs, max_length=64)
    expected = ref.intersect(starts, dirs, max_length=64)
    np.testing.assert_array_equal(path.leaves, expected.leaves)
    np.testing.assert_allclose(path.t_stops, expected.t_stops, atol=1e-6,
                               rtol=0)
    assert (expected.leaves >= 0).sum() > 200
    with pytest.raises(ValueError, match="matching shapes"):
        ours.intersect(starts, dirs[:1], max_length=8)


@pytest.mark.parametrize("tree_kind", ["clusters", "root-only", "bench"])
def test_torch_traversal_matches_jax_device(trees, tree_kind):
    """The torch traversal is JAX's ``device.py`` bit for bit: the same
    query leaves, and the same t stops and leaves of every step."""
    if tree_kind == "clusters":
        tree = trees[0]
    elif tree_kind == "root-only":
        tree = TorchTree(1.0, [], [0])
    else:
        tree = TorchTree.build_from_samples(bench_cloud(), 6, 2)
    nodes, leaves = tree.index_tensors("cpu")
    rng = np.random.default_rng(11)
    points = rng.uniform(-1.3, 1.3, (3000, 3)).astype(np.float32)
    got = torch_query(nodes, leaves, torch.from_numpy(points),
                      scale=tree.scale, max_depth=tree.depth)
    ref = device_batch_query(jnp.asarray(tree._node_index, jnp.int32),
                             jnp.asarray(tree._leaf_index, jnp.int32),
                             jnp.asarray(points), scale=tree.scale,
                             max_depth=tree.depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int64

    starts, dirs = _rays(200)
    path = torch_intersect(nodes, leaves, torch.from_numpy(starts),
                           torch.from_numpy(dirs), scale=tree.scale,
                           max_depth=tree.depth, max_length=48)
    expected = device_batch_intersect(
        jnp.asarray(tree._node_index, jnp.int32),
        jnp.asarray(tree._leaf_index, jnp.int32), jnp.asarray(starts),
        jnp.asarray(dirs), scale=tree.scale, max_depth=tree.depth,
        max_length=48)
    np.testing.assert_array_equal(path.leaves.numpy(),
                                  np.asarray(expected.leaves))
    np.testing.assert_array_equal(path.t_stops.numpy(),
                                  np.asarray(expected.t_stops))
    if tree_kind != "root-only":
        assert (path.leaves >= 0).any()
    # the tail slots hold the root exit and leaf -1
    assert (path.leaves[:, -1] == -1).all()


def test_torch_traversal_agrees_with_the_library(trees):
    """The torch tracer and the C++ one record the same leaves at the
    same t (the C++ tracer divides where torch multiplies by 1/d, so t
    may differ in the last bits; tail slots of rays that miss the cube
    can hold a root exit far along the ray, hence the relative term)."""
    tree = trees[0]
    starts, dirs = _rays(300, seed=8)
    host = tree.intersect(starts, dirs, max_length=64)
    dev = tree.intersect_device(torch.from_numpy(starts),
                                torch.from_numpy(dirs), max_length=64)
    np.testing.assert_array_equal(dev.leaves.numpy(), host.leaves)
    np.testing.assert_allclose(dev.t_stops.numpy(), host.t_stops, rtol=1e-6,
                               atol=1e-5)


def test_torch_traversal_advances_at_large_t(trees):
    """At t >= ~256 an f32 ulp exceeds a fixed 1e-5 nudge; the relative
    nudge keeps the march moving."""
    tree = trees[0]
    path = tree.intersect_device(torch.tensor([[0.0, 0.0, -1000.0]]),
                                 torch.tensor([[0.0, 0.0, 1.0]]), 64)
    leaves = path.leaves[0]
    assert (leaves >= 0).any()
    steps = path.t_stops[0][:max(int((leaves >= 0).sum()), 2)]
    assert (steps[1:] > steps[:-1]).all()


def test_prune_matches_jax(trees):
    ours, ref = trees
    _assert_same_tree(ours.prune(), ref.prune())
    bare = TorchTree.build_from_samples(bench_cloud(), 5, 2)
    _assert_same_tree(bare.prune(),
                      OcTree.build_from_samples(bench_cloud(), 5, 2).prune())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_loads_in_the_other_package(trees, tmp_path, writer):
    ours, ref = trees
    path = str(tmp_path / "tree.npz")
    if writer == "port":
        ours.save(path)
        _assert_same_tree(OcTree.load(path), ref)
    else:
        ref.save(path)
        _assert_same_tree(TorchTree.load(path), ours)
    blank = TorchTree(1.0, [0], [1, 2, 3, 4, 5, 6, 7, 8])
    blank.load_state(ref.state_dict)
    _assert_same_tree(blank, ours)
    with pytest.raises(FileNotFoundError):
        TorchTree.load(str(tmp_path / "missing.npz"))


def test_failed_build_raises(tmp_path, monkeypatch):
    """No NumPy fallback: a source g++ rejects raises with its output,
    and so does a machine without g++."""
    broken = tmp_path / "octree.cpp"
    broken.write_text("int octree_build( {\n")
    monkeypatch.setattr(port_build, "SOURCE", broken)
    monkeypatch.setattr(port_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(port_build, "_LIBRARY", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on octree.cpp"):
        TorchTree(1.0, [0], [1, 2])
    monkeypatch.setattr(port_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        TorchTree.build_from_samples(bench_cloud(), 3, 2)


# ---------------------------------------------------------------------------
# mesh sampling
# ---------------------------------------------------------------------------

def test_mesh_sampling_matches_jax():
    np.testing.assert_array_equal(port_mesh.van_der_corput(100),
                                  jax_mesh.van_der_corput(100))
    np.testing.assert_array_equal(port_mesh.van_der_corput(17, base=2),
                                  jax_mesh.van_der_corput(17, base=2))
    counts = np.array([64, 0, 33, 5])
    np.testing.assert_array_equal(port_mesh.sample_regular_barys(counts),
                                  jax_mesh.sample_regular_barys(counts))

    rng = np.random.default_rng(2)
    verts = rng.normal(0, 1, (12, 3)).astype(np.float32)
    triangles = rng.integers(0, 12, (20, 3))
    uvs = rng.uniform(0, 1, (12, 2)).astype(np.float32)
    ours = port_mesh.sample_barycentric_point_cloud(
        verts, triangles, uvs, 500, np.random.default_rng(4))
    ref = jax_mesh.sample_barycentric_point_cloud(
        verts, triangles, uvs, 500, np.random.default_rng(4))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)

    for up in ([0, 1, 0], [0, -1, 0], [1, 0, 0], [0.3, 0.2, -0.9]):
        up = np.asarray(up, np.float64) / np.linalg.norm(up)
        np.testing.assert_array_equal(
            port_mesh._align_vectors(up, np.array([0.0, 1.0, 0.0])),
            jax_mesh._align_vectors(up, np.array([0.0, 1.0, 0.0])))
        np.testing.assert_array_equal(port_mesh.normalize_points(verts, up),
                                      jax_mesh.normalize_points(verts, up))

    texture = rng.integers(0, 256, (9, 7, 4), dtype=np.uint8)
    np.testing.assert_allclose(
        port_mesh.interpolate_bilinear(texture, ours[1]),
        np.asarray(interpolate_bilinear(texture, ours[1])), rtol=1e-6,
        atol=1e-4)


def test_build_from_mesh_names_trimesh(tmp_path):
    """Neither this package's test machine nor the card's has trimesh:
    the mesh path and its CLI fail with an error naming it."""
    with pytest.raises(ImportError, match="trimesh"):
        TorchTree.build_from_mesh(str(tmp_path / "mesh.obj"), 6, 4)
    with pytest.raises(ImportError, match="trimesh"):
        port_mesh_cli.main([str(tmp_path / "mesh.obj"),
                            str(tmp_path / "tree.npz")])
    assert not (tmp_path / "tree.npz").exists()


# ---------------------------------------------------------------------------
# samplers on a tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nerf():
    model = NeRF(**CONFIG)
    params = model.init(jax.random.PRNGKey(4))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    return model, params, params_from_jax(TorchNeRF(**CONFIG), flat)


@pytest.fixture(scope="module")
def rig():
    return orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]), 3,
                 40.0, Resolution(16, 16), 4.0)


@pytest.fixture(scope="module")
def bench_trees():
    return (TorchTree.build_from_samples(bench_cloud(), 6, 2),
            OcTree.build_from_samples(bench_cloud(), 6, 2))


@pytest.mark.parametrize("resolution, dilate", [(64, 1), (32, 0), (16, 2)])
def test_occupancy_grid_from_tree_matches_jax(bench_trees, resolution,
                                              dilate):
    ours, ref = bench_trees
    grid = torch_grid_from_tree(ours, resolution, dilate)
    expected = occupancy_grid_from_tree(ref, resolution, dilate)
    np.testing.assert_array_equal(grid, expected)
    assert 0.0 < expected.mean() < 1.0


def _occupancy_from_tree(bench_trees, rig, num_samples=12):
    ours, ref = bench_trees
    return (TorchOccupancy.from_tree(ours, rig, num_samples, bounds=BOUNDS),
            OccupancyGridSampler(ref, rig, num_samples, bounds=BOUNDS))


def test_occupancy_from_tree_samples_match_jax(bench_trees, rig):
    port_sampler, jax_sampler = _occupancy_from_tree(bench_trees, rig)
    assert (port_sampler.empty_weight == jax_sampler.empty_weight == 1e-2
            and port_sampler.num_probes == jax_sampler.num_probes == 32)
    assert port_sampler._grid_scale == jax_sampler._grid_scale
    offsets = np.arange(256)
    geometry = jax_sampler.camera_ray_geometry(
        jnp.int32(1), jnp.asarray(offsets, jnp.int32))
    _, _, ref_hit = jax_sampler._probe_cdf_geometry(*geometry[:4])
    ours = [torch.from_numpy(np.array(g)) for g in geometry[:4]]
    _, _, hit = port_sampler._probe_cdf_geometry(*ours)
    np.testing.assert_array_equal(gather_hit(port_sampler, *ours).numpy(),
                                  np.asarray(ref_hit))
    assert np.asarray(ref_hit).any() and not np.asarray(ref_hit).all()
    bound = face_bound(port_sampler, *ours).numpy()
    assert (hit.numpy() >= np.asarray(ref_hit)).all()
    np.testing.assert_array_equal(hit.numpy()[~bound],
                                  np.asarray(ref_hit)[~bound])
    ref, _ = jax_sampler.sample_camera_rays(jnp.int32(1),
                                            jnp.asarray(offsets, jnp.int32))
    ours, _ = port_sampler.sample_camera_rays(1, torch.from_numpy(offsets))
    np.testing.assert_allclose(ours.t_values.numpy(),
                               np.asarray(ref.t_values), rtol=0, atol=1e-5)


def _assert_frames_close(ours, ref):
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("mode", ["occupancy", "traversal"])
def test_tree_frames_match_jax(nerf, bench_trees, rig, mode):
    model, params, port = nerf
    if mode == "occupancy":
        port_sampler, jax_sampler = _occupancy_from_tree(bench_trees, rig)
    else:
        port_sampler = TorchOctreeSampler(bench_trees[0], rig, 12,
                                          bounds=BOUNDS)
        jax_sampler = OctreeRaySampler(bench_trees[1], rig, 12,
                                       bounds=BOUNDS)
    ref = Raycaster(model).render_frame(params, jax_sampler, 2,
                                        chunk_size=96)
    ours = TorchRaycaster(port).render_frame(port_sampler, 2, chunk_size=96)
    _assert_frames_close(ours, ref)
    assert ref.any()


def test_octree_sampler_samples_match_jax(bench_trees, rig, monkeypatch):
    """Deterministic and stratified samples (the same uniforms injected
    into both samplers), clamped into near/far."""
    import fourier_feature_nets_torch.render.octree_sampler as port_module
    import fourier_feature_nets_tpu.render.octree_sampler as jax_module
    port_sampler = TorchOctreeSampler(bench_trees[0], rig, 12,
                                      bounds=BOUNDS, stratified=True)
    jax_sampler = OctreeRaySampler(bench_trees[1], rig, 12, bounds=BOUNDS,
                                   stratified=True)
    assert port_sampler.max_length == jax_sampler.max_length == 64
    assert port_sampler.empty_weight == jax_sampler.empty_weight == 1e-3
    offsets = np.arange(0, 256, 2)
    ref, ref_valid = jax_sampler.sample_camera_rays(
        jnp.int32(0), jnp.asarray(offsets, jnp.int32))
    ours, valid = port_sampler.sample_camera_rays(0,
                                                  torch.from_numpy(offsets))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_allclose(ours.t_values.numpy(),
                               np.asarray(ref.t_values), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours.positions.numpy(),
                               np.asarray(ref.positions), rtol=0, atol=1e-5)

    jitter = np.random.default_rng(6).uniform(
        0, 1, (len(offsets), 12)).astype(np.float32)
    monkeypatch.setattr(jax_module, "per_ray_uniform",
                        lambda *args, **kwargs: jnp.asarray(jitter))
    monkeypatch.setattr(port_module, "per_ray_uniform",
                        lambda *args, **kwargs: torch.from_numpy(jitter))
    idx = port_sampler.to_valid(np.arange(len(port_sampler)))[:len(offsets)]
    ref = jax_sampler.sample(jnp.asarray(idx), None, jax.random.PRNGKey(0))
    ours = port_sampler.sample(torch.from_numpy(idx), None, 0)
    np.testing.assert_allclose(ours.t_values.numpy(),
                               np.asarray(ref.t_values), rtol=0, atol=1e-5)
    near = port_sampler.ray_tables.near[idx]
    far = port_sampler.ray_tables.far[idx]
    assert (ours.t_values >= near[:, None]).all()
    assert (ours.t_values <= far[:, None]).all()
