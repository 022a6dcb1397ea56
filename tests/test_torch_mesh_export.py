"""Mesh export in the port against the JAX package (mirrors
tests/test_mesh_export.py): surface nets and the OBJ writer (NumPy
copies: the JAX package's output exactly), ``mesh_from_model`` on a
voxel ball (vertices within 1e-5 of JAX's, the same triangles; a NeRF
through its zero-view query; the batched sweep equal to one batch) and
the CLI with ``--device cpu``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fourier_feature_nets_tpu.mesh_export as jax_mesh
from fourier_feature_nets_torch import models as port_models
from fourier_feature_nets_torch.cli.export_mesh import _parse_args
from fourier_feature_nets_torch.cli.export_mesh import main as port_cli
from fourier_feature_nets_torch.mesh_export import (
    alpha_field,
    export_obj,
    mesh_from_model,
    surface_nets,
)
from fourier_feature_nets_tpu.models import NeRF, Voxels, save_model
from ffn_parity import flat


def _sphere_field(resolution, radius):
    c = np.linspace(-1, 1, resolution, dtype=np.float32)
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    return radius - np.sqrt(x * x + y * y + z * z)


def _ellipsoid_field(resolution=48):
    c = np.linspace(-1, 1, resolution, dtype=np.float32)
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    return 1 - np.sqrt((x / 0.7) ** 2 + (y / 0.5) ** 2 + (z / 0.3) ** 2)


class TestSurfaceNets:
    def test_sphere_watertight_and_accurate(self):
        radius, resolution = 0.6, 48
        vertices, triangles = surface_nets(
            _sphere_field(resolution, radius), 0.0, origin=-1.0)
        assert len(vertices) > 500 and len(triangles) > 1000
        h = 2.0 / (resolution - 1)
        radii = np.linalg.norm(vertices, axis=1)
        assert np.abs(radii - radius).max() < h, radii
        edges = np.sort(np.stack([triangles[:, [0, 1]],
                                  triangles[:, [1, 2]],
                                  triangles[:, [2, 0]]]).reshape(-1, 2),
                        axis=1)
        unique_edges, counts = np.unique(edges, axis=0, return_counts=True)
        assert (counts == 2).all()
        assert len(vertices) - len(unique_edges) + len(triangles) == 2

    def test_outward_winding(self):
        vertices, triangles = surface_nets(_sphere_field(48, 0.6), 0.0,
                                           origin=-1.0)
        p0, p1, p2 = (vertices[triangles[:, i]] for i in range(3))
        normals = np.cross(p1 - p0, p2 - p0)
        centers = (p0 + p1 + p2) / 3
        assert (np.einsum("ij,ij->i", normals, centers) > 0).all()

    def test_anisotropic_axis_mapping(self):
        vertices, _ = surface_nets(_ellipsoid_field(), 0.0, origin=-1.0)
        np.testing.assert_allclose(np.abs(vertices).max(0), [0.7, 0.5, 0.3],
                                   atol=0.06)

    def test_empty_field(self):
        vertices, triangles = surface_nets(-np.ones((8, 8, 8), np.float32),
                                           0.0)
        assert len(vertices) == 0 and len(triangles) == 0


@pytest.mark.parametrize("field", ["sphere", "ellipsoid", "noise"])
def test_surface_nets_equal_jax(field):
    fields = {"sphere": lambda: _sphere_field(40, 0.55),
              "ellipsoid": _ellipsoid_field,
              "noise": lambda: np.random.default_rng(2).normal(
                  size=(14, 14, 14)).astype(np.float32)}
    values = fields[field]()
    ours = surface_nets(values, 0.1, origin=-0.8, spacing=0.05)
    ref = jax_mesh.surface_nets(values, 0.1, origin=-0.8, spacing=0.05)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("colors", [True, False])
def test_export_obj_equals_jax(colors, tmp_path):
    vertices, triangles = surface_nets(_sphere_field(16, 0.5), 0.0)
    rgb = (np.random.default_rng(0).uniform(-0.2, 1.2, (len(vertices), 3))
           if colors else None)
    export_obj(str(tmp_path / "port.obj"), vertices, triangles, rgb)
    jax_mesh.export_obj(str(tmp_path / "jax.obj"), vertices, triangles, rgb)
    ours = open(tmp_path / "port.obj").read().splitlines()
    ref = open(tmp_path / "jax.obj").read().splitlines()
    # the header comment names the package; every record is the same
    assert ours[0].startswith("#") and ref[0].startswith("#")
    assert ours[1:] == ref[1:]


def _ball_voxels_model():
    """A Voxels field: an opaque red ball of radius 0.5, JAX's and the
    port's."""
    side = 24
    model = Voxels(side=side, scale=1.0)
    c = (np.arange(side) + 0.5) / side * 2 - 1
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    inside = (x * x + y * y + z * z) < 0.5 ** 2
    voxels = np.zeros((side, side, side, 4), np.float32)
    voxels[..., 0] = 15.0
    voxels[..., 1:3] = -15.0
    voxels[..., 3] = np.where(inside, 200.0, -200.0)
    params = {"voxels": jnp.asarray(voxels),
              "bias": jnp.zeros(4, jnp.float32)}
    port = port_models.build_model("voxels", model.params_manifest)
    return model, params, port_models.params_from_jax(port, flat(params))


def test_mesh_from_model_ball():
    _, _, port = _ball_voxels_model()
    vertices, triangles, colors = mesh_from_model(
        port, resolution=48, scale=1.0, alpha_threshold=0.5)
    assert len(vertices) > 200 and len(triangles) > 400
    radii = np.linalg.norm(vertices, axis=1)
    assert 0.35 < radii.min() and radii.max() < 0.65, (radii.min(),
                                                       radii.max())
    assert colors.shape == (len(vertices), 3)
    assert (colors[:, 0] > 0.8).mean() > 0.9
    assert (colors[:, 1] < 0.2).all()


def test_mesh_from_model_ball_matches_jax():
    model, params, port = _ball_voxels_model()
    ref = jax_mesh.mesh_from_model(model, params, resolution=40, scale=1.0,
                                   alpha_threshold=0.5)
    ours = mesh_from_model(port, resolution=40, scale=1.0,
                           alpha_threshold=0.5)
    np.testing.assert_allclose(ours[0], ref[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_allclose(ours[2], np.asarray(ref[2]), rtol=0,
                               atol=1e-5)


def test_mesh_from_a_nerf_matches_jax():
    """A NeRF takes zero view directions, in the field sweep and for the
    vertex colors."""
    config = dict(num_layers=2, num_channels=32, max_log_scale_pos=3.0,
                  num_freq_pos=4, max_log_scale_view=2.0, num_freq_view=2,
                  skips=[1], include_inputs=True)
    model = NeRF(**config)
    params = dict(model.init(jax.random.PRNGKey(5)))
    # a steep density, so that the grid holds a surface at alpha 0.3
    params["opacity_out"] = {
        "bias": params["opacity_out"]["bias"] + 5.0,
        "weight": params["opacity_out"]["weight"] * 100.0}
    port = port_models.params_from_jax(port_models.NeRF(**config),
                                       flat(params))
    ref = jax_mesh.mesh_from_model(model, params, resolution=20,
                                   alpha_threshold=0.3)
    ours = mesh_from_model(port, resolution=20, alpha_threshold=0.3)
    assert len(ref[0]) > 50
    np.testing.assert_allclose(ours[0], ref[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_allclose(ours[2], np.asarray(ref[2]), rtol=0,
                               atol=1e-5)


def test_sweep_batches_equal_one_batch():
    _, _, port = _ball_voxels_model()
    whole = alpha_field(port, 24, 1.0, batch=24 ** 3)
    np.testing.assert_array_equal(alpha_field(port, 24, 1.0, batch=1000),
                                  whole)
    assert whole.shape == (24, 24, 24) and 0 < whole.mean() < 1


def test_export_obj_and_cli(tmp_path):
    model, params, _ = _ball_voxels_model()
    ckpt = str(tmp_path / "ball.npz")
    save_model(model, params, ckpt)
    out = str(tmp_path / "ball.obj")
    assert port_cli([ckpt, out, "--device", "cpu", "--resolution", "32"]) == 0
    verts = faces = 0
    with open(out) as obj:
        for line in obj:
            if line.startswith("v "):
                verts += 1
                assert len(line.split()) == 7
            elif line.startswith("f "):
                faces += 1
                idx = [int(tok) for tok in line.split()[1:]]
                assert all(1 <= i <= verts for i in idx)
    assert verts > 100 and faces > 200
    assert port_cli([ckpt, str(tmp_path / "none.obj"), "--device", "cpu",
                     "--resolution", "16", "--alpha-threshold", "2.0"]) == 1
    assert not os.path.exists(tmp_path / "none.obj")


def test_cli_defaults_match_jax_and_cuda():
    args = _parse_args(["m.npz", "o.obj"])
    assert args.device == "cuda"
    assert (args.resolution, args.scale, args.alpha_threshold) == (192, 1.0,
                                                                   0.5)
