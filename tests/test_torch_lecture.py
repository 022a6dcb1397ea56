"""The port's lecture figures and animations (``lecture/``) against the
JAX package's, on the CPU.

Held: ``fourier1d_figure``'s TSV within rtol 1e-5; every figure and
animation writes JAX's file names, frame counts and image sizes; frames
drawn from the same numbers by the same matplotlib calls agree within a
mean |difference| of 0.5 levels (the volume raycasting frames draw
each package's renders, which agree within 1); the Gaussian encoding
figure drawn from JAX's matrix equals JAX's figure; the MP4s are read
back by ``cv2.VideoCapture`` with every frame; ``view_angle_animation``
chooses the same cameras and places the same patch as JAX's, its frames
equal off a 2-pixel band around each drawn segment; each matplotlib
entry point raises naming matplotlib without it."""

import os
import sys

import cv2
import jax
import numpy as np
import pytest

import fourier_feature_nets_tpu as ffn
from fourier_feature_nets_torch.datasets import ImageDataset as TorchDataset
from fourier_feature_nets_torch.lecture import animations as port_anim
from fourier_feature_nets_torch.lecture import figures as port_figs
from fourier_feature_nets_torch.models import NeRF as TorchNeRF
from fourier_feature_nets_torch.models import params_from_jax
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
)
from fourier_feature_nets_tpu.lecture import animations as jax_anim
from fourier_feature_nets_tpu.lecture import figures as jax_figs
from fourier_feature_nets_tpu.models import NeRF
from fourier_feature_nets_tpu.models.serialization import _flatten

MEAN_DIFF = 0.5


def _listing(root):
    """{relative path: image shape or None} of every file under root."""
    out = {}
    for folder, _, names in os.walk(root):
        for name in names:
            path = os.path.join(folder, name)
            rel = os.path.relpath(path, root)
            out[rel] = (cv2.imread(path).shape if name.endswith(".png")
                        else None)
    return out


def _mean_diff(a, b) -> float:
    return float(np.abs(cv2.imread(a).astype(float)
                        - cv2.imread(b).astype(float)).mean())


def _video_frames(path) -> int:
    capture = cv2.VideoCapture(path)
    count = 0
    while capture.read()[0]:
        count += 1
    capture.release()
    return count


def test_fourier1d_tsv_matches_jax(tmp_path):
    ours, ref = tmp_path / "port.tsv", tmp_path / "jax.tsv"
    port_figs.fourier1d_figure(tsv_path=str(ours))
    jax_figs.fourier1d_figure(tsv_path=str(ref))
    ours_rows = ours.read_text().splitlines()
    ref_rows = ref.read_text().splitlines()
    assert ours_rows[0] == ref_rows[0] and len(ours_rows) == len(ref_rows)
    np.testing.assert_allclose(np.loadtxt(ours, skiprows=1),
                               np.loadtxt(ref, skiprows=1), rtol=1e-5)


def test_save_all_figures_matches_jax(tmp_path):
    """The same files at the same sizes; the figures of the same numbers
    (spectra, the 1-D decomposition) within the mean limit. The
    spectral-bias curves come from each package's own training, the
    Gaussian matrix from each package's generator."""
    port_figs.save_all_figures(str(tmp_path / "port"), device="cpu")
    jax_figs.save_all_figures(str(tmp_path / "jax"))
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    for name in ("signal_multifreq.png", "signal_sawtooth.png",
                 "fourier1d.png", "fourier2d.png"):
        assert _mean_diff(str(tmp_path / "port" / name),
                          str(tmp_path / "jax" / name)) <= MEAN_DIFF, name


def test_encoding_figure_with_jax_matrix_equals_jax(tmp_path, monkeypatch):
    """The port draws its Gaussian matrix from a ``torch.Generator``;
    with JAX's matrix carried across the figure is JAX's."""
    from fourier_feature_nets_tpu.ops.encoding import (
        gaussian_encoding_matrix,
    )
    matrix = np.asarray(gaussian_encoding_matrix(jax.random.PRNGKey(0),
                                                 10.0, 2, 64))
    monkeypatch.setattr(port_figs, "gaussian_encoding_matrix",
                        lambda generator, sigma, inputs, size: matrix)
    port_figs.encoding_matrix_figure().savefig(tmp_path / "port.png",
                                               dpi=60)
    jax_figs.encoding_matrix_figure().savefig(tmp_path / "jax.png", dpi=60)
    assert _mean_diff(str(tmp_path / "port.png"),
                      str(tmp_path / "jax.png")) <= MEAN_DIFF


def test_save_all_animations_matches_jax(tmp_path):
    port_anim.save_all_animations(str(tmp_path / "port"), num_frames=3,
                                  device="cpu")
    jax_anim.save_all_animations(str(tmp_path / "jax"), num_frames=3)
    listing = _listing(tmp_path / "port")
    assert listing == _listing(tmp_path / "jax")
    videos = [name for name in listing if name.endswith(".mp4")]
    assert len(videos) == 5
    for name in videos:
        assert _video_frames(str(tmp_path / "port" / name)) == 3
    for name, shape in listing.items():
        if shape is not None:
            assert _mean_diff(str(tmp_path / "port" / name),
                              str(tmp_path / "jax" / name)) <= MEAN_DIFF, name


def test_voxels_animation_matches_jax(tmp_path):
    from fourier_feature_nets_torch.octree import OcTree as TorchTree
    from fourier_feature_nets_tpu.octree import OcTree
    rng = np.random.default_rng(1)
    cloud = np.concatenate([rng.normal([0.2, 0.0, 0.0], 0.2, (4000, 3)),
                            [[-1, -1, -1], [1, 1, 1]]]).astype(np.float32)
    port_anim.voxels_animation(TorchTree.build_from_samples(cloud, 5, 2),
                               str(tmp_path / "port"), min_depth=3,
                               num_frames=3)
    jax_anim.voxels_animation(OcTree.build_from_samples(cloud, 5, 2),
                              str(tmp_path / "jax"), min_depth=3,
                              num_frames=3)
    listing = _listing(tmp_path / "port")
    assert listing == _listing(tmp_path / "jax")
    for name, shape in listing.items():
        if shape is not None:
            assert _mean_diff(str(tmp_path / "port" / name),
                              str(tmp_path / "jax" / name)) <= MEAN_DIFF


@pytest.fixture(scope="module")
def view_setup(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("view") / "scene.npz")
    generate_synthetic_dataset(path, resolution=40, split_counts=(16, 1, 1),
                               volume_side=16, num_samples=64)
    config = dict(num_layers=2, num_channels=32, max_log_scale_pos=3.0,
                  num_freq_pos=4, max_log_scale_view=1.0, num_freq_view=2,
                  skips=[1], include_inputs=True)
    model = NeRF(**config)
    params = model.init(jax.random.PRNGKey(5))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    return path, model, params, params_from_jax(TorchNeRF(**config), flat)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_view_angle_animation_matches_jax(view_setup, tmp_path, fused):
    path, model, params, port = view_setup
    kwargs = dict(camera=1, angle_threshold=0.0, patch_size=8, zoom_size=16)
    jax_data = ffn.ImageDataset.load(path, "train", 16)
    port_data = TorchDataset.load(path, "train", 16)
    caster = TorchRaycaster(port, fused=fused)
    count = port_anim.view_angle_animation(port_data, caster,
                                           str(tmp_path / "port"), **kwargs)
    ref = jax_anim.view_angle_animation(jax_data, ffn.Raycaster(model),
                                        params, str(tmp_path / "jax"),
                                        **kwargs)
    assert count == ref >= 2
    listing = _listing(tmp_path / "port")
    assert listing == _listing(tmp_path / "jax")
    assert _video_frames(str(tmp_path / "port" / "view_angle.mp4")) == count

    # the patches JAX placed, from its own depth: a band of 2 pixels
    # around each of its drawn segments (thickness 2) is left out
    sampler = port_data.sampler
    width, height = sampler.image_width, sampler.image_height
    index = sampler.rays_per_camera + (height // 2) * width + width // 2
    rays = jax_data.sampler.sample(jax.numpy.asarray([index]), None, None)
    depth = float(ffn.Raycaster(model).render(params, rays, True).depth[0])
    position = (np.asarray(jax_data.sampler.starts[index])
                + np.asarray(jax_data.sampler.directions[index]) * depth)
    source = port_data.cameras[1].position.reshape(-1)
    source = source / np.linalg.norm(source)
    frame = 0
    for camera in port_data.cameras:
        pos = camera.position.reshape(-1)
        if float((source * pos / np.linalg.norm(pos)).sum()) < 0.0:
            continue
        u, v = camera.project(position[None])[0]
        c, r = int(u) - 4, int(v) - 4
        if not (0 <= r <= height - 8 and 0 <= c <= width - 8):
            continue
        band = np.zeros((height, 2 * width), np.uint8)
        zoom_row, zoom_col = (height - 16) // 2, width + (width - 16) // 2
        port_anim.draw_rectangle(band, (c, r), (c + 8, r + 8), 1, 6)
        port_anim.draw_rectangle(band, (zoom_col, zoom_row),
                                 (zoom_col + 16, zoom_row + 16), 1, 6)
        port_anim.draw_segment(band, (c + 8, r), (zoom_col, zoom_row), 1, 6)
        port_anim.draw_segment(band, (c + 8, r + 8),
                               (zoom_col, zoom_row + 16), 1, 6)
        name = os.path.join("view_angle", f"frame_{frame:04d}.png")
        ours = cv2.imread(str(tmp_path / "port" / name))
        theirs = cv2.imread(str(tmp_path / "jax" / name))
        off_band = band == 0
        np.testing.assert_array_equal(ours[off_band], theirs[off_band])
        # the drawn segments are white in both
        assert (ours[band > 0] == 255).all(-1).mean() > 0.4
        frame += 1
    assert frame == count


@pytest.mark.parametrize("call", [
    lambda out: port_figs.signal_spectrum_figure(np.sin),
    lambda out: port_figs.encoding_matrix_figure(),
    lambda out: port_figs.spectral_bias_figure(num_steps=1, device="cpu"),
    lambda out: port_figs.fourier1d_figure(),
    lambda out: port_figs.fourier2d_figure(np.zeros((8, 8))),
    lambda out: port_figs.save_all_figures(out, device="cpu"),
    lambda out: port_anim.camera_to_world_animation(out, 1),
    lambda out: port_anim.world_to_camera_animation(out, 1),
    lambda out: port_anim.ray_cube_intersection_animation(out, 1),
    lambda out: port_anim.rendering_equation_animation(out, 1),
    lambda out: port_anim.volume_raycasting_animation(out, 1, 8, "cpu"),
    lambda out: port_anim.voxels_animation(None, out),
    lambda out: port_anim.save_all_animations(out, 1, "cpu"),
])
def test_matplotlib_paths_name_matplotlib(monkeypatch, tmp_path, call):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ModuleNotFoundError, match="matplotlib"):
        call(str(tmp_path))
