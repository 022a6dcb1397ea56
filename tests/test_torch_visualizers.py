"""The orbit-video and comparison visualizers of the port against the JAX
package's, and ``--make-video`` of the three NeRF-field trainers.

The same weights (a 2x32 NeRF, a random voxel grid) render through each
package's visualizer under the same step sequences: the files have the
same names and cadence, and each image is within 1 of JAX's in uint8
(the JAX package writes its PNGs with OpenCV, the port with its own
writer; both are read back with the port's reader). The trainers run
with ``--make-video --device cpu`` and write their ``video/`` frames at
the JAX visualizer's cadence.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fourier_feature_nets_tpu as ffn
from fourier_feature_nets_torch import models as port_models
from fourier_feature_nets_torch.datasets import ImageDataset as TorchDataset
from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
from fourier_feature_nets_torch.utils.png import read_png
from fourier_feature_nets_torch.visualizers import (
    ComparisonVisualizer,
    OrbitVideoVisualizer,
)
from fourier_feature_nets_tpu.cameras import Resolution
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
)
from ffn_parity import flat

pytest.importorskip("cv2")   # the JAX visualizers write with OpenCV

NERF = dict(num_layers=2, num_channels=32, max_log_scale_pos=4.0,
            num_freq_pos=5, max_log_scale_view=2.0, num_freq_view=3,
            skips=[1], include_inputs=True)
# (num_steps, num_frames, the steps fit reports to visualizers, the
# frames written): one step a call (an interval of 2), and chunks of 4
# (only each chunk's last step; each crosses an interval of 4 but the
# first)
CADENCES = {"one_step_a_call": (8, 3, list(range(9)), 5),
            "chunks_of_4": (16, 4, [3, 7, 11, 15, 16], 4)}


def _nerf():
    model = ffn.NeRF(**NERF)
    params = model.init(jax.random.PRNGKey(3))
    port = port_models.params_from_jax(port_models.NeRF(**NERF), flat(params))
    return model, params, port


def _voxels():
    model = ffn.Voxels(side=8, scale=1.0)
    rng = np.random.default_rng(4)
    params = {"voxels": jnp.asarray(rng.normal(
                  0.0, 2.0, (8, 8, 8, 4)).astype(np.float32)),
              "bias": jnp.asarray(rng.normal(size=4).astype(np.float32))}
    port = port_models.build_model("voxels", model.params_manifest)
    return model, params, port_models.params_from_jax(port, flat(params))


PAIRS = {"nerf": _nerf, "voxels": _voxels}


def _renders(pair):
    """Each package's ``render(samples, include_depth)``, as its fit
    passes it to the visualizers."""
    model, params, port = pair
    jax_caster, port_caster = ffn.Raycaster(model), TorchRaycaster(port)
    return (lambda s, d: jax_caster.batched_render(params, s, 16384, d),
            lambda s, d: port_caster.batched_render(s, 16384, d))


def _same_images(jax_dir, port_dir, count):
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    assert len(names) == count
    for name in names:
        ref = read_png(os.path.join(jax_dir, name))
        ours = read_png(os.path.join(port_dir, name))
        assert ours.shape == ref.shape and ours.dtype == np.uint8
        assert int(np.abs(ours.astype(int) - ref.astype(int)).max()) <= 1, \
            name
    return names


@pytest.mark.parametrize("cadence", sorted(CADENCES))
@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_orbit_video_frames_match_jax(kind, cadence, tmp_path):
    num_steps, num_frames, steps, count = CADENCES[cadence]
    jax_render, port_render = _renders(PAIRS[kind]())
    args = (num_steps, Resolution(12, 12), num_frames, 10, "RGB")
    ref = ffn.OrbitVideoVisualizer(str(tmp_path / "jax"), *args)
    ours = OrbitVideoVisualizer(str(tmp_path / "port"), *args, "cpu")
    for step in steps:
        ref.visualize(step, jax_render, None)
        ours.visualize(step, port_render, None)
    names = _same_images(str(tmp_path / "jax" / "video"),
                         str(tmp_path / "port" / "video"), count)
    frames = [read_png(str(tmp_path / "port" / "video" / n)) for n in names]
    assert any(f.min() != f.max() for f in frames)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    return generate_synthetic_dataset(path, resolution=12,
                                      split_counts=(2, 2, 1),
                                      volume_side=12, num_samples=48)


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_comparison_frames_match_jax(kind, scene, tmp_path):
    """Train and val strips (ground truth beside the prediction), one a
    camera, (H * cameras, 4 W, 3), within 1 of JAX's."""
    jax_render, port_render = _renders(PAIRS[kind]())
    datasets = {
        "jax": [ffn.ImageDataset.load(scene, split, 10)
                for split in ("train", "val")],
        "port": [TorchDataset.load(scene, split, 10)
                 for split in ("train", "val")]}
    ref = ffn.ComparisonVisualizer(str(tmp_path / "jax"), 4, 2,
                                   *datasets["jax"])
    ours = ComparisonVisualizer(str(tmp_path / "port"), 4, 2,
                                *datasets["port"], device="cpu")
    for step in range(5):
        ref.visualize(step, jax_render, None)
        ours.visualize(step, port_render, None)
    names = _same_images(str(tmp_path / "jax" / "compare"),
                         str(tmp_path / "port" / "compare"), 3)
    frame = read_png(str(tmp_path / "port" / "compare" / names[0]))
    assert frame.shape == (12 * 2, 12 * 4, 3)
    assert frame[:, :12].any() and frame[:, 12:24].any()


def test_comparison_needs_as_many_val_cameras(scene, tmp_path):
    train = TorchDataset.load(scene, "train", 10)
    test = TorchDataset.load(scene, "test", 10)
    with pytest.raises(ValueError, match="cameras"):
        ComparisonVisualizer(str(tmp_path), 4, 2, train, test)


# each trainer's positional arguments before the results directory, and
# its own flags (train_voxels has no crop curriculum)
TRAINERS = {
    "train_nerf": ([], ["--num-layers", "2", "--num-channels", "32",
                        "--fused", "--crop-steps", "0"]),
    "train_voxels": (["8"], []),
    "train_tiny_nerf": (["positional"], ["--num-channels", "32",
                                         "--embedding-size", "16",
                                         "--crop-steps", "0"]),
}


@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_trainers_make_video_on_cpu(trainer, scene, tmp_path):
    """``--make-video --device cpu``: the orbit frames in ``video/`` at
    the JAX visualizer's cadence (steps 0, 4 and 8 of 8 at 2 frames), at
    the train cameras' resolution, and no evaluation grids."""
    import importlib
    main = importlib.import_module(
        f"fourier_feature_nets_torch.cli.{trainer}").main
    positional, flags = TRAINERS[trainer]
    main([scene, *positional, str(tmp_path), "--device", "cpu",
          "--num-samples", "8", "--batch-size", "64", "--num-steps", "8",
          "--report-interval", "4", "--make-video", "--num-frames", "2",
          *flags])
    frames = sorted(os.listdir(tmp_path / "video"))
    assert frames == [f"frame_{i:05d}.png" for i in range(3)]
    for name in frames:
        assert read_png(str(tmp_path / "video" / name)).shape == (12, 12, 3)
    assert not os.path.exists(tmp_path / "train")


def test_make_video_visualizer_takes_the_run_device(scene, tmp_path):
    from argparse import Namespace

    from fourier_feature_nets_torch.cli.common import make_visualizers
    train = TorchDataset.load(scene, "train", 8)
    args = Namespace(make_video=True, results_dir=str(tmp_path),
                     num_steps=10, num_frames=2, num_samples=8,
                     color_space="RGB", device="cpu", image_interval=0)
    (vis,) = make_visualizers(args, train, None)
    assert isinstance(vis, OrbitVideoVisualizer)
    assert vis._sampler.device == torch.device("cpu")
    assert vis._sampler.num_samples == 8
