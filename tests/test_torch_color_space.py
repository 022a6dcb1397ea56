"""YCrCb in the port against OpenCV and the JAX package: the NumPy
conversions (:mod:`fourier_feature_nets_torch.utils.color`) equal
``cv2.cvtColor``'s uint8 ``COLOR_RGB2YCrCb`` / ``COLOR_YCrCb2RGB`` bit
for bit, and a YCrCb dataset's colors, pools, loss (rel 1e-6) and
images, the sampler's ``to_image`` and a YCrCb frame match the JAX
package's, which converts with OpenCV."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fourier_feature_nets_torch.datasets import ImageDataset as TorchDataset
from fourier_feature_nets_torch.render import RenderResult
from fourier_feature_nets_torch.utils.color import rgb_to_ycrcb, ycrcb_to_rgb
from fourier_feature_nets_tpu.datasets import ImageDataset
from fourier_feature_nets_tpu.datasets.ray_dataset import (
    RenderResult as JaxRenderResult,
)
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
)

cv2 = pytest.importorskip("cv2")

CONVERSIONS = [(rgb_to_ycrcb, cv2.COLOR_RGB2YCrCb),
               (ycrcb_to_rgb, cv2.COLOR_YCrCb2RGB)]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The JAX package's synthetic scene at 24 px (3/1/1 cameras)."""
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    return generate_synthetic_dataset(path, resolution=24,
                                      split_counts=(3, 1, 1),
                                      volume_side=16, num_samples=64)


@pytest.mark.parametrize("ours, code", CONVERSIONS,
                         ids=["rgb2ycrcb", "ycrcb2rgb"])
def test_random_pixels_bit_equal_to_cv2(ours, code):
    image = np.random.default_rng(0).integers(0, 256, (1024, 1024, 3),
                                              dtype=np.uint8)
    np.testing.assert_array_equal(ours(image), cv2.cvtColor(image, code))


@pytest.mark.parametrize("ours, code", CONVERSIONS,
                         ids=["rgb2ycrcb", "ycrcb2rgb"])
def test_extremes_bit_equal_to_cv2(ours, code):
    """Every pixel whose channels come from {0, 1, 127, 128, 129, 254,
    255}: the corners of the cube, the rounding midpoint and the clamps."""
    levels = np.array([0, 1, 127, 128, 129, 254, 255], np.uint8)
    image = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"),
                     -1).reshape(1, -1, 3)
    np.testing.assert_array_equal(ours(image), cv2.cvtColor(image, code))
    # one image dimension fewer: a row of pixels
    np.testing.assert_array_equal(ours(image[0]),
                                  cv2.cvtColor(image, code)[0])


def test_rejects_non_uint8():
    with pytest.raises(ValueError, match="uint8"):
        rgb_to_ycrcb(np.zeros((2, 2, 3), np.float32))


def test_ycrcb_dataset_matches_jax(scene):
    ref = ImageDataset.load(scene, "train", 16, color_space="YCrCb")
    ours = TorchDataset.load(scene, "train", 16, color_space="YCrCb")
    assert ours.color_space == ref.color_space == "YCrCb"
    np.testing.assert_array_equal(ours.colors.numpy(), np.asarray(ref.colors))
    np.testing.assert_array_equal(ours.alphas.numpy(), np.asarray(ref.alphas))
    for mode in ("Full", "Center", "Dilate"):
        np.testing.assert_array_equal(
            ours.index_pool(TorchDataset.Mode[mode]),
            ref.index_pool(ImageDataset.Mode[mode]))
    rgb = TorchDataset.load(scene, "train", 16)
    assert not np.array_equal(ours.colors.numpy(), rgb.colors.numpy())

    rng = np.random.default_rng(5)
    idx = ref.index_pool()[:200]
    color = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, 200).astype(np.float32)
    expected = float(ref.loss(jnp.asarray(idx), JaxRenderResult(
        jnp.asarray(color), jnp.asarray(alpha), None)))
    got = float(ours.loss(torch.from_numpy(idx), RenderResult(
        torch.from_numpy(color), torch.from_numpy(alpha), None)))
    assert got == pytest.approx(expected, rel=1e-6)


def test_ycrcb_images_match_jax(scene):
    """The dataset's and the sampler's ``to_image`` of the same YCrCb
    colors: RGB uint8 images equal to JAX's."""
    ref = ImageDataset.load(scene, "val", 16, color_space="YCrCb")
    ours = TorchDataset.load(scene, "val", 16, color_space="YCrCb")
    valid = ours.index_for_camera(0)
    np.testing.assert_array_equal(valid, ref.index_for_camera(0))
    colors = np.asarray(ref.colors)[valid]
    np.testing.assert_array_equal(ours.to_image(0, colors),
                                  ref.to_image(0, colors))
    np.testing.assert_array_equal(
        ours.sampler.to_image(0, colors, "YCrCb"),
        ref.sampler.to_image(0, colors, "YCrCb"))
    # the round trip through YCrCb lands within OpenCV's own error
    image = ref.images[0][..., :3].reshape(-1, 3)[valid]
    back = ours.to_image(0, colors).reshape(-1, 3)[valid]
    assert np.abs(back.astype(int) - image.astype(int)).max() <= 3


def test_ycrcb_frame_matches_jax():
    """``render_frame(color_space="YCrCb")`` converts a frame of a model
    trained on YCrCb colors to RGB, as the JAX renderer does: equal to
    the port's RGB frame converted, and within 2 of JAX's (the frames
    are within +-1 before the conversion, whose fixed-point products can
    widen a one-level gap by one)."""
    import jax
    from fourier_feature_nets_torch.models import NeRF as TorchNeRF
    from fourier_feature_nets_torch.models import params_from_jax
    from fourier_feature_nets_torch.render import Raycaster as TorchRaycaster
    from fourier_feature_nets_torch.render import RaySampler as TorchSampler
    from fourier_feature_nets_tpu.cameras import Resolution
    from fourier_feature_nets_tpu.models import NeRF
    from fourier_feature_nets_tpu.models.serialization import _flatten
    from fourier_feature_nets_tpu.render import Raycaster, RaySampler
    from fourier_feature_nets_tpu.utils.camera_paths import orbit

    config = dict(num_layers=2, num_channels=32, max_log_scale_pos=4.0,
                  num_freq_pos=5, max_log_scale_view=2.0, num_freq_view=3,
                  skips=[], include_inputs=True)
    model = NeRF(**config)
    params = model.init(jax.random.PRNGKey(4))
    port = params_from_jax(TorchNeRF(**config), {
        k: np.asarray(v) for k, v in _flatten(params).items()})
    cameras = orbit(np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]), 2,
                    40.0, Resolution(16, 16), 3.0)
    bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    caster = TorchRaycaster(port)
    sampler = TorchSampler(bounds, cameras, 8)
    ours = caster.render_frame(sampler, 1, color_space="YCrCb")
    np.testing.assert_array_equal(
        ours, ycrcb_to_rgb(caster.render_frame(sampler, 1)))
    ref = Raycaster(model).render_frame(params, RaySampler(bounds, cameras, 8),
                                        1, color_space="YCrCb")
    assert ours.shape == ref.shape == (16, 16, 3)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 2
