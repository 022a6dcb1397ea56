"""The port's regression data and CLIs against the JAX package's: the
PNG reader and the INTER_AREA resize against OpenCV, the procedural test
image, ``PixelDataset`` and ``SignalDataset``, one and five full-batch
image and signal steps against the JAX CLIs' step math, and the CLIs
(``train_image_regression``, ``train_signal_regression``,
``train_tiny_nerf``, ``convert_checkpoint``) end to end on the CPU."""

import os
import struct
import sys
import zlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourier_feature_nets_torch import models as port_models
from fourier_feature_nets_torch.cli import convert_checkpoint as port_convert
from fourier_feature_nets_torch.cli import train_image_regression as port_image
from fourier_feature_nets_torch.cli import train_signal_regression as port_signal
from fourier_feature_nets_torch.cli import train_tiny_nerf as port_tiny
from fourier_feature_nets_torch.datasets import PixelDataset, SignalDataset
from fourier_feature_nets_torch.datasets.synthetic import (
    generate_synthetic_image as port_synthetic_image,
)
from fourier_feature_nets_torch.utils.image import resize_area
from fourier_feature_nets_torch.utils.png import decode_png, read_png
from fourier_feature_nets_tpu import models as jax_models
from fourier_feature_nets_tpu.cli import (
    train_signal_regression as jax_signal_cli,
)
from fourier_feature_nets_tpu.datasets.pixel_dataset import (
    PixelDataset as JaxPixelDataset,
)
from fourier_feature_nets_tpu.datasets.signal_dataset import (
    SignalDataset as JaxSignalDataset,
)
from fourier_feature_nets_tpu.datasets.synthetic import (
    generate_synthetic_dataset,
    generate_synthetic_image as jax_synthetic_image,
)
from fourier_feature_nets_tpu.utils.optim import (
    adam_init,
    adam_update,
    exponential_lr,
)
from ffn_parity import flat

LOSS_RTOL = 1e-5
GRAD = dict(rtol=2e-3, atol=2e-4)


def _cv2():
    return pytest.importorskip("cv2")


def _test_image(shape, seed=0):
    """A smooth image with noise (so the PNG writer picks every row
    filter) of ``shape``: (H, W) or (H, W, C) uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]].astype(np.float32)
    base = 128 + 60 * np.sin(xx / 7) + 50 * np.cos(yy / 5)
    channels = shape[2] if len(shape) == 3 else 1
    planes = [base + rng.normal(0, 6, shape[:2]) + 30 * c
              for c in range(channels)]
    image = np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)
    return image.reshape(shape)


# ---------------------------------------------------------------------------
# PNG, resize, the test image
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 45), (37, 45, 3), (37, 45, 4),
                                   (96, 120, 3)])
def test_png_reader_decodes_cv2_pngs_exactly(shape, tmp_path):
    cv2 = _cv2()
    image = _test_image(shape)
    path = str(tmp_path / "image.png")
    assert cv2.imwrite(path, image)
    ours = read_png(path)
    if image.ndim == 2:
        expected = image[..., None]
    else:   # OpenCV's BGR(A) is stored as RGB(A)
        expected = image[..., [2, 1, 0, 3][:image.shape[2]]]
    assert ours.shape == expected.shape
    np.testing.assert_array_equal(ours, expected)


def _png_bytes(width, height, depth, color, interlace=0, body=b""):
    def chunk(kind, data):
        crc = zlib.crc32(kind + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", crc)
    header = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0,
                         interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("data, message", [
    (b"GIF89a....", "not a PNG"),
    (_png_bytes(2, 2, 8, 3), "palette"),
    (_png_bytes(2, 2, 8, 4), "grey \\+ alpha"),
    (_png_bytes(2, 2, 16, 2), "bit depth 16"),
    (_png_bytes(2, 2, 8, 2, interlace=1), "interlaced"),
], ids=["signature", "palette", "grey-alpha", "16-bit", "interlaced"])
def test_png_reader_names_what_it_does_not_read(data, message):
    with pytest.raises(ValueError, match=message):
        decode_png(data)


@pytest.mark.parametrize("size, target", [
    ((64, 64), (32, 32)), ((100, 100), (37, 37)), ((97, 97), (64, 64)),
    ((100, 80), (37, 41)), ((30, 30), (64, 64)), ((20, 20), (30, 30)),
    ((16, 16), (48, 48))],
    ids=["shrink-2x", "shrink-2.7x", "shrink-1.5x", "shrink-uneven",
         "enlarge-2.1x", "enlarge-1.5x", "enlarge-3x"])
@pytest.mark.parametrize("channels", [None, 3])
def test_area_resize_is_within_one_of_cv2(size, target, channels):
    cv2 = _cv2()
    shape = size if channels is None else size + (channels,)
    image = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    ref = cv2.resize(image, target[::-1], interpolation=cv2.INTER_AREA)
    ours = resize_area(image, target[1], target[0])
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    assert int(np.abs(ours.astype(int) - ref.astype(int)).max()) <= 1


def test_synthetic_image_equals_jax(tmp_path):
    """The port's PNG holds the JAX package's pixels bit for bit."""
    cv2 = _cv2()
    jax_path = jax_synthetic_image(str(tmp_path / "jax.png"), 48)
    port_path = port_synthetic_image(str(tmp_path / "port.png"), 48)
    np.testing.assert_array_equal(cv2.imread(port_path),
                                  cv2.imread(jax_path))
    assert read_png(port_path).shape == (48, 48, 3)


# ---------------------------------------------------------------------------
# the datasets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    """A 44 x 36 RGB PNG (not square: it is center-cropped)."""
    path = str(tmp_path_factory.mktemp("photo") / "photo.png")
    from fourier_feature_nets_torch.utils.png import write_png
    write_png(path, _test_image((44, 36, 3), seed=4))
    return path


@pytest.mark.parametrize("color_space", ["RGB", "YCrCb"])
@pytest.mark.parametrize("size", [36, 32, 24], ids=["crop", "shrink-1.1x",
                                                     "shrink-1.5x"])
def test_pixel_dataset_matches_jax(photo, color_space, size):
    """Crop, INTER_AREA resize (within one level), colour space and the
    UV grids against the JAX package's ``PixelDataset`` (OpenCV)."""
    _cv2()
    ref = JaxPixelDataset.create(photo, color_space, size)
    ours = PixelDataset.create(photo, color_space, size)
    for name in ("train_uv", "val_uv"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for name in ("train_color", "val_color"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1.01 / 255, rtol=0)
    assert int(np.abs(ours.image.astype(int)
                      - ref.image.astype(int)).max()) <= 2
    colors = np.random.default_rng(2).uniform(
        0, 1, (size, size, 3)).astype(np.float32)
    np.testing.assert_array_equal(ours.to_image(torch.from_numpy(colors)),
                                  ref.to_image(colors))


def test_pixel_dataset_psnr_and_act_image_match_jax(photo):
    _cv2()
    ref = JaxPixelDataset.create(photo, "RGB", 32)
    ours = PixelDataset.create(photo, "RGB", 32)
    model = jax_models.GaussianFourierMLP(2, 3, 10.0, num_layers=1,
                                          num_channels=64,
                                          embedding_size=16,
                                          rng=jax.random.PRNGKey(1))
    params = model.init(jax.random.PRNGKey(2))
    port = port_models.params_from_jax(
        port_models.build_model("fourier", model.params_manifest),
        flat(params))
    with torch.no_grad():
        out = torch.sigmoid(port(ours.val_uv))
    # the same prediction against each package's own (resized) pixels
    assert ours.psnr(out) == pytest.approx(
        ref.psnr(jnp.asarray(out.numpy())), abs=0.05)
    act = ours.to_act_image(port, 32)
    ref_act = ref.to_act_image(model, params, 32)
    assert act.shape == ref_act.shape == (32, 32, 3)
    assert int(np.abs(act.astype(int) - ref_act.astype(int)).max()) <= 1


def test_pixel_dataset_missing_file_and_color_space(tmp_path):
    with pytest.raises(FileNotFoundError):
        PixelDataset.create(str(tmp_path / "nope.png"), "RGB", 8)
    with pytest.raises(NotImplementedError, match="HSV"):
        PixelDataset.create(str(tmp_path / "nope.png"), "HSV", 8)


@pytest.mark.parametrize("signal", sorted(jax_signal_cli.SIGNALS))
def test_signal_dataset_matches_jax(signal):
    ref = JaxSignalDataset.create(jax_signal_cli.SIGNALS[signal], 16, 4)
    ours = SignalDataset.create(port_signal.SIGNALS[signal], 16, 4)
    for name in ("train_x", "train_y", "val_x", "val_y"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert ours.x_lim == pytest.approx(ref.x_lim)
    assert ours.y_lim == pytest.approx(ref.y_lim)


def test_signal_plot_names_matplotlib_when_missing(monkeypatch):
    from fourier_feature_nets_torch.datasets import signal_dataset
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ModuleNotFoundError, match="matplotlib"):
        signal_dataset.pyplot()


# ---------------------------------------------------------------------------
# the full-batch steps
# ---------------------------------------------------------------------------

def _assert_params_close(port, params):
    ref = flat(params)
    ours = port_models.params_to_jax(port)
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], err_msg=key, **GRAD)


@pytest.mark.parametrize("num_steps", [1, 5])
def test_image_steps_match_jax_cli_math(tmp_path, num_steps):
    """The CLI's step (sigmoid, 0.5 MSE, plain Adam at a decaying rate)
    from the same weights on a 32-px synthetic image: each loss within
    rtol 1e-5, the weights after the steps within the gradient bound."""
    _cv2()
    path = port_synthetic_image(str(tmp_path / "image.png"), 32)
    jax_data = JaxPixelDataset.create(path, "RGB", 32)
    data = PixelDataset.create(path, "RGB", 32)
    model = jax_models.PositionalFourierMLP(2, 3, 6.0, num_layers=2,
                                            num_channels=32,
                                            embedding_size=32)
    params = model.init(jax.random.PRNGKey(0))
    port = port_models.params_from_jax(
        port_models.build_model("fourier", model.params_manifest),
        flat(params))
    lr, rate, decay = 1e-3, 0.1, 3
    opt_state = adam_init(params)

    def loss_fn(p):
        output = jax.nn.sigmoid(model.apply(p, jax_data.train_uv))
        return 0.5 * jnp.mean(jnp.square(output - jax_data.train_color))

    step_fn = port_image.make_train_step(port, data, lr, rate, decay)
    for step in range(num_steps):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt_state = adam_update(
            grads, opt_state, params,
            exponential_lr(lr, jnp.asarray(step), rate, decay))
        assert float(step_fn(step)) == pytest.approx(float(loss),
                                                     rel=LOSS_RTOL)
    _assert_params_close(port, params)


@pytest.mark.parametrize("num_steps", [1, 5])
def test_signal_steps_match_jax_cli_math(num_steps):
    """The CLI's step (MSE, plain Adam with weight decay 1e-3) on
    ``multifreq`` with hand-built Fourier features, the last bias at the
    train mean, from the same weights."""
    data = SignalDataset.create(port_signal.multifreq, 32, 8)
    jax_data = JaxSignalDataset.create(jax_signal_cli.multifreq, 32, 8)
    args = SimpleNamespace(fourier=True, num_samples=32, num_channels=64,
                           num_layers=1, seed=5)
    port = port_signal.build_model(args, data)
    assert float(port.layers[-1].bias.detach()) == pytest.approx(
        float(jnp.mean(jax_data.train_y)), rel=1e-6)
    model = jax_models.FourierFeatureMLP(
        1, 1, port.a_values.numpy(), port.b_values.numpy(), [64])
    # jnp.array copies: an array made by jnp.asarray may share the
    # tensor's storage, which the port's Adam step then updates in place.
    params = {"layers": [
        {"weight": jnp.array(layer.weight.detach().numpy().T),
         "bias": jnp.array(layer.bias.detach().numpy())}
        for layer in port.layers]}
    opt_state = adam_init(params)

    def loss_fn(p):
        return jnp.mean(jnp.square(model.apply(p, jax_data.train_x)
                                   - jax_data.train_y))

    step_fn = port_signal.make_train_step(port, data)
    for _ in range(num_steps):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt_state = adam_update(grads, opt_state, params, 5e-4,
                                        weight_decay=1e-3)
        assert float(step_fn()) == pytest.approx(float(loss), rel=LOSS_RTOL)
    _assert_params_close(port, params)


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--activations", "--vertical"]],
                         ids=["plain", "activations"])
def test_image_regression_cli_on_cpu(tmp_path, monkeypatch, flags):
    monkeypatch.setenv("FFN_TORCH_DATA_DIR", str(tmp_path / "data"))
    out = str(tmp_path / "run")
    log = port_image.main(["synthetic:48", "gaussian", out, "--device",
                           "cpu", "--image-size", "16", "--num-steps", "4",
                           "--report-interval", "2", "--num-channels", "64",
                           "--embedding-size", "16", *flags])
    assert [step for step, _ in log] == [0, 2, 4]
    assert log[-1][1] > log[0][1]
    assert os.path.exists(tmp_path / "data" / "synthetic_image_48.png")
    names = sorted(os.listdir(out))
    assert names == ["log.txt", "model.npz", "superres.png", "val00000.png",
                     "val00002.png", "val00004.png"]
    assert read_png(os.path.join(out, "superres.png")).shape == (32, 32, 3)
    frame = read_png(os.path.join(out, "val00004.png")).shape
    assert frame == ((32, 16, 3) if flags else (16, 32, 3))
    model = port_models.load_model(os.path.join(out, "model.npz"))
    assert model.model_type == "fourier" and model.num_inputs == 2


@pytest.mark.parametrize("flags", [["--no-plot"], []],
                         ids=["no-plot", "plot"])
def test_signal_regression_cli_on_cpu(tmp_path, flags):
    if not flags:
        pytest.importorskip("matplotlib")
    out = str(tmp_path / "run")
    log = port_signal.main(["multifreq", out, "--device", "cpu",
                            "--fourier", "--num-steps", "60",
                            "--report-interval", "30", *flags])
    assert [entry.step for entry in log] == [0, 30, 60]
    assert log[-1].val_loss < log[0].val_loss
    expected = {"log.txt", "model.npz"} | (set() if flags else {"final.png"})
    assert set(os.listdir(out)) == expected


@pytest.mark.parametrize("main", [port_image.main, port_signal.main],
                         ids=["image", "signal"])
def test_regression_make_video_is_not_ported(tmp_path, main):
    argv = (["synthetic:8", "mlp", str(tmp_path)] if main is port_image.main
            else ["multifreq", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="Remaining models"):
        main(argv + ["--device", "cpu", "--make-video"])


def test_clis_default_to_cuda():
    assert port_image._parse_args(["i.png", "mlp", "o"]).device == "cuda"
    assert port_signal._parse_args(["multifreq", "o"]).device == "cuda"
    assert port_tiny._parse_args(["d", "mlp", "o"]).device == "cuda"


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "scene.npz")
    return generate_synthetic_dataset(path, resolution=16,
                                      split_counts=(3, 1, 1),
                                      volume_side=16, num_samples=64)


_TINY = ["--device", "cpu", "--num-samples", "8", "--batch-size", "64",
         "--image-interval", "0", "--report-interval", "4",
         "--crop-steps", "0", "--num-channels", "64", "--embedding-size",
         "12"]


@pytest.mark.parametrize("encoding", ["mlp", "basic", "positional",
                                      "gaussian"])
def test_train_tiny_nerf_cli_on_cpu(scene, tmp_path, encoding, capsys):
    out = str(tmp_path / "run")
    assert port_tiny.main([scene, encoding, out, "--num-steps", "4",
                           *_TINY]) == 0
    model = port_models.load_model(os.path.join(out, "tiny_nerf.npz"))
    assert type(model) is port_models.FourierFeatureMLP
    assert (model.num_inputs, model.num_outputs) == (3, 4)
    assert os.path.exists(os.path.join(out, "tiny_nerf_best.npz"))
    assert "train_tiny_nerf: " + encoding in capsys.readouterr().out


def test_train_tiny_nerf_activations_and_opacity_model(scene, tmp_path):
    """--make-activations writes the activation orbit; --opacity-model
    focus-samples with a voxels checkpoint (a model without views)."""
    voxels = str(tmp_path / "voxels.npz")
    port_models.save_model(port_models.Voxels(8, 1.0), voxels)
    out = str(tmp_path / "run")
    assert port_tiny.main([scene, "positional", out, "--num-steps", "4",
                           "--make-activations", "--num-frames", "2",
                           "--opacity-model", voxels, *_TINY]) == 0
    frames = sorted(os.listdir(os.path.join(out, "activations")))
    assert frames == ["frame_00000.png", "frame_00001.png",
                      "frame_00002.png"]
    grid = read_png(os.path.join(out, "activations", frames[-1]))
    assert grid.shape == (128, 128, 3)


@pytest.mark.parametrize("kind", ["fourier", "voxels"])
def test_convert_checkpoint_round_trip(tmp_path, kind):
    """NPZ -> .pt -> NPZ through the port's CLI keeps every weight bit
    for bit; the JAX CLI reads the port's .pt and the port reads the JAX
    CLI's."""
    from fourier_feature_nets_tpu.cli import (
        convert_checkpoint as jax_convert,
    )
    if kind == "fourier":
        model = jax_models.PositionalFourierMLP(3, 4, 5.5, num_layers=2,
                                                num_channels=16,
                                                embedding_size=12)
        params = model.init(jax.random.PRNGKey(0))
    else:
        model = jax_models.Voxels(6, 1.0)
        params = model.init(None)
        params["voxels"] = jnp.asarray(np.random.default_rng(0).normal(
            size=(6, 6, 6, 4)).astype(np.float32))
    start = str(tmp_path / "start.npz")
    jax_models.save_model(model, params, start)
    assert port_convert.main([start, str(tmp_path / "port.pt")]) == 0
    assert port_convert.main([str(tmp_path / "port.pt"),
                              str(tmp_path / "back.npz")]) == 0
    jax_convert.main([str(tmp_path / "port.pt"), str(tmp_path / "jax.npz")])
    jax_convert.main([start, str(tmp_path / "jax.pt")])
    assert port_convert.main([str(tmp_path / "jax.pt"),
                              str(tmp_path / "port_from_jax.npz")]) == 0
    for name in ("back.npz", "jax.npz", "port_from_jax.npz"):
        with np.load(str(tmp_path / name)) as data:
            got = {k: data[k] for k in data.files if k != "__manifest__"}
        ref = flat(params)
        assert sorted(got) == sorted(ref), name
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key],
                                          err_msg=f"{name}: {key}")
