"""2-D pixel regression dataset.

Port of ``fourier_feature_nets_tpu/datasets/pixel_dataset.py``: an
image's pixels and their UV grid as tensors on an explicit device, so
the full-batch train step runs on the device. UVs span [0, 2), the
input range the FFNs expect. The image is read by the port's PNG reader
(:mod:`..utils.png`) and shrunk by its NumPy ``INTER_AREA``
(:mod:`..utils.image`), since the card's machine has no OpenCV.
"""

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from ..utils.color import rgb_to_ycrcb, ycrcb_to_rgb
from ..utils.image import resize_area
from ..utils.png import read_png

__all__ = ["PixelData", "PixelDataset"]


class PixelData(NamedTuple):
    """UV coordinates in [0, 2) and the colors at them in [0, 1]."""

    uv: torch.Tensor
    color: torch.Tensor


def _uv_grid(size: int) -> np.ndarray:
    """(size, size, 2) f32 UVs over [0, 2), u along the columns."""
    vals = np.linspace(0, 2, size, endpoint=False, dtype=np.float32)
    return np.stack(np.meshgrid(vals, vals), axis=-1)


class PixelDataset:
    """Dataset of image pixels for 2-D regression."""

    def __init__(self, size: int, color_space: str,
                 train_data: PixelData, val_data: PixelData):
        self.size = size
        self.color_space = color_space
        self.train_uv, self.train_color = train_data
        self.val_uv, self.val_color = val_data
        self.image = self.to_image(self.val_color)

    @property
    def device(self) -> torch.device:
        return self.val_uv.device

    @staticmethod
    def create(path: str, color_space: str, size=512,
               data_dir: str = None, device="cpu") -> "PixelDataset":
        """A dataset from a PNG file (8-bit grey, RGB or RGBA; the alpha
        is dropped, as OpenCV's colour read drops it).

        Center-crops to a square, resizes it to ``size`` (INTER_AREA),
        converts to the color space (``RGB`` or ``YCrCb``), and builds
        the train (every other pixel, the half-resolution UV grid) and
        val (full resolution) splits on ``device``. A relative ``path``
        that does not exist is looked up in ``data_dir``.
        """
        if color_space not in ("RGB", "YCrCb"):
            raise NotImplementedError(
                "Unsupported color space: {}".format(color_space))
        if not os.path.exists(path) and data_dir:
            path = os.path.join(data_dir, path)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        pixels = read_png(path)
        if pixels.shape[2] == 1:
            pixels = np.repeat(pixels, 3, axis=2)
        pixels = pixels[..., :3]

        height, width = pixels.shape[:2]
        if height > width:
            start = (height - width) // 2
            pixels = pixels[start:start + width, :]
        elif width > height:
            start = (width - height) // 2
            pixels = pixels[:, start:start + height]
        if pixels.shape[0] != size:
            pixels = resize_area(pixels, size, size)
        if color_space == "YCrCb":
            pixels = rgb_to_ycrcb(pixels)
        pixels = (pixels / 255).astype(np.float32)

        def tensor(array):
            return torch.from_numpy(np.ascontiguousarray(array)).to(device)

        train = PixelData(tensor(_uv_grid(size // 2)),
                          tensor(pixels[::2, ::2, :]))
        val = PixelData(tensor(_uv_grid(size)), tensor(pixels))
        return PixelDataset(size, color_space, train, val)

    @staticmethod
    def generate_uvs(size: int, device="cpu") -> torch.Tensor:
        """(size, size, 2) UV grid spanning [0, 2) on ``device``."""
        return torch.from_numpy(_uv_grid(size)).to(device)

    def to_image(self, colors, size=0) -> np.ndarray:
        """Colors (a tensor or an array, size * size * 3 values in
        [0, 1]) as an RGB uint8 image."""
        if size == 0:
            size = self.size
        if isinstance(colors, torch.Tensor):
            colors = colors.detach().cpu().numpy()
        pixels = np.asarray(colors).reshape(size, size, 3)
        pixels = (pixels * 255).astype(np.uint8)
        if self.color_space == "YCrCb":
            pixels = ycrcb_to_rgb(pixels)
        return pixels

    @torch.no_grad()
    def to_act_image(self, model, size: int) -> np.ndarray:
        """An 8x8 grid of the images of the last hidden layer's first 64
        units: each unit's activation times its row of the last layer's
        weights, plus the bias, through a sigmoid."""
        num_grid = 8
        grid_size = size // num_grid
        uvs = self.generate_uvs(grid_size, self.device).reshape(-1, 2)
        _, activation = model(uvs, return_hidden=True)
        activation = activation.T[..., None]          # (units, P, 1)
        out_layer = model.layers[-1]
        palette = out_layer.weight.T[:, None, :]       # (units, 1, 3)
        values = torch.sigmoid(activation * palette + out_layer.bias)
        values = values.cpu().numpy()

        act_pixels = np.zeros((size, size, 3), np.float32)
        for i in range(num_grid):
            for j in range(num_grid):
                unit = values[i * num_grid + j]
                act_pixels[i * grid_size:(i + 1) * grid_size,
                           j * grid_size:(j + 1) * grid_size] = (
                    unit.reshape(grid_size, grid_size, 3))
        act_pixels = (act_pixels * 255).astype(np.uint8)
        if self.color_space == "YCrCb":
            act_pixels = ycrcb_to_rgb(act_pixels)
        return act_pixels

    def psnr(self, colors: torch.Tensor) -> float:
        """PSNR of predicted colors against the validation pixels."""
        mse = float(torch.mean(torch.square(
            colors.reshape(self.val_color.shape) - self.val_color)))
        # guard the perfect-reconstruction case (log10(0))
        return -10 * math.log10(max(mse, 1e-10))
