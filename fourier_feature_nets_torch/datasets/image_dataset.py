"""Multi-view image dataset for training radiance fields.

Port of ``fourier_feature_nets_tpu/datasets/image_dataset.py``.
Ground-truth colors and alphas live as tensors on the dataset's device
and are gathered per batch of ray ids; the sampling modes (Full,
Sparse, Center, Dilate, Patch) are host-side index pools, filtered to
valid rays on first use.

Three departures from the JAX package, all because the card's machine
has neither OpenCV nor network access: the alpha-mask dilation is
``scipy.ndimage.binary_dilation`` with OpenCV's elliptic stencil
(:func:`ellipse_stencil`), ``YCrCb`` colors come from OpenCV's uint8
conversion rebuilt in NumPy (:mod:`..utils.color`), and a missing NPZ
is an error naming the path (the JAX package downloads it).
"""

import os
from typing import List

import numpy as np
import scipy.ndimage
import torch

from ..cameras import CameraInfo, Resolution, pixel_grid
from ..render.ray_sampler import RaySampler, RaySamples
from ..render.raycaster import RenderResult
from ..utils.color import rgb_to_ycrcb
from .ray_dataset import Mode, RayDataset

__all__ = ["ImageDataset", "ellipse_stencil"]


def ellipse_stencil(size: int) -> np.ndarray:
    """(size, size) bool disk for an odd ``size``, built row by row the
    way OpenCV's ``getStructuringElement(MORPH_ELLIPSE, (size, size))``
    builds it: row ``r + dy`` spans ``r +- round(r * sqrt(1 - dy^2 /
    r^2))`` with ``r = size // 2``."""
    radius = size // 2
    inv_r2 = 1.0 / (radius * radius) if radius else 0.0
    stencil = np.zeros((size, size), bool)
    for row in range(size):
        dy = row - radius
        dx = int(np.rint(radius * np.sqrt((radius * radius - dy * dy)
                                          * inv_r2)))
        stencil[row, radius - dx:radius + dx + 1] = True
    return stencil


class ImageDataset(RayDataset):
    """Dataset of posed RGB(A) images for ray-based training."""

    def __init__(self, label: str, images: np.ndarray, bounds: np.ndarray,
                 cameras: List[CameraInfo], num_samples: int,
                 include_alpha: bool = True, stratified: bool = False,
                 opacity_model=None, batch_size: int = 4096,
                 color_space: str = "RGB", sparse_size: int = 50,
                 anneal_start: float = 0.2, num_anneal_steps: int = 0,
                 alpha_weight: float = 0.1, device="cpu"):
        if images.ndim != 4 or len(images) != len(cameras) \
                or images.dtype != np.uint8:
            raise ValueError("images must be (C, H, W, 3|4) uint8, one per "
                             "camera")
        if color_space not in ("RGB", "YCrCb"):
            raise ValueError(f"unknown color space {color_space!r}")
        self._color_space = color_space
        self._mode = Mode.Full
        self._label = label
        self._images = images
        self.device = torch.device(device)
        self.include_alpha = include_alpha
        self.image_height, self.image_width = images.shape[1:3]
        self.sparse_size = sparse_size

        self.sampler = RaySampler(bounds, cameras, num_samples, device,
                                  stratified=stratified,
                                  anneal_start=anneal_start,
                                  num_anneal_steps=num_anneal_steps,
                                  opacity_model=opacity_model,
                                  batch_size=batch_size)
        points = pixel_grid(cameras[0].resolution)
        rays_per_camera = self.sampler.rays_per_camera

        # center crop: the middle half of the image
        source_resolution = np.array([self.image_width, self.image_height])
        crop_start = source_resolution // 4
        crop_end = source_resolution - crop_start
        inside_crop = ((points >= crop_start) & (points < crop_end)).all(-1)
        crop_points = np.nonzero(inside_crop)[0]
        self.crop_rays_per_camera = len(crop_points)

        sparse_points = self._subsample_rays(sparse_size)
        self.sparse_rays_per_camera = len(sparse_points)

        # patch-major pixel order: contiguous runs tile square patches
        self.patch_size = 8
        patch_points = self._patch_rays(self.patch_size)
        self.patch_rays_per_camera = len(patch_points)

        stencil_radius = 8 * min(self.image_width, self.image_height) // 100
        stencil = ellipse_stencil(2 * stencil_radius + 1)

        colors, alphas = [], []
        crop_index, sparse_index, patch_index, dilate_index = [], [], [], []
        self.dilate_ranges = []
        num_dilate = 0
        has_alpha = images.shape[-1] == 4
        for cam, image in enumerate(images):
            color = image[..., :3]
            if color_space == "YCrCb":
                color = rgb_to_ycrcb(color)
            color = color.astype(np.float32) / 255
            colors.append(color[points[:, 1], points[:, 0]])
            offset = cam * rays_per_camera
            if has_alpha:
                alpha = image[..., 3].astype(np.float32) / 255
                alphas.append(alpha[points[:, 1], points[:, 0]])
                mask = scipy.ndimage.binary_dilation(image[..., 3] > 0,
                                                     stencil)
                mask = mask[points[:, 1], points[:, 0]]
                dilate_points = np.nonzero(mask)[0]
                dilate_index.append(dilate_points + offset)
                self.dilate_ranges.append(
                    (num_dilate, num_dilate + len(dilate_points)))
                num_dilate += len(dilate_points)
            crop_index.append(crop_points + offset)
            sparse_index.append(sparse_points + offset)
            patch_index.append(patch_points + offset)

        self.crop_index = np.concatenate(crop_index)
        self.sparse_index = np.concatenate(sparse_index)
        self.patch_index = np.concatenate(patch_index)
        self.dilate_index = (np.concatenate(dilate_index)
                             if dilate_index else np.array([], np.int64))

        self.colors = torch.from_numpy(np.concatenate(colors)).to(self.device)
        if has_alpha and include_alpha:
            self.alphas = torch.from_numpy(np.concatenate(alphas)).to(
                self.device)
            self.alpha_weight = alpha_weight
        else:
            self.alphas = None
            self.alpha_weight = 0.0
        self._pools = {}

    @property
    def color_space(self) -> str:
        return self._color_space

    @property
    def label(self) -> str:
        return self._label

    @property
    def images(self) -> np.ndarray:
        return self._images

    @property
    def mode(self) -> Mode:
        return self._mode

    @mode.setter
    def mode(self, value: Mode):
        if value == Mode.Dilate and len(self.dilate_index) == 0:
            raise ValueError(
                "Unable to use dilate mode: missing alpha channel")
        self._mode = value

    @property
    def num_cameras(self) -> int:
        return self.sampler.num_cameras

    @property
    def num_samples(self) -> int:
        return self.sampler.num_samples

    @property
    def cameras(self) -> List[CameraInfo]:
        return self.sampler.cameras

    def _mode_index(self, mode: Mode) -> np.ndarray:
        if mode == Mode.Center:
            return self.crop_index
        if mode == Mode.Sparse:
            return self.sparse_index
        if mode == Mode.Dilate:
            return self.dilate_index
        if mode == Mode.Patch:
            return self.patch_index
        return np.arange(self.sampler.num_rays)

    def index_pool(self, mode=None) -> np.ndarray:
        """Valid global ray ids available under ``mode`` (cached)."""
        mode = self._mode if mode is None else mode
        if mode not in self._pools:
            self._pools[mode] = self.sampler.to_valid(self._mode_index(mode))
        return self._pools[mode]

    def to_valid(self, idx) -> np.ndarray:
        return self.sampler.to_valid(idx)

    def __len__(self) -> int:
        """Number of rays (valid or not) under the active mode."""
        if self._mode == Mode.Full:
            return self.sampler.num_rays
        return len(self._mode_index(self._mode))

    def index_for_camera(self, camera: int) -> np.ndarray:
        """Per-camera pixel indices of the valid rays under the active
        mode."""
        camera_start = camera * self.sampler.rays_per_camera
        if self._mode == Mode.Dilate:
            start, end = self.dilate_ranges[camera]
            idx = self.dilate_index[start:end]
        elif self._mode == Mode.Full:
            idx = np.arange(camera_start,
                            camera_start + self.sampler.rays_per_camera)
        else:
            per_camera = {Mode.Center: self.crop_rays_per_camera,
                          Mode.Sparse: self.sparse_rays_per_camera,
                          Mode.Patch: self.patch_rays_per_camera}[self._mode]
            start = camera * per_camera
            idx = self._mode_index(self._mode)[start:start + per_camera]
        return self.sampler.to_valid(idx) - camera_start

    def rays_for_camera(self, camera: int) -> RaySamples:
        """Deterministic ray samples of one camera under the active
        mode."""
        idx = (self.index_for_camera(camera)
               + camera * self.sampler.rays_per_camera)
        return self.sampler.sample(torch.from_numpy(idx).to(self.device))

    def render(self, rays: torch.Tensor) -> RenderResult:
        """Ground-truth colors/alphas for global ray ids. In Dilate mode
        alpha supervision is off and background pixels keep their
        colors."""
        color = self.colors[rays]
        if self.alphas is None or self._mode == Mode.Dilate:
            return RenderResult(color, None, None)
        alpha = self.alphas[rays]
        color = torch.where(alpha[:, None] > 0, color, 0.0)
        return RenderResult(color, alpha, None)

    def loss(self, rays: torch.Tensor, render: RenderResult) -> torch.Tensor:
        """MSE(color) + alpha_weight * MSE(alpha)."""
        actual = self.render(rays)
        color_loss = torch.mean(torch.square(actual.color - render.color))
        if self.alpha_weight > 0 and actual.alpha is not None:
            alpha_loss = torch.mean(torch.square(actual.alpha - render.alpha))
            return color_loss + self.alpha_weight * alpha_loss
        return color_loss

    def _patch_rays(self, patch_size: int) -> np.ndarray:
        """Pixel indices reordered patch-major."""
        height = (self.image_height // patch_size) * patch_size
        width = (self.image_width // patch_size) * patch_size
        ys, xs = np.meshgrid(np.arange(height), np.arange(width),
                             indexing="ij")
        order = np.lexsort((xs.reshape(-1) % patch_size,
                            ys.reshape(-1) % patch_size,
                            xs.reshape(-1) // patch_size,
                            ys.reshape(-1) // patch_size))
        flat = (ys.reshape(-1) * self.image_width + xs.reshape(-1))[order]
        return flat.astype(np.int64)

    def _subsample_rays(self, resolution: int) -> np.ndarray:
        """Sparse pixel grid indices."""
        num_x = resolution * self.image_width // self.image_height
        num_y = resolution
        x_vals = np.linspace(0, self.image_width - 1, num_x) + 0.5
        y_vals = np.linspace(0, self.image_height - 1, num_y) + 0.5
        x_vals, y_vals = np.meshgrid(x_vals.astype(np.int32),
                                     y_vals.astype(np.int32))
        return (y_vals.reshape(-1) * self.image_width
                + x_vals.reshape(-1)).astype(np.int64)

    def subset(self, cameras: List[int], num_samples: int,
               stratified: bool, label: str) -> "ImageDataset":
        """Camera-subset dataset on the same device."""
        return ImageDataset(label, self._images[cameras],
                            self.sampler.bounds,
                            [self.sampler.cameras[i] for i in cameras],
                            num_samples, self.include_alpha, stratified,
                            self.sampler.opacity_model,
                            self.sampler.batch_size,
                            self._color_space, self.sparse_size,
                            self.sampler.anneal_start,
                            self.sampler.num_anneal_steps,
                            self.alpha_weight, self.device)

    def to_scenepic(self):
        """Ray-sampling inspection scene (optional scenepic dependency,
        :func:`..scenepic_io.dataset_to_scenepic`); the PNG-based
        alternative is ``cli/inspect_ray_sampling``."""
        from ..scenepic_io import dataset_to_scenepic
        return dataset_to_scenepic(self)

    @staticmethod
    def load(path: str, split: str, num_samples: int,
             include_alpha: bool = True, stratified: bool = False,
             opacity_model=None, batch_size: int = 4096,
             color_space: str = "RGB", sparse_size: int = 50,
             anneal_start: float = 0.2, num_anneal_steps: int = 0,
             device="cpu") -> "ImageDataset":
        """Loads a split ("train", "val" or "test") of an NPZ: images
        (C,H,W,3|4) u8, bounds (4,4), intrinsics (C,3,3), extrinsics
        (C,4,4), split_counts (3,) in train/val/test order."""
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no dataset at {path!r}: the PyTorch port does not "
                "download datasets; pass a local NPZ or 'synthetic[:res]'")
        with np.load(path) as data:
            test_end, height, width = data["images"].shape[:3]
            split_counts = data["split_counts"]
            train_end = int(split_counts[0])
            val_end = train_end + int(split_counts[1])
            ranges = {"train": (0, train_end), "val": (train_end, val_end),
                      "test": (val_end, test_end)}
            if split not in ranges:
                raise ValueError(f"unrecognized split {split!r}")
            idx = list(range(*ranges[split]))
            bounds = data["bounds"]
            images = data["images"][idx]
            intrinsics = data["intrinsics"][idx]
            extrinsics = data["extrinsics"][idx]
        cameras = [CameraInfo.create("{}{:03}".format(split, i),
                                     Resolution(width, height), intr, extr)
                   for i, (intr, extr) in enumerate(zip(intrinsics,
                                                        extrinsics))]
        return ImageDataset(split, images, bounds, cameras, num_samples,
                            include_alpha, stratified, opacity_model,
                            batch_size, color_space, sparse_size,
                            anneal_start, num_anneal_steps, device=device)
