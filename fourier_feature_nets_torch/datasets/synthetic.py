"""Synthetic multi-view dataset generation.

Port of ``make_scene_volume``, ``render_dataset_images``,
``generate_synthetic_dataset``, ``load_or_generate`` and
``generate_synthetic_image`` from
``fourier_feature_nets_tpu/datasets/synthetic.py``: a procedural RGBA
volume is ray-marched into posed RGBA images and written as an NPZ in
the schema :meth:`ImageDataset.load` reads, so training runs without a
downloaded dataset; a procedural test image (the JAX package's pixels,
written by the port's PNG writer) stands in for image regression's
photos. The trilinear lookup is ``F.grid_sample``
(``padding_mode="border"``, ``align_corners=False``), the call the JAX
package's ``ops/grid_sample.py`` reproduces.
"""

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..cameras import Resolution, raycast_grid
from ..ops import (
    batch_linspace,
    bounds_min_max,
    calculate_blend_weights,
    ray_aabb_near_far,
)
from ..utils.camera_paths import hemisphere
from ..utils.png import write_png

__all__ = ["make_scene_volume", "render_dataset_images",
           "generate_synthetic_dataset", "generate_synthetic_image",
           "load_or_generate"]


def make_scene_volume(side: int = 64) -> np.ndarray:
    """Builds a procedural RGBA volume on [-1, 1]^3.

    The scene is a composition with structure at several spatial
    frequencies: a large center cube with a spherical cavity, a small
    dense sphere, and a thin ground slab — each colored by smooth
    spatial gradients so appearance is view-consistent.

    Returns:
        (side, side, side, 4) float32 array; rgb in [0, 1], density
        (last channel) in absorption units.
    """
    coords = np.linspace(-1, 1, side, dtype=np.float32)
    z, y, x = np.meshgrid(coords, coords, coords, indexing="ij")

    density = np.zeros((side, side, side), np.float32)
    color = np.zeros((side, side, side, 3), np.float32)

    # large cube [-0.45, 0.45]^3 with a spherical cavity of r=0.3
    cube = (np.maximum.reduce([np.abs(x), np.abs(y), np.abs(z)]) < 0.45)
    cavity = (x ** 2 + y ** 2 + z ** 2) < 0.3 ** 2
    body = cube & ~cavity
    density[body] = 40.0
    color[body] = np.stack([0.5 + 0.5 * x, 0.5 + 0.5 * y,
                            0.5 + 0.5 * z], -1)[body]

    # dense sphere at (0.55, 0.3, -0.4), r=0.18
    sphere = ((x - 0.55) ** 2 + (y - 0.3) ** 2
              + (z + 0.4) ** 2) < 0.18 ** 2
    density[sphere] = 80.0
    color[sphere] = np.array([0.9, 0.2, 0.15], np.float32)

    # thin ground slab
    slab = (y > -0.75) & (y < -0.65) & (np.abs(x) < 0.8) & (np.abs(z) < 0.8)
    density[slab] = 60.0
    checker = ((np.floor(x * 4) + np.floor(z * 4)) % 2)
    color[slab] = np.stack([0.2 + 0.6 * checker, 0.7 - 0.4 * checker,
                            0.3 + 0.0 * checker], -1)[slab]

    return np.concatenate([color, density[..., None]], -1)


def render_dataset_images(volume: np.ndarray, cameras, bounds: np.ndarray,
                          num_samples: int = 256, batch_rays: int = 65536,
                          device="cpu") -> np.ndarray:
    """Ray-marches the RGBA volume to per-camera RGBA uint8 images on
    ``device``."""
    device = torch.device(device)
    resolution = cameras[0].resolution
    ray = raycast_grid(cameras)
    lo, hi = bounds_min_max(bounds)
    scale = float(hi[0])
    lo = torch.from_numpy(lo).to(device)
    hi = torch.from_numpy(hi).to(device)
    # (1, C, D, H, W); grid_sample's last coordinate axis is (x, y, z)
    grid = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(volume.astype(np.float32), -1, 0)))[None].to(device)
    origins = torch.from_numpy(ray.origin.astype(np.float32)).to(device)
    directions = torch.from_numpy(ray.direction.astype(np.float32)).to(
        device)

    num_rays = origins.shape[0]
    colors = torch.zeros(num_rays, 3, device=device)
    alphas = torch.zeros(num_rays, device=device)
    for start in range(0, num_rays, batch_rays):
        starts = origins[start:start + batch_rays]
        dirs = directions[start:start + batch_rays]
        nf = ray_aabb_near_far(starts, dirs, lo, hi)
        near = torch.where(nf.valid, nf.near, 1.0)
        far = torch.where(nf.valid, nf.far, 2.0)
        t_values = batch_linspace(near, far, num_samples)
        positions = starts[:, None, :] + t_values[..., None] * dirs[:, None]
        coords = (positions.reshape(1, 1, 1, -1, 3) / scale)
        rgba = F.grid_sample(grid, coords, mode="bilinear",
                             padding_mode="border", align_corners=False)
        rgba = rgba.reshape(4, -1).T.reshape(-1, num_samples, 4)
        weights = calculate_blend_weights(t_values, rgba[..., 3])
        # zero weight past the exit plane (the 1e10 tail delta would
        # otherwise absorb everything on the last sample)
        weights = torch.where(nf.valid[:, None], weights, 0.0)
        colors[start:start + batch_rays] = torch.sum(
            weights[..., None] * rgba[..., :3], dim=-2)
        alphas[start:start + batch_rays] = torch.sum(weights[..., :-1],
                                                     dim=-1)

    rgba = torch.cat([colors, alphas[:, None]], -1).cpu().numpy()
    rgba = rgba.reshape(len(cameras), resolution.height, resolution.width, 4)
    return (np.clip(rgba, 0, 1) * 255).astype(np.uint8)


def generate_synthetic_dataset(path: str, resolution: int = 100,
                               split_counts: Tuple[int, int, int] = (20, 4, 4),
                               volume_side: int = 64,
                               num_samples: int = 256,
                               seed: int = 20080524, device="cpu") -> str:
    """Generates the synthetic dataset NPZ at ``path`` (cameras from a
    seeded NumPy generator, images rendered on ``device``)."""
    rng = np.random.default_rng(seed)
    num_cameras = sum(split_counts)
    res = Resolution(resolution, resolution)
    cameras = hemisphere(np.array([0.0, 1.0, 0.0]),
                         np.array([0.0, 0.0, 1.0]), num_cameras,
                         fov_y_degrees=40.0, resolution=res,
                         distance=3.2, pos_noise=0.05, rng=rng)
    bounds = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    volume = make_scene_volume(volume_side)
    images = render_dataset_images(volume, cameras, bounds, num_samples,
                                   device=device)
    intrinsics = np.stack([c.intrinsics for c in cameras])
    extrinsics = np.stack([c.extrinsics for c in cameras])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as handle:
        np.savez(handle, images=images, intrinsics=intrinsics,
                 extrinsics=extrinsics, bounds=bounds,
                 split_counts=np.asarray(split_counts))
    return path


def load_or_generate(path: str, **kwargs) -> str:
    """Returns ``path``, generating the synthetic dataset on first use."""
    if not os.path.exists(path):
        generate_synthetic_dataset(path, **kwargs)
    return path


def generate_synthetic_image(path: str, size: int = 512,
                             seed: int = 20080524) -> str:
    """Writes a procedural (size, size) RGB test image for 2-D image
    regression as a PNG at ``path``: smooth color gradients,
    mid-frequency radial rings, a high-frequency diagonal checker patch
    and soft blobs, so that the four FFN variants separate as they do on
    natural images. Its pixels are the JAX package's."""
    coords = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    y, x = np.meshgrid(coords, coords, indexing="ij")
    r = np.sqrt(x * x + y * y)

    rng = np.random.default_rng(seed)
    red = 0.5 + 0.5 * np.sin(3.0 * x + 9.0 * r)
    green = 0.5 + 0.5 * np.cos(14.0 * r + 2.0 * y)
    blue = 0.4 + 0.6 * (0.5 + 0.5 * np.sin(40.0 * (x + y)
                                           ) * (r < 0.6))
    for _ in range(6):
        cx, cy = rng.uniform(-0.8, 0.8, 2)
        radius = rng.uniform(0.05, 0.25)
        blob = np.exp(-((x - cx) ** 2 + (y - cy) ** 2)
                      / (2 * radius ** 2))
        channel = rng.integers(0, 3)
        [red, green, blue][channel][:] = np.clip(
            [red, green, blue][channel] + 0.6 * blob, 0.0, 1.0)

    rgb = np.stack([red, green, blue], -1)
    pixels = (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, pixels)
    return path
