"""Pinhole camera geometry.

A NumPy-only copy of ``fourier_feature_nets_tpu/cameras.py``: camera
calibration is tiny host-side metadata, so both packages keep it in
NumPy. It is copied rather than imported because importing the JAX
package runs its ``__init__``, which imports jax.
"""

from typing import List, NamedTuple

import numpy as np

__all__ = ["Ray", "Resolution", "CameraInfo", "normalize"]


def normalize(x: np.ndarray) -> np.ndarray:
    """Normalizes vectors along the last axis."""
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


class Ray(NamedTuple):
    """A bundle of ray origins and unit directions."""

    origin: np.ndarray
    direction: np.ndarray


class Resolution(NamedTuple):
    """Width and height of an image.

    Parity: camera_info.py:18-40.
    """

    width: int
    height: int

    def scale_to_height(self, height: int) -> "Resolution":
        """Scales, keeping the aspect ratio, to the desired height."""
        return Resolution(self.width * height // self.height, height)

    def square(self) -> "Resolution":
        """Returns a square version of this resolution."""
        size = min(self.width, self.height)
        return Resolution(size, size)

    @property
    def ratio(self) -> float:
        """Aspect ratio."""
        return self.width / self.height


class CameraInfo(NamedTuple):
    """Camera calibration: 3x3 intrinsics + 4x4 camera-to-world extrinsics.

    Parity: camera_info.py:43-109. ``intrinsics`` follows the standard
    pinhole projection convention (focal lengths on the diagonal,
    principal point in the last column); ``extrinsics`` maps camera
    coordinates to world coordinates.
    """

    name: str
    resolution: Resolution
    intrinsics: np.ndarray
    extrinsics: np.ndarray

    @staticmethod
    def create(name: str, resolution: Resolution, intrinsics: np.ndarray,
               extrinsics: np.ndarray) -> "CameraInfo":
        """Creates a camera, trimming intrinsics to 3x3."""
        intrinsics = np.asarray(intrinsics, np.float32)[:3, :3]
        extrinsics = np.asarray(extrinsics, np.float32)
        return CameraInfo(name, resolution, intrinsics, extrinsics)

    @property
    def projection(self) -> np.ndarray:
        """4x4 world-to-image-plane projection matrix."""
        proj = np.eye(4, dtype=np.float32)
        proj[:3, :3] = self.intrinsics
        return proj @ np.linalg.inv(self.extrinsics)

    def unproject(self, points: np.ndarray) -> np.ndarray:
        """Unprojects 2D pixel points to 3D homogeneous world positions.

        Pixel points are lifted to homogeneous image coordinates
        ``[x, y, 1, 1]`` and multiplied by the inverse projection
        (camera_info.py:66-74).
        """
        unprojection = np.linalg.inv(self.projection)
        pts = np.asarray(points, np.float32).reshape(-1, 2)
        ones = np.ones((pts.shape[0], 2), np.float32)
        h_coords = np.concatenate([pts, ones], axis=-1)
        return h_coords @ unprojection.T

    def project(self, positions: np.ndarray) -> np.ndarray:
        """Projects 3D world positions to 2D image-plane points."""
        positions = np.asarray(positions, np.float32)
        ones = np.ones((positions.shape[0], 1), np.float32)
        h_coords = np.concatenate([positions, ones], axis=-1)
        points = h_coords @ self.projection.T
        return points[:, :2] / points[:, 2:3]

    @property
    def fov_y_degrees(self) -> float:
        """Y-axis field of view in degrees (camera_info.py:87-92)."""
        fov_y = (0.5 * self.resolution.width) / self.intrinsics[1, 1]
        return float(2 * np.arctan(fov_y) * 180 / np.pi)

    @property
    def position(self) -> np.ndarray:
        """(1, 3) camera position in world coordinates."""
        return self.extrinsics[:3, 3].reshape(1, 3)

    def raycast(self, points: np.ndarray) -> Ray:
        """Casts world-space rays through the given 2D pixel points.

        Returns broadcastable origins of shape (N, 3) (all equal to the
        camera position) and unit directions (camera_info.py:99-109).
        """
        world_coords = self.unproject(points)
        camera_pos = self.position
        ray_dir = normalize(world_coords[:, :3] - camera_pos)
        origins = np.broadcast_to(camera_pos, ray_dir.shape).copy()
        return Ray(origins, ray_dir)


def pixel_grid(resolution: Resolution) -> np.ndarray:
    """(H*W, 2) integer pixel coordinates in row-major (x fastest) order."""
    x_vals = np.arange(resolution.width)
    y_vals = np.arange(resolution.height)
    points = np.stack(np.meshgrid(x_vals, y_vals), -1)
    return points.reshape(-1, 2)


def raycast_grid(cameras: List[CameraInfo]) -> Ray:
    """Casts one ray per pixel for every camera, batched.

    Returns origins/directions of shape (num_cameras * H * W, 3) in
    camera-major, row-major pixel order — the canonical global ray
    index layout used throughout the framework (matches the reference
    sampler's layout, ray_sampler.py:133-175, computed here in one
    vectorized pass instead of a per-camera Python loop).
    """
    if not cameras:
        raise ValueError("raycast_grid needs at least one camera")
    if any(camera.resolution != cameras[0].resolution
           for camera in cameras):
        # the global index layout assumes one shared H*W per camera;
        # mixed resolutions would silently misalign per-camera offsets
        raise ValueError(
            "raycast_grid requires all cameras to share one "
            "resolution; got "
            + ", ".join(str(camera.resolution) for camera in cameras))
    points = pixel_grid(cameras[0].resolution)
    starts = []
    dirs = []
    for camera in cameras:
        ray = camera.raycast(points)
        starts.append(ray.origin)
        dirs.append(ray.direction)
    return Ray(np.concatenate(starts), np.concatenate(dirs))
