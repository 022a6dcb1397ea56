"""Synthetic camera orbits.

NumPy port of ``fourier_feature_nets_tpu/utils/camera_paths.py``
(``orbit``, ``look_at_extrinsics``, ``_intrinsics`` and the Rodrigues
rotation they use). Camera paths are host-side metadata, so the code is
the same NumPy on both sides.
"""

import math
from typing import List

import numpy as np

from ..cameras import CameraInfo, Resolution

__all__ = ["orbit", "look_at_extrinsics", "rotation_about_axis"]


def rotation_about_axis(axis: np.ndarray, angle: float) -> np.ndarray:
    """4x4 rotation about an arbitrary axis (Rodrigues formula)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    rot = np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s,
         x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c),
         y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
         c + z * z * (1 - c)],
    ])
    out = np.eye(4)
    out[:3, :3] = rot
    return out


def look_at_extrinsics(position: np.ndarray, up_dir: np.ndarray) -> np.ndarray:
    """Camera-to-world transform for a camera at ``position`` looking
    at the origin, with +y up in the image.

    The camera's +z axis points from the origin through the camera,
    then a 180-degree rotation about x gives the OpenCV convention
    (y down, z toward the scene).
    """
    position = np.asarray(position, np.float64)
    forward = position / np.linalg.norm(position)  # camera looks along -fwd
    up = np.asarray(up_dir, np.float64)
    right = np.cross(up, forward)
    right = right / np.linalg.norm(right)
    true_up = np.cross(forward, right)
    cam_to_world = np.eye(4)
    cam_to_world[:3, 0] = right
    cam_to_world[:3, 1] = true_up
    cam_to_world[:3, 2] = forward
    cam_to_world[:3, 3] = position
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    return cam_to_world @ flip


def _intrinsics(fov_y_degrees: float, resolution: Resolution) -> np.ndarray:
    """Pinhole intrinsics from vertical FOV."""
    fov_y = fov_y_degrees * np.pi / 180
    focal_length = 0.5 * resolution.width / np.tan(0.5 * fov_y)
    return np.array([
        [focal_length, 0, resolution.width / 2],
        [0, focal_length, resolution.height / 2],
        [0, 0, 1],
    ], np.float32)


def orbit(up_dir: np.ndarray, forward_dir: np.ndarray, num_frames: int,
          fov_y_degrees: float, resolution: Resolution, distance: float,
          min_altitude=np.pi / 12,
          max_altitude=np.pi / 4) -> List[CameraInfo]:
    """Cameras orbiting the origin: two full azimuth revolutions while
    the altitude triangles between min and max."""
    up_dir = np.asarray(up_dir, np.float64)
    forward_dir = np.asarray(forward_dir, np.float64)
    right_dir = np.cross(up_dir, forward_dir)

    azimuth = np.linspace(0, 4 * np.pi, num_frames, endpoint=False)
    altitude = np.zeros_like(azimuth)
    half = num_frames // 2
    altitude[:half] = np.linspace(min_altitude, max_altitude, half,
                                  endpoint=False)
    altitude[half:] = np.linspace(max_altitude, min_altitude,
                                  num_frames - half, endpoint=False)

    intrinsics = _intrinsics(fov_y_degrees, resolution)
    init_ext = look_at_extrinsics(-forward_dir * distance, up_dir)

    cameras = []
    for frame_azi, frame_alt in zip(azimuth, altitude):
        elevate = rotation_about_axis(right_dir, frame_alt)
        rotate = rotation_about_axis(up_dir, frame_azi)
        extrinsics = rotate @ elevate @ init_ext
        cameras.append(CameraInfo.create(f"cam{len(cameras)}", resolution,
                                         intrinsics, extrinsics))
    return cameras
