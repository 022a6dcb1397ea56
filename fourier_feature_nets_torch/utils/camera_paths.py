"""Synthetic camera orbits.

NumPy port of ``fourier_feature_nets_tpu/utils/camera_paths.py``
(``orbit``, ``hemisphere``, ``fibonacci_hemisphere``,
``shuffle_positions``, ``look_at_extrinsics``, ``_intrinsics`` and the
Rodrigues rotation they use). Camera paths are host-side metadata, so
the code is the same NumPy on both sides.
"""

import math
from typing import List

import numpy as np

from ..cameras import CameraInfo, Resolution

__all__ = ["orbit", "hemisphere", "fibonacci_hemisphere",
           "shuffle_positions", "look_at_extrinsics", "rotation_about_axis"]


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


def shuffle_positions(positions: np.ndarray, random=True,
                      rng: np.random.Generator = None) -> List[int]:
    """Farthest-point-biased shuffling of positions."""
    if rng is None:
        rng = np.random.default_rng()
    samples = [0]
    all_positions = set(range(len(positions)))
    while len(samples) < len(all_positions):
        sample_positions = positions[samples]
        distances = positions[:, None, :] - sample_positions[None, :, :]
        distances = np.square(distances).sum(-1).min(-1)
        unchosen = np.array(sorted(all_positions - set(samples)))
        if random:
            weights = np.asarray(distances[unchosen], np.float64)
            weights = weights / weights.sum()
            choice = rng.choice(unchosen, p=weights)
        else:
            choice = unchosen[distances[unchosen].argmax()]
        samples.append(int(choice))
    return samples


def fibonacci_hemisphere(num_samples: int,
                         rng: np.random.Generator = None) -> np.ndarray:
    """Evenly spread hemisphere points, far-point shuffled."""
    phi = math.pi * (3.0 - math.sqrt(5.0))
    i = np.arange(num_samples, dtype=np.float64)
    y = 1 - i / (num_samples - 1)
    radius = np.sqrt(1 - y * y)
    theta = phi * i
    points = np.stack([np.cos(theta) * radius, y,
                       np.sin(theta) * radius], -1)
    index = shuffle_positions(points, rng=rng)
    return points[index]


def hemisphere(up_dir: np.ndarray, forward_dir: np.ndarray,
               num_cameras: int, fov_y_degrees: float,
               resolution: Resolution, distance: float, pos_noise=0.1,
               rng: np.random.Generator = None) -> List[CameraInfo]:
    """Randomly perturbed, evenly placed hemisphere cameras."""
    if rng is None:
        rng = np.random.default_rng()
    directions = fibonacci_hemisphere(num_cameras, rng=rng)
    up_dir = np.asarray(up_dir, np.float64)
    right_dir = np.cross(up_dir, np.asarray(forward_dir, np.float64))
    intrinsics = _intrinsics(fov_y_degrees, resolution)

    cameras = []
    for direction in directions:
        position = direction * distance + rng.normal(0, pos_noise, size=3)
        dist = np.linalg.norm(position)
        azimuth = math.atan2(direction[0], direction[2])
        altitude = math.asin(min(1.0, max(-1.0, direction[1])))
        pos = np.eye(4)
        pos[2, 3] = -dist
        elevate = rotation_about_axis(right_dir, altitude)
        rotate = rotation_about_axis(up_dir, azimuth)
        # unlike orbit, no x-flip: the camera's +z axis (OpenCV
        # forward) already points at the origin from the translated
        # position
        extrinsics = rotate @ elevate @ pos
        cameras.append(CameraInfo.create(f"cam{len(cameras)}", resolution,
                                         intrinsics, extrinsics))
    return cameras
