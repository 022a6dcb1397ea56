"""The one generator of the benchmark's inputs, driven by a traffic mix's
parameters (``traffic/<mix>.json``).

* ``orbit_rig``: the orbit of ``orbit_video``: ``num_cameras`` cameras
  at ``distance``, two turns of azimuth about ``up`` while the altitude
  rises from ``min_altitude_deg`` to ``max_altitude_deg`` and back.
* ``hemisphere_rig``: ``num_cameras`` cameras spread over the upper
  hemisphere by a Fibonacci lattice, shuffled far-point first and
  jittered by ``pos_noise``, from ``rig_seed``.
* ``sphere_poses``: one pose a request, fixed by the count: a Fibonacci
  lattice on the sphere of ``distance`` (its caps beyond ``max_abs_up``
  left out), looking at the origin with ``up``; a run's seed only
  orders them.
* ``cloud_grid``: the 0/1 occupancy grid of a seeded point cloud (an
  orbit's ``"cloud"`` occupancy source): ``points`` draws from
  N(``mean``, ``sigma``) by NumPy's ``default_rng(seed)``, as bench.py
  draws its cloud; a cell of the grid is occupied when it holds
  ``min_points`` (the cloud's own cells, not bench.py's octree leaves,
  which ``from_tree`` also dilates).
* ``synthetic_scene``: the project's procedural scene (a cube with a
  spherical cavity, a dense sphere and a ground slab, 64^3 by default)
  ray-marched into RGBA images from a hemisphere rig.

All cameras have the pinhole intrinsics of ``fov_y_degrees`` at
``resolution``; extrinsics map camera to world with OpenCV's axes.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["intrinsics", "orbit_rig", "hemisphere_rig", "sphere_poses",
           "cloud_grid", "synthetic_scene"]


def intrinsics(fov_y_degrees: float, width: int, height: int) -> np.ndarray:
    focal = 0.5 * width / math.tan(0.5 * math.radians(fov_y_degrees))
    return np.array([[focal, 0, width / 2], [0, focal, height / 2],
                     [0, 0, 1]], np.float32)


def _rotation(axis, angle: float) -> np.ndarray:
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    c, s = math.cos(angle), math.sin(angle)
    out = np.eye(4)
    out[:3, :3] = [[c + x * x * (1 - c), x * y * (1 - c) - z * s,
                    x * z * (1 - c) + y * s],
                   [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                    y * z * (1 - c) - x * s],
                   [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                    c + z * z * (1 - c)]]
    return out


def look_at(position, up) -> np.ndarray:
    """Camera-to-world extrinsics of a camera at ``position`` looking at
    the origin (x flipped into OpenCV's axes)."""
    position = np.asarray(position, np.float64)
    forward = position / np.linalg.norm(position)
    right = np.cross(np.asarray(up, np.float64), forward)
    right /= np.linalg.norm(right)
    out = np.eye(4)
    out[:3, 0], out[:3, 1] = right, np.cross(forward, right)
    out[:3, 2], out[:3, 3] = forward, position
    return out @ np.diag([1.0, -1.0, -1.0, 1.0])


def _stack(extrinsics, mix):
    k = intrinsics(mix["fov_y_degrees"], mix["resolution"],
                   mix["resolution"])
    return (np.stack([k] * len(extrinsics)),
            np.stack(extrinsics).astype(np.float32))


def orbit_rig(mix: dict):
    """(intrinsics (C, 3, 3), extrinsics (C, 4, 4)) of the orbit."""
    count, up = mix["num_cameras"], np.asarray(mix["up"], np.float64)
    forward = np.asarray(mix["forward"], np.float64)
    right = np.cross(up, forward)
    azimuth = np.linspace(0, 4 * np.pi, count, endpoint=False)
    low, high = (math.radians(mix["min_altitude_deg"]),
                 math.radians(mix["max_altitude_deg"]))
    half = count // 2
    altitude = np.concatenate([
        np.linspace(low, high, half, endpoint=False),
        np.linspace(high, low, count - half, endpoint=False)])
    start = look_at(-forward * mix["distance"], up)
    return _stack([_rotation(up, a) @ _rotation(right, e) @ start
                   for a, e in zip(azimuth, altitude)], mix)


def _far_point_order(points: np.ndarray, rng) -> list:
    order, left = [0], set(range(1, len(points)))
    while left:
        gaps = np.square(points[:, None] - points[order][None]).sum(-1)
        gaps = gaps.min(-1)
        unchosen = np.array(sorted(left))
        weights = gaps[unchosen] / gaps[unchosen].sum()
        choice = int(rng.choice(unchosen, p=weights))
        order.append(choice)
        left.discard(choice)
    return order


def hemisphere_rig(mix: dict):
    """(intrinsics, extrinsics) of the hemisphere rig."""
    rng = np.random.default_rng(mix["rig_seed"])
    count = mix["num_cameras"]
    golden = math.pi * (3.0 - math.sqrt(5.0))
    i = np.arange(count, dtype=np.float64)
    y = 1 - i / (count - 1)
    radius = np.sqrt(1 - y * y)
    points = np.stack([np.cos(golden * i) * radius, y,
                       np.sin(golden * i) * radius], -1)
    points = points[_far_point_order(points, rng)]
    up = np.asarray(mix["up"], np.float64)
    right = np.cross(up, np.asarray(mix["forward"], np.float64))
    extrinsics = []
    for direction in points:
        position = (direction * mix["distance"]
                    + rng.normal(0, mix["pos_noise"], size=3))
        back = np.eye(4)
        back[2, 3] = -np.linalg.norm(position)
        azimuth = math.atan2(direction[0], direction[2])
        altitude = math.asin(min(1.0, max(-1.0, direction[1])))
        extrinsics.append(_rotation(up, azimuth) @ _rotation(right, altitude)
                          @ back)
    return _stack(extrinsics, mix)


def sphere_poses(mix: dict, count: int, order_seed: int):
    """(intrinsics, extrinsics) of ``count`` poses, in the order drawn
    from ``order_seed``."""
    golden = math.pi * (3.0 - math.sqrt(5.0))
    i = np.arange(count, dtype=np.float64)
    y = (1 - 2 * (i + 0.5) / count) * mix["max_abs_up"]
    radius = np.sqrt(1 - y * y)
    points = np.stack([np.cos(golden * i) * radius, y,
                       np.sin(golden * i) * radius], -1)
    order = np.random.default_rng(order_seed).permutation(count)
    return _stack([look_at(points[j] * mix["distance"], mix["up"])
                   for j in order], mix)


def cloud_grid(occupancy: dict, scale: float) -> np.ndarray:
    """The (R, R, R) f32 0/1 grid, indexed [z, y, x], over [-scale,
    scale]^3 at R = ``occupancy["resolution"]``: a cell is 1 when it
    holds at least ``min_points`` of the cloud ``occupancy["cloud"]``'s
    points (f32); points outside the box count nowhere."""
    cloud, side = occupancy["cloud"], occupancy["resolution"]
    rng = np.random.default_rng(cloud["seed"])
    points = rng.normal(cloud["mean"], cloud["sigma"],
                        (cloud["points"], 3)).astype(np.float32)
    cells = np.floor((points / np.float32(scale) + 1.0) * 0.5
                     * side).astype(np.int64)
    cells = cells[np.all((cells >= 0) & (cells < side), axis=1)]
    x, y, z = cells.T
    counts = np.bincount((z * side + y) * side + x, minlength=side ** 3)
    return (counts >= occupancy["min_points"]).astype(np.float32).reshape(
        side, side, side)


def _scene_volume(side: int) -> np.ndarray:
    coords = np.linspace(-1, 1, side, dtype=np.float32)
    z, y, x = np.meshgrid(coords, coords, coords, indexing="ij")
    density = np.zeros((side, side, side), np.float32)
    color = np.zeros((side, side, side, 3), np.float32)
    body = ((np.maximum.reduce([np.abs(x), np.abs(y), np.abs(z)]) < 0.45)
            & ((x ** 2 + y ** 2 + z ** 2) >= 0.3 ** 2))
    density[body] = 40.0
    color[body] = np.stack([0.5 + 0.5 * x, 0.5 + 0.5 * y,
                            0.5 + 0.5 * z], -1)[body]
    sphere = ((x - 0.55) ** 2 + (y - 0.3) ** 2 + (z + 0.4) ** 2) < 0.18 ** 2
    density[sphere] = 80.0
    color[sphere] = np.array([0.9, 0.2, 0.15], np.float32)
    slab = (y > -0.75) & (y < -0.65) & (np.abs(x) < 0.8) & (np.abs(z) < 0.8)
    density[slab] = 60.0
    checker = (np.floor(x * 4) + np.floor(z * 4)) % 2
    color[slab] = np.stack([0.2 + 0.6 * checker, 0.7 - 0.4 * checker,
                            0.3 + 0.0 * checker], -1)[slab]
    return np.concatenate([color, density[..., None]], -1)


def synthetic_scene(mix: dict, device):
    """(images (C, H, W, 4) uint8, intrinsics, extrinsics, scale) of the
    scene's hemisphere rig, rendered in f32 on ``device`` with
    ``march_samples`` uniform samples a ray over the box [-scale,
    scale]^3."""
    from ..reference.geometry import box_near_far, composite_density, rig_rays
    k, e = hemisphere_rig(mix)
    size = mix["resolution"]
    origins, directions = rig_rays(k, e, size, size)
    volume = torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        _scene_volume(mix["volume_side"]), -1, 0)))[None].to(device)
    scale = mix["scale"]
    lo = torch.full((3,), -scale, device=device)
    hi = torch.full((3,), scale, device=device)
    starts = torch.from_numpy(origins).to(device)
    dirs = torch.from_numpy(directions).to(device)
    rgba = []
    samples = mix["march_samples"]
    for start in range(0, starts.shape[0], 65536):
        s, d = starts[start:start + 65536], dirs[start:start + 65536]
        near, far, valid = box_near_far(s, d, lo, hi)
        ramp = torch.arange(samples, device=device) / (samples - 1)
        t = near[:, None] + ramp * (far - near)[:, None]
        points = s[:, None, :] + t[..., None] * d[:, None, :]
        sampled = F.grid_sample(volume, (points / scale).reshape(1, 1, 1, -1,
                                                                 3),
                                mode="bilinear", padding_mode="border",
                                align_corners=False)
        sampled = sampled.reshape(4, -1).T.reshape(-1, samples, 4)
        color, alpha = composite_density(sampled, t, valid)
        rgba.append(torch.cat([color, alpha[:, None]], -1))
    rgba = torch.cat(rgba).cpu().numpy().reshape(len(k), size, size, 4)
    return (np.clip(rgba, 0, 1) * 255).astype(np.uint8), k, e, scale
