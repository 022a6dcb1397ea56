"""Mesh voxelization: octree construction from textured meshes.

The counterpart of ``fourier_feature_nets_tpu/octree/mesh.py``, ported
as it is: low-discrepancy surface sampling via the Basu-Owen triangle
construction driven by a base-4 Van der Corput sequence, barycentric
attribute interpolation and texture lookup, all vectorized NumPy
(octree.py:28-197, 807-853 of the reference). Mesh IO needs
``trimesh``; without it :func:`build_octree_from_mesh` raises
``ImportError`` naming the package.
"""

from typing import Tuple

import numpy as np

__all__ = ["van_der_corput", "sample_regular_barys",
           "sample_barycentric_point_cloud", "normalize_points",
           "interpolate_bilinear", "build_octree_from_mesh"]


def van_der_corput(count: int, base: int = 4) -> np.ndarray:
    """First ``count`` Van der Corput numbers in the given base
    (radical inverse), vectorized."""
    indices = np.arange(1, count + 1, dtype=np.int64)
    result = np.zeros(count, np.float64)
    norm = 1.0 / base
    active = indices > 0
    work = indices.copy()
    while active.any():
        result[active] += (work[active] % base) * norm
        work = work // base
        norm /= base
        active = work > 0
    return result.astype(np.float32)


def sample_regular_barys(points_per_triangle: np.ndarray) -> np.ndarray:
    """Basu-Owen low-discrepancy barycentric samples.

    Each sample's base-4 digits drive 16 rounds of triangle
    subdivision selection; the final barycentric coordinate is the
    centroid of the selected sub-triangle (octree.py:42-99 semantics,
    fully vectorized).
    """
    max_count = int(points_per_triangle.max()) if len(
        points_per_triangle) else 0
    corput = van_der_corput(max_count)
    samples = np.concatenate([corput[:count]
                              for count in points_per_triangle])
    num_points = len(samples)

    a = np.zeros((num_points, 2), np.float32)
    b = np.zeros_like(a)
    c = np.zeros_like(a)
    a[:, 0] = 1
    b[:, 1] = 1
    digits = (samples.astype(np.float64) * (1 << 32)).astype(np.uint32)
    for i in range(16):
        d = (digits >> (2 * (15 - i))) & 0x3
        a_new = np.where((d == 0)[:, None], (b + c) / 2,
                         np.where((d == 1)[:, None], a,
                                  np.where((d == 2)[:, None], (b + a) / 2,
                                           (c + a) / 2)))
        b_new = np.where((d == 0)[:, None], (a + c) / 2,
                         np.where((d == 1)[:, None], (a + b) / 2,
                                  np.where((d == 2)[:, None], b,
                                           (c + b) / 2)))
        c_new = np.where((d == 0)[:, None], (a + b) / 2,
                         np.where((d == 1)[:, None], (a + c) / 2,
                                  np.where((d == 2)[:, None], (b + c) / 2,
                                           c)))
        a, b, c = a_new, b_new, c_new

    barys = np.zeros((num_points, 3), np.float32)
    barys[:, :2] = (a + b + c) / 3
    barys[:, 2] = 1 - barys.sum(-1)
    return barys


def sample_barycentric_point_cloud(vertex_positions: np.ndarray,
                                   triangles: np.ndarray,
                                   uvs: np.ndarray, num_points: int,
                                   rng: np.random.Generator = None
                                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted surface sampling with low-discrepancy placement
    (octree.py:120-136)."""
    if rng is None:
        rng = np.random.default_rng()
    triangle_verts = vertex_positions[triangles]
    normals = np.cross(triangle_verts[:, 2] - triangle_verts[:, 0],
                       triangle_verts[:, 1] - triangle_verts[:, 0])
    area = 0.5 * np.linalg.norm(normals, axis=-1)
    area = area / area.sum()
    sample_indices = rng.choice(len(area), size=num_points, p=area)
    counts = np.bincount(sample_indices, minlength=len(triangles))
    bary_ids = triangles[np.repeat(np.arange(len(triangles)), counts)]
    bary_coords = sample_regular_barys(counts)

    verts = np.einsum("nvd,nv->nd",
                      vertex_positions[bary_ids].astype(np.float64),
                      bary_coords.astype(np.float64)).astype(np.float32)
    uv = np.einsum("nvd,nv->nd", uvs[bary_ids].astype(np.float64),
                   bary_coords.astype(np.float64)).astype(np.float32)
    return verts, uv


def _align_vectors(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix aligning unit vector a to b (Rodrigues).

    The reference divides by (1 + cos) unguarded (octree.py:160-171)
    and returns NaN for antiparallel inputs — a valid y-down
    ``up_dir`` would silently produce an all-NaN octree; handle the
    degenerate case with an explicit 180-degree rotation instead.
    """
    v = np.cross(a, b)
    cos = float(a @ b)
    if cos < -1.0 + 1e-9:
        # antiparallel: rotate pi around any axis orthogonal to a
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-9:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        transform = np.eye(4)
        transform[:3, :3] = 2.0 * np.outer(axis, axis) - np.eye(3)
        return transform
    vx = np.array([[0, -v[2], v[1]],
                   [v[2], 0, -v[0]],
                   [-v[1], v[0], 0]], np.float64)
    transform = np.eye(4)
    transform[:3, :3] += vx + (vx @ vx) / (1 + cos)
    return transform


def normalize_points(vertex_positions: np.ndarray,
                     up_dir: np.ndarray) -> np.ndarray:
    """Rotates up to +y, scales to a 1.6-unit extent, centers
    (octree.py:174-197)."""
    vertex_positions = np.asarray(vertex_positions, np.float64)
    transform = _align_vectors(np.asarray(up_dir, np.float64),
                               np.array([0.0, 1.0, 0.0]))
    centered = vertex_positions - vertex_positions.mean(0)
    rotated = centered @ transform[:3, :3].T
    extent = (rotated.max(0) - rotated.min(0)).max()
    scaled = rotated * (1.6 / extent)
    center = 0.5 * (scaled.max(0) + scaled.min(0))
    return (scaled - center).astype(np.float32)


def interpolate_bilinear(grid: np.ndarray,
                         query_points: np.ndarray) -> np.ndarray:
    """Samples a (H, W, C) grid at (N, 2) query points in [0, 1]
    (column = u * width, row = v * height, corners clamped), as the JAX
    package's ``ops/interpolation.py``.

    Returns:
        (N, C) interpolated values.
    """
    grid = np.asarray(grid)
    query_points = np.asarray(query_points)
    if grid.ndim != 3 or query_points.ndim != 2:
        raise ValueError("grid must be (height, width, dim) and query "
                         "points (N, 2)")
    height, width, _ = grid.shape
    col = query_points[:, 0] * width
    row = query_points[:, 1] * height

    i0 = np.floor(row).astype(np.int32)
    j0 = np.floor(col).astype(np.int32)
    di = (row - i0)[:, None]
    dj = (col - j0)[:, None]

    i1 = np.clip(i0 + 1, 0, height - 1)
    j1 = np.clip(j0 + 1, 0, width - 1)
    i0 = np.clip(i0, 0, height - 1)
    j0 = np.clip(j0, 0, width - 1)

    v00 = (1 - di) * (1 - dj) * grid[i0, j0, :]
    v01 = (1 - di) * dj * grid[i0, j1, :]
    v10 = di * (1 - dj) * grid[i1, j0, :]
    v11 = di * dj * grid[i1, j1, :]
    return v00 + v01 + v10 + v11


def build_octree_from_mesh(mesh_path: str, voxel_depth: int,
                           min_leaf_size: int, up_dir=(0, 1, 0)):
    """Mesh -> octree with per-leaf colors (octree.py:807-853)."""
    try:
        import trimesh
    except ImportError as error:
        raise ImportError(
            "build_from_mesh requires the optional 'trimesh' package"
        ) from error

    from .octree import OcTree

    mesh = trimesh.load(mesh_path)
    verts = normalize_points(np.asarray(mesh.vertices, np.float32),
                             np.asarray(up_dir, np.float32))
    triangles = np.asarray(mesh.faces, np.int64)
    uvs = np.asarray(mesh.visual.uv, np.float32)
    num_positions = (8 ** (voxel_depth - 2)) * min_leaf_size

    verts, uvs = sample_barycentric_point_cloud(verts, triangles, uvs,
                                                num_positions)
    texture = np.asarray(mesh.visual.material.image)[::-1]
    colors = interpolate_bilinear(texture, uvs)[..., :3]
    colors = (colors / 255).astype(np.float32)
    return OcTree.build_from_samples(verts, voxel_depth, min_leaf_size,
                                     colors)
