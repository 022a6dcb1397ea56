"""Mesh extraction from trained radiance fields (surface nets).

Port of ``fourier_feature_nets_tpu/mesh_export.py``. :func:`surface_nets`
(naive surface nets: one vertex per sign-change cell at the centroid of
its edge crossings, one quad per interior sign-change edge, emitted as
two triangles) and :func:`export_obj` (Wavefront OBJ with the 6-float
vertex-color extension) are NumPy copies of the JAX package's and give
its output exactly. :func:`mesh_from_model` sweeps the field's per-cell
alpha ``1 - exp(-softplus(sigma) * h)`` (the occupancy tooling's
threshold semantics) over the cell centres with the plain f32 model on
its own device, in batches of at most :data:`MESH_BATCH` points: the
CLI's default 192^3 grid is 7,077,888 points, and one 256-wide f32
activation of all of them would take 7.2 GB. Vertex colors are the
field's emission at each vertex (zero view directions for a model with
views).
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .models.module import query_model

__all__ = ["MESH_BATCH", "alpha_field", "export_obj", "mesh_from_model",
           "surface_nets"]

# points a batch of the field sweep
MESH_BATCH = 1 << 18


def surface_nets(field: np.ndarray, iso: float = 0.0,
                 origin: float = -1.0, spacing: Optional[float] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Extracts the ``field == iso`` isosurface as a triangle mesh.

    Args:
        field: (R, R, R) scalar samples on a uniform grid, axis order
            (z, y, x) (the density-sweep convention); values > iso are
            INSIDE.
        iso: isovalue.
        origin: world coordinate of grid index 0 on every axis.
        spacing: world distance between grid samples; default spans
            [origin, -origin].

    Returns:
        (vertices (V, 3) float32 world xyz, triangles (T, 3) int32).
        Triangles wind counter-clockwise seen from OUTSIDE.
    """
    field = np.asarray(field, np.float32)
    assert field.ndim == 3
    shape = np.asarray(field.shape)
    if spacing is None:
        spacing = (-2.0 * origin) / (shape.max() - 1)

    inside = field > iso
    num_cells = shape - 1

    # --- vertex placement: centroid of a cell's edge crossings -------
    # accumulate each crossing point into the (up to) 4 cells sharing
    # its edge, then divide; cells keyed by their min-corner index
    acc = np.zeros((*num_cells, 3), np.float64)
    cnt = np.zeros(tuple(num_cells), np.int32)

    quads = []  # (4, N, 3) cell indices + orientation per axis

    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(None, -1)
        hi[axis] = slice(1, None)
        f0 = field[tuple(lo)]
        f1 = field[tuple(hi)]
        crossing = inside[tuple(lo)] != inside[tuple(hi)]
        idx = np.argwhere(crossing)              # (N, 3) edge start
        if idx.size == 0:
            continue
        a = f0[tuple(idx.T)]
        b = f1[tuple(idx.T)]
        frac = (iso - a) / (b - a)               # in (0, 1) by crossing
        point = idx.astype(np.float64)
        point[:, axis] += frac

        # the 4 cells sharing this edge: min-corner = idx with the two
        # OTHER axes each reduced by 0 or 1
        other = [ax for ax in range(3) if ax != axis]
        cells = []
        for da in (0, -1):
            for db in (0, -1):
                cell = idx.copy()
                cell[:, other[0]] += da
                cell[:, other[1]] += db
                cells.append(cell)
        for cell in cells:
            valid = np.all((cell >= 0) & (cell < num_cells), axis=1)
            np.add.at(acc, tuple(cell[valid].T), point[valid])
            np.add.at(cnt, tuple(cell[valid].T), 1)

        # interior edges (all 4 cells exist) become quads; orientation
        # flips with the crossing direction so normals face OUTWARD
        interior = np.all(
            [np.all((c >= 0) & (c < num_cells), axis=1) for c in cells],
            axis=0)
        if not interior.any():
            continue
        # lower end inside => the surface normal points toward +axis
        # => one winding; else the other
        lower_inside = inside[tuple(lo)][tuple(idx[interior].T)]
        c00, c01, c10, c11 = (c[interior] for c in cells)
        # around the edge, the 4 cells in cyclic order are
        # (0,0) -> (0,-1) -> (-1,-1) -> (-1,0) in (other0, other1)
        cyc = (c00, c10, c11, c01)
        quads.append((cyc, lower_inside, axis))

    active = cnt > 0
    cell_id = np.full(tuple(num_cells), -1, np.int64)
    cell_id[active] = np.arange(int(active.sum()))
    verts_idx = acc[active] / cnt[active][:, None]

    tris = []
    for cyc, lower_inside, axis in quads:
        ids = np.stack([cell_id[tuple(c.T)] for c in cyc], axis=1)
        assert (ids >= 0).all()
        fwd = np.stack([ids[:, 0], ids[:, 1], ids[:, 2],
                        ids[:, 0], ids[:, 2], ids[:, 3]], 1)
        rev = np.stack([ids[:, 0], ids[:, 2], ids[:, 1],
                        ids[:, 0], ids[:, 3], ids[:, 2]], 1)
        # winding parity validated against an analytic sphere
        # (outward normals, tests/test_mesh_export.py): lower-inside
        # edges take the REVERSED cyclic winding on axes 0/2 and the
        # forward one on axis 1 (the (z, y, x) index order makes the
        # middle axis left-handed relative to world xyz)
        pick = np.where(lower_inside[:, None],
                        rev if axis != 1 else fwd,
                        fwd if axis != 1 else rev)
        tris.append(pick.reshape(-1, 3))

    triangles = (np.concatenate(tris).astype(np.int32)
                 if tris else np.zeros((0, 3), np.int32))

    # index space (z, y, x) + half-cell dual offset -> world xyz
    verts_idx = verts_idx + 0.5
    world = origin + verts_idx * spacing
    vertices = np.stack([world[:, 2], world[:, 1], world[:, 0]],
                        -1).astype(np.float32)
    return vertices, triangles


def export_obj(path: str, vertices: np.ndarray, triangles: np.ndarray,
               colors: Optional[np.ndarray] = None) -> None:
    """Writes a Wavefront OBJ (triangles; optional per-vertex RGB via
    the 6-float vertex-color extension)."""
    with open(path, "w") as out:
        out.write("# fourier_feature_nets_torch mesh export\n")
        if colors is not None:
            colors = np.clip(np.asarray(colors, np.float64), 0.0, 1.0)
            for v, c in zip(vertices, colors):
                out.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                          f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
        else:
            for v in vertices:
                out.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in triangles + 1:
            out.write(f"f {t[0]} {t[1]} {t[2]}\n")


def _cell_centers(resolution: int, scale: float) -> np.ndarray:
    centers = (np.arange(resolution) + 0.5) / resolution * 2 - 1
    return (centers * scale).astype(np.float32)


def _logits(model, points: torch.Tensor) -> torch.Tensor:
    """(N, 4) f32 logits of any field at (N, 3) points, with zero view
    directions for a model that takes them."""
    return query_model(model, points, torch.zeros_like(points))


@torch.no_grad()
def alpha_field(model, resolution: int = 128, scale: float = 1.0,
                batch: int = MESH_BATCH) -> np.ndarray:
    """The (R, R, R) f32 per-cell alpha of ``model`` at the cell centres
    of a ``resolution``^3 grid over [-scale, scale]^3, indexed [z, y, x],
    computed on the model's device ``batch`` points at a time (each
    batch's points are made there from the centres) and copied to the
    host once."""
    device = next(model.parameters()).device
    centers = torch.from_numpy(_cell_centers(resolution, scale)).to(device)
    cell = 2.0 * scale / resolution
    total = resolution ** 3
    alpha = torch.empty(total, device=device)
    for start in range(0, total, batch):
        idx = torch.arange(start, min(start + batch, total), device=device)
        points = torch.stack([centers[idx % resolution],
                              centers[(idx // resolution) % resolution],
                              centers[idx // (resolution * resolution)]], -1)
        sigma = F.softplus(_logits(model, points)[:, 3])
        alpha[start:start + batch] = 1.0 - torch.exp(-sigma * cell)
    return alpha.cpu().numpy().reshape(resolution, resolution, resolution)


@torch.no_grad()
def mesh_from_model(model, resolution: int = 128, scale: float = 1.0,
                    alpha_threshold: float = 0.5, with_colors: bool = True,
                    batch: int = MESH_BATCH):
    """Extracts a colored isosurface mesh from a trained field.

    Args:
        model: any radiance-field model (NeRF, the FFNs, Voxels,
            FactorizedVoxels, a distilled student), on its device.
        resolution: sampling grid side.
        scale: half extent of the sampled volume.
        alpha_threshold: per-cell alpha isovalue.
        with_colors: compute each vertex's color.
        batch: points a batch of the field sweep.

    Returns:
        (vertices (V, 3), triangles (T, 3), colors (V, 3) or None).
    """
    field = alpha_field(model, resolution, scale, batch)
    centers = _cell_centers(resolution, scale)
    spacing = float(centers[1] - centers[0]) if resolution > 1 else 1.0
    vertices, triangles = surface_nets(field - alpha_threshold, iso=0.0,
                                       origin=centers[0], spacing=spacing)
    colors = None
    if with_colors and len(vertices):
        device = next(model.parameters()).device
        points = torch.from_numpy(vertices.astype(np.float32)).to(device)
        colors = torch.cat([
            torch.sigmoid(_logits(model, points[start:start + batch])[:, :3])
            for start in range(0, points.shape[0], batch)]).cpu().numpy()
    return vertices, triangles, colors
