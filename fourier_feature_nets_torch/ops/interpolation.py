"""Bilinear image interpolation on tensors.

Port of ``fourier_feature_nets_tpu/ops/interpolation.py``: the same
query convention (column = u * width, row = v * height) and corner
clamping, on the grid's device. The octree's mesh sampling keeps a NumPy
copy for its host path (``octree/mesh.py``).
"""

import torch

__all__ = ["interpolate_bilinear"]


def interpolate_bilinear(grid: torch.Tensor,
                         query_points: torch.Tensor) -> torch.Tensor:
    """Samples an (H, W, C) grid at (N, 2) query points in [0, 1].

    Points outside [0, 1] read the clamped border rows and columns, with
    the weights of their unclamped position, as the JAX op does.

    Returns:
        (N, C) interpolated values.
    """
    if grid.ndim != 3 or query_points.ndim != 2:
        raise ValueError("grid must be (height, width, dim) and query "
                         "points (N, 2)")
    height, width, _ = grid.shape
    col = query_points[:, 0] * width
    row = query_points[:, 1] * height

    i0 = torch.floor(row).to(torch.int64)
    j0 = torch.floor(col).to(torch.int64)
    di = (row - i0)[:, None]
    dj = (col - j0)[:, None]

    i1 = torch.clamp(i0 + 1, 0, height - 1)
    j1 = torch.clamp(j0 + 1, 0, width - 1)
    i0 = torch.clamp(i0, 0, height - 1)
    j0 = torch.clamp(j0, 0, width - 1)

    v00 = (1 - di) * (1 - dj) * grid[i0, j0, :]
    v01 = (1 - di) * dj * grid[i0, j1, :]
    v10 = di * (1 - dj) * grid[i1, j0, :]
    v11 = di * dj * grid[i1, j1, :]
    return v00 + v01 + v10 + v11
