"""Factorized (TensoRF-VM style) voxel radiance field as an ``nn.Module``.

Port of ``fourier_feature_nets_tpu/models/factorized.py``, the same
function: the (side, side, side, C) volume is a vector-matrix
decomposition

    G[x, y, z, :] = sum_r  M_xy[x, y, r] * v_z[z, r] * B[r]
                  + sum_r  M_xz[x, z, r] * v_y[y, r] * B[R + r]
                  + sum_r  M_yz[y, z, r] * v_x[x, r] * B[2R + r]

queried by bilinear interpolation of each plane and linear
interpolation of each vector, with coordinates clamped to the grid's
border (the JAX package's ``clip(grid, 0, side - 1)``). The JAX package
evaluates the interpolations as dense "hat"-vector matmuls, a TPU
workaround for slow gathers; here they are gathers: ``F.grid_sample``
(``align_corners=False``, ``padding_mode="border"``: the same cell
coordinate and the same clamp) on each plane and on each vector, read
as a one-row image. (An indexed two-tap lerp computes the same, but
its backward, a sorted index accumulate, took 12.9 of a train step's
16.1 ms of device time on an H100.)

Layouts: a plane is (1, R, side, side), its first axis the JAX plane's
first (``plane_xy[0, r, x, y]``), so ``F.grid_sample`` reads it with
(y, x) grid coordinates; a vector is (side, R), as in the JAX package.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .module import Linear, linear_apply, logit

__all__ = ["FactorizedVoxels"]

# (plane axes, vector axis) of the three VM components, as indices into
# (x, y, z), with the names of their plane and vector
_COMPONENTS = (((0, 1), 2, "xy", "z"), ((0, 2), 1, "xz", "y"),
               ((1, 2), 0, "yz", "x"))


def _sample(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """(1, R, H, W) image at (1, 1, N, 2) grid coordinates -> (N, R):
    bilinear, clamped to the border, ``align_corners=False``."""
    out = F.grid_sample(image, grid, mode="bilinear", padding_mode="border",
                        align_corners=False)
    return out.reshape(image.shape[1], -1).T


class FactorizedVoxels(nn.Module):
    """Vector-matrix factorized voxel radiance field."""

    model_type = "factorized_voxels"
    use_view = False

    def __init__(self, side: int, scale: float, rank: int = 16,
                 init_scale: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        """Constructor.

        Args:
            side: factor resolution per axis (the virtual dense grid
                is side^3).
            scale: half-extent of the volume (scale 1 = 2x2x2 volume).
            rank: components per VM term (3 * rank features in all).
            init_scale: standard deviation of the factors' init.
            generator: draws the planes (xy, xz, yz), the vectors
                (z, y, x) and then the basis layer, on the CPU.
        """
        super().__init__()
        self.side = side
        self.scale = scale
        self.rank = rank
        self.init_scale = init_scale

        def normal(*shape):
            return nn.Parameter(init_scale * torch.randn(
                shape, generator=generator))

        for _, _, plane, _ in _COMPONENTS:
            setattr(self, f"plane_{plane}", normal(1, rank, side, side))
        for _, _, _, vector in _COMPONENTS:
            setattr(self, f"vector_{vector}", normal(side, rank))
        self.basis = Linear(3 * rank, 4, generator)
        self.bias = nn.Parameter(
            torch.tensor([logit(1e-5)] * 3 + [-2.0], dtype=torch.float32))

    @property
    def params_manifest(self) -> dict:
        return {"side": self.side, "scale": self.scale,
                "rank": self.rank, "init_scale": self.init_scale}

    def forward(self, positions: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(N, 3) world positions -> (N, 4) color + opacity logits (the
        contract of :class:`~.voxels.Voxels`). With ``compute_dtype`` the
        factors are rounded to it, and the basis layer runs in it."""
        coords = positions.reshape(-1, 3) / self.scale
        features = []
        for (axis_a, axis_b), axis_v, plane, vector in _COMPONENTS:
            plane = getattr(self, f"plane_{plane}")
            vector = getattr(self, f"vector_{vector}")
            if compute_dtype is not None:
                plane = plane.to(compute_dtype).float()
                vector = vector.to(compute_dtype).float()
            # grid_sample's last grid axis holds (W, H) coordinates: the
            # plane's second axis, then its first
            grid = torch.stack([coords[:, axis_b], coords[:, axis_a]],
                               -1).reshape(1, 1, -1, 2)
            # a vector is a one-row image: H = 1 puts the row coordinate
            # 0 on its only row, so this is the clamped two-tap lerp
            # along W
            row = torch.stack([coords[:, axis_v],
                               torch.zeros_like(coords[:, axis_v])], -1)
            features.append(
                _sample(plane, grid)
                * _sample(vector.T.reshape(1, self.rank, 1, self.side),
                          row.reshape(1, 1, -1, 2)))
        out = linear_apply(self.basis, torch.cat(features, dim=-1),
                           compute_dtype)
        return out + self.bias

    def dense_grid(self) -> torch.Tensor:
        """The virtual (side, side, side, 4) dense grid, indexed [x, y,
        z] as the JAX package's ``dense_grid`` (for inspection; not on
        the query path)."""
        side, rank = self.side, self.rank
        features = []
        for (axis_a, axis_b), axis_v, plane, vector in _COMPONENTS:
            shape_p = [1, 1, 1, rank]
            shape_p[axis_a] = side
            shape_p[axis_b] = side
            shape_v = [1, 1, 1, rank]
            shape_v[axis_v] = side
            plane = getattr(self, f"plane_{plane}")[0].permute(1, 2, 0)
            vector = getattr(self, f"vector_{vector}")
            features.append((plane.reshape(shape_p) * vector.reshape(shape_v))
                            .expand(side, side, side, rank))
        out = linear_apply(self.basis, torch.cat(features, dim=-1))
        return out + self.bias
