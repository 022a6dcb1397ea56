"""Trilinear voxel radiance field as an ``nn.Module``.

Port of ``fourier_feature_nets_tpu/models/voxels.py``: a learnable
grid, queried by trilinear interpolation with border clamping, plus a
learnable per-channel bias initialized to logit(1e-5) for color and -2
for opacity. The lookup is ``F.grid_sample(padding_mode="border",
align_corners=False)``, the call the JAX package's
``ops/grid_sample.py`` reproduces; its gradient is grid_sample's own
backward (the JAX package's cell-binned VJP is a TPU workaround).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .module import logit

__all__ = ["Voxels"]


class Voxels(nn.Module):
    """A voxel-based radiance field model."""

    model_type = "voxels"
    use_view = False

    def __init__(self, side: int, scale: float):
        """Constructor.

        Args:
            side: voxels per cube edge.
            scale: half-extent of the volume (scale 1 = 2x2x2 volume).
        """
        super().__init__()
        self.side = side
        self.scale = scale
        # (1, 4, D, H, W), the reference's layout; the JAX package keeps
        # (D, H, W, 4)
        self.voxels = nn.Parameter(torch.zeros(1, 4, side, side, side))
        self.bias = nn.Parameter(
            torch.tensor([logit(1e-5)] * 3 + [-2.0], dtype=torch.float32))

    @property
    def params_manifest(self) -> dict:
        return {"side": self.side, "scale": self.scale}

    def forward(self, positions: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(N, 3) world positions (divided by ``scale`` into the [-1, 1]
        grid domain) -> (N, 4) color + opacity logits. A gather and a
        lerp: there is no product to run in ``compute_dtype``."""
        del compute_dtype
        coords = positions.reshape(1, 1, 1, -1, 3) / self.scale
        output = F.grid_sample(self.voxels, coords, mode="bilinear",
                               padding_mode="border", align_corners=False)
        return output.reshape(4, -1).T + self.bias
