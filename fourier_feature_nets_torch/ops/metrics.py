"""Quality metrics (port of ``fourier_feature_nets_tpu/ops/metrics.py``).

:func:`mse` and :func:`psnr` take tensors; :func:`psnr_from_mse` takes a
float or an array on the host, as the distill CLI's evaluation gives it.
"""

import numpy as np
import torch

__all__ = ["mse", "psnr", "psnr_from_mse"]


def mse(prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error."""
    return torch.mean(torch.square(prediction - target))


def psnr_from_mse(value):
    """PSNR = -10 * log10(mse)."""
    return -10.0 * np.log10(value)


def psnr(prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio between prediction and target."""
    return -10.0 * torch.log10(mse(prediction, target))
