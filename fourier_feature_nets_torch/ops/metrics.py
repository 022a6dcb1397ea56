"""Quality metrics (port of ``psnr_from_mse`` of
``fourier_feature_nets_tpu/ops/metrics.py``, what the distill CLI's
evaluation needs)."""

import numpy as np

__all__ = ["psnr_from_mse"]


def psnr_from_mse(value):
    """PSNR = -10 * log10(mse)."""
    return -10.0 * np.log10(value)
