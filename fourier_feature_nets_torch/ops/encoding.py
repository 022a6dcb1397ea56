"""Positional-encoding frequency matrices and the f32 phase product.

Port of ``positional_encoding_matrix`` from
``fourier_feature_nets_tpu/ops/encoding.py``. The NeRF encodings apply
no pi scale and no amplitudes.
"""

import numpy as np
import torch

__all__ = ["positional_encoding_matrix", "encode_phases"]


def positional_encoding_matrix(max_log_scale: float, num_frequencies: int,
                               num_inputs: int) -> np.ndarray:
    """Axis-aligned log-spaced frequency matrix.

    Produces a (num_inputs, num_frequencies * num_inputs) matrix whose
    columns are ``2**linspace(0, max_log_scale, num_frequencies)``
    times the identity (frequency-major, axis-minor layout).
    """
    frequencies = 2.0 ** np.linspace(0, max_log_scale, num_frequencies,
                                     dtype=np.float64)
    blocks = frequencies[:, None, None] * np.eye(num_inputs)[None]
    return blocks.reshape(-1, num_inputs).T.astype(np.float32)


def encode_phases(x: torch.Tensor, encoding: torch.Tensor) -> torch.Tensor:
    """(N, 3) @ (3, E) as three f32 broadcast multiply-adds.

    Phases reach ``2**max_log_scale * |x|`` (512|x| for the flagship),
    so the product must stay in full f32: a TF32 or bf16 matmul would
    move them by whole radians.
    """
    return (x[:, 0:1] * encoding[0] + x[:, 1:2] * encoding[1]
            + x[:, 2:3] * encoding[2])
