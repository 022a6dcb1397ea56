"""Fourier feature encodings: the frequency matrices and the f32 phase
product.

Port of ``fourier_feature_nets_tpu/ops/encoding.py``. The FFN family
applies gamma(x) = [a*cos(pi x B), a*sin(pi x B)] (a pi scale, because
its inputs span a range of 2); the NeRF encodings apply no pi scale and
no amplitudes.
"""

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["basic_encoding_matrix", "encode_phases", "fourier_encode",
           "gaussian_encoding_matrix", "positional_encoding_matrix"]


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


def gaussian_encoding_matrix(generator: Optional[torch.Generator],
                             sigma: float, num_inputs: int,
                             embedding_size: int) -> np.ndarray:
    """(num_inputs, embedding_size) frequencies ~ N(0, sigma), drawn from
    ``generator`` (a CPU ``torch.Generator``; the JAX package draws them
    from its PRNG, so the two packages' matrices differ by design)."""
    b = torch.randn((num_inputs, embedding_size), generator=generator)
    return (sigma * b).numpy()


def basic_encoding_matrix(num_inputs: int) -> np.ndarray:
    """Identity frequency matrix (inputs projected onto the unit
    circle)."""
    return np.eye(num_inputs, dtype=np.float32)


def encode_phases(x: torch.Tensor, encoding: torch.Tensor) -> torch.Tensor:
    """(N, d) @ (d, E) as d f32 broadcast multiply-adds.

    Phases reach ``2**max_log_scale * |x|`` (512|x| for the flagship
    NeRF, pi * 2^6 * |x| for the FFNs), so the product must stay in full
    f32: a TF32 or bf16 matmul would move them by whole radians. After
    the first product each term is one ``addcmul``, a fused
    multiply-add on the CPU, which is how XLA's CPU backend sums the JAX
    package's product: at phases of hundreds of radians one rounding
    more moves a cos by ~1e-5. (An axis-aligned matrix, the NeRF's, has
    one non-zero a column: every order gives the same phases.)
    """
    phases = x[:, 0:1] * encoding[0]
    for i in range(1, encoding.shape[0]):
        phases = torch.addcmul(phases, x[:, i:i + 1], encoding[i])
    return phases


def fourier_encode(x: torch.Tensor, b_values: torch.Tensor,
                   a_values: Optional[torch.Tensor] = None,
                   scale: float = math.pi) -> torch.Tensor:
    """gamma(x) = [a*cos(scale * x B), a*sin(scale * x B)], cos block
    first.

    Args:
        x: (N, num_inputs) coordinates.
        b_values: (num_inputs, E) frequency matrix.
        a_values: optional (E,) amplitudes.
        scale: the input scale before the product (pi for the FFN
            family, as the JAX package scales the inputs first).

    Returns:
        (N, 2E) encoded features.
    """
    phases = encode_phases(scale * x, b_values)
    cos, sin = torch.cos(phases), torch.sin(phases)
    if a_values is not None:
        cos = a_values * cos
        sin = a_values * sin
    return torch.cat([cos, sin], dim=-1)
