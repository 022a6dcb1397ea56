"""The Fourier Feature MLP family as ``nn.Module``s.

Port of ``fourier_feature_nets_tpu/models/fourier.py``: an MLP preceded
by gamma(x) = [a*cos(pi x B), a*sin(pi x B)]. The (a, B) matrices are
registered buffers (not trained), so they move with the module and sit
in its state dict, as in the reference's ``.pt`` files. Without B the
inputs pass through unencoded (the plain MLP).
"""

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..ops.encoding import (
    basic_encoding_matrix,
    fourier_encode,
    gaussian_encoding_matrix,
    positional_encoding_matrix,
)
from .module import mlp_apply, mlp_layers

__all__ = ["FourierFeatureMLP", "MLP", "BasicFourierMLP",
           "PositionalFourierMLP", "GaussianFourierMLP"]


def _buffer(values) -> Optional[torch.Tensor]:
    if values is None:
        return None
    return torch.from_numpy(np.array(values, np.float32))


class FourierFeatureMLP(nn.Module):
    """MLP with a Fourier-feature preprocessing stage: ``b_values`` is
    (num_inputs, E), ``a_values`` (E,)."""

    model_type = "fourier"
    use_view = False

    def __init__(self, num_inputs: int, num_outputs: int,
                 a_values: Optional[np.ndarray],
                 b_values: Optional[np.ndarray],
                 layer_channels: List[int],
                 generator: Optional[torch.Generator] = None):
        """Builds the layers on the CPU, drawing every weight and bias
        from ``generator`` (torch.nn.Linear's default scheme); move the
        model with ``.to(device)``."""
        super().__init__()
        self.num_inputs = num_inputs
        self.num_outputs = num_outputs
        self.layer_channels = list(layer_channels)
        self.register_buffer("b_values", _buffer(b_values))
        self.register_buffer("a_values",
                             None if b_values is None else _buffer(a_values))
        if self.b_values is None:
            num_encoded = num_inputs
        else:
            if self.b_values.shape[0] != num_inputs:
                raise ValueError(f"b_values {tuple(self.b_values.shape)} "
                                 f"does not take {num_inputs} inputs")
            if self.a_values.shape != self.b_values.shape[1:]:
                raise ValueError(f"a_values {tuple(self.a_values.shape)} "
                                 f"does not match b_values "
                                 f"{tuple(self.b_values.shape)}")
            num_encoded = 2 * self.b_values.shape[1]
        self.layers = mlp_layers(num_encoded, self.layer_channels,
                                 num_outputs, generator)

    @property
    def params_manifest(self) -> dict:
        """Constructor arguments, persisted in checkpoints (the JAX
        package's manifest)."""
        def listed(values):
            return None if values is None else values.cpu().tolist()
        return {
            "num_inputs": self.num_inputs,
            "num_outputs": self.num_outputs,
            "a_values": listed(self.a_values),
            "b_values": listed(self.b_values),
            "layer_channels": self.layer_channels,
        }

    def encode(self, inputs: torch.Tensor) -> torch.Tensor:
        """The Fourier feature encoding of (N, num_inputs) inputs (the
        identity without B)."""
        if self.b_values is None:
            return inputs
        return fourier_encode(inputs, self.b_values, self.a_values)

    def forward(self, inputs: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None,
                return_hidden: bool = False):
        """(..., num_inputs) coordinates -> (..., num_outputs); with
        ``return_hidden`` also the (..., C) last hidden activations."""
        lead = inputs.shape[:-1]
        result = mlp_apply(self.layers,
                           self.encode(inputs.reshape(-1, self.num_inputs)),
                           compute_dtype, return_hidden)
        if return_hidden:
            output, hidden = result
            return (output.reshape(*lead, -1), hidden.reshape(*lead, -1))
        return result.reshape(*lead, -1)


class MLP(FourierFeatureMLP):
    """Unencoded baseline MLP."""

    def __init__(self, num_inputs: int, num_outputs: int, num_layers=3,
                 num_channels=256,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_inputs, num_outputs, None, None,
                         [num_channels] * num_layers, generator)


class BasicFourierMLP(FourierFeatureMLP):
    """Inputs projected onto the unit circle."""

    def __init__(self, num_inputs: int, num_outputs: int, num_layers=3,
                 num_channels=256,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_inputs, num_outputs,
                         np.ones(num_inputs, np.float32),
                         basic_encoding_matrix(num_inputs),
                         [num_channels] * num_layers, generator)


class PositionalFourierMLP(FourierFeatureMLP):
    """Axis-aligned log-scale positional encoding."""

    def __init__(self, num_inputs: int, num_outputs: int,
                 max_log_scale: float, num_layers=3, num_channels=256,
                 embedding_size=256,
                 generator: Optional[torch.Generator] = None):
        b_values = positional_encoding_matrix(
            max_log_scale, embedding_size // num_inputs, num_inputs)
        super().__init__(num_inputs, num_outputs,
                         np.ones(b_values.shape[1], np.float32), b_values,
                         [num_channels] * num_layers, generator)


class GaussianFourierMLP(FourierFeatureMLP):
    """Full random-Gaussian encoding: B ~ N(0, sigma), drawn from
    ``generator`` before the layers are."""

    def __init__(self, num_inputs: int, num_outputs: int, sigma: float,
                 num_layers=3, num_channels=256, embedding_size=256,
                 generator: Optional[torch.Generator] = None):
        b_values = gaussian_encoding_matrix(generator, sigma, num_inputs,
                                            embedding_size)
        super().__init__(num_inputs, num_outputs,
                         np.ones(b_values.shape[1], np.float32), b_values,
                         [num_channels] * num_layers, generator)
