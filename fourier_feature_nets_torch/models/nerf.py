"""The full NeRF model as an ``nn.Module``.

Port of ``fourier_feature_nets_tpu/models/nerf.py``: separate
positional/view encodings (no pi scale, optional raw-input concat), a
ReLU body whose skip layers re-concatenate the encoded position, a
view-independent opacity head, and a bottleneck -> encoded view ->
half-width hidden layer -> color head.

Output is (N, 4) raw logits: RGB color logits + opacity logit.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.encoding import encode_phases, positional_encoding_matrix
from .module import Linear, linear_apply

__all__ = ["NeRF", "flagship_nerf"]


class NeRF(nn.Module):
    """NeRF radiance field MLP with view dependence."""

    model_type = "nerf"
    use_view = True

    def __init__(self, num_layers: int, num_channels: int,
                 max_log_scale_pos: float, num_freq_pos: int,
                 max_log_scale_view: float, num_freq_view: int,
                 skips: Sequence[int], include_inputs: bool,
                 generator: Optional[torch.Generator] = None):
        """Builds the layers on the CPU, drawing every weight and bias
        from ``generator`` (torch.nn.Linear's default scheme); move the
        model with ``.to(device)``."""
        super().__init__()
        self.num_layers = num_layers
        self.num_channels = num_channels
        self.max_log_scale_pos = max_log_scale_pos
        self.num_freq_pos = num_freq_pos
        self.max_log_scale_view = max_log_scale_view
        self.num_freq_view = num_freq_view
        self.skips = set(skips)
        self.include_inputs = include_inputs

        self.register_buffer("pos_encoding", torch.from_numpy(
            positional_encoding_matrix(max_log_scale_pos, num_freq_pos, 3)))
        self.register_buffer("view_encoding", torch.from_numpy(
            positional_encoding_matrix(max_log_scale_view, num_freq_view,
                                       3)))
        self.num_pos_encoded = 2 * self.pos_encoding.shape[-1] + (
            3 if include_inputs else 0)
        self.num_view_encoded = 2 * self.view_encoding.shape[-1] + (
            3 if include_inputs else 0)

        layers = []
        layer_inputs = self.num_pos_encoded
        for i in range(num_layers):
            if i in self.skips:
                layer_inputs += self.num_pos_encoded
            layers.append(Linear(layer_inputs, num_channels, generator))
            layer_inputs = num_channels
        self.layers = nn.ModuleList(layers)
        self.opacity_out = Linear(layer_inputs, 1, generator)
        self.bottleneck = Linear(layer_inputs, num_channels, generator)
        self.hidden_view = Linear(num_channels + self.num_view_encoded,
                                  num_channels // 2, generator)
        self.color_out = Linear(num_channels // 2, 3, generator)

    @property
    def params_manifest(self) -> dict:
        """Constructor arguments, persisted in checkpoints."""
        return {
            "num_layers": self.num_layers,
            "num_channels": self.num_channels,
            "max_log_scale_pos": self.max_log_scale_pos,
            "num_freq_pos": self.num_freq_pos,
            "max_log_scale_view": self.max_log_scale_view,
            "num_freq_view": self.num_freq_view,
            "skips": sorted(self.skips),
            "include_inputs": self.include_inputs,
        }

    def _encode(self, x: torch.Tensor,
                encoding: torch.Tensor) -> torch.Tensor:
        """[cos(xB), sin(xB)] (+ raw x), phases in full f32."""
        phases = encode_phases(x, encoding)
        parts = [torch.cos(phases), torch.sin(phases)]
        if self.include_inputs:
            parts.append(x)
        return torch.cat(parts, dim=-1)

    def forward(self, position: torch.Tensor, view: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
        """Queries the radiance field.

        Args:
            position: (N, 3) positions.
            view: (N, 3) normalized view directions.
            compute_dtype: optional matmul dtype (e.g. torch.bfloat16).

        Returns:
            (N, 4) color + opacity logits.
        """
        encoded_pos = self._encode(position, self.pos_encoding)
        encoded_view = self._encode(view, self.view_encoding)

        outputs = encoded_pos
        for i, layer in enumerate(self.layers):
            if i in self.skips:
                outputs = torch.cat([outputs, encoded_pos], dim=-1)
            outputs = torch.relu(linear_apply(layer, outputs, compute_dtype))

        opacity = linear_apply(self.opacity_out, outputs, compute_dtype)
        bottleneck = linear_apply(self.bottleneck, outputs, compute_dtype)

        outputs = torch.cat([bottleneck, encoded_view], dim=-1)
        outputs = torch.relu(
            linear_apply(self.hidden_view, outputs, compute_dtype))
        color = linear_apply(self.color_out, outputs, compute_dtype)
        return torch.cat([color, opacity], dim=-1)


def flagship_nerf(generator: Optional[torch.Generator] = None) -> NeRF:
    """The flagship full-NeRF configuration: 8x256, pos 10 freq /
    log-scale 9, view 4 freq / log-scale 3, skip at 4, raw inputs."""
    return NeRF(num_layers=8, num_channels=256, max_log_scale_pos=9.0,
                num_freq_pos=10, max_log_scale_view=3.0, num_freq_view=4,
                skips=[4], include_inputs=True, generator=generator)
