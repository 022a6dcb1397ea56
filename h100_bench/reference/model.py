"""The NeRF MLP in plain float32 PyTorch (Mildenhall et al. 2020, section
5 and figure 7, with the project's widths).

Each input is encoded as [cos(x B), sin(x B), x] with B the
axis-aligned frequencies ``2 ** linspace(0, max_log_scale, F)`` in
frequency-major order. The body is ReLU layers of ``num_channels``,
with the encoded position concatenated again before each skip layer.
The opacity logit is read from the body; the color comes from a
bottleneck, concatenated with the encoded view, through a ReLU layer of
half width. The output is (N, 4): three color logits, then opacity.

``quant="fp8"`` rounds both operands of every product, forward and
backward, to float8 e4m3 with a per-tensor scale: the nearest precision
below the configurations' bf16, the benchmark's control.
"""

import torch
from torch import nn

from ..counts.nerf import layer_shapes

__all__ = ["PlainNeRF", "fp8_round"]

_E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a scale that maps its largest
    magnitude to the format's largest value."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Product(torch.autograd.Function):
    """``x @ w.T`` with every product's operands rounded to fp8."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.T

    @staticmethod
    def backward(ctx, grad):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(grad)
        return gq @ wq, gq.T @ xq


def _frequencies(max_log_scale: float, count: int, device) -> torch.Tensor:
    values = [2.0 ** (max_log_scale * i / (count - 1)) if count > 1 else 1.0
              for i in range(count)]
    return torch.tensor(values, dtype=torch.float32, device=device)


class PlainNeRF(nn.Module):
    """The reference model; parameters named as the configuration's
    leaves (``layers.i``, ``opacity_out``, ``bottleneck``,
    ``hidden_view``, ``color_out``)."""

    def __init__(self, cfg: dict, device):
        super().__init__()
        self.cfg = cfg
        self.skips = set(cfg["skips"])
        self.include_inputs = cfg["include_inputs"]
        shapes = layer_shapes(cfg)
        body = shapes[:cfg["num_layers"]]
        self.layers = nn.ModuleList(
            [nn.Linear(i, o, device=device) for _, i, o in body])
        heads = {name: nn.Linear(i, o, device=device)
                 for name, i, o in shapes[cfg["num_layers"]:]}
        self.opacity_out = heads["opacity_out"]
        self.bottleneck = heads["bottleneck"]
        self.hidden_view = heads["hidden_view"]
        self.color_out = heads["color_out"]
        self.register_buffer("freq_pos", _frequencies(
            cfg["max_log_scale_pos"], cfg["num_freq_pos"], device))
        self.register_buffer("freq_view", _frequencies(
            cfg["max_log_scale_view"], cfg["num_freq_view"], device))

    def _encode(self, x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
        phases = (x[:, None, :] * freqs[None, :, None]).reshape(x.shape[0],
                                                                -1)
        parts = [torch.cos(phases), torch.sin(phases)]
        if self.include_inputs:
            parts.append(x)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def _dense(layer: nn.Linear, x: torch.Tensor, quant) -> torch.Tensor:
        if quant == "fp8":
            return _Fp8Product.apply(x, layer.weight) + layer.bias
        return x @ layer.weight.T + layer.bias

    def forward(self, position: torch.Tensor, view: torch.Tensor,
                quant=None) -> torch.Tensor:
        encoded_pos = self._encode(position, self.freq_pos)
        encoded_view = self._encode(view, self.freq_view)
        hidden = encoded_pos
        for i, layer in enumerate(self.layers):
            if i in self.skips:
                hidden = torch.cat([hidden, encoded_pos], dim=-1)
            hidden = torch.relu(self._dense(layer, hidden, quant))
        opacity = self._dense(self.opacity_out, hidden, quant)
        bottleneck = self._dense(self.bottleneck, hidden, quant)
        hidden = torch.relu(self._dense(
            self.hidden_view, torch.cat([bottleneck, encoded_view], dim=-1),
            quant))
        color = self._dense(self.color_out, hidden, quant)
        return torch.cat([color, opacity], dim=-1)
