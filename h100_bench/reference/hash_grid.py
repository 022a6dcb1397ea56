"""Instant-NGP's NeRF in plain float32 PyTorch (Müller et al., "Instant
Neural Graphics Primitives with a Multiresolution Hash Encoding", SIGGRAPH
2022, arXiv:2201.05989, sections 3, 4 and 5.4; instant-ngp's
``configs/nerf/base.json``).

A position ``p`` in the box ``[-scale, scale]^3`` maps to ``x = clamp((p /
scale + 1) / 2, 0, 1)``. Level ``l`` of ``n_levels`` has the scale ``s_l =
base * b^l - 1`` (``b`` the ``per_level_scale``), ``res_l = ceil(s_l) + 1``
and ``n_l = min(roundup8(res_l^3), 2^log2_hashmap_size)`` rows of two
features. With ``q = x s_l + 0.5``, ``c0 = floor(q)`` and ``w = q - c0``,
each corner ``c0 + {0,1}^3`` weighs ``prod_d (w_d or 1 - w_d)``; its row is
``c_x + c_y res_l + c_z res_l^2`` where ``res_l^3 <= n_l``, else
``c_x ^ c_y 2654435761 ^ c_z 805459861`` (tiny-cuda-nn's hash; in int64
the low bits of the XOR of the whole products are the uint32 products'),
modulo ``n_l``. The levels' features, concatenated level-major, go through
the density MLP (``density_neurons`` x ``density_hidden_layers`` ->
``density_outputs``), whose output 0 is the opacity logit; its outputs and
the 16 real spherical harmonics of bands 0-3 of the normalized view go
through the color MLP (``color_neurons`` x ``color_hidden_layers`` -> 3).
ReLU between layers, no biases. The output is (N, 4): three color logits,
then opacity. The gather is int64 indexing, its backward autograd's
scatter-add.

Departures from the paper, each also under ``assumed`` in
``configs/instant-ngp.json``:

* the clamp of ``x`` to the unit cube, so that a sample rounded out of
  the box does not wrap;
* the opacity logit becomes a density by softplus (the harness's
  composite, as for the NeRF), not exp;
* float32 tables and products here, where instant-ngp keeps fp16 tables
  and fp16 MLPs (the program: f32 tables, bf16 products);
* the table drawn from U(-1e-4, 1e-4), each weight from U(-1/sqrt(fan_in),
  1/sqrt(fan_in)) (``families/hash_grid.py``).

``quant="fp8"`` (the family's control) rounds both operands of every MLP
product, forward and backward, and the interpolated features to float8
e4m3 with a per-tensor scale (``reference/model.py::fp8_round``).
"""

import math

import torch
from torch import nn

from .model import _Fp8Product, fp8_round

__all__ = ["PlainHashGridNeRF", "grid_levels", "spherical_harmonics"]

_PRIMES = (1, 2654435761, 805459861)


def grid_levels(cfg: dict):
    """[(scale, resolution, rows, offset, dense)] of every level."""
    levels, offset = [], 0
    for level in range(cfg["n_levels"]):
        scale = (cfg["base_resolution"] * cfg["per_level_scale"] ** level
                 - 1.0)
        resolution = math.ceil(scale) + 1
        rows = min(-(-resolution ** 3 // 8) * 8,
                   2 ** cfg["log2_hashmap_size"])
        levels.append((scale, resolution, rows, offset,
                       resolution ** 3 <= rows))
        offset += rows
    return levels


def spherical_harmonics(d: torch.Tensor) -> torch.Tensor:
    """(N, 3) unit directions -> (N, 16) real spherical harmonics of bands
    0 to 3 (tiny-cuda-nn's order and signs)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * x * y,
        -1.0925484305920792 * y * z,
        0.94617469575755997 * z * z - 0.31539156525251999,
        -1.0925484305920792 * x * z,
        0.54627421529603959 * (x * x - y * y),
        0.59004358992664352 * y * (3 * x * x - y * y),
        2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1 - 5 * z * z),
        0.3731763325901154 * z * (5 * z * z - 3),
        0.45704579946446572 * x * (1 - 5 * z * z),
        1.4453057213202769 * z * (x * x - y * y),
        0.59004358992664352 * x * (x * x - 3 * y * y)], dim=-1)


def _layers(num_inputs: int, neurons: int, hidden: int, outputs: int,
            device) -> nn.ModuleList:
    widths = [num_inputs] + [neurons] * hidden + [outputs]
    return nn.ModuleList([nn.Linear(i, o, bias=False, device=device)
                          for i, o in zip(widths[:-1], widths[1:])])


class PlainHashGridNeRF(nn.Module):
    """The reference model; parameters named as the configuration's
    leaves (``table``, ``density.i.weight``, ``color.i.weight``)."""

    def __init__(self, cfg: dict, device):
        super().__init__()
        if cfg["sh_degree"] != 4 or cfg["n_features_per_level"] != 2:
            raise ValueError("the reference holds 2 features a level and "
                             "harmonics of degree 4")
        self.cfg = cfg
        self.levels = grid_levels(cfg)
        rows = sum(level[2] for level in self.levels)
        self.table = nn.Parameter(torch.zeros(rows, 2, device=device))
        self.density = _layers(2 * cfg["n_levels"], cfg["density_neurons"],
                               cfg["density_hidden_layers"],
                               cfg["density_outputs"], device)
        self.color = _layers(cfg["density_outputs"] + 16,
                             cfg["color_neurons"],
                             cfg["color_hidden_layers"], 3, device)

    def encode(self, points: torch.Tensor) -> torch.Tensor:
        """(N, 3) points -> (N, 2 n_levels) interpolated features."""
        x = torch.clamp((points / self.cfg["scale"] + 1.0) / 2.0, 0.0, 1.0)
        features = []
        for scale, resolution, rows, offset, dense in self.levels:
            q = x * scale + 0.5
            low = torch.floor(q)
            w = q - low
            low = low.long()
            level = 0.0
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        cx, cy, cz = low[:, 0] + dx, low[:, 1] + dy, \
                            low[:, 2] + dz
                        if dense:
                            index = cx + cy * resolution \
                                + cz * resolution ** 2
                        else:
                            index = ((cx * _PRIMES[0]) ^ (cy * _PRIMES[1])
                                     ^ (cz * _PRIMES[2])) & 0xFFFFFFFF
                        weight = ((w[:, 0] if dx else 1 - w[:, 0])
                                  * (w[:, 1] if dy else 1 - w[:, 1])
                                  * (w[:, 2] if dz else 1 - w[:, 2]))
                        level = level + weight[:, None] \
                            * self.table[offset + index % rows]
            features.append(level)
        return torch.cat(features, dim=-1)

    @staticmethod
    def _mlp(layers: nn.ModuleList, x: torch.Tensor, quant) -> torch.Tensor:
        for i, layer in enumerate(layers):
            x = (_Fp8Product.apply(x, layer.weight) if quant == "fp8"
                 else x @ layer.weight.T)
            if i < len(layers) - 1:
                x = torch.relu(x)
        return x

    def forward(self, points: torch.Tensor, views: torch.Tensor,
                quant=None) -> torch.Tensor:
        features = self.encode(points)
        if quant == "fp8":
            features = fp8_round(features)
        density = self._mlp(self.density, features, quant)
        d = views / torch.linalg.norm(views, dim=-1, keepdim=True)
        color = self._mlp(self.color, torch.cat(
            [density, spherical_harmonics(d)], dim=-1), quant)
        return torch.cat([color, density[:, :1]], dim=-1)
