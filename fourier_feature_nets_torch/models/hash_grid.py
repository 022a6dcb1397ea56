"""Instant-NGP's NeRF: a multiresolution hash encoding and two small MLPs.

Müller, Evans, Schied, Keller, "Instant Neural Graphics Primitives with a
Multiresolution Hash Encoding", SIGGRAPH 2022 (arXiv:2201.05989),
sections 4 and 5.4, at instant-ngp's ``configs/nerf/base.json``: a hash
grid of 16 levels of 2 features (``log2_hashmap_size`` 19, base
resolution 16), a density MLP (64 neurons, 1 hidden layer, 16 outputs),
the view direction in the real spherical harmonics of degree 4, and a
color MLP (64 neurons, 2 hidden layers); ReLU throughout and no biases,
as tiny-cuda-nn's fused MLPs have none.

A position in the box ``[-scale, scale]^3`` is mapped to the unit cube
and clamped to it; the encoding (``kernels/hash_grid.py``: the kernel on
a CUDA device, its twin elsewhere) gives 32 features. The density MLP's
output 0 is the opacity logit; its 16 outputs and the 16 harmonics go to
the color MLP. Output is (N, 4): three color logits, then the opacity
logit, which ``Raycaster``'s composite turns into a density by softplus
(the paper uses exp).

The table is one f32 parameter of (entries, 2) rows, every level's in
turn; the encoding interpolates and the table's gradient sums in f32.
The MLP products run in ``compute_dtype`` (``F.linear`` on bf16
operands on the card), as ``query_model`` passes it.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


__all__ = ["HashGridNeRF", "harmonics_matrix", "instant_ngp",
           "spherical_harmonics"]

# instant-ngp's configs/nerf/base.json on the synthetic scene: the finest
# level 2048 over the unit cube, per_level_scale = 2^(7/15)
INSTANT_NGP = dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
                   base_resolution=16, per_level_scale=1.3819128799677760,
                   density_neurons=64, density_hidden_layers=1,
                   density_outputs=16, color_neurons=64,
                   color_hidden_layers=2, sh_degree=4, scale=1.0)
# the table's init, U(-1e-4, 1e-4) (the paper, section 4)
TABLE_INIT = 1e-4


# the real spherical harmonics of bands 0-3 in tiny-cuda-nn's order and
# signs, each {monomial of (x, y, z): coefficient}; a monomial is a tuple of
# axes (0 x, 1 y, 2 z), () the constant
_C1, _C3 = 0.59004358992664352, 0.45704579946446572
_HARMONICS = [
    {(): 0.28209479177387814},
    {(1,): -0.48860251190291987}, {(2,): 0.48860251190291987},
    {(0,): -0.48860251190291987},
    {(0, 1): 1.0925484305920792}, {(1, 2): -1.0925484305920792},
    {(2, 2): 0.94617469575755997, (): -0.31539156525251999},
    {(0, 2): -1.0925484305920792},
    {(0, 0): 0.54627421529603959, (1, 1): -0.54627421529603959},
    {(0, 0, 1): 3.0 * _C1, (1, 1, 1): -_C1},           # y (3x^2 - y^2)
    {(0, 1, 2): 2.8906114426405538},
    {(1,): _C3, (1, 2, 2): -5.0 * _C3},                 # y (1 - 5z^2)
    {(2, 2, 2): 5.0 * 0.3731763325901154,               # z (5z^2 - 3)
     (2,): -3.0 * 0.3731763325901154},
    {(0,): _C3, (0, 2, 2): -5.0 * _C3},                 # x (1 - 5z^2)
    {(0, 0, 2): 1.4453057213202769, (1, 1, 2): -1.4453057213202769},
    {(0, 0, 0): _C1, (0, 1, 1): -3.0 * _C1},           # x (x^2 - 3y^2)
]


def harmonics_matrix() -> torch.Tensor:
    """(64, 16) f32: the harmonics of bands 0 to 3 as combinations of the
    64 products ``m_a m_b m_c`` of ``m = (1, x, y, z)`` (column ``16 a +
    4 b + c``), for :func:`spherical_harmonics`."""
    matrix = torch.zeros(64, len(_HARMONICS))
    for column, terms in enumerate(_HARMONICS):
        for monomial, coefficient in terms.items():
            a, b, c = (0,) * (3 - len(monomial)) + tuple(
                axis + 1 for axis in monomial)
            matrix[16 * a + 4 * b + c, column] = coefficient
    return matrix


def spherical_harmonics(views: torch.Tensor,
                        matrix: torch.Tensor) -> torch.Tensor:
    """(N, 3) directions -> (N, 16) real spherical harmonics of the
    normalized direction, ``matrix`` from :func:`harmonics_matrix`: the
    products of ``(1, x, y, z)`` up to the third, then one f32 product
    with the coefficients (a few kernels where each harmonic written out
    takes several)."""
    d = views.float()
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    m = F.pad(d, (1, 0), value=1.0)
    products = (m[:, :, None, None] * m[:, None, :, None]
                * m[:, None, None, :]).reshape(-1, 64)
    return products @ matrix


def _mlp(num_inputs: int, neurons: int, hidden_layers: int,
         num_outputs: int, generator) -> nn.ModuleList:
    """Bias-free layers, each weight from U(-1/sqrt(fan_in),
    1/sqrt(fan_in))."""
    widths = [num_inputs] + [neurons] * hidden_layers + [num_outputs]
    layers = nn.ModuleList()
    for n_in, n_out in zip(widths[:-1], widths[1:]):
        layer = nn.Linear(n_in, n_out, bias=False)
        with torch.no_grad():
            layer.weight.uniform_(-n_in ** -0.5, n_in ** -0.5,
                                  generator=generator)
        layers.append(layer)
    return layers


def _apply(layers: nn.ModuleList, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """ReLU between the layers, none after the last; operands in
    ``dtype``."""
    for i, layer in enumerate(layers):
        x = F.linear(x.to(dtype), layer.weight.to(dtype))
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


class HashGridNeRF(nn.Module):
    """Instant-NGP's radiance field: hash grid, density MLP, spherical
    harmonics, color MLP."""

    model_type = "hash_grid_nerf"
    use_view = True

    def __init__(self, n_levels: int, n_features_per_level: int,
                 log2_hashmap_size: int, base_resolution: int,
                 per_level_scale: float, density_neurons: int,
                 density_hidden_layers: int, density_outputs: int,
                 color_neurons: int, color_hidden_layers: int,
                 sh_degree: int, scale: float,
                 generator: Optional[torch.Generator] = None):
        """Builds the parameters on the CPU, drawing them from
        ``generator``: the table from U(-1e-4, 1e-4), each MLP weight
        from U(-1/sqrt(fan_in), 1/sqrt(fan_in)); move the model with
        ``.to(device)``."""
        # imported here: the kernels' and utils' packages import this one
        from ..kernels.hash_grid import hash_grid_levels
        super().__init__()
        if n_features_per_level != 2:
            raise ValueError("the hash grid's kernel holds 2 features a "
                             "level, got n_features_per_level "
                             f"{n_features_per_level}")
        if sh_degree != 4:
            raise ValueError("the view is encoded by the harmonics of "
                             f"degree 4, got sh_degree {sh_degree}")
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.log2_hashmap_size = log2_hashmap_size
        self.base_resolution = base_resolution
        self.per_level_scale = per_level_scale
        self.density_neurons = density_neurons
        self.density_hidden_layers = density_hidden_layers
        self.density_outputs = density_outputs
        self.color_neurons = color_neurons
        self.color_hidden_layers = color_hidden_layers
        self.sh_degree = sh_degree
        self.scale = scale
        self.grid = hash_grid_levels(n_levels, log2_hashmap_size,
                                     base_resolution, per_level_scale, scale)
        table = torch.empty(self.grid.entries, n_features_per_level)
        table.uniform_(-TABLE_INIT, TABLE_INIT, generator=generator)
        self.table = nn.Parameter(table)
        self.density = _mlp(n_levels * n_features_per_level, density_neurons,
                            density_hidden_layers, density_outputs,
                            generator)
        self.color = _mlp(density_outputs + len(_HARMONICS), color_neurons,
                          color_hidden_layers, 3, generator)
        self.register_buffer("harmonics", harmonics_matrix(),
                             persistent=False)

    @property
    def params_manifest(self) -> dict:
        """Constructor arguments, persisted in checkpoints."""
        return {name: getattr(self, name) for name in INSTANT_NGP}

    def forward(self, position: torch.Tensor, view: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
        """Queries the radiance field.

        Args:
            position: (N, 3) positions.
            view: (N, 3) view directions (normalized here).
            compute_dtype: optional dtype of the encoding's output and of
                the MLPs' operands (e.g. torch.bfloat16).

        Returns:
            (N, 4) color + opacity logits, f32.
        """
        from ..kernels.hash_grid import hash_grid_apply
        from ..utils.tracing import span
        dtype = compute_dtype or torch.float32
        with span("hash_grid.encode", points=position.shape[0],
                  levels=self.n_levels):
            features = hash_grid_apply(self.table, position, self.grid,
                                       dtype)
        density = _apply(self.density, features, dtype)
        harmonics = spherical_harmonics(view, self.harmonics)
        color = _apply(self.color, torch.cat(
            [density, harmonics.to(dtype)], -1), dtype)
        return torch.cat([color, density[:, :1]], -1).float()


def instant_ngp(generator: Optional[torch.Generator] = None
                ) -> HashGridNeRF:
    """Instant-NGP's NeRF at ``configs/nerf/base.json``'s widths: 16
    levels of 2 features, 2^19 entries a level at most, base resolution
    16, density 64 x 1 -> 16, color 64 x 2 -> 3, harmonics of degree 4,
    in the box [-1, 1]^3."""
    return HashGridNeRF(**INSTANT_NGP, generator=generator)
