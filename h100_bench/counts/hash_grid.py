"""Frozen operation and byte counts of Instant-NGP's NeRF and of its hash
encoding's kernels (``kernels/csrc/hash_grid.cu``), with their bound at
the card's memory rate (``counts/h100.py``).

The counts follow from a configuration's widths alone, whatever code
computes the model: a later change to a kernel cannot move them.

* A point's forward is 2 x its multiply-adds: the MLPs' ``fan_in x
  fan_out`` each (9,408 at the published widths: density 32x64 + 64x16,
  color 32x64 + 64x64 + 64x3) and the encoding's blend, each level's 8
  corners x 2 features (256). The corner weights, the index arithmetic
  and the harmonics are not counted, as the NeRF's counts leave out its
  sines and cosines. A point trained is 3 forwards, as the NeRF counts it.
* The encoding's least time on N points is its compulsory bytes at the
  HBM rate: the forward reads each point's 12-byte position and every
  table row once and writes the features at their stored width (bf16 in
  a bf16 configuration); the backward reads the features' gradient and
  the positions and writes the table's f32 gradient once. The same bytes
  whatever implements it.
"""

from h100_bench.counts.h100 import PEAK_HBM_BYTES_PER_S
from h100_bench.reference.hash_grid import grid_levels

__all__ = ["table_rows", "layer_shapes", "matmul_macs", "interpolation_macs",
           "forward_flops", "step_flops", "pass_bytes", "forward_bounds",
           "step_bounds"]


def table_rows(cfg: dict) -> int:
    """Rows of the table, every level's."""
    return sum(level[2] for level in grid_levels(cfg))


def layer_shapes(cfg: dict):
    """[(name, fan_in, fan_out)] of every MLP layer, in the order the
    model registers them."""
    density = ([2 * cfg["n_levels"]]
               + [cfg["density_neurons"]] * cfg["density_hidden_layers"]
               + [cfg["density_outputs"]])
    color = ([cfg["density_outputs"] + cfg["sh_degree"] ** 2]
             + [cfg["color_neurons"]] * cfg["color_hidden_layers"] + [3])
    return ([(f"density.{i}", a, b)
             for i, (a, b) in enumerate(zip(density[:-1], density[1:]))]
            + [(f"color.{i}", a, b)
               for i, (a, b) in enumerate(zip(color[:-1], color[1:]))])


def matmul_macs(cfg: dict) -> int:
    """Multiply-adds of one point's MLP layers."""
    return sum(fan_in * fan_out for _, fan_in, fan_out in layer_shapes(cfg))


def interpolation_macs(cfg: dict) -> int:
    """Multiply-adds of one point's blend: 8 corners x the features of
    every level."""
    return 8 * cfg["n_levels"] * cfg["n_features_per_level"]


def forward_flops(cfg: dict) -> int:
    """Operations of one point's forward pass."""
    return 2 * (matmul_macs(cfg) + interpolation_macs(cfg))


def step_flops(cfg: dict) -> int:
    """Operations of one point trained: the forward, and the backward at
    twice its cost."""
    return 3 * forward_flops(cfg)


def _feature_bytes(cfg: dict) -> int:
    """A point's features at their stored width."""
    width = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    return width * cfg["n_levels"] * cfg["n_features_per_level"]


def pass_bytes(cfg: dict, points: int) -> int:
    """The compulsory bytes of the encode on ``points`` points, and
    equally of its backward: a 12-byte position and the features (or
    their gradient) at their stored width a point, and every table row
    (or its gradient's) once."""
    table = 4 * cfg["n_features_per_level"] * table_rows(cfg)
    return points * (12 + _feature_bytes(cfg)) + table


def forward_bounds(cfg: dict, points: int) -> dict:
    """The least seconds of the encode kernel on ``points``."""
    return {"hash_bound_s": pass_bytes(cfg, points) / PEAK_HBM_BYTES_PER_S}


def step_bounds(cfg: dict, points: int) -> dict:
    """The least seconds of the encode and backward kernels of a training
    step on ``points``."""
    return {"hash_bound_s": 2 * pass_bytes(cfg, points)
            / PEAK_HBM_BYTES_PER_S}
