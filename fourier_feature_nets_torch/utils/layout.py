"""The weight layouts of the JAX package, keyed by a parameter's path.

A parameter, or its Adam moment, lives in the module in torch's layout
and in a JAX-package checkpoint in JAX's: a Linear weight (out, in)
here and (in, out) there, a grid (``voxels``, a plane of factorized
voxels) (1, C, ...) here and (..., C) there. The rule reads the path
alone (``layers/0/weight``, ``voxels``, ``plane_xy``, ...), so the
checkpoint and optimizer code need no model to apply it.
"""

import numpy as np

__all__ = ["from_jax_layout", "to_jax_layout"]

# the paths of grids the module keeps as (1, C, ...) and the JAX package
# as (..., C)
_GRIDS = ("voxels", "plane_xy", "plane_xz", "plane_yz")


def to_jax_layout(path: str, value: np.ndarray) -> np.ndarray:
    """A parameter's (or its Adam moment's) value at ``path`` in the JAX
    package's layout: a Linear weight transposed to (in, out), a grid
    from (1, C, ...) to (..., C); anything else as it is."""
    if path.rsplit("/", 1)[-1] == "weight":
        return value.T
    if path in _GRIDS:
        return np.moveaxis(value[0], 0, -1)
    return value


def from_jax_layout(path: str, value: np.ndarray) -> np.ndarray:
    """The inverse of :func:`to_jax_layout`."""
    if path.rsplit("/", 1)[-1] == "weight":
        return value.T
    if path in _GRIDS:
        return np.moveaxis(value, -1, 0)[None]
    return value
