"""Multiresolution hash encoding: a Hopper kernel and its plain twin.

Instant-NGP's encoding (Müller et al. 2022, arXiv:2201.05989, section 3;
tiny-cuda-nn's ``GridEncoding``) maps a position to the trilinear
interpolation of a learnt table at each of ``L`` levels of growing
resolution. The CUDA kernels (``csrc/hash_grid.cu``) replace no TPU
kernel: the JAX package has no hash grid. Plain PyTorch would build an
int64 index tensor of L x 8 corners a point (1 KB a point) and scatter
the backward with ``index_put_``; the kernels compute the corners in
registers, gather the table and scatter its gradient with ``float2``
atomics. The source comment says what bounds them on an H100.

* :class:`HashGridLevels` is the levels' geometry: each level's scale,
  resolution, entry count, offset in the one table of ``(entries, 2)``
  and whether it is indexed densely or by the spatial hash.
* :func:`corner_indices` and :func:`hash_grid_encode_reference` /
  :func:`hash_grid_backward_reference` are the plain twin, in the
  kernels' order of operations.
* :func:`hash_grid_encode` and :func:`hash_grid_backward` launch the
  kernels for CUDA tensors and run the twin for CPU tensors; a CUDA call
  launches or raises. Each launch adds one to its wrapper's
  ``launches``; the encode also adds its points to
  ``hash_grid_encode.points``.
* :func:`hash_grid_apply` is the differentiable encoding
  (:class:`HashGridEncode`): positions take no gradient.
"""

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .launch import INT, LONG, PTR, KernelLibrary, on_cuda

__all__ = ["HashGridEncode", "HashGridLevels", "PRIMES", "corner_indices",
           "hash_grid_apply", "hash_grid_backward",
           "hash_grid_backward_reference", "hash_grid_encode",
           "hash_grid_encode_reference", "hash_grid_levels", "load_kernel"]

# tiny-cuda-nn's coherent prime hash, one prime an axis (x's is 1)
PRIMES = (1, 2654435761, 805459861)
# the kernels' largest level count (csrc/hash_grid.cu, kMaxLevels)
MAX_LEVELS = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class HashGridLevels(NamedTuple):
    """The geometry of a hash grid's levels, each a NumPy array of one
    entry a level: ``scales`` (f32, ``s_l``), ``resolutions``
    (``res_l``), ``sizes`` (entries ``n_l``), ``offsets`` (the level's
    first row in the table) and ``dense`` (indexed as a dense grid, not
    hashed); ``entries`` is the table's row count and ``box`` the scene's
    half extent."""

    scales: np.ndarray
    resolutions: np.ndarray
    sizes: np.ndarray
    offsets: np.ndarray
    dense: np.ndarray
    entries: int
    box: float

    @property
    def levels(self) -> int:
        return len(self.scales)

    @property
    def meta(self) -> np.ndarray:
        """(L, 4) int64 rows of offset, size, resolution and dense, as
        the kernels read them."""
        return np.ascontiguousarray(np.stack(
            [self.offsets, self.sizes, self.resolutions,
             self.dense.astype(np.int64)], -1).astype(np.int64))


def hash_grid_levels(n_levels: int, log2_hashmap_size: int,
                     base_resolution: int, per_level_scale: float,
                     box: float = 1.0) -> HashGridLevels:
    """The levels of instant-ngp's grid: ``s_l = base * b^l - 1``,
    ``res_l = ceil(s_l) + 1`` and ``n_l = min(roundup8(res_l^3),
    2^log2_hashmap_size)`` entries; a level whose ``res_l^3`` fits in
    ``n_l`` is indexed densely."""
    scales, resolutions, sizes, offsets, dense = [], [], [], [], []
    offset = 0
    for level in range(n_levels):
        scale = base_resolution * per_level_scale ** level - 1.0
        resolution = int(math.ceil(scale)) + 1
        size = min((resolution ** 3 + 7) // 8 * 8, 1 << log2_hashmap_size)
        scales.append(scale)
        resolutions.append(resolution)
        sizes.append(size)
        offsets.append(offset)
        dense.append(resolution ** 3 <= size)
        offset += size
    return HashGridLevels(np.asarray(scales, np.float32),
                          np.asarray(resolutions, np.int64),
                          np.asarray(sizes, np.int64),
                          np.asarray(offsets, np.int64),
                          np.asarray(dense, bool), offset, float(box))


def _unit_positions(positions: torch.Tensor, box: float) -> torch.Tensor:
    """Positions in the box ``[-box, box]^3`` mapped to the unit cube and
    clamped to it."""
    return torch.clamp((positions.float() / box + 1.0) / 2.0, 0.0, 1.0)


def corner_indices(positions: torch.Tensor, grid: HashGridLevels):
    """Of every level and corner: the table rows (L, 8, N) int64, offset
    included, and the trilinear weights (L, 8, N) f32, in the kernels'
    order and rounding. Corner ``c``'s bit ``d`` says whether it lies
    above ``floor(q)`` on axis ``d``; its weight is the product over x,
    y, z of ``w_d`` or ``1 - w_d``, left to right."""
    x = _unit_positions(positions, grid.box)
    rows, weights = [], []
    for level in range(grid.levels):
        q = x * torch.tensor(grid.scales[level], device=x.device) + 0.5
        low = torch.floor(q)
        frac = q - low
        low = low.to(torch.int64)
        size = int(grid.sizes[level])
        resolution = int(grid.resolutions[level])
        level_rows, level_weights = [], []
        for corner in range(8):
            up = [(corner >> axis) & 1 for axis in range(3)]
            c = [low[:, axis] + up[axis] for axis in range(3)]
            weight = None
            for axis in range(3):
                term = frac[:, axis] if up[axis] else 1.0 - frac[:, axis]
                weight = term if weight is None else weight * term
            if grid.dense[level]:
                index = c[0] + c[1] * resolution \
                    + c[2] * (resolution * resolution)
            else:
                index = ((c[0] * PRIMES[0]) ^ (c[1] * PRIMES[1])
                         ^ (c[2] * PRIMES[2])) & 0xFFFFFFFF
            level_rows.append(index % size + int(grid.offsets[level]))
            level_weights.append(weight)
        rows.append(torch.stack(level_rows))
        weights.append(torch.stack(level_weights))
    return torch.stack(rows), torch.stack(weights)


def hash_grid_encode_reference(positions: torch.Tensor, table: torch.Tensor,
                               grid: HashGridLevels,
                               dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """Plain twin of the encode kernel: (N, 3) positions -> (N, L * F)
    features in ``dtype``, level-major, each level's F features the sum
    over its 8 corners, in order, of weight x table row in f32.
    Differentiable in ``table``."""
    rows, weights = corner_indices(positions, grid)
    levels = []
    for level in range(grid.levels):
        out = torch.zeros(positions.shape[0], table.shape[1],
                          device=positions.device)
        for corner in range(8):
            out = out + (weights[level, corner][:, None]
                         * table[rows[level, corner]])
        levels.append(out)
    return torch.cat(levels, -1).to(dtype)


def hash_grid_backward_reference(positions: torch.Tensor,
                                 grad: torch.Tensor,
                                 grid: HashGridLevels) -> torch.Tensor:
    """Plain twin of the backward kernel: the (entries, F) f32 gradient
    of the table under ``grad``, the (N, L * F) cotangent of the
    features (any float type), summed with ``index_add_``."""
    rows, weights = corner_indices(positions, grid)
    grad = grad.float().reshape(positions.shape[0], grid.levels, -1)
    out = torch.zeros(grid.entries, grad.shape[-1], device=positions.device)
    for level in range(grid.levels):
        for corner in range(8):
            out.index_add_(0, rows[level, corner],
                           weights[level, corner][:, None] * grad[:, level])
    return out


_LIB = KernelLibrary(
    "hash_grid.cu", "hash_grid_error_string",
    hash_grid_encode=(PTR, PTR, PTR, PTR, INT, ctypes.c_float, PTR, LONG,
                      INT),
    hash_grid_backward=(PTR, PTR, PTR, PTR, INT, ctypes.c_float, PTR, LONG,
                        INT))


def load_kernel():
    """Builds (first call) and loads the hash grid's library; returns
    the :class:`~.build.BuiltLibrary`."""
    return _LIB.load()


def _check(positions: torch.Tensor, table: torch.Tensor,
           grid: HashGridLevels) -> None:
    """Raises unless the CUDA kernels take these inputs."""
    if positions.dtype != torch.float32 or positions.dim() != 2 \
            or positions.shape[1] != 3 or not positions.is_contiguous():
        raise ValueError(f"positions must be a contiguous (N, 3) float32 "
                         f"tensor, got {positions.dtype} "
                         f"{tuple(positions.shape)}")
    if table.dtype != torch.float32 or table.shape != (grid.entries, 2) \
            or not table.is_contiguous() or table.device != positions.device:
        raise ValueError(f"the table must be a contiguous ({grid.entries}, "
                         f"2) float32 tensor beside the positions, got "
                         f"{table.dtype} {tuple(table.shape)} on "
                         f"{table.device}")
    if not 0 < grid.levels <= MAX_LEVELS:
        raise ValueError(f"the kernels take 1 to {MAX_LEVELS} levels, got "
                         f"{grid.levels}")


def _meta_args(grid: HashGridLevels):
    """The level arrays as the entry points take them; the caller keeps
    the arrays alive over the call."""
    scales = np.ascontiguousarray(grid.scales, np.float32)
    meta = grid.meta
    return (scales, meta), (scales.ctypes.data, meta.ctypes.data,
                            grid.levels, grid.box)


def hash_grid_encode(positions: torch.Tensor, table: torch.Tensor,
                     grid: HashGridLevels,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, 3) positions -> (N, L * 2) features in ``dtype`` (f32 or
    bf16). CPU tensors run :func:`hash_grid_encode_reference`; CUDA
    tensors launch the encode kernel on the current stream (building it
    on first use) or raise. Each launch adds one to
    ``hash_grid_encode.launches`` and N to ``hash_grid_encode.points``."""
    if not on_cuda(positions, "hash grid encode"):
        return hash_grid_encode_reference(positions, table, grid, dtype)
    _check(positions, table, grid)
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"features are float32 or bfloat16, got {dtype}")
    num = positions.shape[0]
    features = torch.empty(num, 2 * grid.levels, dtype=dtype,
                           device=positions.device)
    if num == 0:
        return features
    keep, args = _meta_args(grid)
    _LIB.launch(hash_grid_encode, "hash_grid_encode", positions.device,
                positions.data_ptr(), table.data_ptr(), *args,
                features.data_ptr(), num, _DTYPE_CODES[dtype])
    del keep
    hash_grid_encode.points += num
    return features


hash_grid_encode.launches = 0
hash_grid_encode.points = 0


def hash_grid_backward(positions: torch.Tensor, grad: torch.Tensor,
                       grid: HashGridLevels) -> torch.Tensor:
    """The (entries, 2) f32 gradient of the table under ``grad``, the
    (N, L * 2) cotangent of :func:`hash_grid_encode`'s features (f32 or
    bf16). CPU tensors run :func:`hash_grid_backward_reference`; CUDA
    tensors launch the backward kernel, which adds each corner's share
    into zeros with ``float2`` atomics (so the sums' order changes from
    launch to launch), or raise. Each launch adds one to
    ``hash_grid_backward.launches``."""
    if not on_cuda(positions, "hash grid backward"):
        return hash_grid_backward_reference(positions, grad, grid)
    num = positions.shape[0]
    if grad.dtype not in _DTYPE_CODES or grad.shape != (num, 2 * grid.levels) \
            or not grad.is_contiguous() or grad.device != positions.device:
        raise ValueError(f"the cotangent must be a contiguous (N, "
                         f"{2 * grid.levels}) float32 or bfloat16 tensor "
                         f"beside the positions, got {grad.dtype} "
                         f"{tuple(grad.shape)} on {grad.device}")
    out = torch.zeros(grid.entries, 2, device=positions.device)
    _check(positions, out, grid)
    if num == 0:
        return out
    keep, args = _meta_args(grid)
    _LIB.launch(hash_grid_backward, "hash_grid_backward", positions.device,
                positions.data_ptr(), grad.data_ptr(), *args,
                out.data_ptr(), num, _DTYPE_CODES[grad.dtype])
    del keep
    return out


hash_grid_backward.launches = 0


class HashGridEncode(torch.autograd.Function):
    """The encoding with the table's gradient from the backward kernel
    (or its twin); positions get no gradient."""

    @staticmethod
    def forward(ctx, table, positions, grid, dtype):
        ctx.grid = grid
        ctx.save_for_backward(positions)
        return hash_grid_encode(positions, table, grid, dtype)

    @staticmethod
    def backward(ctx, grad):
        positions, = ctx.saved_tensors
        return (hash_grid_backward(positions, grad.contiguous(), ctx.grid),
                None, None, None)


def hash_grid_apply(table: torch.Tensor, positions: torch.Tensor,
                    grid: HashGridLevels,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Differentiable encoding: (N, 3) positions -> (N, L * 2) features
    in ``dtype`` (f32 when None)."""
    return HashGridEncode.apply(table, positions.float().contiguous(), grid,
                                dtype or torch.float32)
