"""The IO-floor copy kernels: three Hopper kernels and their plain twins.

The CUDA kernels (``csrc/io_floor.cu``) replace the three TPU Pallas
kernels of ``tools/kernel_io_floor_bench.py::main``, which time moving
the fused NeRF forward's inputs and outputs without its math. ``tile``
is the JAX tool's block rows where a kernel takes it:

* :func:`io_narrow` (P3a, ``io_kernel``): (n, 3) positions + (n, 3)
  views -> (n, 4) ``[p, v[:, :1]]``; ``tile`` (a multiple of 4) is the
  rows each block moves, staged through shared memory;
* :func:`io_wide` (P3b, ``io_wide_kernel``): (n, 128) f32 -> ``x * 2``;
  its grid follows the array, one float4 a thread and 4 KB a block, so
  it takes no ``tile`` (the tool's has no counterpart);
* :func:`packed8` (P3c, ``p8_kernel``): (n, 8) f32 ->
  ``[x[:, :3], x[:, 3:4], x[:, :4] * 0]`` (a NaN stays a NaN); ``tile``
  is the rows each block copies.

Each ``*_reference`` is the plain PyTorch twin. A wrapper runs its twin
for CPU tensors; for CUDA tensors it launches its kernel or raises, and
each launch adds one to ``<wrapper>.launches``. Every CUDA tensor must
be contiguous f32 and 16-byte aligned (the kernels move float4).
"""

import torch

from .launch import INT, LONG, PTR, KernelLibrary, on_cuda

__all__ = ["io_narrow", "io_narrow_reference", "io_wide", "io_wide_reference",
           "load_kernel", "packed8", "packed8_reference"]

DEFAULT_TILE = 2048


def io_narrow_reference(positions: torch.Tensor,
                        views: torch.Tensor) -> torch.Tensor:
    """Plain twin of P3a: ``[p, v[:, :1]]``."""
    return torch.cat([positions, views[:, :1]], -1)


def io_wide_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of P3b: ``x * 2``."""
    return x * 2.0


def packed8_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of P3c: ``[x[:, :3], x[:, 3:4], x[:, :4] * 0]``."""
    return torch.cat([x[:, :3], x[:, 3:4], x[:, :4] * 0.0], -1)


_LIB = KernelLibrary("io_floor.cu", "io_floor_error_string",
                     io_narrow=(PTR, PTR, PTR, LONG, INT),
                     io_wide=(PTR, PTR, LONG),
                     packed8=(PTR, PTR, LONG, INT))


def load_kernel():
    """Builds (first call) and loads the IO-floor library; returns the
    :class:`~.build.BuiltLibrary`."""
    return _LIB.load()


def _check(tensors, width_of, tile=None):
    """Raises unless each (name, tensor) is a contiguous, 16-byte
    aligned, non-empty (n, width_of[name]) f32 tensor on the first
    tensor's device, with one n, and ``tile``, where given, is
    positive."""
    device = tensors[0][1].device
    num = tensors[0][1].shape[0] if tensors[0][1].dim() else 0
    for name, tensor in tensors:
        width = width_of[name]
        if tensor.dtype != torch.float32 or tensor.dim() != 2 \
                or tensor.shape != (num, width) or num == 0 \
                or not tensor.is_contiguous() or tensor.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"(n > 0, {width}) float32 tensor, got "
                             f"{tensor.dtype} {tuple(tensor.shape)}")
        if tensor.device != device:
            raise ValueError(f"{name} is on {tensor.device}, expected "
                             f"{device}")
    if tile is not None and tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    return num


def io_narrow(positions: torch.Tensor, views: torch.Tensor,
              tile: int = DEFAULT_TILE) -> torch.Tensor:
    """P3a: (n, 3) + (n, 3) -> (n, 4) ``[p, v[:, :1]]``."""
    if not on_cuda(positions, "io-narrow"):
        return io_narrow_reference(positions, views)
    num = _check([("positions", positions), ("views", views)],
                 {"positions": 3, "views": 3}, tile)
    if tile % 4:
        raise ValueError(f"io-narrow takes a tile of a multiple of 4 rows, "
                         f"got {tile}")
    out = torch.empty((num, 4), dtype=torch.float32, device=positions.device)
    _LIB.launch(io_narrow, "io_narrow", positions.device, positions.data_ptr(),
                views.data_ptr(), out.data_ptr(), num, tile)
    return out


io_narrow.launches = 0


def io_wide(x: torch.Tensor) -> torch.Tensor:
    """P3b: (n, 128) -> ``x * 2``; the tool's tile has no counterpart."""
    if not on_cuda(x, "io-wide"):
        return io_wide_reference(x)
    num = _check([("x", x)], {"x": 128})
    out = torch.empty_like(x)
    _LIB.launch(io_wide, "io_wide", x.device, x.data_ptr(), out.data_ptr(),
                num)
    return out


io_wide.launches = 0


def packed8(x: torch.Tensor, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """P3c: (n, 8) -> ``[x[:, :3], x[:, 3:4], x[:, :4] * 0]``."""
    if not on_cuda(x, "packed8"):
        return packed8_reference(x)
    num = _check([("x", x)], {"x": 8}, tile)
    out = torch.empty_like(x)
    _LIB.launch(packed8, "packed8", x.device, x.data_ptr(), out.data_ptr(),
                num, tile)
    return out


packed8.launches = 0
