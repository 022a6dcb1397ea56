"""The int8 tensor-core probe: three Hopper kernels and their plain twins.

The CUDA kernels (``csrc/int8_probe.cu``) replace the three TPU Pallas
kernels of ``tools/int8_probe.py::main``; the layout is that tool's,
W (rows = outputs, cols = inputs) @ h (inputs, columns):

* :func:`int8_matmul` (P1a, ``k_int8``): int8 (M, K) @ int8 (K, N) ->
  int32, exact;
* :func:`quantized_matmul` (P1b, ``k_quant``): f32 x (K, N) quantized
  with one scale, ``max|x| / 127 + 1e-30``, rounded half to even to
  int8, multiplied by int8 W (M, K) and dequantized -> f32 (M, N);
* :func:`layer_stack` (P1c, ``stack_kernel``): L chained layers
  ``h <- cast(max(W_l @ h, 0))`` in bf16 (f32 sums) or int8 (int32
  sums; the cast wraps, two's complement) -> f32 (C, N).

Each ``*_reference`` is the plain PyTorch twin. Integer products go
through float64, exact while a sum stays under 2**53, so the twins run
on the CPU and on a card alike. A wrapper runs its twin for CPU
tensors; for CUDA tensors it launches its kernel or raises, and each
launch adds one to ``<wrapper>.launches``. The source comment says what
bounds the kernels on an H100.
"""

import ctypes

import torch

from .launch import INT, PTR, KernelLibrary, on_cuda

__all__ = ["int8_matmul", "int8_matmul_reference", "layer_stack",
           "layer_stack_plan", "layer_stack_reference", "load_kernel",
           "quantized_matmul", "quantized_matmul_reference"]

MAX_CHANNELS = 256   # kMaxChannels in csrc/int8_probe.cu
_STACK_DTYPES = {torch.int8: 0, torch.bfloat16: 1}


def _int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of integer-valued tensors as exact int32 sums."""
    return (a.double() @ b.double()).to(torch.int32)


def int8_matmul_reference(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain twin of P1a: int8 (M, K) @ int8 (K, N) -> int32 (M, N)."""
    return _int_product(w, h)


def _quant_scale(x: torch.Tensor) -> torch.Tensor:
    """max|x| / 127 + 1e-30 as an f32 tensor on x's device (a 0-dim
    tensor divisor, so a CUDA device divides and does not multiply by
    a reciprocal)."""
    divisor = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    return x.abs().max() / divisor + 1e-30


def quantized_matmul_reference(x: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """Plain twin of P1b: f32 x (K, N), int8 w (M, K) -> f32 (M, N)."""
    scale = _quant_scale(x)
    q = torch.round(x / scale).to(torch.int8)
    return _int_product(w, q).float() * scale


def layer_stack_reference(h0: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Plain twin of P1c: h0 (C, N) and ws (L, C, C), both bf16 or both
    int8 -> f32 (C, N)."""
    h = h0
    for w in ws:
        if h.dtype == torch.int8:
            h = torch.clamp_min(_int_product(w, h), 0).to(torch.int8)
        else:
            h = torch.relu(w.float() @ h.float()).to(h.dtype)
    return h.float()


_LIB = KernelLibrary(
    "int8_probe.cu", "int8_probe_error_string",
    int8_matmul=(PTR, PTR, PTR, INT, INT, INT),
    quantized_matmul=(PTR, PTR, PTR, INT, INT, INT),
    layer_stack=(PTR, PTR, PTR, INT, INT, INT, INT),
    layer_stack_plan=(INT, INT, INT, INT, PTR))


def load_kernel():
    """Builds (first call) and loads the probe library; returns the
    :class:`~.build.BuiltLibrary`."""
    return _LIB.load()


def _check(device, *operands):
    """Raises unless each (name, tensor, dtype, dims) is a contiguous
    non-empty ``dims``-D ``dtype`` tensor on ``device``."""
    for name, tensor, dtype, dims in operands:
        if tensor.dtype != dtype or tensor.dim() != dims \
                or not tensor.is_contiguous() or 0 in tensor.shape:
            raise ValueError(f"{name} must be a contiguous non-empty {dims}-D "
                             f"{dtype} tensor, got {tensor.dtype} "
                             f"{tuple(tensor.shape)}")
        if tensor.device != device:
            raise ValueError(f"{name} is on {tensor.device}, expected "
                             f"{device}")


def int8_matmul(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """P1a: int8 w (M, K) @ int8 h (K, N) -> int32 (M, N), exact."""
    if not on_cuda(w, "int8 matmul"):
        return int8_matmul_reference(w, h)
    device = w.device
    _check(device, ("w", w, torch.int8, 2), ("h", h, torch.int8, 2))
    (m, k), (k_h, n) = w.shape, h.shape
    if k_h != k:
        raise ValueError(f"w {tuple(w.shape)} @ h {tuple(h.shape)}")
    out = torch.empty((m, n), dtype=torch.int32, device=device)
    _LIB.launch(int8_matmul, "int8_matmul", device, w.data_ptr(),
                h.data_ptr(), out.data_ptr(), m, k, n)
    return out


int8_matmul.launches = 0


def quantized_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P1b: f32 x (K, N) and int8 w (M, K) -> f32 (M, N), on P1a's
    grid of 32x32 output tiles, each block finding max|x| itself."""
    if not on_cuda(x, "quantized matmul"):
        return quantized_matmul_reference(x, w)
    device = x.device
    _check(device, ("x", x, torch.float32, 2), ("w", w, torch.int8, 2))
    (m, k), (k_x, n) = w.shape, x.shape
    if k_x != k:
        raise ValueError(f"w {tuple(w.shape)} @ x {tuple(x.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    _LIB.launch(quantized_matmul, "quantized_matmul", device, x.data_ptr(),
                w.data_ptr(), out.data_ptr(), m, k, n)
    return out


quantized_matmul.launches = 0


def layer_stack_plan(channels: int, n: int, layers: int, dtype: torch.dtype,
                     device: torch.device) -> dict:
    """How :func:`layer_stack` launches for (C, N, L) in ``dtype`` on the
    CUDA ``device``, as the kernel's library plans it
    (``csrc/int8_probe.cu::layer_stack_plan``): the blocks of the grid,
    the blocks of a cluster (which share a 64-point tile, each a slice of
    the C output channels), the layers' weight slices a block keeps at
    once and its dynamic shared memory in bytes. Launches nothing."""
    plan = (ctypes.c_longlong * 4)()
    _LIB.call("layer_stack_plan", device, channels, n, layers,
              _STACK_DTYPES[dtype], ctypes.addressof(plan))
    return dict(zip(("ctas", "cluster", "stages", "smem_bytes"), plan))


def layer_stack(h0: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """P1c: h0 (C, N) and the layers' weights ws (L, C, C), both bf16 or
    both int8 -> f32 (C, N). The kernel takes C a multiple of 16 up to
    256 and ws 16-byte aligned; it spreads a 64-point tile over a
    cluster of blocks (:func:`layer_stack_plan`)."""
    if not on_cuda(h0, "layer stack"):
        return layer_stack_reference(h0, ws)
    if h0.dtype not in _STACK_DTYPES:
        raise ValueError(f"the layer stack takes bf16 or int8, got {h0.dtype}")
    device = h0.device
    _check(device, ("h0", h0, h0.dtype, 2), ("ws", ws, h0.dtype, 3))
    channels, n = h0.shape
    if ws.shape[1:] != (channels, channels) or channels % 16 \
            or channels > MAX_CHANNELS:
        raise ValueError(f"ws must be (L, C, C) with C = {channels} a "
                         f"multiple of 16 up to {MAX_CHANNELS}, got "
                         f"{tuple(ws.shape)}")
    if ws.data_ptr() % 16:
        raise ValueError("ws must be 16-byte aligned: the kernel copies the "
                         "weights 16 bytes at a time")
    out = torch.empty((channels, n), dtype=torch.float32, device=device)
    _LIB.launch(layer_stack, "layer_stack", device, h0.data_ptr(),
                ws.data_ptr(), out.data_ptr(), channels, n, ws.shape[0],
                _STACK_DTYPES[h0.dtype])
    return out


layer_stack.launches = 0
