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
import functools

import torch

from .build import build_library

__all__ = ["int8_matmul", "int8_matmul_reference", "layer_stack",
           "layer_stack_reference", "load_kernel", "quantized_matmul",
           "quantized_matmul_reference"]

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


@functools.lru_cache(maxsize=None)
def load_kernel():
    """Builds (first call) and loads the probe library; returns the
    :class:`~.build.BuiltLibrary` with the entry points typed."""
    built = build_library("int8_probe.cu")
    lib = built.lib
    for name in ("int8_matmul", "quantized_matmul"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.layer_stack.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.layer_stack.restype = ctypes.c_int
    lib.int8_probe_error_string.argtypes = [ctypes.c_int]
    lib.int8_probe_error_string.restype = ctypes.c_char_p
    return built


def _check(name, tensor, dtype, dims, device):
    if tensor.dtype != dtype or tensor.dim() != dims \
            or not tensor.is_contiguous() or 0 in tensor.shape:
        raise ValueError(f"{name} must be a contiguous non-empty {dims}-D "
                         f"{dtype} tensor, got {tensor.dtype} "
                         f"{tuple(tensor.shape)}")
    if tensor.device != device:
        raise ValueError(f"{name} is on {tensor.device}, expected {device}")


def _launch(wrapper, entry, out, *args):
    lib = load_kernel().lib
    with torch.cuda.device(out.device):
        code = getattr(lib, entry)(*args,
                                   torch.cuda.current_stream().cuda_stream)
    if code != 0:
        message = lib.int8_probe_error_string(code).decode()
        raise RuntimeError(f"{entry} kernel launch failed: {message} "
                           f"(cudaError {code})")
    wrapper.launches += 1
    return out


def _on_cuda(tensor: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if tensor.device.type == "cpu":
        return False
    if tensor.device.type != "cuda":
        raise ValueError(f"no {what} kernel for {tensor.device}")
    return True


def int8_matmul(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """P1a: int8 w (M, K) @ int8 h (K, N) -> int32 (M, N), exact."""
    if not _on_cuda(w, "int8 matmul"):
        return int8_matmul_reference(w, h)
    _check("w", w, torch.int8, 2, w.device)
    _check("h", h, torch.int8, 2, w.device)
    if h.shape[0] != w.shape[1]:
        raise ValueError(f"w {tuple(w.shape)} @ h {tuple(h.shape)}")
    (m, k), n = w.shape, h.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=w.device)
    return _launch(int8_matmul, "int8_matmul", out, w.data_ptr(),
                   h.data_ptr(), out.data_ptr(), m, k, n)


int8_matmul.launches = 0


def quantized_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P1b: f32 x (K, N) and int8 w (M, K) -> f32 (M, N), in one block
    of the card."""
    if not _on_cuda(x, "quantized matmul"):
        return quantized_matmul_reference(x, w)
    _check("x", x, torch.float32, 2, x.device)
    _check("w", w, torch.int8, 2, x.device)
    if x.shape[0] != w.shape[1]:
        raise ValueError(f"w {tuple(w.shape)} @ x {tuple(x.shape)}")
    (m, k), n = w.shape, x.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    return _launch(quantized_matmul, "quantized_matmul", out, x.data_ptr(),
                   w.data_ptr(), out.data_ptr(), m, k, n)


quantized_matmul.launches = 0


def layer_stack(h0: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """P1c: h0 (C, N) and the layers' weights ws (L, C, C), both bf16 or
    both int8 -> f32 (C, N). The kernel takes C a multiple of 16 up to
    256 and ws 16-byte aligned."""
    if not _on_cuda(h0, "layer stack"):
        return layer_stack_reference(h0, ws)
    if h0.dtype not in _STACK_DTYPES:
        raise ValueError(f"the layer stack takes bf16 or int8, got {h0.dtype}")
    _check("h0", h0, h0.dtype, 2, h0.device)
    _check("ws", ws, h0.dtype, 3, h0.device)
    channels, n = h0.shape
    if ws.shape[1:] != (channels, channels) or channels % 16 \
            or channels > MAX_CHANNELS:
        raise ValueError(f"ws must be (L, C, C) with C = {channels} a "
                         f"multiple of 16 up to {MAX_CHANNELS}, got "
                         f"{tuple(ws.shape)}")
    if ws.data_ptr() % 16:
        raise ValueError("ws must be 16-byte aligned: the kernel loads the "
                         "weights as 16-byte vectors")
    out = torch.empty((channels, n), dtype=torch.float32, device=h0.device)
    return _launch(layer_stack, "layer_stack", out, h0.data_ptr(),
                   ws.data_ptr(), out.data_ptr(), channels, n, ws.shape[0],
                   _STACK_DTYPES[h0.dtype])


layer_stack.launches = 0
