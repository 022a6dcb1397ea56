"""The fused NeRF forward's ablations: the Hopper kernel and its plain twin.

The CUDA kernel (``csrc/fused_nerf_ablation.cu``) replaces the TPU
Pallas kernel of ``tools/kernel_ablation_bench.py::main``: K1's forward
with one part of the work taken out, in the modes of :data:`MODES`. The
modes touch only the body layers, as that tool's ``post()`` does:
``no-bias`` adds no body bias, ``no-relu`` casts without a ReLU,
``matmul-only`` does both; ``no-view`` skips the bottleneck, the view
encode, the hidden layer and the color head, and sets the color to
``opacity * 0 + color bias``. ``base`` is K1's function.

The weights are the pack of :func:`~.fused_nerf.prepare_fused_nerf`, in
bf16 or f32. :func:`fused_nerf_ablation` runs the twin for CPU tensors;
for CUDA tensors it launches the kernel or raises, and each launch adds
one to ``fused_nerf_ablation.launches``.
"""

import torch

from .fused_nerf import (
    _DTYPE_CODES,
    FusedNeRFWeights,
    _check_cuda_inputs,
    _dense,
    _features,
)
from .launch import INT, LONG, PTR, KernelLibrary, on_cuda

__all__ = ["MODES", "fused_nerf_ablation", "fused_nerf_ablation_reference",
           "load_kernel"]

MODES = ("base", "no-view", "no-bias", "no-relu", "matmul-only")


def _body(x, layer, mode, dtype):
    """One body layer in ``mode``: f32 sum (+ bias), cast (, ReLU)."""
    weight, bias = layer
    acc = x.float() @ weight.float()
    if mode not in ("no-bias", "matmul-only"):
        acc = acc + bias
    h = acc.to(dtype)
    return h if mode in ("no-relu", "matmul-only") else torch.relu(h)


def fused_nerf_ablation_reference(weights: FusedNeRFWeights,
                                  positions: torch.Tensor,
                                  views: torch.Tensor,
                                  mode: str) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (N, 3) positions and views ->
    (N, 4) f32 logits, with K1's twin's rounding; ``base`` equals
    :func:`~.fused_nerf.fused_nerf_reference`."""
    if mode not in MODES:
        raise ValueError(f"unknown ablation mode {mode!r}; one of {MODES}")
    dtype = weights.weights.dtype
    layers = weights.layers
    num_layers = weights.num_layers
    enc = _features(positions.float(), weights.pos_enc, weights.pos_width,
                    weights.include_inputs, dtype)
    h = _body(enc, layers[0], mode, dtype)
    for i in range(1, num_layers):
        inputs = torch.cat([h, enc], -1) if i in weights.skips else h
        h = _body(inputs, layers[i], mode, dtype)
    opacity = _dense(h, layers[num_layers])[:, :1]
    if mode == "no-view":
        color = opacity * 0.0 + layers[num_layers + 3][1][:3]
    else:
        bottleneck = _dense(h, layers[num_layers + 1]).to(dtype)
        venc = _features(views.float(), weights.view_enc, weights.view_width,
                         weights.include_inputs, dtype)
        hidden = torch.relu(_dense(torch.cat([bottleneck, venc], -1),
                                   layers[num_layers + 2])).to(dtype)
        color = _dense(hidden, layers[num_layers + 3])[:, :3]
    return torch.cat([color, opacity], dim=-1)


_LIB = KernelLibrary("fused_nerf_ablation.cu",
                     "fused_nerf_ablation_error_string",
                     fused_nerf_ablation_forward=(PTR,) * 8 + (LONG, INT,
                                                               INT))


def load_kernel():
    """Builds (first call) and loads the ablation library; returns the
    :class:`~.build.BuiltLibrary`."""
    return _LIB.load()


def fused_nerf_ablation(weights: FusedNeRFWeights, positions: torch.Tensor,
                        views: torch.Tensor, mode: str) -> torch.Tensor:
    """K1's forward in an ablation ``mode``: (N, 3) positions + views ->
    (N, 4) logits."""
    if mode not in MODES:
        raise ValueError(f"unknown ablation mode {mode!r}; one of {MODES}")
    if not on_cuda(positions, "fused NeRF ablation"):
        return fused_nerf_ablation_reference(weights, positions, views, mode)
    _check_cuda_inputs(weights, positions, views)
    num = positions.shape[0]
    device = positions.device
    out = torch.empty((num, 4), dtype=torch.float32, device=device)
    if num == 0:
        return out
    _LIB.launch(fused_nerf_ablation, "fused_nerf_ablation_forward", device,
                positions.data_ptr(), views.data_ptr(),
                weights.pos_enc.data_ptr(), weights.view_enc.data_ptr(),
                weights.weights.data_ptr(), weights.biases.data_ptr(),
                weights.meta.ctypes.data, out.data_ptr(), num,
                MODES.index(mode), _DTYPE_CODES[weights.weights.dtype])
    return out


fused_nerf_ablation.launches = 0
