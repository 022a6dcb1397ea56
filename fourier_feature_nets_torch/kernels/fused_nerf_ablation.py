"""The fused NeRF forward's ablations: the Hopper kernel and its plain twin.

The CUDA kernel (``csrc/fused_nerf_ablation.cu``) replaces the TPU
Pallas kernel of ``tools/kernel_ablation_bench.py::make_kernel``: K1's
forward with one part of the work changed, in the modes of
:data:`ALL_MODES`. :data:`MODES` are the five the tool's run times
(``:174``), and the ablation CLI prints those. The modes touch only the
body layers and the position encode, as that tool does:

* ``base`` is K1's function, computed on the 64-point WMMA tile of
  ``csrc/fused_nerf_common.cuh`` (K1's bf16 tile before its wgmma
  redesign; K3 runs it too), so the modes split that tile's time, not
  the wgmma kernel's, and ``base`` holds K1's bf16 output within K1's
  atol 0.05, not bit for bit;
* ``no-view`` skips the bottleneck, the view encode, the hidden layer
  and the color head, and sets the color to ``opacity * 0 + color
  bias``;
* ``no-bias`` adds no body bias, ``no-relu`` casts without a ReLU,
  ``matmul-only`` does both;
* ``bf16-accum`` (bf16 packs only) rounds each body product to bf16,
  and sums the products and adds the bias in bf16: the tool's
  ``preferred_element_type=bf16``. Layer 0 is the chain ``((cos + sin)
  + raw) + bias``, a skip layer ``(h + ((cos + sin) + raw)) + bias``,
  one bf16 rounding after every product and every add;
* ``no-sincos`` encodes positions as ``[phase | phase * 0.5 | raw]``
  in place of ``[cos | sin | raw]``; the view encode keeps its sin/cos.

The weights are the pack of :func:`~.fused_nerf.prepare_fused_nerf`, in
bf16 or f32. :func:`fused_nerf_ablation` runs the twin for CPU tensors;
for CUDA tensors it launches the kernel or raises, and each launch adds
one to ``fused_nerf_ablation.launches``.
"""

import torch

from ..ops.encoding import encode_phases
from .fused_nerf import (
    _DTYPE_CODES,
    FusedNeRFWeights,
    _check_cuda_inputs,
    _dense,
    _features,
    fast_sincos,
)
from .launch import INT, LONG, PTR, KernelLibrary, on_cuda

__all__ = ["ALL_MODES", "MODES", "fused_nerf_ablation",
           "fused_nerf_ablation_reference", "load_kernel"]

MODES = ("base", "no-view", "no-bias", "no-relu", "matmul-only")
ALL_MODES = MODES + ("bf16-accum", "no-sincos")


def _check_mode(mode: str, dtype: torch.dtype) -> None:
    if mode not in ALL_MODES:
        raise ValueError(f"unknown ablation mode {mode!r}; one of "
                         f"{ALL_MODES}")
    if mode == "bf16-accum" and dtype != torch.bfloat16:
        raise ValueError(f"bf16-accum takes a bf16 pack, got {dtype}")


def _pos_parts(weights: FusedNeRFWeights, positions, mode, dtype):
    """The position encode's parts in ``dtype``: [cos, sin(, raw)], or
    [phase, phase * 0.5(, raw)] in ``no-sincos``."""
    x = positions.float()
    phases = encode_phases(x, weights.pos_enc)
    if mode == "no-sincos":
        parts = [phases, phases * 0.5]
    else:
        sin, cos = fast_sincos(phases)
        parts = [cos, sin]
    if weights.include_inputs:
        parts.append(x)
    return [part.to(dtype) for part in parts]


def _body(x, layer, mode, dtype):
    """One body layer in ``mode``: f32 sum (+ bias), cast (, ReLU)."""
    weight, bias = layer
    acc = x.float() @ weight.float()
    if mode not in ("no-bias", "matmul-only"):
        acc = acc + bias
    h = acc.to(dtype)
    return h if mode in ("no-relu", "matmul-only") else torch.relu(h)


def _bf16_body(h, parts, layer):
    """One body layer in ``bf16-accum``: each product rounded to bf16,
    the sums and the bias add in bf16, then the ReLU. ``parts`` are the
    encode's parts, whose weight rows follow ``h``'s (none for a middle
    layer); their products chain left to right, and ``h``'s product
    joins that chain last, as the tool's skip layer adds them."""
    weight, bias = layer
    rows = h.shape[1] if h is not None else 0
    acc = None
    for part in parts:
        width = part.shape[1]
        product = (part.float() @ weight[rows:rows + width].float()).to(
            torch.bfloat16)
        acc = product if acc is None else acc + product
        rows += width
    if h is not None:
        product = (h.float() @ weight[:h.shape[1]].float()).to(torch.bfloat16)
        acc = product if acc is None else product + acc
    return torch.relu(acc + bias.to(torch.bfloat16))


def fused_nerf_ablation_reference(weights: FusedNeRFWeights,
                                  positions: torch.Tensor,
                                  views: torch.Tensor,
                                  mode: str) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (N, 3) positions and views ->
    (N, 4) f32 logits, with K1's twin's rounding; ``base`` equals
    :func:`~.fused_nerf.fused_nerf_reference`."""
    dtype = weights.weights.dtype
    _check_mode(mode, dtype)
    layers = weights.layers
    num_layers = weights.num_layers
    parts = _pos_parts(weights, positions, mode, dtype)
    enc = torch.cat(parts, -1)
    enc = torch.nn.functional.pad(enc, (0, weights.pos_width - enc.shape[1]))
    if mode == "bf16-accum":
        h = _bf16_body(None, parts, layers[0])
        for i in range(1, num_layers):
            h = _bf16_body(h, parts if i in weights.skips else [], layers[i])
    else:
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
    _check_mode(mode, weights.weights.dtype)
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
                ALL_MODES.index(mode), _DTYPE_CODES[weights.weights.dtype])
    return out


fused_nerf_ablation.launches = 0
